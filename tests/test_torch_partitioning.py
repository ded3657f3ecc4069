"""Round-robin and range partitioning (K11) of the PyTorch/CUDA port against
the JAX package's device path, on the CPU.

Exec level: the same parquet files go through the reference's
``ShuffleExchangeExec`` (``TpuSession``'s scan, ``backend="device"``) and
the port's (``TorchSession(device="cpu")``), with
``spark.sql.adaptive.advisoryPartitionSizeInBytes`` pinned to 0 so that the
map side is never coalesced; each partition holds the same rows in the
same order.  The fuzzed files carry NaN, +-0.0, +-inf, nulls, low-cardinality
keys (tied bounds) and string columns whose widths differ between files;
the reference's own shapes of ``tests/test_exchange.py:61-110`` are here
too.  Kernel level: K11's plain version against a direct count of the
bounds below each row, with Spark's key order written out in Python.
Query level: ``top_customers_rr`` and the two range sorts of
``bench/tpcds_queries.py`` at sf0.1 in a multi-file layout against the
reference's rows, and against numpy.
"""
import functools
import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu.bench import tpcds_gen as jgen
from spark_rapids_tpu.conf import TpuConf
from spark_rapids_tpu.exec.core import ExecCtx as JCtx
from spark_rapids_tpu.exec.core import device_to_host
from spark_rapids_tpu.exec.exchange import ShuffleExchangeExec as JExchange
from spark_rapids_tpu.exec.partitioning import RangePartitioning as JRange
from spark_rapids_tpu.exec.partitioning import \
    RoundRobinPartitioning as JRoundRobin
from spark_rapids_tpu.exec.sortexec import SortExec as JSort
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr.core import col as jcol
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.bench import tpcds_queries as pq_
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.exec import (RangePartitioning,
                                         RoundRobinPartitioning,
                                         ShuffleExchangeExec)
from spark_rapids_tpu_torch.exec import exchange as pex
from spark_rapids_tpu_torch.expr.core import col as pcol
from spark_rapids_tpu_torch.ops import range_partition as RP
from spark_rapids_tpu_torch.ops.sort import SortOrder

CPU = torch.device("cpu")
PIN = {"spark.sql.adaptive.advisoryPartitionSizeInBytes": 0}
RPF = 1 << 15


def _norm(rows):
    """Rows with NaN as a comparable marker."""
    return [tuple("NaN" if isinstance(v, float) and math.isnan(v) else v
                  for v in r) for r in rows]


def _jax_parts(plan) -> list:
    ctx = JCtx(backend="device", conf=TpuConf(PIN))
    out = []
    for pid in range(plan.num_partitions(ctx)):
        rows = []
        for b in plan.partition_iter(ctx, pid):
            rows.extend(device_to_host(b).to_rows())
        out.append(_norm(rows))
    return out


def _port_parts(session, plan) -> list:
    return [_norm([r for b in bs for r in b.to_rows()])
            for bs in pq_.partition_batches(session, plan)]


def _children(path, where=None):
    js, ps = TpuSession(PIN), TorchSession(PIN, device="cpu")
    jdf, pdf = js.read_parquet(path), ps.read_parquet(path)
    if where is not None:
        jdf, pdf = jdf.where(where(jcol)), pdf.where(where(pcol))
    return jdf._overridden(quiet=True)[1].exec_node, pdf._prepared(), ps


# ---------------------------------------------------------------------------
# exec level: the reference's shapes and fuzzed files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_shapes(tmp_path_factory):
    """tests/test_exchange.py's ``_scan``: k (0..39, 6% null), v, s (25
    words, every fifth null), 3 partitions of 64-row batches; 300 rows,
    and 250 for the round-robin case."""
    out = {}
    for n in (300, 250):
        d = tmp_path_factory.mktemp(f"ref_shapes_{n}")
        rng = np.random.default_rng(42)
        k = [None if rng.random() < 0.06 else int(x)
             for x in rng.integers(0, 40, n)]
        v = [int(x) for x in rng.integers(-100, 100, n)]
        s = [f"s{x}" if x % 5 else None for x in rng.integers(0, 25, n)]
        t = pa.table({"k": pa.array(k, pa.int32()), "v": pa.array(v),
                      "s": pa.array(s, pa.string())})
        per = -(-n // 3)
        for i in range(3):
            pq.write_table(t.slice(i * per, per),
                           os.path.join(d, f"part-{i}.parquet"),
                           row_group_size=64)
        out[n] = str(d)
    return out


def test_round_robin_balance_matches_jax(ref_shapes):
    jchild, pchild, ps = _children(ref_shapes[250])
    want = _jax_parts(JExchange(JRoundRobin(5), jchild))
    got = _port_parts(ps, ShuffleExchangeExec(RoundRobinPartitioning(5),
                                              pchild))
    assert got == want
    sizes = [len(p) for p in got]
    assert sum(sizes) == 250 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("orders,parts", [([("v", True)], 4),
                                          ([("k", False)], 3)])
def test_reference_range_shapes_match_jax(ref_shapes, orders, parts):
    jchild, pchild, ps = _children(ref_shapes[300])
    want = _jax_parts(JExchange(JRange(orders, parts), jchild))
    got = _port_parts(ps, ShuffleExchangeExec(RangePartitioning(orders,
                                                                parts),
                                              pchild))
    assert got == want
    assert sum(len(p) for p in got) == 300
    if orders == [("v", True)]:
        for a, b in zip(got, got[1:]):
            if a and b:
                assert max(r[1] for r in a) <= min(r[1] for r in b)
    else:  # descending, nulls last: every null in the last partition
        assert all(r[0] is not None for p in got[:-1] for r in p)


@pytest.fixture(scope="module")
def fuzz_dir(tmp_path_factory):
    """Four files: ints with nulls, longs, doubles with NaN/+-0.0/+-inf and
    nulls, bools, a 3-value key (tied bounds) and strings whose widths
    differ from file to file (W 4, 32, 16, 8)."""
    d = tmp_path_factory.mktemp("partitioning_fuzz")
    rng = np.random.default_rng(20261017)
    words = [["", "a", "bb", "abc"],
             ["a string of twenty-nine bytes", "zz", "é", "a"],
             ["héllo", "world!", "", "bb"], ["abcdefg", "a\x00b", "b"]]
    for i, ws in enumerate(words):
        n = 150 + 40 * i
        x = rng.choice([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.5,
                        1e300], n)
        pq.write_table(pa.table({
            "i": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                          mask=rng.random(n) < 0.1),
            "l": pa.array(rng.integers(-2**62, 2**62, n)),
            "x": pa.array(x, mask=rng.random(n) < 0.1),
            "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
            "low": pa.array(rng.integers(0, 3, n).astype(np.int32)),
            "s": pa.array([ws[j] for j in rng.integers(0, len(ws), n)],
                          pa.string(), mask=rng.random(n) < 0.1),
        }), os.path.join(d, f"part-{i}.parquet"))
    return str(d)


_FUZZ_CASES = {
    "double_desc_nulls_first": ([("x", False, True)], 7),
    "string_widths_then_int": ([("s", True, False), ("i", False)], 5),
    "bool_desc_long_nulls_last": ([("b", False), ("l", True, False)], 3),
    "tied_bounds": ([("low", True)], 9),
    "three_keys": ([("low", False), ("s", False, True), ("x", True)], 6),
    "one_partition": ([("i", True)], 1),
    "more_partitions_than_rows": ([("s", True), ("l", False)], 1000),
}


@pytest.mark.parametrize("case", sorted(_FUZZ_CASES))
def test_range_partitions_match_jax(fuzz_dir, case):
    orders, parts = _FUZZ_CASES[case]
    jchild, pchild, ps = _children(fuzz_dir)
    want = _jax_parts(JExchange(JRange(orders, parts), jchild))
    got = _port_parts(ps, ShuffleExchangeExec(RangePartitioning(orders,
                                                                parts),
                                              pchild))
    assert [len(p) for p in got] == [len(p) for p in want]
    assert got == want
    assert sum(len(p) for p in got) == 150 + 190 + 230 + 270
    if case == "tied_bounds":
        assert sum(1 for p in got if p) == 3  # one partition per value


def test_empty_map_side(fuzz_dir):
    """No row passes the filter: no bounds, no rows in any partition."""
    for part in (RangePartitioning([("x", True)], 4),
                 RoundRobinPartitioning(4)):
        _jchild, pchild, ps = _children(fuzz_dir,
                                        lambda c: c("i") > 1000)
        got = _port_parts(ps, ShuffleExchangeExec(part, pchild))
        assert got == [[], [], [], []]


def test_range_exchanges_fingerprint_their_orders(fuzz_dir):
    _jchild, pchild, _ps = _children(fuzz_dir)
    a, b, c = (ShuffleExchangeExec(RangePartitioning(o, 4), pchild)
               for o in ([("x", True)], [("x", True)], [("x", False)]))
    assert a.shuffle_id == b.shuffle_id != c.shuffle_id


# ---------------------------------------------------------------------------
# K11's plain version against a direct count
# ---------------------------------------------------------------------------

def _cmp1(a, b, asc: bool, nulls_first: bool) -> int:
    """Spark's order of two values of one key (None = null; NaN largest,
    -0.0 == 0.0; strings by their UTF-8 bytes)."""
    if a is None or b is None:
        if a is None and b is None:
            return 0
        first = -1 if nulls_first else 1
        return first if a is None else -first

    def norm(v):
        if isinstance(v, float):
            return (1, 0.0) if math.isnan(v) else (0, v + 0.0)
        return v.encode() if isinstance(v, str) else v

    ka, kb = norm(a), norm(b)
    c = (ka > kb) - (ka < kb)
    return c if asc else -c


def _column(values, dtype):
    arr = pa.array(values, dtype)
    rb = pa.RecordBatch.from_arrays([arr], names=["c"])
    return ColumnBatch.from_arrow(rb, CPU, codec=False).columns[0]


_TYPES = {
    "int32": (pa.int32(), lambda r, n: [int(v) for v in
                                        r.integers(-5, 5, n)]),
    "int64": (pa.int64(), lambda r, n: [int(v) * 2**40 for v in
                                        r.integers(-4, 4, n)]),
    "double": (pa.float64(), lambda r, n: [float(v) for v in r.choice(
        [np.nan, -0.0, 0.0, np.inf, -np.inf, 2.5, -1.0], n)]),
    "bool": (pa.bool_(), lambda r, n: [bool(v) for v in r.random(n) < .5]),
    "string": (pa.string(), lambda r, n: [
        ["", "a", "ab", "b", "é", "a\x00", "zzzz zzzz zzzz"][v]
        for v in r.integers(0, 7, n)]),
}


@pytest.mark.parametrize("nb", [0, 1, 7, 40])
@pytest.mark.parametrize("keys", [["int32"], ["double"], ["string"],
                                  ["bool", "int64"],
                                  ["string", "double", "int32"]])
def test_range_ids_plain_counts_bounds_below(keys, nb):
    rng = np.random.default_rng(len(keys) * 100 + nb)
    n = 300
    rows, bounds, orders = [], [], []
    for ki, name in enumerate(keys):
        dtype, draw = _TYPES[name]
        vals = draw(rng, n + nb)
        vals = [None if rng.random() < 0.1 else v for v in vals]
        rows.append(vals[:n])
        bounds.append(vals[n:])
        orders.append(SortOrder(ki, bool(rng.random() < 0.5),
                                bool(rng.random() < 0.5)))

    def cmp(a, b):
        for o, x, y in zip(orders, a, b):
            c = _cmp1(x, y, o.ascending, o.resolved_nulls_first)
            if c:
                return c
        return 0

    # bounds are sorted, as a range partitioning's are
    brows = sorted(zip(*bounds), key=functools.cmp_to_key(cmp)) if nb \
        else []
    bcols = [_column([r[k] for r in brows], _TYPES[name][0])
             for k, name in enumerate(keys)]
    rcols = [_column(rows[k], _TYPES[name][0])
             for k, name in enumerate(keys)]
    got = RP.range_partition_ids_plain(rcols, RP.RangeBounds(bcols, orders))
    want = [sum(1 for b in brows if cmp(b, r) < 0) for r in zip(*rows)]
    assert got.dtype == torch.int32
    assert got.tolist() == want
    # the wrapper takes its plain version for CPU tensors
    assert RP.range_partition_ids(rcols, RP.RangeBounds(bcols, orders)) \
        .tolist() == want


def test_round_robin_ids():
    assert RP.round_robin_ids(5, 7, 3, CPU).tolist() == [1, 2, 0, 1, 2]
    assert RP.round_robin_ids(0, 7, 3, CPU).tolist() == []


def test_range_partitioning_needs_an_order():
    with pytest.raises(ValueError, match="order"):
        RangePartitioning([], 4)


# ---------------------------------------------------------------------------
# the paths at sf0.1 in a multi-file layout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpcds_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpcds_partitioning"))
    jgen.generate_tpcds(d, sf=0.1, tables=("store_sales", "customer"),
                        rows_per_file=RPF)
    return d


def _node_names(explain: str) -> list:
    return [line.strip().lstrip("*!").strip().split("[")[0]
            for line in explain.splitlines()]


def test_top_customers_rr_matches_jax(tpcds_dir, monkeypatch):
    jdf = TpuSession().read_parquet(
        os.path.join(tpcds_dir, "store_sales"),
        columns=["ss_customer_sk", "ss_net_paid"]) \
        .repartition(8) \
        .group_by("ss_customer_sk").agg(
            JA.CountStar().alias("n"),
            JA.Max(jcol("ss_net_paid")).alias("max_paid"),
            JA.Sum(jcol("ss_net_paid")).alias("paid")) \
        .order_by(("n", False), ("ss_customer_sk", True)).limit(100)
    pdf = pq_.top_customers_rr(TorchSession(device="cpu"), tpcds_dir)
    explain = pdf.explain()
    assert _node_names(explain) == _node_names(jdf.explain())
    assert "ShuffleExchangeExec[RoundRobinPartitioning(8)]" in explain
    calls = []
    real = pex.group_by_part
    monkeypatch.setattr(pex, "group_by_part",
                        lambda *a: calls.append(a[2]) or real(*a))
    got, want = pdf.collect(), jdf.collect()
    # the round-robin exchange is never coalesced: K10 once per map batch
    assert calls.count(8) == 9
    assert len(got) == len(want) == 100 and got[0][0] is None
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        assert math.isclose(g[3], w[3], rel_tol=1e-12)


def _store_sales_np(d):
    t = pq.read_table(os.path.join(d, "store_sales"),
                      columns=["ss_sold_date_sk", "ss_net_paid",
                               "ss_ticket_number"])
    date = t.column(0).combine_chunks()
    return (date.fill_null(0).to_numpy(zero_copy_only=False),
            date.is_null().to_numpy(zero_copy_only=False),
            t.column(1).to_numpy(), t.column(2).to_numpy())


def test_range_sort_store_sales_matches_jax_and_numpy(tpcds_dir):
    ps = TorchSession(PIN, device="cpu")
    got = _port_parts(ps, pq_.range_sort_store_sales(ps, tpcds_dir))
    orders = pq_.RANGE_STORE_SALES_ORDERS
    jchild = TpuSession(PIN).read_parquet(
        os.path.join(tpcds_dir, "store_sales"),
        columns=["ss_sold_date_sk", "ss_net_paid", "ss_ticket_number"]) \
        ._overridden(quiet=True)[1].exec_node
    want = _jax_parts(JSort(orders, JExchange(JRange(orders, 8), jchild),
                            global_sort=False))
    assert got == want
    # numpy: bounds at the same positions of np.lexsort's order; a row
    # goes above a bound only when its key is strictly greater, so the
    # partitions end at the last row of each bound's group of equal keys
    date, null, paid, _ticket = _store_sales_np(tpcds_dir)
    n = len(date)
    order = np.lexsort((-paid, date, ~null))  # nulls first, paid desc
    sd, sn, sp = date[order], null[order], paid[order]
    pos = np.clip(np.arange(1, 8) * n // 8, 0, n - 1)
    new = np.r_[True, (sd[1:] != sd[:-1]) | (sn[1:] != sn[:-1])
                | (sp[1:] != sp[:-1])]
    group_end = np.r_[np.flatnonzero(new)[1:] - 1, n - 1]
    ends = group_end[np.cumsum(new)[pos] - 1] + 1
    assert [len(p) for p in got] == np.diff(np.r_[0, ends, n]).tolist()
    rows = [r for p in got for r in p]
    assert [r[0] for r in rows] == [None if x else int(y)
                                    for x, y in zip(sn, sd)]
    assert [r[1] for r in rows] == sp.tolist()


def test_range_sort_customer_names_matches_jax(tpcds_dir):
    ps = TorchSession(PIN, device="cpu")
    got = _port_parts(ps, pq_.range_sort_customer_names(ps, tpcds_dir))
    orders = pq_.RANGE_CUSTOMER_ORDERS
    jchild = TpuSession(PIN).read_parquet(
        os.path.join(tpcds_dir, "customer"),
        columns=["c_last_name", "c_first_name", "c_customer_id"]) \
        ._overridden(quiet=True)[1].exec_node
    want = _jax_parts(JSort(orders, JExchange(JRange(orders, 200), jchild),
                            global_sort=False))
    assert len(got) == 200 and got == want
    rows = [r for p in got for r in p]
    assert len(rows) == 19952

    def key(r):
        last, first, cid = r
        return ((last is not None, last or ""),
                (first is None,
                 tuple(-b for b in (first or "").encode()) + (1,)),
                cid)

    assert rows == sorted(rows, key=key)
