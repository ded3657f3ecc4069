"""The shuffle exchange of the PyTorch/CUDA port against the JAX package:
partition grouping (K10), the exchange and adaptive-reader execs, the
partial/final aggregation over them, explicit repartitions, and TPC-DS
q3, q6, q42 and q52 in a multi-file layout.

Kernel level: ``ops/partition.py`` ``group_by_part`` against
``spark_rapids_tpu/exec/exchange.py`` ``_jit_group_by_part`` on identical
leaves -- the same permutation (a row-number column), counts and starts
over the reference's first ``num_rows`` rows.  Query level: the same
parquet through ``TpuSession`` and ``TorchSession(device="cpu")`` gives
the same rows in the same order and explain trees with the same node
names.  TPC-DS runs at sf0.1 with ``rows_per_file=1 << 15``: 9
store_sales files, 8 scan partitions, so grouped aggregates plan
partial -> ShuffleExchangeExec[HashPartitioning(8)] -> final, read
through AdaptiveShuffleReaderExec with ``spark.sql.adaptive.enabled`` on.

The reference sizes a batch by its power-of-two padded capacity and the
port by its exact bytes, so a query whose adaptive grouping could differ
orders its rows fully or compares them as a multiset.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu.bench import tpcds_gen as jgen
from spark_rapids_tpu.bench import tpcds_queries as jq
from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu.exec.exchange import _jit_group_by_part
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr.core import col as jcol
from spark_rapids_tpu.expr.core import lit as jlit
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import col as pcol
from spark_rapids_tpu_torch import lit as plit
from spark_rapids_tpu_torch.bench import tpcds_gen as pgen
from spark_rapids_tpu_torch.bench.tpcds_queries import (TPCDS_QUERIES,
                                                        top_customers)
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.exec import exchange as pex
from spark_rapids_tpu_torch.exec.core import ExecCtx
from spark_rapids_tpu_torch.exec.partitioning import (HashPartitioning,
                                                      RangePartitioning,
                                                      SinglePartitioning)
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops import partition as pp

CPU = torch.device("cpu")
AQE = "spark.sql.adaptive.enabled"
RPF = 1 << 15


def _node_names(explain: str) -> list:
    out = []
    for line in explain.splitlines():
        name = line.strip().lstrip("*!").strip().split("[")[0]
        out.append((len(line) - len(line.lstrip()), name))
    return out


def _same_rows(got, want):
    """Equal rows in order; doubles within 1e-12 relative (the two
    packages sum a group's doubles in different orders)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                assert math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-300) \
                    or (math.isnan(a) and math.isnan(b)), (g, w)
            else:
                assert a == b, (g, w)


# ---------------------------------------------------------------------------
# K10: group_by_part against _jit_group_by_part
# ---------------------------------------------------------------------------

def _pair(rb):
    jb = JBatch.from_arrow(rb)
    n = int(jax.device_get(jb.num_rows))
    leaves = jax.device_get([(c.data, c.validity, c.lengths)
                             for c in jb.columns])
    return jb, PBatch.from_leaves(rb.schema, leaves, n, CPU)


def _payload(rng, n: int) -> pa.RecordBatch:
    words = np.array(["", "a", "héllo", "日本", "a longer string"],
                     dtype=object)
    return pa.RecordBatch.from_arrays([
        pa.array(np.arange(n, dtype=np.int64)),
        pa.array(list(words[rng.integers(0, len(words), n)]),
                 type=pa.string(), mask=rng.random(n) < 0.1),
        pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
    ], names=["row", "s", "d"])


@pytest.mark.parametrize("num_parts", [1, 8, 200])
@pytest.mark.parametrize("shape", ["uniform", "skewed", "empty"])
def test_group_by_part_matches_jax(num_parts, shape):
    rng = np.random.default_rng(num_parts * 7 + len(shape))
    n = 0 if shape == "empty" else 1500
    ids = rng.integers(0, num_parts, n)
    if shape == "skewed":
        ids[rng.random(n) < 0.8] = num_parts // 2
    jb, pb = _pair(_payload(rng, n))
    jids = np.full(jb.capacity, num_parts, dtype=np.int32)
    jids[:n] = ids
    jsorted, jcounts, jstarts = _jit_group_by_part(jb, jnp.asarray(jids),
                                                   num_parts)
    grouped, counts, starts = pp.group_by_part(
        pb, torch.from_numpy(ids.astype(np.int32)), num_parts)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    assert counts.dtype == starts.dtype == torch.int32
    want = jax.device_get([(c.data, c.validity, c.lengths)
                           for c in jsorted.columns])
    for gc, (d, v, ln) in zip(grouped.columns, want):
        np.testing.assert_array_equal(gc.data.numpy(), np.asarray(d)[:n])
        np.testing.assert_array_equal(gc.validity.numpy(),
                                      np.asarray(v)[:n])
        if ln is not None:
            np.testing.assert_array_equal(gc.lengths.numpy(),
                                          np.asarray(ln)[:n])
    # the permutation: a stable sort of the ids
    np.testing.assert_array_equal(grouped.columns[0].data.numpy(),
                                  np.argsort(ids, kind="stable"))


def test_group_by_part_puts_out_of_range_ids_last():
    rng = np.random.default_rng(2)
    _jb, pb = _pair(_payload(rng, 9))
    ids = torch.tensor([3, -1, 0, 4, 3, 9, 0, 1, 2], dtype=torch.int32)
    grouped, counts, starts = pp.group_by_part(pb, ids, 4)
    assert counts.tolist() == [2, 1, 1, 2]
    assert starts.tolist() == [0, 2, 3, 4]
    assert grouped.columns[0].data.tolist() == [2, 6, 7, 8, 0, 4, 1, 3, 5]


def test_slice_part_is_a_view():
    rng = np.random.default_rng(4)
    _jb, pb = _pair(_payload(rng, 40))
    ids = torch.from_numpy(rng.integers(0, 3, 40).astype(np.int32))
    grouped, counts, starts = pp.group_by_part(pb, ids, 3)
    piece = pp.slice_part(grouped, int(starts[1]), int(counts[1]))
    assert piece.num_rows == int(counts[1])
    assert piece.columns[0].data.data_ptr() == \
        grouped.columns[0].data[int(starts[1]):].data_ptr()
    rows = piece.columns[0].data.numpy()
    assert (ids.numpy()[rows] == 1).all() and (np.diff(rows) > 0).all()


def test_group_wrapper_does_not_fall_back(monkeypatch):
    """Off the CPU the K10 wrapper launches its kernel or raises."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel")

    monkeypatch.setattr(native, "lib", no_kernel)
    meta = torch.device("meta")
    rng = np.random.default_rng(1)
    _jb, pb = _pair(_payload(rng, 4))
    mcols = [type(c)(c.data.to(meta), c.validity.to(meta), c.dtype,
                     None if c.lengths is None else c.lengths.to(meta))
             for c in pb.columns]
    mb = PBatch(mcols, 4, pb.schema, meta)
    with pytest.raises(RuntimeError, match="no partition_group kernel"):
        pp.group_by_part(mb, torch.zeros(4, dtype=torch.int32, device=meta),
                         8)


# ---------------------------------------------------------------------------
# exchange execs and partial/final aggregation over a small dataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    """Five parquet files (five scan partitions) of keyed rows."""
    d = tmp_path_factory.mktemp("exchange_small")
    rng = np.random.default_rng(20261017)
    words = np.array(["", "a", "bb", "héllo", "日本語", "zz top"],
                     dtype=object)
    for i in range(5):
        n = 300 + 37 * i
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 40, n).astype(np.int32),
                          mask=rng.random(n) < 0.05),
            "s": pa.array(list(words[rng.integers(0, len(words), n)]),
                          type=pa.string(), mask=rng.random(n) < 0.05),
            "v": pa.array(np.round(rng.normal(50, 20, n), 2),
                          mask=rng.random(n) < 0.1),
            "w": pa.array(rng.integers(-1000, 1000, n)),
        }), os.path.join(d, f"part-{i:05d}.parquet"))
    return str(d)


def _both(settings=None):
    return TpuSession(settings or {}), TorchSession(settings or {},
                                                    device="cpu")


def _agg_query(s, d, m, c, key):
    """Every aggregate's merge: sums, counts (a count merges as a sum),
    min/max and an average (a sum plus a count)."""
    return s.read_parquet(d).group_by(*key).agg(
        m.Sum(c("v")).alias("sv"), m.Count(c("v")).alias("cv"),
        m.CountStar().alias("n"), m.Min(c("w")).alias("mn"),
        m.Max(c("w")).alias("mx"), m.Average(c("v")).alias("av")) \
        .order_by(*[(k, True) for k in key])


_SMALL_CONFS = {
    "aqe_on": {},
    "aqe_off": {AQE: False},
    # a map side above the advisory size: K9/K10 run and the reader
    # coalesces adjacent partitions by size
    "aqe_small_advisory": {
        "spark.sql.adaptive.advisoryPartitionSizeInBytes": 2048},
    "three_partitions": {AQE: False, "spark.sql.shuffle.partitions": 3},
}


@pytest.mark.parametrize("conf", list(_SMALL_CONFS))
@pytest.mark.parametrize("key", [("k",), ("s", "k")])
def test_partial_final_aggregate_matches_jax(small_dir, conf, key):
    js, ps = _both(_SMALL_CONFS[conf])
    jdf = _agg_query(js, small_dir, JA, jcol, key)
    pdf = _agg_query(ps, small_dir, PA, pcol, key)
    assert _node_names(pdf.explain()) == _node_names(jdf.explain())
    names = [n for _i, n in _node_names(pdf.explain())]
    assert names[names.index("HashAggregateExec") + 1:][:1] == (
        ["ShuffleExchangeExec"] if conf in ("aqe_off", "three_partitions")
        else ["AdaptiveShuffleReaderExec"])
    assert "HashAggregateExec[partial" in pdf.explain()
    _same_rows(pdf.collect(), jdf.collect())


def _repart(s, d, n, *keys):
    return s.read_parquet(d).repartition(n, *keys)


@pytest.mark.parametrize("conf", ["aqe_on", "aqe_off"])
@pytest.mark.parametrize("keys", ["k", "s", "s+w", "expr"])
def test_repartition_rows_in_partition_order_match_jax(small_dir, conf,
                                                       keys):
    """No sort: rows come out partition by partition, each in map order,
    so the order itself checks K9's ids and K10's stable grouping."""
    js, ps = _both(_SMALL_CONFS[conf])
    jk = {"k": ["k"], "s": ["s"], "s+w": ["s", "w"],
          "expr": [jcol("k") + jlit(1)]}[keys]
    pk = {"k": ["k"], "s": ["s"], "s+w": ["s", "w"],
          "expr": [pcol("k") + plit(1)]}[keys]
    jdf = _repart(js, small_dir, 6, *jk)
    pdf = _repart(ps, small_dir, 6, *pk)
    assert pdf.explain().splitlines()[0].strip() == \
        "* ShuffleExchangeExec[HashPartitioning(6)]"
    _same_rows(pdf.collect(), jdf.collect())


def test_repartitioned_join_side_reads_through_a_split_only_reader(
        small_dir):
    settings = {"spark.sql.adaptive.skewedPartitionThresholdInBytes": 512,
                "spark.sql.adaptive.advisoryPartitionSizeInBytes": 512}
    js, ps = _both(settings)

    def q(s, c):
        left = s.read_parquet(small_dir).repartition(4, "k")
        right = s.read_parquet(small_dir).select(
            c("k").alias("rk"), c("w").alias("rw")).where(c("rw") > 900)
        return left.join(right, on=[("k", "rk")])

    jdf, pdf = q(js, jcol), q(ps, pcol)
    assert _node_names(pdf.explain()) == _node_names(jdf.explain())
    assert "AdaptiveShuffleReaderExec[skew-split]" in pdf.explain()
    got, want = pdf.collect(), jdf.collect()
    key = lambda r: tuple((x is None, x) for x in r)  # noqa: E731
    assert sorted(got, key=key) == sorted(want, key=key)
    # the reader split the skewed partitions: more groups than 4
    root = pdf._prepared()
    reader = root.children[0]
    assert isinstance(reader, pex.AdaptiveShuffleReaderExec)
    ctx = ExecCtx(device=CPU, conf=ps.conf)
    assert reader.num_partitions(ctx) > 4
    ctx.close()


def test_map_side_coalesce_follows_the_conf(small_dir, monkeypatch):
    """AQE on and a tiny map side: every batch goes whole to partition 0
    and K9/K10 never run; AQE off, or an explicit repartition: they run
    once per map batch."""
    calls = []
    real = pex.group_by_part
    monkeypatch.setattr(pex, "group_by_part",
                        lambda *a: calls.append(1) or real(*a))

    def run(settings, df_fn):
        calls.clear()
        s = TorchSession(settings, device="cpu")
        df_fn(s).collect()
        return len(calls)

    def agg(s):
        return s.read_parquet(small_dir).group_by("k").agg(
            PA.CountStar().alias("n"))

    assert run({}, agg) == 0
    assert run({AQE: False}, agg) == 5  # one partial buffer per partition
    assert run({}, lambda s: _repart(s, small_dir, 4, "k")) == 5


def test_exec_ctx_releases_every_shuffle(small_dir):
    s = TorchSession({AQE: False}, device="cpu")
    root = s.read_parquet(small_dir).group_by("k").agg(
        PA.CountStar().alias("n"))._prepared()
    ctx = ExecCtx(device=CPU, conf=s.conf)
    rows = sum(b.num_rows for b in root.execute(ctx))
    assert rows == 41  # 40 keys and null
    [(transport, sid)] = ctx._shuffles
    assert transport.partition_rows(sid)
    ctx.close()
    assert transport._store == {} and not ctx._shuffles
    assert ctx._cache == {}


def test_equal_subtrees_share_one_shuffle(small_dir, monkeypatch):
    """The cache key is the structural shuffle_id (plan_fingerprint): two
    exchanges over equal subtrees of one scan materialize once."""
    s = TorchSession({AQE: False}, device="cpu")
    scan = s.read_parquet(small_dir)._prepared()

    def ex(keys, n=4):
        return pex.ShuffleExchangeExec(
            HashPartitioning([pcol(k) for k in keys], n), scan)

    e1, e2, e3, e4 = ex(["k"]), ex(["k"]), ex(["s"]), ex(["k"], 5)
    assert e1.shuffle_id == e2.shuffle_id
    assert len({e1.shuffle_id, e3.shuffle_id, e4.shuffle_id}) == 3
    calls = []
    real = pex.ShuffleExchangeExec._do_shuffle
    monkeypatch.setattr(pex.ShuffleExchangeExec, "_do_shuffle",
                        lambda self, ctx: calls.append(1) or real(self, ctx))
    ctx = ExecCtx(device=CPU, conf=s.conf)
    r1 = [b.num_rows for b in e1.execute(ctx)]
    r2 = [b.num_rows for b in e2.execute(ctx)]
    assert r1 == r2 and sum(r1) == 1870 and len(calls) == 1
    ctx.close()


def test_unported_partitionings_and_codecs_raise(small_dir):
    """The lz4 codec still raises; round-robin and range partitioning (K11)
    are ported: a keyless repartition keeps every row, and a range
    exchange orders its partitions by the key (nulls first), each holding
    its rows in map order."""
    s = TorchSession(device="cpu")
    assert len(s.read_parquet(small_dir).repartition(4).collect()) == 1870
    pinned = TorchSession(
        {"spark.sql.adaptive.advisoryPartitionSizeInBytes": 0}, device="cpu")
    ex = pex.ShuffleExchangeExec(RangePartitioning([("k", True)], 4),
                                 pinned.read_parquet(small_dir)._prepared())
    ctx = ExecCtx(device=CPU, conf=pinned.conf)
    parts = [[r[0] for b in ex.partition_iter(ctx, p) for r in b.to_rows()]
             for p in range(4)]
    ctx.close()
    assert sum(map(len, parts)) == 1870 and all(parts)
    keys = [[(k is not None, k or 0) for k in p] for p in parts]
    assert all(max(a) <= min(b) for a, b in zip(keys, keys[1:]))
    lz4 = TorchSession({"spark.rapids.shuffle.compression.codec": "lz4"},
                       device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        _repart(lz4, small_dir, 4, "k").collect()
    one = SinglePartitioning()
    b = s.read_parquet(small_dir)._prepared().execute(
        ExecCtx(device=CPU)).__next__()
    assert one.device_ids(b, 0).tolist() == [0] * b.num_rows


# ---------------------------------------------------------------------------
# TPC-DS at sf0.1 in a multi-file layout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpcds_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpcds_multifile"))
    jgen.generate_tpcds(d, sf=0.1, tables=pgen.TABLES, rows_per_file=RPF)
    return d


def test_multifile_layout(tpcds_dir, tmp_path):
    files = [f for f in os.listdir(os.path.join(tpcds_dir, "store_sales"))
             if f.endswith(".parquet")]
    assert len(files) == 9
    s = TorchSession(device="cpu")
    scan = s.read_parquet(os.path.join(tpcds_dir, "store_sales"))
    assert scan._prepared().num_partitions(ExecCtx(device=CPU)) == 8
    # the port's generator writes the same files
    pgen.generate_tpcds(str(tmp_path), sf=0.1, tables=("store_sales",),
                        rows_per_file=RPF)
    for f in ("part-00000.parquet", "part-00008.parquet"):
        a = pq.read_table(os.path.join(tpcds_dir, "store_sales", f))
        b = pq.read_table(os.path.join(tmp_path, "store_sales", f))
        assert a.equals(b)


_TPCDS_CASES = [("q3", True), ("q6", True), ("q6", False), ("q15", True),
                ("q42", True), ("q52", True)]


@pytest.mark.parametrize("name,aqe", _TPCDS_CASES)
def test_tpcds_multifile_matches_jax(tpcds_dir, name, aqe):
    jdf = getattr(jq, name)(TpuSession({AQE: aqe}), tpcds_dir)
    pdf = TPCDS_QUERIES[name][0](TorchSession({AQE: aqe}, device="cpu"),
                                 tpcds_dir)
    want_plan = _node_names(jdf.explain())
    got_plan = _node_names(pdf.explain())
    assert got_plan == want_plan
    names = [n for _i, n in got_plan]
    assert "ShuffleExchangeExec" in names
    assert ("AdaptiveShuffleReaderExec" in names) == aqe
    got = pdf.collect()
    assert got == jdf.collect()
    assert got
    if name == "q6":
        assert len(got) == 51


def test_repartition_query_matches_jax(tpcds_dir):
    """``bench/tpcds_queries.py`` ``top_customers`` against the same
    DataFrame code on the JAX package."""
    jdf = TpuSession().read_parquet(
        os.path.join(tpcds_dir, "store_sales"), columns=["ss_customer_sk"]) \
        .repartition(8, "ss_customer_sk") \
        .group_by("ss_customer_sk").agg(JA.CountStar().alias("n")) \
        .order_by(("n", False), ("ss_customer_sk", True)).limit(100)
    pdf = top_customers(TorchSession(device="cpu"), tpcds_dir)
    assert _node_names(pdf.explain()) == _node_names(jdf.explain())
    names = [n for _i, n in _node_names(pdf.explain())]
    assert names.count("ShuffleExchangeExec") == 2
    got = pdf.collect()
    assert got == jdf.collect()
    assert len(got) == 100 and got[0][0] is None
