"""Window execs and plans of the PyTorch/CUDA port against the JAX package:
``WindowExec`` with stacked specs over a multi-file scan, the planner's
window exchanges (and the rule that skips one), min/max over frames with
a bounded lower edge (K12c's plain version), TPC-DS q51, q53 and q63 and
``moving_extrema`` at sf0.1 in a multi-file layout, the generator's
``store`` and ``web_sales`` tables, and a window path that imports no JAX.

The reference's ``_jit_window`` can reuse a compiled body across window
specs (ROADMAP.md Queue 3), so the bounded-frame queries clear JAX's
caches before the reference runs and are held against numpy as well.

The same parquet goes through ``TpuSession`` and
``TorchSession(device="cpu")``: explain trees have the same node names at
the same depths, and rows are equal in order, doubles within rtol 1e-12
(the packages sum a frame's doubles in different orders).
"""
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu.bench import tpcds_gen as jgen
from spark_rapids_tpu.bench import tpcds_queries as jq
from spark_rapids_tpu.bench import tpcds_queries5 as jq5
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import window as JWX
from spark_rapids_tpu.expr.conditional import If as JIf
from spark_rapids_tpu.expr.core import col as jcol
from spark_rapids_tpu.expr.core import lit as jlit
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.bench import tpcds_gen as pgen
from spark_rapids_tpu_torch.bench.tpcds_queries import (TPCDS_QUERIES,
                                                        moving_extrema)
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import window as PWX
from spark_rapids_tpu_torch.expr.core import col as pcol
from spark_rapids_tpu_torch.expr.core import lit as plit
from spark_rapids_tpu_torch.plan import logical as PL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RPF = 1 << 15


def _node_names(explain: str) -> list:
    out = []
    for line in explain.splitlines():
        name = line.strip().lstrip("*!").strip().split("[")[0]
        out.append((len(line) - len(line.lstrip()), name))
    return out


def _same_rows(got, want, rtol=1e-12):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                assert math.isclose(a, b, rel_tol=rtol, abs_tol=1e-9) \
                    or (math.isnan(a) and math.isnan(b)), (g, w)
            else:
                assert a == b, (g, w)


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    """Five parquet files of a seeded table: more than one scan
    partition, so the planner inserts window exchanges."""
    d = tmp_path_factory.mktemp("window_small")
    rng = np.random.default_rng(29)
    n = 2000
    words = np.array(["", "a", "bb", "héllo", "zz"], dtype=object)
    v = np.round(rng.normal(size=n) * 50, 2)
    v[rng.random(n) < 0.03] = -0.0
    t = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "k": pa.array(rng.integers(0, 25, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "g": pa.array(list(words[rng.integers(0, len(words), n)]),
                      type=pa.string(), mask=rng.random(n) < 0.05),
        "v": pa.array(v, mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-1000, 1000, n),
                      mask=rng.random(n) < 0.1),
        "dt": pa.array(rng.integers(0, 60, n).astype(np.int32),
                       mask=rng.random(n) < 0.05).cast(pa.date32()),
    })
    for i in range(5):
        pq.write_table(t.slice(i * 400, 400), str(d / f"part-{i}.parquet"))
    pq.write_table(t, str(d.parent / "window_one.parquet"))
    return str(d)


def _stacked(mod, col, lit, A, session, path):
    """Several specs and every window function over one projection."""
    W = mod
    cum = W.WindowFrame("rows", W.UNBOUNDED, W.CURRENT_ROW)
    by_k = W.WindowSpec(partition_by=(col("k"),),
                        order_by=((col("dt"), True), (col("id"), True)),
                        frame=cum)
    by_k_dt = W.WindowSpec(partition_by=(col("k"),),
                           order_by=((col("dt"), True),))
    by_g = W.WindowSpec(partition_by=(col("g"),),
                        order_by=((col("dt"), False, True),))
    whole_k = W.WindowSpec(partition_by=(col("k"),))
    around = W.WindowSpec(partition_by=(col("k"),),
                          order_by=((col("id"), True),),
                          frame=W.WindowFrame("rows", -2, 2))
    df = session.read_parquet(path)
    out = df.select(
        col("id"), col("k"), col("g"), col("v"),
        W.WindowExpression(A.Sum(col("v")), by_k).alias("cum_v"),
        W.WindowExpression(W.RowNumber(), by_k).alias("rn"),
        W.WindowExpression(W.Rank(), by_k_dt).alias("rk"),
        W.WindowExpression(W.DenseRank(), by_k_dt).alias("drk"),
        W.WindowExpression(A.Max(col("v")), by_k_dt).alias("max_v"),
        W.WindowExpression(A.Min(col("i")), by_k_dt).alias("min_i"),
        W.WindowExpression(W.Lag(col("v"), 1), by_k).alias("lag_v"),
        W.WindowExpression(W.Lead(col("g"), 2, lit("dflt")),
                           by_k).alias("lead_g"),
        W.WindowExpression(A.CountStar(), by_g).alias("cnt_g"),
        W.WindowExpression(A.Count(col("v")), whole_k).alias("cnt_v"),
        W.WindowExpression(A.Average(col("i")), around).alias("avg_i"),
        (col("v") * lit(100.0)
         / W.WindowExpression(A.Sum(col("v")), whole_k)).alias("share"))
    return out.order_by(("id", True))


@pytest.mark.parametrize("layout", ["multi", "one"])
def test_stacked_window_specs_match_jax(small_dir, layout):
    path = small_dir if layout == "multi" else \
        os.path.join(os.path.dirname(small_dir), "window_one.parquet")
    jdf = _stacked(JWX, jcol, jlit, JA, TpuSession(), path)
    pdf = _stacked(PWX, pcol, plit, PA, TorchSession(device="cpu"), path)
    plan = _node_names(pdf.explain())
    assert plan == _node_names(jdf.explain())
    names = [n for _d, n in plan]
    assert names.count("WindowExec") == 5
    # over a multi-partition input: an exchange on k for the first spec
    # over k (the second reuses it), one on g, and one on k again after
    # the spec over g (the last spec reuses that one); none over one file
    assert names.count("ShuffleExchangeExec") == (3 if layout == "multi"
                                                  else 0)
    got = pdf.collect()
    assert len(got) == 2000
    _same_rows(got, jdf.collect())


def test_window_skips_exchange_on_hash_partitioned_child(small_dir):
    """A child already hash-partitioned on a subset of the window's keys
    keeps its distribution: no second exchange (reference :435)."""
    def q(W, col, A, session):
        spec = W.WindowSpec(partition_by=(col("k"), col("g")),
                            order_by=((col("id"), True),))
        return session.read_parquet(small_dir).repartition(4, "k") \
            .select(col("id"), col("k"), col("g"),
                    W.WindowExpression(A.Sum(col("i")), spec).alias("s")) \
            .order_by(("id", True))

    jdf = q(JWX, jcol, JA, TpuSession())
    pdf = q(PWX, pcol, PA, TorchSession(device="cpu"))
    plan = _node_names(pdf.explain())
    assert plan == _node_names(jdf.explain())
    assert [n for _d, n in plan].count("ShuffleExchangeExec") == 1
    _same_rows(pdf.collect(), jdf.collect())


def test_logical_window_node_matches_jax(small_dir):
    """``L.Window`` lowers to an exchange on the partition keys and one
    WindowExec, as the reference's ``lower`` does."""
    def q(W, L, col, A, session):
        df = session.read_parquet(small_dir)
        spec = W.WindowSpec(partition_by=(col("k"),),
                            order_by=((col("id"), True),))
        w = W.WindowExpression(A.Sum(col("i")), spec).alias("s")
        return type(df)(df._s, L.Window([w], df._plan)).order_by(
            ("id", True))

    jdf = q(JWX, JL, jcol, JA, TpuSession())
    pdf = q(PWX, PL, pcol, PA, TorchSession(device="cpu"))
    assert _node_names(pdf.explain()) == _node_names(jdf.explain())
    _same_rows(pdf.collect(), jdf.collect())


def test_unported_window_shapes_raise(small_dir):
    s = TorchSession(device="cpu")
    glob = PWX.WindowExpression(PA.Sum(pcol("i")), PWX.WindowSpec())
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        s.read_parquet(small_dir).select(pcol("id"),
                                         glob.alias("t")).collect()


#: (name, mode, lower, upper, order key) of the bounded-lower frames:
#: trailing, centred, following-only (empty at a partition's tail), wider
#: than any partition, and the RANGE CURRENT ROW frames over peers
_BOUNDED = [("trail", "rows", -2, 0, "id"), ("centre", "rows", -1, 3, "id"),
            ("ahead", "rows", 2, 5, "id"), ("wide", "rows", -500, 400, "id"),
            ("peers", "range", 0, 0, "dt"), ("on", "range", 0, None, "dt")]


def _bounded_min_max(W, A, col, session, path):
    def spec(mode, lo, hi, key):
        return W.WindowSpec(partition_by=(col("k"),),
                            order_by=((col(key), True), (col("id"), True))
                            if mode == "rows" else ((col(key), True),),
                            frame=W.WindowFrame(mode, lo, hi))

    # the reference plans one WindowExec (and one compile) per expression:
    # two a frame, min and max taking turns over the double and the long
    exprs = [col("id"), col("k"), col("dt"), col("v"), col("i")]
    for f, (name, mode, lo, hi, key) in enumerate(_BOUNDED):
        pair = ((A.Min, "v"), (A.Max, "i")) if f % 2 else \
            ((A.Max, "v"), (A.Min, "i"))
        for fn, c in pair:
            exprs.append(W.WindowExpression(
                fn(col(c)), spec(mode, lo, hi, key)).alias(
                f"{fn.__name__}_{c}_{name}"))
    return session.read_parquet(path).select(*exprs).order_by(("id", True))


def _numpy_bounded(path):
    """Each row's min and max of v and i over every frame of
    :data:`_BOUNDED`, row by row over the sorted partitions (None for a
    frame without a value)."""
    t = pq.read_table(path).to_pydict()
    n = len(t["id"])
    groups = {}
    for j in range(n):
        groups.setdefault(t["k"][j], []).append(j)
    where = {}
    for key in ("id", "dt"):
        for rows in groups.values():
            part = sorted(rows, key=lambda j: ((t[key][j] is not None,
                                                t[key][j]), t["id"][j]))
            for pos, j in enumerate(part):
                where[(key, j)] = (part, pos)
    out = {}
    for name, mode, lo, hi, key in _BOUNDED:
        for ri in range(n):
            part, pos = where[(key, ri)]
            if mode == "rows":
                a, b = max(pos + lo, 0), min(pos + hi, len(part) - 1)
                frame = part[a:b + 1] if a <= b else []
            else:
                peers = [j for j in part if t[key][j] == t[key][ri]]
                start = part.index(peers[0])
                frame = peers if hi == 0 else part[start:]
            for c in ("v", "i"):
                vals = [t[c][j] for j in frame if t[c][j] is not None]
                out[(ri, c, name)] = (min(vals) if vals else None,
                                      max(vals) if vals else None)
    return t, out


def test_bounded_frame_min_max_match_jax_and_numpy(small_dir):
    path = os.path.join(os.path.dirname(small_dir), "window_one.parquet")
    pdf = _bounded_min_max(PWX, PA, pcol, TorchSession(device="cpu"), path)
    got = pdf.collect()
    jax.clear_caches()
    jdf = _bounded_min_max(JWX, JA, jcol, TpuSession(), path)
    assert _node_names(pdf.explain()) == _node_names(jdf.explain())
    _same_rows(got, jdf.collect())
    t, want = _numpy_bounded(path)
    names = pdf.schema.names
    checked = 0
    for row in got:
        ri = row[0]  # ids are 0..n-1 in file order
        for name, *_f in _BOUNDED:
            for c in ("v", "i"):
                for fn, w in zip(("Min", "Max"), want[(ri, c, name)]):
                    label = f"{fn}_{c}_{name}"
                    if label in names:
                        assert row[names.index(label)] == w, (row, label)
                        checked += 1
    assert checked == 2 * len(_BOUNDED) * len(got)


# ---------------------------------------------------------------------------
# TPC-DS at sf0.1 in a multi-file layout
# ---------------------------------------------------------------------------

_WINDOW_TABLES = ("date_dim", "item", "store", "store_sales", "web_sales")


@pytest.fixture(scope="module")
def tpcds_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpcds_window"))
    jgen.generate_tpcds(d, sf=0.1, tables=_WINDOW_TABLES, rows_per_file=RPF)
    return d


def test_generator_writes_reference_store_and_web_sales(tpcds_dir, tmp_path):
    pgen.generate_tpcds(str(tmp_path), sf=0.1, tables=("store", "web_sales"),
                        rows_per_file=RPF)
    for table in ("store", "web_sales"):
        files = sorted(f for f in os.listdir(os.path.join(tpcds_dir, table))
                       if f.endswith(".parquet"))
        assert files == sorted(
            f for f in os.listdir(os.path.join(tmp_path, table))
            if f.endswith(".parquet"))
        for f in files:
            a = pq.read_table(os.path.join(tpcds_dir, table, f))
            b = pq.read_table(os.path.join(tmp_path, table, f))
            assert a.equals(b), (table, f)
    assert len(files) == 3  # web_sales: 72,000 rows in 2^15-row files


_TPCDS = {"q51": jq5.q51, "q53": jq.q53, "q63": jq.q63}


@pytest.mark.parametrize("name", sorted(_TPCDS))
def test_window_queries_match_jax(tpcds_dir, name):
    jdf = _TPCDS[name](TpuSession(), tpcds_dir)
    pdf = TPCDS_QUERIES[name][0](TorchSession(device="cpu"), tpcds_dir)
    plan = _node_names(pdf.explain())
    assert plan == _node_names(jdf.explain())
    names = [n for _d, n in plan]
    assert names.count("WindowExec") == (4 if name == "q51" else 1)
    got = pdf.collect()
    assert len(got) == 100
    _same_rows(got, jdf.collect())


def _moving_extrema_jax(session, d):
    """bench/tpcds_queries.py ``moving_extrema`` on the JAX package."""
    W, c, lit = JWX, jcol, jlit
    dd = session.read_parquet(os.path.join(d, "date_dim"),
                              columns=["d_date_sk", "d_date", "d_month_seq"]) \
        .where((c("d_month_seq") >= lit(1200))
               & (c("d_month_seq") <= lit(1211)))
    days = session.read_parquet(
        os.path.join(d, "store_sales"),
        columns=["ss_item_sk", "ss_sold_date_sk", "ss_sales_price"]) \
        .where(c("ss_item_sk").is_not_null()) \
        .join(dd, on=[("ss_sold_date_sk", "d_date_sk")]) \
        .group_by("ss_item_sk", "d_date") \
        .agg(JA.Sum(c("ss_sales_price")).alias("day_sales"))

    def over(fn, frame):
        return W.WindowExpression(fn(c("day_sales")), W.WindowSpec(
            partition_by=(c("ss_item_sk"),), order_by=((c("d_date"), True),),
            frame=frame))

    w = days.select(
        c("ss_item_sk"), c("day_sales"),
        over(JA.Max, W.WindowFrame("rows", -6, W.CURRENT_ROW)).alias("high7"),
        over(JA.Min, W.WindowFrame("rows", -3, 3)).alias("low7"),
        over(JA.Max, W.WindowFrame("range", W.CURRENT_ROW, W.UNBOUNDED))
        .alias("high_on"))
    return w.group_by("ss_item_sk").agg(
        JA.Sum(JIf(c("day_sales") >= c("high7") - lit(0.005), lit(1),
                   lit(0))).alias("high_days"),
        JA.Sum(JIf(c("day_sales") >= c("high_on") - lit(0.005), lit(1),
                   lit(0))).alias("peak_days"),
        JA.Sum(c("low7")).alias("low_sum")).order_by(("ss_item_sk", True))


def _moving_extrema_numpy(d):
    """moving_extrema with numpy alone, in exact cents: per (item, day)
    sums, then per item's days the sliding windows (rows: shifted copies
    within the item; the forward high: a reversed running max per
    item)."""
    dd = pq.read_table(os.path.join(d, "date_dim"),
                       columns=["d_date_sk", "d_date", "d_month_seq"])
    seq = dd.column("d_month_seq").to_numpy()
    keep = (seq >= 1200) & (seq <= 1211)
    sk = dd.column("d_date_sk").to_numpy()[keep]
    day = dd.column("d_date").cast(pa.int32()).to_numpy()[keep]
    ss = pq.read_table(os.path.join(d, "store_sales"),
                       columns=["ss_item_sk", "ss_sold_date_sk",
                                "ss_sales_price"])
    sold = ss.column("ss_sold_date_sk").combine_chunks()
    ok = sold.is_valid().to_numpy(zero_copy_only=False)
    sold = sold.fill_null(0).to_numpy(zero_copy_only=False)
    order = np.argsort(sk)
    at = np.clip(np.searchsorted(sk[order], sold), 0, len(sk) - 1)
    ok &= sk[order][at] == sold
    item = ss.column("ss_item_sk").to_numpy()[ok]
    key = item.astype(np.int64) * 100_000 + day[order][at][ok]
    uniq, inv = np.unique(key, return_inverse=True)
    sales = np.zeros(len(uniq), np.int64)
    np.add.at(sales, inv, np.rint(
        ss.column("ss_sales_price").to_numpy()[ok] * 100).astype(np.int64))
    items = uniq // 100_000
    n = len(uniq)
    idx = np.arange(n)

    def shifted(k, fill):
        j = idx + k
        inside = (j >= 0) & (j < n)
        j = np.clip(j, 0, n - 1)
        return np.where(inside & (items[j] == items), sales[j], fill)

    high7 = np.max([shifted(-k, -1) for k in range(7)], axis=0)
    low7 = np.min([shifted(k, 2 ** 62) for k in range(-3, 4)], axis=0)
    high_on = np.empty(n, np.int64)
    starts = np.flatnonzero(np.r_[True, items[1:] != items[:-1]])
    for a, b in zip(starts, np.r_[starts[1:], n]):
        high_on[a:b] = np.maximum.accumulate(sales[a:b][::-1])[::-1]
    out = []
    for a, b in zip(starts, np.r_[starts[1:], n]):
        out.append((int(items[a]), int((sales[a:b] == high7[a:b]).sum()),
                    int((sales[a:b] == high_on[a:b]).sum()),
                    float(low7[a:b].sum()) / 100))
    return out


def test_moving_extrema_matches_jax_and_numpy(tpcds_dir):
    pdf = moving_extrema(TorchSession(device="cpu"), tpcds_dir)
    got = pdf.collect()
    jax.clear_caches()
    jdf = _moving_extrema_jax(TpuSession(), tpcds_dir)
    plan = _node_names(pdf.explain())
    assert plan == _node_names(jdf.explain())
    assert [n for _d, n in plan].count("WindowExec") == 3
    _same_rows(got, jdf.collect())
    want = _moving_extrema_numpy(tpcds_dir)
    assert len(got) == len(want) > 1000
    for g, w in zip(got, want):
        assert g[:3] == w[:3], (g, w)
        assert math.isclose(g[3], w[3], rel_tol=1e-9)


def test_window_path_imports_no_jax(tmp_path):
    """q51 and q63 through the port alone: neither jax nor the JAX package
    is imported."""
    code = (
        "import sys\n"
        "import spark_rapids_tpu_torch as P\n"
        "from spark_rapids_tpu_torch.bench import tpcds_gen\n"
        "from spark_rapids_tpu_torch.bench.tpcds_queries import q51, q63\n"
        f"d = {str(tmp_path)!r}\n"
        "tpcds_gen.generate_tpcds(d, sf=0.02, rows_per_file=1 << 13,\n"
        "    tables=('date_dim', 'item', 'store', 'store_sales',"
        " 'web_sales'))\n"
        "s = P.TorchSession(device='cpu')\n"
        "assert 'WindowExec' in q51(s, d).explain()\n"
        "assert q51(s, d).collect() and q63(s, d).collect()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spark_rapids_tpu' or m.startswith('spark_rapids_tpu.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
