"""The mesh execs of the PyTorch/CUDA port against the JAX package.

Both sessions run with ``spark.rapids.tpu.mesh.deviceCount=8`` and mesh
regions off, the reference on its virtual 8-device CPU mesh
(``tests/conftest.py``), the port on ``SRT_VIRTUAL_DEVICES=8`` CPU slots,
after ``tests/test_mesh_exec.py``: grouped and grand aggregates,
repartitions, replicated and partitioned joins, sorts with and without a
limit, the multichip dryrun's query (``__graft_entry__.py:137-207``), the
explain trees, the single-device path without virtual devices, the window
and array cases that stay off the mesh, and top_customers and TPC-H q22 at
a small scale.  Rows compare as multisets, or per slot and in order where
the reference fixes the order; doubles within rtol 1e-9 (per-shard sums
are added in another order).
"""
import math
import os

import numpy as np
import pytest
import torch

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.bench import tpcds_gen as jdsgen
from spark_rapids_tpu.bench import tpch_gen as jhgen
from spark_rapids_tpu.bench import tpch_queries as jhq
from spark_rapids_tpu.exec.core import ExecCtx as JCtx
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import window as JW
from spark_rapids_tpu.expr.core import col as jcol
from spark_rapids_tpu.expr.core import lit as jlit
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.bench.tpcds_queries import top_customers
from spark_rapids_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from spark_rapids_tpu_torch.exec.core import ExecCtx
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import window as PW
from spark_rapids_tpu_torch.expr.core import col as pcol
from spark_rapids_tpu_torch.expr.core import lit as plit
from spark_rapids_tpu_torch.parallel import mesh_shuffle as pms
from spark_rapids_tpu_torch.parallel.mesh import COUNTERS

CPU = torch.device("cpu")
RTOL = 1e-9
MESH = {"spark.rapids.tpu.mesh.deviceCount": 8,
        "spark.rapids.tpu.mesh.regions.enabled": False}
PART = {"spark.rapids.tpu.mesh.join.buildThresholdBytes": 0}


@pytest.fixture(autouse=True)
def _virtual_devices(monkeypatch):
    monkeypatch.setenv("SRT_VIRTUAL_DEVICES", "8")


def _schema(mod):
    return mod.Schema([
        mod.StructField("k", mod.IntegerType(), True),
        mod.StructField("g", mod.StringType(), True),
        mod.StructField("v", mod.LongType(), True),
        mod.StructField("f", mod.DoubleType(), True),
    ])


def _data(seed: int = 0, n: int = 400, nkeys: int = 17):
    rng = np.random.default_rng(seed)
    v = rng.integers(-1000, 1000, n).astype(object)
    v[rng.random(n) < 0.1] = None
    k = rng.integers(0, nkeys, n).astype(object)
    k[rng.random(n) < 0.05] = None
    return {"k": list(k),
            "g": [None if x % 11 == 0 else f"g{int(x) % 5}" * (1 + x % 3)
                  for x in rng.integers(0, 50, n)],
            "v": list(v),
            "f": rng.normal(size=n).tolist()}


def _dim(mod):
    schema = mod.Schema([mod.StructField("k", mod.IntegerType(), True),
                         mod.StructField("name", mod.StringType(), True)])
    return ({"k": list(range(0, 17, 2)),
             "name": [f"n{i}" for i in range(0, 17, 2)]}, schema)


def _sessions(conf=None):
    conf = {**MESH, **(conf or {})}
    return TpuSession(conf), TorchSession(conf, device="cpu")


def _frames(conf=None, seed: int = 0, partitions: int = 4,
            rows_per_batch: int | None = 64):
    """(reference fact, dim, port fact, dim) over the same data."""
    js, ps = _sessions(conf)
    data = _data(seed)
    out = []
    for s, mod in ((js, JT), (ps, T)):
        dd, ds = _dim(mod)
        out += [s.from_pydict(data, _schema(mod), partitions=partitions,
                              rows_per_batch=rows_per_batch),
                s.from_pydict(dd, ds, partitions=1)]
    return out


def _close_rows(got, want) -> None:
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert (math.isnan(a) and math.isnan(b)) or a == b or \
                    abs(a - b) <= RTOL * max(abs(a), abs(b)), (g, w)
            else:
                assert a == b, (g, w)


def _sorted(rows):
    return sorted(rows, key=lambda r: tuple(
        (x is None, repr(x) if isinstance(x, float) else str(x))
        for x in r))


def _same_multiset(pdf, jdf) -> list:
    got, want = _sorted(pdf.collect()), _sorted(jdf.collect())
    _close_rows(got, want)
    return got


def _node_names(explain: str) -> list:
    return [line.strip().lstrip("*!").strip().split("[")[0]
            for line in explain.splitlines() if line.strip()]


def _mesh_nodes(explain: str) -> list:
    return [n for n in _node_names(explain) if n.startswith("Mesh")]


def _jrows(b) -> list:
    rb = b.to_arrow()
    cols = [rb.column(i).to_pylist() for i in range(rb.num_columns)]
    return list(zip(*cols)) if cols else []


def _per_partition(pdf, jdf, node=lambda n: n):
    """Each output partition's rows of the prepared roots (``node`` picks
    a node under the root), reference and port."""
    ov, meta = jdf._overridden(quiet=True)
    jnode = node(meta.exec_node)
    with JCtx(backend="device", conf=jdf._s.conf) as ctx:
        want = [[r for b in jnode.partition_iter(ctx, pid)
                 for r in _jrows(b)]
                for pid in range(jnode.num_partitions(ctx))]
    pnode = node(pdf._prepared())
    ctx = ExecCtx(device=CPU, conf=pdf._s.conf)
    try:
        got = [[r for b in pnode.partition_iter(ctx, pid)
                for r in b.to_rows()]
               for pid in range(pnode.num_partitions(ctx))]
    finally:
        ctx.close()
    return got, want


# ---------------------------------------------------------------------------
# aggregates
# ---------------------------------------------------------------------------

def _agg(A, col, key):
    return (A.Sum(col("v")).alias("sv"), A.CountStar().alias("n"),
            A.Min(col("v")).alias("mn"), A.Max(col("f")).alias("mx"),
            A.Average(col("f")).alias("av"), A.Count(col("g")).alias("cg"))


@pytest.mark.parametrize("case", ["int_key", "string_key", "filter"])
def test_grouped_aggregate_matches_jax(case):
    jf, _jd, pf, _pd = _frames(partitions=4, rows_per_batch=100)
    key = "g" if case == "string_key" else "k"

    def q(df, A, col, lit):
        if case == "filter":
            df = df.where(col("v") > lit(0))
        return df.group_by(key).agg(*_agg(A, col, key))

    jdf, pdf = q(jf, JA, jcol, jlit), q(pf, PA, pcol, plit)
    assert _mesh_nodes(pdf.explain()) == _mesh_nodes(jdf.explain()) == \
        ["MeshAggregateExec"]
    got = _same_multiset(pdf, jdf)
    assert len(got) > 3
    # per slot, in order, as the reference's program leaves them
    g, w = _per_partition(pdf, jdf)
    for gd, wd in zip(g, w):
        _close_rows(gd, wd)


def test_grand_aggregate_merges_on_slot_zero():
    jf, _jd, pf, _pd = _frames()
    jdf = jf.agg(JA.Sum(jcol("v")).alias("sv"), JA.CountStar().alias("n"),
                 JA.Average(jcol("f")).alias("a"))
    pdf = pf.agg(PA.Sum(pcol("v")).alias("sv"), PA.CountStar().alias("n"),
                 PA.Average(pcol("f")).alias("a"))
    assert _mesh_nodes(pdf.explain()) == _mesh_nodes(jdf.explain()) == \
        ["MeshAggregateExec"]
    _close_rows(pdf.collect(), jdf.collect())
    g, w = _per_partition(pdf, jdf)
    assert [len(x) for x in g] == [len(x) for x in w] == [1] + [0] * 7
    _close_rows(g[0], w[0])


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 8])
def test_repartition_per_partition_matches_jax(n):
    jf, _jd, pf, _pd = _frames(partitions=2, rows_per_batch=100)
    jdf, pdf = jf.repartition(n, "k"), pf.repartition(n, "k")
    assert "MeshExchangeExec" in pdf.explain()
    g, w = _per_partition(pdf, jdf)
    assert len(g) == len(w) == n
    for gd, wd in zip(g, w):
        _close_rows(gd, wd)
    assert sum(len(x) for x in g) == 400


def test_send_capacity_overflow_counts_and_keeps_every_row():
    conf = {"spark.rapids.tpu.mesh.exchange.sendCapacityRows": 8}
    jf, _jd, pf, _pd = _frames(conf, partitions=2, rows_per_batch=100)
    from spark_rapids_tpu.obs.registry import get_registry

    def jcount():
        return get_registry().snapshot()["counters"].get(
            "mesh_send_overflows", 0)

    j0, p0 = jcount(), COUNTERS["mesh_send_overflows"]
    g, w = _per_partition(pf.repartition(8, "k"), jf.repartition(8, "k"))
    assert jcount() - j0 == COUNTERS["mesh_send_overflows"] - p0 == 1
    for gd, wd in zip(g, w):
        _close_rows(gd, wd)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["replicated", "partitioned"])
@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_mesh_join_matches_jax(mode, how):
    conf = PART if mode == "partitioned" else {}
    jf, jd, pf, pd = _frames(conf)
    jdf, pdf = jf.join(jd, on="k", how=how), pf.join(pd, on="k", how=how)
    assert _mesh_nodes(pdf.explain()) == _mesh_nodes(jdf.explain()) == \
        ["MeshJoinExec"]
    before = dict(COUNTERS)
    got = _same_multiset(pdf, jdf)
    assert got
    key = f"mesh_join_{mode}"
    assert COUNTERS[key] == before[key] + 1
    g, w = _per_partition(pdf, jdf)
    for gd, wd in zip(g, w):
        _close_rows(gd, wd)


def test_full_join_stays_in_process_and_aligns_mesh_outputs():
    jf, jd, pf, pd = _frames()
    jdf = jf.join(jd, on="k", how="inner").join(jd, on="k", how="full")
    pdf = pf.join(pd, on="k", how="inner").join(pd, on="k", how="full")
    assert _node_names(pdf.explain()) == _node_names(jdf.explain())
    assert "JoinExec" in _node_names(pdf.explain())
    before = COUNTERS["mesh_gather_fallbacks"]
    _same_multiset(pdf, jdf)
    assert COUNTERS["mesh_gather_fallbacks"] > before


def test_join_then_aggregate_matches_jax():
    jf, jd, pf, pd = _frames()
    jdf = jf.join(jd, on="k").group_by("name").agg(
        JA.Sum(jcol("v")).alias("sv"), JA.CountStar().alias("c"))
    pdf = pf.join(pd, on="k").group_by("name").agg(
        PA.Sum(pcol("v")).alias("sv"), PA.CountStar().alias("c"))
    assert _mesh_nodes(pdf.explain()) == _mesh_nodes(jdf.explain()) == \
        ["MeshAggregateExec", "MeshJoinExec"]
    g, w = _per_partition(pdf, jdf)
    for gd, wd in zip(g, w):
        _close_rows(gd, wd)
    assert sum(len(x) for x in g) > 3


# ---------------------------------------------------------------------------
# sorts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("limit", [None, 25])
def test_mesh_sort_per_slot_matches_jax(limit):
    jf, _jd, pf, _pd = _frames(partitions=3, rows_per_batch=50)
    orders = [("v", False), ("k", True), ("f", True)]
    jdf, pdf = jf.order_by(*orders), pf.order_by(*orders)
    pick = (lambda n: n)
    if limit is not None:
        jdf, pdf = jdf.limit(limit), pdf.limit(limit)
        pick = (lambda n: n.children[0])
    assert _mesh_nodes(pdf.explain()) == _mesh_nodes(jdf.explain()) == \
        ["MeshSortExec"]
    g, w = _per_partition(pdf, jdf, pick)
    assert [len(x) for x in g] == [len(x) for x in w]
    for gd, wd in zip(g, w):
        _close_rows(gd, wd)
    _close_rows(pdf.collect(), jdf.collect())
    if limit is not None:
        assert [len(x) for x in g] == [limit] + [0] * 7


# ---------------------------------------------------------------------------
# the dryrun query, explain, the single-device path, off-mesh cases
# ---------------------------------------------------------------------------

def _dryrun(s, mod, A, col, lit, n_devices: int = 8):
    n = 50 * n_devices
    rng = np.random.default_rng(11)
    data = {
        "ss_customer_sk": rng.integers(1, 100, n).astype(np.int32),
        "ss_item_sk": rng.integers(1, 1800, n).astype(np.int32),
        "ss_sales_price": np.round(rng.uniform(0, 200, n), 2),
        "ss_quantity": rng.integers(1, 100, n).astype(np.int64),
    }
    schema = mod.Schema([
        mod.StructField("ss_customer_sk", mod.IntegerType(), True),
        mod.StructField("ss_item_sk", mod.IntegerType(), True),
        mod.StructField("ss_sales_price", mod.DoubleType(), True),
        mod.StructField("ss_quantity", mod.LongType(), True),
    ])
    item_schema = mod.Schema([
        mod.StructField("i_item_sk", mod.IntegerType(), True),
        mod.StructField("i_category_id", mod.IntegerType(), True)])
    item_sk = np.arange(1, 1800, 2, dtype=np.int32)
    fact = s.from_pydict(data, schema, partitions=n_devices) \
        .where((col("ss_quantity") >= lit(10))
               & (col("ss_sales_price") > lit(5.0)))
    dim = s.from_pydict({"i_item_sk": item_sk,
                         "i_category_id": item_sk % 10}, item_schema,
                        partitions=1)
    return fact.join(dim, on=[("ss_item_sk", "i_item_sk")]) \
        .group_by("i_category_id") \
        .agg(A.Sum(col("ss_sales_price")).alias("rev"),
             A.CountStar().alias("n"),
             A.Min(col("ss_quantity")).alias("qmin"),
             A.Max(col("ss_quantity")).alias("qmax"),
             A.Average(col("ss_sales_price")).alias("avg_price"))


@pytest.mark.parametrize("mode", ["replicated", "partitioned"])
def test_dryrun_query_matches_jax(mode):
    js, ps = _sessions(PART if mode == "partitioned" else {})
    jdf = _dryrun(js, JT, JA, jcol, jlit)
    pdf = _dryrun(ps, T, PA, pcol, plit)
    assert _node_names(pdf.explain()) == _node_names(jdf.explain())
    assert _mesh_nodes(pdf.explain()) == ["MeshAggregateExec",
                                          "MeshJoinExec"]
    got = _same_multiset(pdf, jdf)
    assert len(got) == 5  # odd item keys: categories 1, 3, 5, 7, 9


def test_without_virtual_devices_the_single_device_path_runs(monkeypatch):
    """With fewer devices than the mesh, every mesh exec takes the
    reference's own single-device path; K15 never runs."""
    calls = []
    for name in ("mesh_pack", "mesh_unpack"):
        fn = getattr(pms, name)
        monkeypatch.setattr(pms, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    jf, jd, pf, pd = _frames()

    def q(f, d, A, col):
        return f.join(d, on="k").group_by("name").agg(
            A.Sum(col("v")).alias("sv")).order_by(("name", True))

    jdf, pdf = q(jf, jd, JA, jcol), q(pf, pd, PA, pcol)
    with_mesh = pdf.collect()
    assert calls
    calls.clear()
    monkeypatch.delenv("SRT_VIRTUAL_DEVICES")
    _close_rows(pdf.collect(), jdf.collect())
    _close_rows(with_mesh, jdf.collect())
    assert calls == []


def _window_frames(conf):
    jf, _jd, pf, _pd = _frames(conf)
    out = []
    for df, W, col in ((jf, JW, jcol), (pf, PW, pcol)):
        spec = W.WindowSpec(partition_by=(col("k"),),
                            order_by=((col("v"), True), (col("f"), True)))
        out.append(df.select(col("k"), col("v"), col("f"),
                             W.WindowExpression(W.RowNumber(), spec)
                             .alias("rn")))
    return out


def test_mesh_window_raises_and_runs_with_the_conf_off():
    _jdf, pdf = _window_frames({})
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        pdf.explain()
    jdf, pdf = _window_frames({"spark.rapids.tpu.mesh.window.enabled":
                               False})
    assert not _mesh_nodes(pdf.explain())
    _same_multiset(pdf, jdf)


def test_percentiles_and_arrays_stay_in_process():
    jf, _jd, pf, _pd = _frames()
    jdf = jf.group_by("k").agg(JA.Percentile(jcol("f"), 0.5).alias("p"))
    pdf = pf.group_by("k").agg(PA.Percentile(pcol("f"), 0.5).alias("p"))
    assert _node_names(pdf.explain()) == _node_names(jdf.explain())
    assert not _mesh_nodes(pdf.explain())
    _same_multiset(pdf, jdf)
    js, ps = _sessions()
    arr = {"k": [1, 2, 1, 3], "a": [[1, 2], [3], [], [4, 5, 6]]}
    out = []
    for s, mod in ((js, JT), (ps, T)):
        schema = mod.Schema([
            mod.StructField("k", mod.IntegerType(), True),
            mod.StructField("a", mod.ArrayType(mod.IntegerType()), True)])
        out.append(s.from_pydict(arr, schema, partitions=2)
                   .repartition(4, "k").order_by(("k", True)))
    assert not _mesh_nodes(out[1].explain())
    assert _node_names(out[1].explain()) == _node_names(out[0].explain())
    assert out[1].collect() == out[0].collect()


# ---------------------------------------------------------------------------
# whole queries at a small scale
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpc_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_tpc")
    ds = str(d / "tpcds")
    jdsgen.generate_tpcds(ds, sf=0.01, tables=("store_sales",),
                          rows_per_file=1 << 13)
    hs = str(d / "tpch")
    jhgen.generate_tpch(hs, sf=0.01)
    return ds, hs


def test_top_customers_on_the_mesh_matches_jax(tpc_dir):
    ds, _hs = tpc_dir
    js, ps = _sessions()
    jdf = js.read_parquet(os.path.join(ds, "store_sales"),
                          columns=["ss_customer_sk"]) \
        .repartition(8, "ss_customer_sk") \
        .group_by("ss_customer_sk").agg(JA.CountStar().alias("n")) \
        .order_by(("n", False), ("ss_customer_sk", True)).limit(100)
    pdf = top_customers(ps, ds)
    assert _mesh_nodes(pdf.explain()) == _mesh_nodes(jdf.explain()) == \
        ["MeshSortExec", "MeshAggregateExec", "MeshExchangeExec"]
    got = pdf.collect()
    assert got == jdf.collect() and len(got) == 100


def test_q22_on_the_mesh_matches_jax(tpc_dir):
    _ds, hs = tpc_dir
    js, ps = _sessions()
    jdf, pdf = jhq.q22(js, hs), TPCH_QUERIES["q22"](ps, hs)
    names = _mesh_nodes(pdf.explain())
    assert names == _mesh_nodes(jdf.explain())
    assert names == ["MeshSortExec", "MeshAggregateExec", "MeshJoinExec"]
    got = pdf.collect()
    _close_rows(got, jdf.collect())
    assert [r[0] for r in got] == ["13", "17", "18", "23", "29", "30",
                                   "31"]
