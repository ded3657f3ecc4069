"""The join and limit execs of the PyTorch/CUDA port against the JAX
package: the same parquet joined through ``TpuSession`` and
``TorchSession(device="cpu")`` must give the same rows in the same order
(stream order; within a stream row, the build's stable sorted order; the
full-outer tail last), over several stream batches, on both join paths
(one integral key: prepared build; strings, doubles, several keys: rank
ids), for every join type, with a residual condition and as a cross join.
The kernels themselves are held against the JAX package in
``tests/test_torch_join.py``.
"""
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu.expr.core import col as jcol
from spark_rapids_tpu.expr.core import lit as jlit
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import col as pcol
from spark_rapids_tpu_torch import lit as plit
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import GlobalLimitExec, LocalLimitExec
from spark_rapids_tpu_torch.exec.core import ExecCtx, PlanNode
from spark_rapids_tpu_torch.ops import kernels as pk

CPU = torch.device("cpu")
I32MAX = 2 ** 31 - 1


def _side(rng, n: int, null_p: float, pool: int) -> pa.RecordBatch:
    """Key columns of every kind the two join paths take, drawn from a
    small pool so keys repeat on both sides, plus a payload column."""
    def nulls():
        return rng.random(n) < null_p

    words = np.array(["", "a", "ab", "abc", "zz", "a\x00", "héllo",
                      "a longer string"], dtype=object)
    i32 = rng.integers(0, pool, n).astype(np.int32)
    i32[rng.random(n) < 0.1] = I32MAX
    return pa.RecordBatch.from_arrays([
        pa.array(i32, mask=nulls()),
        pa.array(rng.integers(-pool, pool, n) * (1 << 40), mask=nulls()),
        pa.array(rng.integers(0, pool, n).astype(np.int32),
                 mask=nulls()).cast(pa.date32()),
        pa.array(list(words[rng.integers(0, len(words), n)]),
                 type=pa.string(), mask=nulls()),
        pa.array(rng.choice([-1.5, -0.0, 0.0, 2.5, np.nan], n),
                 mask=nulls()),
        pa.array(rng.integers(-3, 3, n).astype(np.int16), mask=nulls()),
        pa.array(rng.integers(-3, 3, n).astype(np.int8), mask=nulls()),
        pa.array(np.arange(n, dtype=np.int64)),
    ], names=["i", "l", "dt", "s", "d", "h", "b", "row"])


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_join")
    rng = np.random.default_rng(99)
    paths = {}
    for name, n in (("left", 700), ("right", 90)):
        rb = _side(rng, n, 0.08, 40)
        t = pa.Table.from_batches([rb]).rename_columns(
            [f"{name[0]}_{c}" for c in rb.schema.names])
        paths[name] = str(d / name)
        pq.write_table(t, paths[name] + ".parquet")
        paths[name] += ".parquet"
    return paths


_EXEC_KEYS = {"int32": ["i"], "string": ["s"], "double": ["d"],
              "int64+string": ["l", "s"]}


def _join_query(session, col, paths, how, keys, condition=None):
    left = session.read_parquet(paths["left"])
    right = session.read_parquet(paths["right"])
    on = [(f"l_{k}", f"r_{k}") for k in keys]
    return left.join(right, on=on, how=how, condition=condition).collect()


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a == b or (a != a and b != b), (g, w)


_SMALL = {"spark.rapids.sql.reader.batchRows": 128}


@pytest.mark.parametrize("keys", list(_EXEC_KEYS))
@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_join_exec_matches_jax(tables, how, keys):
    """Several stream batches (128 rows each) against one build."""
    k = _EXEC_KEYS[keys]
    want = _join_query(TpuSession(_SMALL), jcol, tables, how, k)
    got = _join_query(TorchSession(_SMALL, device="cpu"), pcol, tables,
                      how, k)
    _same_rows(got, want)
    assert len(got) > 0


def test_inner_join_condition_and_cross_join_match_jax(tables):
    def run(session, col, lit):
        left = session.read_parquet(tables["left"])
        right = session.read_parquet(tables["right"])
        cond = col("l_row") > col("r_row") * lit(5)
        a = left.join(right, on=[("l_i", "r_i")], condition=cond).collect()
        small = right.where(col("r_row") < lit(4))
        b = left.join(small, how="cross").collect()
        c = left.join(small, how="cross",
                      condition=col("l_h") == col("r_h")).collect()
        return a, b, c

    for got, want in zip(run(TorchSession(_SMALL, device="cpu"), pcol, plit),
                         run(TpuSession(_SMALL), jcol, jlit)):
        _same_rows(got, want)
        assert len(got) > 0


def test_join_explain_matches_jax(tables):
    def plan(session, col):
        left = session.read_parquet(tables["left"])
        right = session.read_parquet(tables["right"])
        df = left.join(right, on=[("l_s", "r_s")], how="right") \
            .order_by(("l_row", True)).limit(7)
        return [line.strip() for line in df.explain().splitlines()]

    got = plan(TorchSession(device="cpu"), pcol)
    want = plan(TpuSession(), jcol)
    assert [g.split("[")[0] for g in got] == [w.split("[")[0] for w in want]
    assert "* JoinExec[right, keys=1]" in got


@pytest.mark.parametrize("n", [0, 5, 200, 10_000])
def test_limit_matches_jax(tables, n):
    def run(session, col):
        df = session.read_parquet(tables["left"])
        return df.where(col("l_i") > col("l_h")).limit(n).collect()

    got = run(TorchSession(_SMALL, device="cpu"), pcol)
    _same_rows(got, run(TpuSession(_SMALL), jcol))
    assert len(got) <= n and (n > 200 or len(got) == n)


class _Batches(PlanNode):
    """A leaf that yields fixed batches per partition."""

    def __init__(self, parts):
        super().__init__([])
        self._parts = parts

    @property
    def output_schema(self):
        return self._parts[0][0].schema

    def num_partitions(self, ctx):
        return len(self._parts)

    def partition_iter(self, ctx, pid):
        yield from self._parts[pid]


def test_local_and_global_limit_slice_in_order():
    rows = torch.arange(10, dtype=torch.int64)
    col = DeviceColumn(rows, torch.ones(10, dtype=torch.bool),
                          PT.LongType())
    b = PBatch([col], 10, PT.Schema([PT.StructField("x", PT.LongType())]),
               CPU)
    parts = [[pk.slice_rows(b, 0, 3), pk.slice_rows(b, 3, 6)],
             [pk.slice_rows(b, 6, 10)]]
    ctx = ExecCtx(device=CPU)
    local = LocalLimitExec(4, _Batches(parts))
    assert [x.num_rows for x in local.partition_iter(ctx, 0)] == [3, 1]
    assert [x.num_rows for x in local.partition_iter(ctx, 1)] == [4]
    glob = GlobalLimitExec(5, _Batches(parts))
    out = [int(v) for x in glob.execute(ctx) for v in x.columns[0].data]
    assert out == [0, 1, 2, 3, 4] and glob.num_partitions(ctx) == 1


def test_join_exec_rejects_bad_join_types_and_keys(tables):
    s = TorchSession(device="cpu")
    left = s.read_parquet(tables["left"])
    right = s.read_parquet(tables["right"])
    with pytest.raises(ValueError, match="join type"):
        left.join(right, on=[("l_i", "r_i")], how="outer").collect()
    with pytest.raises(ValueError, match="not supported for left"):
        left.join(right, on=[("l_i", "r_i")], how="left",
                  condition=pcol("l_h") > pcol("r_h")).collect()
    with pytest.raises(ValueError, match="type mismatch"):
        left.join(right, on=[("l_i", "r_l")]).collect()
