"""Join kernels K5-K7 of the PyTorch/CUDA port,
held against the JAX package on the same inputs.

Kernel level: numpy-seeded batches go through ``spark_rapids_tpu.ops.join``
and the port's ``ops/join.py`` (both sides get bit-identical leaves via
``ColumnBatch.from_leaves``).  Key ids, probe counts and the gather plan
must match exactly over the reference's first ``num_rows`` rows and first
``total`` slots (the reference pads to a power-of-two capacity, the port
does not).  The execs over the same parquet through ``TpuSession``
and ``TorchSession(device="cpu")`` must give the same rows in the same
order: ``tests/test_torch_join_exec.py``.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against those by ``tests/test_torch_cuda.py`` and chip_smoke.py
on the card.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu.ops import join as jj
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.ops import join as pj
from spark_rapids_tpu_torch.ops import native

CPU = torch.device("cpu")
I32MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

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


def _pair(rb):
    """(JAX batch, port batch) over the same leaves."""
    jb = JBatch.from_arrow(rb)
    n = int(jax.device_get(jb.num_rows))
    leaves = jax.device_get([(c.data, c.validity, c.lengths)
                             for c in jb.columns])
    return jb, PBatch.from_leaves(rb.schema, leaves, n, CPU)


def _np(x):
    return np.asarray(jax.device_get(x))


# key sets: column indices into _side's batch
_RANK_KEYS = {"string": [3], "double": [4], "int64+string": [1, 3],
              "date+double+string": [2, 4, 3], "int32": [0]}
_FAST_KEYS = {"int32": 0, "int64": 1, "date": 2, "int16": 5, "int8": 6}
_SIZES = {"both": (300, 200), "empty_stream": (0, 50),
          "empty_build": (40, 0)}


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode()) % 1000


def _sides(seed: int, nl: int, nr: int, null_p=0.1, pool=12):
    rng = np.random.default_rng(seed)
    return _pair(_side(rng, nl, null_p, pool)), \
        _pair(_side(rng, nr, null_p, pool))


# ---------------------------------------------------------------------------
# kernel parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys", list(_RANK_KEYS))
@pytest.mark.parametrize("null_p", [0.0, 0.15, 1.0])
def test_key_ids_match_jax(keys, null_p):
    (jl, pl), (jr, pr) = _sides(len(keys) + int(null_p * 100), 257, 131,
                                null_p)
    k = _RANK_KEYS[keys]
    jlid, jrid = jj._key_ids(jl, jr, k, k)
    plid, prid = pj._key_ids(pl, pr, k, k)
    np.testing.assert_array_equal(plid.numpy(), _np(jlid)[:257])
    np.testing.assert_array_equal(prid.numpy(), _np(jrid)[:131])


def _check_plan(jprobe, jtotal, pprobe, ptotal, jt, cl_j, nl, nr):
    """Probe arrays, total and gather plan of both packages."""
    total = int(ptotal.item())
    assert total == int(_np(jtotal))
    jstart, jcnt, jperm, jout, junm = jprobe
    pstart, pcnt, pperm, pout, punm = pprobe
    cnt = _np(jcnt)[:nl]
    np.testing.assert_array_equal(pcnt.numpy(), cnt)
    np.testing.assert_array_equal(pout.numpy(), _np(jout)[:nl])
    has = cnt > 0  # a start only means something where there are matches
    np.testing.assert_array_equal(pstart.numpy()[has], _np(jstart)[:nl][has])
    np.testing.assert_array_equal(pperm.numpy(), _np(jperm)[:nr])
    if jt == "full":
        np.testing.assert_array_equal(punm.numpy().astype(bool),
                                      _np(junm)[:nr])
    else:
        assert punm is None
    li, ri = pj.join_indices_from_probe(nl, pprobe, jt, total)
    jli, jri, jlt, jrt, jtot = jj.join_indices_from_probe(
        cl_j, jprobe, jt, max(total, 1))
    assert int(_np(jtot)) == total
    jlt, jrt = _np(jlt)[:total], _np(jrt)[:total]
    np.testing.assert_array_equal(li.numpy() >= 0, jlt)
    np.testing.assert_array_equal(ri.numpy() >= 0, jrt)
    np.testing.assert_array_equal(li.numpy()[jlt], _np(jli)[:total][jlt])
    np.testing.assert_array_equal(ri.numpy()[jrt], _np(jri)[:total][jrt])
    return li, ri, (jli, jri, jlt, jrt, jtot)


@pytest.mark.parametrize("size", list(_SIZES))
@pytest.mark.parametrize("keys", ["string", "int64+string",
                                  "date+double+string"])
@pytest.mark.parametrize("jt", pj.JOIN_TYPES)
def test_rank_probe_and_plan_match_jax(jt, keys, size):
    nl, nr = _SIZES[size]
    (jl, pl), (jr, pr) = _sides(_seed(jt, keys, size), nl, nr)
    k = _RANK_KEYS[keys] if jt != "cross" else []
    jprobe, jtotal = jj.join_probe(jl, jr, k, k, jt)
    pprobe, ptotal = pj.join_probe(pl, pr, k, k, jt)
    if jt == "cross":
        assert int(ptotal.item()) == int(_np(jtotal)) == nl * nr
    li, ri, jplan = _check_plan(jprobe, jtotal, pprobe, ptotal, jt,
                                jl.capacity, nl, nr)
    # the output batch of the plan, both sides
    include_right = jt not in ("semi", "anti")
    schema = PT.Schema(list(pl.schema.fields) + list(pr.schema.fields)
                       if include_right else list(pl.schema.fields))
    got = pj.gather_join_output(pl, pr, li, ri, schema, include_right)
    jschema = jl.schema if not include_right else \
        type(jl.schema)(list(jl.schema.fields) + list(jr.schema.fields))
    want = jj.gather_join_output(jl, jr, *jplan, jschema, include_right)
    total = got.num_rows
    assert total == int(_np(want.num_rows))
    for p, (jd, jv, jln) in zip(got.columns, jax.device_get(
            [(c.data, c.validity, c.lengths) for c in want.columns])):
        np.testing.assert_array_equal(p.validity.numpy(),
                                      np.asarray(jv)[:total])
        np.testing.assert_array_equal(p.data.numpy(),
                                      np.asarray(jd)[:total])
        if jln is not None:
            np.testing.assert_array_equal(p.lengths.numpy(),
                                          np.asarray(jln)[:total])


@pytest.mark.parametrize("size", list(_SIZES))
@pytest.mark.parametrize("keys", list(_FAST_KEYS))
@pytest.mark.parametrize("jt", ["inner", "left", "semi", "anti"])
def test_fast_probe_and_plan_match_jax(jt, keys, size):
    nl, nr = _SIZES[size]
    (jl, pl), (jr, pr) = _sides(_seed(jt, keys, size) + 7, nl, nr)
    k = _FAST_KEYS[keys]
    jskey, jperm, jnv = jj.build_prepare_fast(jr, k)
    skey, perm, nv = pj.build_prepare_fast(pr, k)
    assert int(nv.item()) == int(_np(jnv))
    np.testing.assert_array_equal(skey.numpy(), _np(jskey)[:nr])
    np.testing.assert_array_equal(perm.numpy(), _np(jperm)[:nr])
    jprobe, jtotal = jj.probe_fast(jl, k, jskey, jperm, jnv, jt)
    pprobe, ptotal = pj.probe_fast(pl, k, skey, perm, nv, jt)
    _check_plan(jprobe, jtotal, pprobe, ptotal, jt, jl.capacity, nl, nr)


def test_int32_max_keys_match_on_both_paths():
    """A genuine INT32_MAX key on both sides matches: build nulls are
    rewritten to the max, and the probe clips to nv."""
    left = pa.RecordBatch.from_arrays([pa.array(
        [I32MAX, 1, None, I32MAX, 5], type=pa.int32())], names=["k"])
    right = pa.RecordBatch.from_arrays([pa.array(
        [None, I32MAX, 5, None, I32MAX, 1], type=pa.int32())], names=["k"])
    (jl, pl), (jr, pr) = _pair(left), _pair(right)
    skey, perm, nv = pj.build_prepare_fast(pr, 0)
    assert int(nv.item()) == 4
    (start, cnt, _p, out_cnt, _u), total = pj.probe_fast(
        pl, 0, skey, perm, nv, "inner")
    assert cnt.tolist() == [2, 1, 0, 2, 1] and int(total.item()) == 6
    jskey, jperm, jnv = jj.build_prepare_fast(jr, 0)
    jprobe, _jt = jj.probe_fast(jl, 0, jskey, jperm, jnv, "inner")
    np.testing.assert_array_equal(cnt.numpy(), _np(jprobe[1])[:5])
    (_s, rcnt, _p, _o, _u), _t = pj.join_probe(pl, pr, [0], [0], "inner")
    assert rcnt.tolist() == cnt.tolist()


def test_matched_build_rows_accumulate():
    ri = torch.tensor([3, -1, 0, 3], dtype=torch.int32)
    m = pj.matched_build_rows(ri, 5)
    assert m.tolist() == [True, False, False, True, False]
    pj.matched_build_rows(torch.tensor([1], dtype=torch.int32), 5, out=m)
    assert m.tolist() == [True, True, False, True, False]
    want = jj.matched_build_rows(jnp.asarray([3, 0, 0, 3]),
                                 jnp.asarray([True, False, True, True]), 5)
    assert _np(want).tolist() == [True, False, False, True, False]


@pytest.mark.parametrize("jt", ["inner", "left", "semi", "anti"])
def test_join_search_on_cpu_is_the_plain_version(jt):
    """On a CPU tensor the search takes the plain ranges, adds the output
    counts to the running total and counts no kernel launch."""
    rng = np.random.default_rng(_seed("search", jt))
    skey = torch.from_numpy(np.sort(rng.integers(0, 40, 60)).astype(np.int64))
    lkey = torch.from_numpy(rng.integers(-5, 45, 200).astype(np.int64))
    lvalid = torch.from_numpy(rng.random(200) >= 0.1)
    nv = torch.tensor([50], dtype=torch.int32)
    total = torch.full((1,), 7, dtype=torch.int64)
    before = pj.join_search.launches
    got = pj.join_search(lkey, lvalid, skey, nv, jt, total)
    want = pj._ranges_plain(lkey, skey, nv, lvalid, jt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(total.item()) == 7 + int(want[2].sum())
    assert pj.join_search.launches == before


def test_batch_total_past_int32_raises():
    arrays = (torch.zeros(1, dtype=torch.int32),) * 4 + (None,)
    with pytest.raises(ValueError, match="int32"):
        pj.join_indices_from_probe(1, arrays, "inner", 2 ** 31)


def test_join_wrappers_do_not_fall_back(monkeypatch):
    """Off the CPU a join wrapper launches its kernel or raises."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel")

    monkeypatch.setattr(native, "lib", no_kernel)
    meta = torch.device("meta")
    i32 = torch.zeros(4, dtype=torch.int32, device=meta)
    col = pj._ids_col(i32)
    batch = PBatch([col], 4, PT.Schema([PT.StructField("k", col.dtype)]),
                   meta)
    with pytest.raises(RuntimeError, match="no join_probe kernel"):
        pj.probe_fast(batch, 0, i32, i32, i32[:1], "inner")
    with pytest.raises(RuntimeError, match="no join_expand kernel"):
        pj.join_indices_from_probe(4, (i32, i32, i32, i32, None), "inner",
                                   4)
    with pytest.raises(RuntimeError, match="no join_expand kernel"):
        pj.matched_build_rows(i32, 4)
    with pytest.raises(RuntimeError, match="no join_probe kernel"):
        pj.join_search(i32, None, i32, None, "inner",
                       torch.zeros(1, dtype=torch.int64, device=meta))
    with pytest.raises(RuntimeError, match="no sort kernel"):
        pj.join_probe(batch, batch, [0], [0], "inner")


@pytest.mark.parametrize("jt", pj.JOIN_TYPES)
def test_join_total_matches_jax(jt):
    (jl, pl), (jr, pr) = _sides(_seed("total", jt), 120, 80)
    k = [] if jt == "cross" else [3, 1]
    assert pj.join_total(pl, pr, k, k, jt) == \
        int(_np(jj.join_total(jl, jr, k, k, jt)))
