"""K2 compact, K3 gather and concat of the PyTorch/CUDA port, held against
the JAX package on the same inputs.

Inputs are made with numpy from a seed, loaded into a JAX ColumnBatch, and
the JAX batch's leaves (trimmed to num_rows) become the port's batch via
``ColumnBatch.from_leaves`` -- both packages see bit-identical data.  On
the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are checked by the ``cuda``-marked tests and by
chip_smoke.py on the card.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu.ops import kernels as jk
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.columnar.column import torch_dtype
from spark_rapids_tpu_torch.ops import kernels as pk
from spark_rapids_tpu_torch.ops import native

CPU = torch.device("cpu")


def _record_batch(rng, n: int) -> pa.RecordBatch:
    """Every fixed-width type of the slice plus strings, with nulls."""
    def nulls(p=0.15):
        return rng.random(n) < p

    words = np.array(["", "a", "ab", "abc", "hello", "zz", "héllo",
                      "a\x00", "longer string here"], dtype=object)
    s = words[rng.integers(0, len(words), n)]
    return pa.RecordBatch.from_arrays([
        pa.array(rng.integers(-5, 5, n).astype(np.int32), mask=nulls()),
        pa.array(rng.integers(-2**40, 2**40, n), mask=nulls()),
        pa.array(rng.choice([-1.5, -0.0, 0.0, 2.5, np.nan], n),
                 mask=nulls()),
        pa.array(rng.integers(0, 20000, n).astype(np.int32),
                 type=pa.int32(), mask=nulls()).cast(pa.date32()),
        pa.array(list(s), type=pa.string(), mask=nulls()),
        pa.array(rng.random(n) < 0.5, mask=nulls()),
        pa.array(rng.integers(-100, 100, n).astype(np.int16), mask=nulls()),
    ], names=["i", "l", "d", "dt", "s", "b", "h"])


def _pair(rb):
    """(JAX batch, port batch) over the same leaves."""
    jb = JBatch.from_arrow(rb)
    n = int(jax.device_get(jb.num_rows))
    leaves = jax.device_get([(c.data, c.validity, c.lengths)
                             for c in jb.columns])
    return jb, PBatch.from_leaves(rb.schema, leaves, n, CPU)


def _jax_cols(cols, n):
    out = []
    for c in jax.device_get([(c.data, c.validity, c.lengths)
                             for c in cols]):
        out.append(tuple(None if a is None else np.asarray(a)[:n]
                         for a in c))
    return out


def _assert_same(pcols, jcols, n):
    for p, (jd, jv, jl) in zip(pcols, _jax_cols(jcols, n)):
        np.testing.assert_array_equal(p.validity.numpy(), jv)
        np.testing.assert_array_equal(p.data.numpy(), jd)
        if jl is None:
            assert p.lengths is None
        else:
            np.testing.assert_array_equal(p.lengths.numpy(), jl)


@pytest.mark.parametrize("n,p_keep", [(1, 1.0), (37, 0.5), (700, 0.9),
                                      (700, 0.0), (1500, 0.02)])
def test_compact_matches_jax(n, p_keep):
    rng = np.random.default_rng(n * 7 + int(p_keep * 10))
    jb, pb = _pair(_record_batch(rng, n))
    keep = rng.random(n) < p_keep
    before = pk.compact.launches
    got = pk.compact(pb, torch.from_numpy(keep))
    assert pk.compact.launches == before  # CPU tensor: plain version
    kp = np.zeros(jb.capacity, dtype=bool)
    kp[:n] = keep
    want = jk.compact(jb, jnp.asarray(kp))
    m = int(jax.device_get(want.num_rows))
    assert got.num_rows == m == int(keep.sum())
    _assert_same(got.columns, want.columns, m)


@pytest.mark.parametrize("n,m", [(50, 50), (300, 1000), (9, 0)])
def test_gather_columns_matches_jax(n, m):
    rng = np.random.default_rng(n + m)
    jb, pb = _pair(_record_batch(rng, n))
    perm = rng.integers(0, n, m).astype(np.int32)
    got = pk.gather_columns(pb.columns, torch.from_numpy(perm))
    want = jk.gather_columns(jb.columns, jnp.asarray(perm),
                             jnp.asarray(m, jnp.int32))
    _assert_same(got, want, m)
    taken = pk.take(pb, torch.from_numpy(perm))
    assert taken.num_rows == m
    _assert_same(taken.columns, want, m)


def test_gather_negative_index_is_null():
    rng = np.random.default_rng(3)
    _jb, pb = _pair(_record_batch(rng, 20))
    out = pk.gather_columns(pb.columns, torch.tensor([-1, 0, -1],
                                                     dtype=torch.int32))
    for c in out:
        assert not bool(c.validity[0]) and not bool(c.validity[2])
        assert not c.data[0].any() and not c.data[2].any()


def test_concat_matches_jax():
    rng = np.random.default_rng(11)
    rbs = [_record_batch(rng, n) for n in (13, 1, 40)]
    pairs = [_pair(rb) for rb in rbs]
    got = pk.concat_batches([p for _j, p in pairs])
    want = jk.concat_batches([j for j, _p in pairs])
    n = int(jax.device_get(want.num_rows))
    assert got.num_rows == n == 54
    _assert_same(got.columns, want.columns, n)


def test_slice_rows_views():
    rng = np.random.default_rng(5)
    _jb, pb = _pair(_record_batch(rng, 30))
    s = pk.slice_rows(pb, 5, 12)
    assert s.num_rows == 7
    assert torch.equal(s.columns[1].data, pb.columns[1].data[5:12])
    assert pk.slice_batch(pb, 100).num_rows == 30


def test_arrow_round_trip_every_type():
    rng = np.random.default_rng(17)
    rb = _record_batch(rng, 64)
    pb = PBatch.from_arrow(rb, CPU)
    back = pb.to_arrow()
    assert back.schema.equals(rb.schema)
    for a, b in zip(back.columns, rb.columns):
        assert a.to_pylist() == b.to_pylist() or all(
            (x == y) or (x != x and y != y)
            for x, y in zip(a.to_pylist(), b.to_pylist()))
    # the same leaves the JAX package builds
    _jb, from_jax = _pair(rb)
    for p, q in zip(pb.columns, from_jax.columns):
        assert torch.equal(p.validity, q.validity)
        assert p.data.numpy().tobytes() == q.data.numpy().tobytes()


def _fixed_width_case(case: str) -> pa.Array:
    """Strings of one length, as CSV dates are: with nulls, with empty
    strings, sliced (a non-zero offset), and with a null slot that still
    owns bytes in the data buffer (so the rows are not back to back)."""
    rng = np.random.default_rng(len(case))
    words = [f"{m:02d}/01/{y}" for m, y in zip(rng.integers(1, 13, 300),
                                               rng.integers(1990, 2040, 300))]
    if case == "plain":
        return pa.array(words)
    if case == "nulls":
        return pa.array(words, mask=rng.random(300) < 0.2)
    if case == "empty":
        return pa.array([w if i % 7 else "" for i, w in enumerate(words)])
    if case == "sliced":
        return pa.array(words, mask=rng.random(300) < 0.2).slice(37, 200)
    if case == "sliced_all_empty":
        # the selected rows are "" or null, the data buffer is not empty
        return pa.array(words[:50] + [""] * 40 + [None] * 10 + words[:50]) \
            .slice(50, 50)
    full = pa.array(words)  # "null_owns_bytes": clear validity bits only
    valid = np.ones(300, bool)
    valid[::5] = False
    return pa.Array.from_buffers(
        pa.string(), 300, [pa.py_buffer(np.packbits(valid,
                                                    bitorder="little")),
                           *full.buffers()[1:]], null_count=60)


@pytest.mark.parametrize("case", ["plain", "nulls", "empty", "sliced",
                                  "sliced_all_empty", "null_owns_bytes"])
def test_fixed_width_strings_match_jax(case):
    """The scan's fixed-width fast path (one reshape of strings stored
    back to back) and the general gather it leaves to lay out the
    reference's byte matrix (zero tail, zero null rows) and lengths."""
    rb = pa.RecordBatch.from_arrays([_fixed_width_case(case)], names=["s"])
    _jb, from_jax = _pair(rb)
    got = PBatch.from_arrow(rb, CPU).columns[0]
    want = from_jax.columns[0]
    assert torch.equal(got.validity, want.validity)
    assert torch.equal(got.lengths, want.lengths)
    assert torch.equal(got.data, want.data)
    assert got.data.shape[1] == (4 if case == "sliced_all_empty" else 16)


def test_types_cover_the_reference_surface():
    from spark_rapids_tpu import types as JT
    assert [t.name for t in PT.all_types()] == \
        [t.name for t in JT.all_types()]
    for t in PT.all_types():
        if t.np_dtype is not None:
            assert torch_dtype(t) == torch.from_numpy(
                np.zeros(1, t.np_dtype)).dtype


def test_wrappers_do_not_fall_back(monkeypatch):
    """A tensor off the CPU goes to the kernel path, which raises when the
    kernel cannot be had -- never the plain version."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel")

    monkeypatch.setattr(native, "lib", no_kernel)
    meta = torch.device("meta")
    batch = PBatch([], 4, PT.Schema([]), meta)
    with pytest.raises(RuntimeError, match="no compact kernel"):
        pk.compact(batch, torch.ones(4, dtype=torch.bool, device=meta))
    with pytest.raises(RuntimeError, match="no gather kernel"):
        pk.gather_columns([], torch.zeros(2, dtype=torch.int32,
                                          device=meta))


def test_tile_size_matches_cuda_source():
    src = (Path(native.CSRC) / "common.cuh").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    items = int(re.search(r"kItems = (\d+);", src).group(1))
    assert threads * items == pk.TILE


def test_every_kernel_source_has_signatures():
    for name, src in native.SOURCES.items():
        text = (Path(native.CSRC) / src).read_text()
        for fn in native._SIGNATURES[name]:
            assert re.search(rf"\bint {fn}\(", text), (name, fn)
        assert "sm_90a" in " ".join(native.NVCC_FLAGS)
