"""The host side of K3 (the row gather) of the PyTorch/CUDA port, on the
CPU.

On the card ``gather_columns`` is one launch a call over every column:
``ops/kernels.py`` ``gather_table`` lists, for each column, its source and
output leaves, its row bytes, the widest load that divides the row and
both data addresses, and whether the source has rows; the kernel
(``csrc/gather.cu``) gives a thread ``GATHER_RUN`` output rows, 32 apart,
of a tile of ``GATHER_TILE`` and, where a row is one load wide, gathers
its rows column by column, else copies the tile's rows in chunks of that
load.  Here a few lines of numpy execute the table on the CPU
tensors' bytes as the kernel's threads do, and the outputs must equal the
plain version's, which must equal the JAX package's, with every output
byte written exactly once.
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
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import kernels as pk
from spark_rapids_tpu_torch.ops import native

CPU = torch.device("cpu")
THREADS = pk.GATHER_TILE // pk.GATHER_RUN


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.numpy().reshape(-1).view(np.uint8)


def _execute(words, leaves, perm: np.ndarray):
    """Run the gather table as csrc/gather.cu does: ``leaves`` maps each
    address in the table to its tensor.  Returns how often each output
    byte was written, by address."""
    m = len(perm)
    W = pk.GATHER_COL_WORDS
    writes = {}

    def out(addr):
        buf = _bytes(leaves[addr])
        if addr not in writes:
            writes[addr] = np.zeros(buf.size, np.int64)
        return buf, writes[addr]

    def put(addr, at, data):
        buf, count = out(addr)
        buf[at:at + len(data)] = data
        count[at:at + len(data)] += 1

    ntiles = -(-m // pk.GATHER_TILE)
    for tile in range(ntiles):
        t0 = tile * pk.GATHER_TILE
        nrows = min(pk.GATHER_TILE, m - t0)
        for j in range(len(words) // W):
            c = words[W * j:W * j + W]
            rb, vec, empty = c[6] & 0xFFFFFFFF, (c[6] >> 32) & 0xFF, \
                (c[6] >> 40) & 1
            assert rb % vec == 0 and vec in (1, 2, 4, 8, 16)
            src_row = np.full(pk.GATHER_TILE, -1, np.int64)
            for t in range(THREADS):  # each thread's rows, 32 apart
                warp, lane = divmod(t, 32)
                for k in range(pk.GATHER_RUN):
                    r = t0 + warp * 32 * pk.GATHER_RUN + lane + 32 * k
                    if r >= m:
                        continue
                    s = int(perm[r])
                    ok = s >= 0 and not empty and \
                        _bytes(leaves[c[2]])[s] != 0
                    put(c[3], r, np.array([ok], np.uint8))
                    if c[5]:
                        ln = leaves[c[4]][s].numpy().astype(np.int32) \
                            if ok else np.int32(0)
                        put(c[5], 4 * r,
                            np.array([ln], np.int32).view(np.uint8))
                    if rb == vec:
                        row = _bytes(leaves[c[0]])[s * rb:(s + 1) * rb] \
                            if ok else np.zeros(rb, np.uint8)
                        put(c[1], r * rb, row)
                    src_row[r - t0] = s if ok else -1
            if rb == vec:
                continue
            nv = rb // vec  # the chunk path: rows and columns stepped
            drow, dcol = THREADS // nv, THREADS % nv
            src = _bytes(leaves[c[0]]) if not empty else None
            for t in range(THREADS):
                row, col = t // nv, t % nv
                for q in range(t, nrows * nv, THREADS):
                    s = src_row[row]
                    at = (s * nv + col) * vec
                    chunk = src[at:at + vec] if s >= 0 \
                        else np.zeros(vec, np.uint8)
                    put(c[1], (t0 * nv + q) * vec, chunk)
                    row, col = row + drow, col + dcol
                    if col >= nv:
                        row, col = row + 1, col - nv
    return writes


def _cols(rng, n: int, widths, offset: bool = False):
    """Fixed-width columns of every item size and bool, strings of each W
    in ``widths`` (NUL tails, nulls), an int64 array column; ``offset``
    slices one row off each string matrix, so that its address is W bytes
    past an allocation (misaligned for most W)."""
    valid = lambda: torch.from_numpy(rng.random(n + 1) < 0.85)  # noqa
    cols = []
    for dt, tt in ((np.int8, T.ByteType()), (np.int16, T.ShortType()),
                   (np.int32, T.IntegerType()), (np.int64, T.LongType()),
                   (np.float32, T.FloatType()), (np.float64, T.DoubleType())):
        v = valid()[1:]
        x = torch.from_numpy(rng.integers(-100, 100, n).astype(dt))
        zero = torch.zeros((), dtype=x.dtype)
        cols.append(DeviceColumn(torch.where(v, x, zero), v, tt))
    v = valid()[1:]
    cols.append(DeviceColumn(torch.from_numpy(rng.random(n) < 0.5) & v, v,
                             T.BooleanType()))
    for w in widths:
        v = valid()
        lens = torch.from_numpy(rng.integers(0, w + 1, n + 1).astype(np.int32))
        mat = torch.from_numpy(rng.integers(0, 256, (n + 1, w))
                               .astype(np.uint8))
        mat[torch.arange(w)[None, :] >= lens[:, None]] = 0
        mat[~v] = 0
        lens = torch.where(v, lens, 0)
        lo = 1 if offset else 0
        hi = n + 1 if offset else n
        cols.append(DeviceColumn(mat[lo:hi], v[lo:hi], T.StringType(),
                                 lens[lo:hi]))
    v = valid()[1:]
    lens = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32))
    arr = torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, (n, 3)))
    arr[torch.arange(3)[None, :] >= lens[:, None]] = 0
    arr[~v] = 0
    cols.append(DeviceColumn(arr, v, T.ArrayType(T.LongType()),
                             torch.where(v, lens, 0)))
    return cols


def _check_table(cols, perm: np.ndarray):
    """Execute the table of ``cols`` gathered by ``perm`` and hold it to
    the plain version; returns the table."""
    m = len(perm)
    srcs = [pk._contig(c) for c in cols]
    outs = [pk._empty_like_rows(c, m) for c in cols]
    for o in outs:  # bytes the table fails to write show as garbage
        for t in (o.data, o.validity, o.lengths):
            if t is not None:
                _bytes(t)[:] = 0xA5
    words = pk.gather_table(srcs, outs)
    assert len(words) == pk.GATHER_COL_WORDS * len(cols)
    leaves = {}
    for c in srcs + outs:
        for t in (c.data, c.validity, c.lengths):
            if t is not None and t.numel():
                leaves[t.data_ptr()] = t
    writes = _execute(words, leaves, perm)
    want = pk.gather_plain(cols, torch.from_numpy(perm))
    for o, w in zip(outs, want):
        for a, b in ((o.data, w.data), (o.validity, w.validity),
                     (o.lengths, w.lengths)):
            if a is None:
                assert b is None
                continue
            np.testing.assert_array_equal(_bytes(a), _bytes(b))
            if m:
                np.testing.assert_array_equal(writes[a.data_ptr()], 1)
    return words


_WIDTHS = [1, 2, 3, 4, 5, 7, 8, 12, 13, 16, 17, 31, 32, 33, 64]


@pytest.mark.parametrize("n,m,offset", [(300, 1, False), (300, 7, True),
                                        (600, 2048, False),
                                        (600, 2100, True)])
def test_gather_table_executes_like_the_plain_version(n, m, offset):
    """1/2/4/8-byte, float and bool columns, strings at W 1-64 (most not
    a multiple of 16; a row-offset slice makes them misaligned) and an
    int64 array column, under indices with negatives, over 1 or 2 tiles
    and partial runs: every output byte written once, equal to
    ``gather_plain``."""
    rng = np.random.default_rng(n + m)
    cols = _cols(rng, n, _WIDTHS, offset)
    perm = rng.integers(-2, n, m).astype(np.int32)
    words = _check_table(cols, perm)
    vecs = {(w & 0xFFFFFFFF, (w >> 32) & 0xFF)
            for w in words[6::pk.GATHER_COL_WORDS]}
    # one-load rows (fixed width, W 1/2/4/8/16 aligned) and chunked rows
    assert any(rb == v for rb, v in vecs) and any(rb != v for rb, v in vecs)
    assert (16, 16) in vecs or offset


def test_gather_table_long_tables_and_empty_sources():
    """More columns than the kernel's parameters hold (its table is then
    read from a device copy), a source without rows under all-negative
    indices, and the 0-row perm, which launches nothing."""
    rng = np.random.default_rng(5)
    base = _cols(rng, 40, [4, 13])
    cols = (base * (pk.GATHER_PARAM_WORDS // pk.GATHER_COL_WORDS
                    // len(base) + 1))
    words = _check_table(cols, rng.integers(-1, 40, 37).astype(np.int32))
    assert len(words) > pk.GATHER_PARAM_WORDS
    assert pk.GATHER_SMALL_WORDS < pk.GATHER_PARAM_WORDS
    empty = [DeviceColumn(c.data[:0], c.validity[:0], c.dtype,
                          None if c.lengths is None else c.lengths[:0])
             for c in base]
    words = _check_table(empty, np.full(9, -1, np.int32))
    assert all((w >> 40) & 1 for w in words[6::pk.GATHER_COL_WORDS])
    out = pk.gather_columns(base, torch.empty(0, dtype=torch.int32))
    assert [o.capacity for o in out] == [0] * len(base)


def test_vec_bytes():
    assert pk.vec_bytes(16, 0, 32) == 16
    assert pk.vec_bytes(13, 0, 32) == 1
    assert pk.vec_bytes(12, 0, 32) == 4
    assert pk.vec_bytes(32, 8, 32) == 8
    assert pk.vec_bytes(64, 16, 48) == 16
    assert pk.vec_bytes(6, 2, 0) == 2


def _cuda_int(src: str, name: str, known: dict) -> int:
    m = re.search(rf"constexpr [\w ]+ {name} = ([\w *]+);", src)
    assert m, name
    return eval(m.group(1), {}, known)


def test_gather_limits_match_the_cuda_source():
    """The constants ``ops/kernels.py`` shares with csrc/gather.cu are the
    ones ``srt_gather_limits`` reports, in order (on the card the loader
    compares them)."""
    csrc = Path(native.CSRC)
    known = {"kThreads": _cuda_int((csrc / "common.cuh").read_text(),
                                   "kThreads", {})}
    src = (csrc / "gather.cu").read_text()
    assert re.search(r"\bint srt_gather_limits\(", src)
    for name in ("kGatherColWords", "kRun", "kGatherTile",
                 "kGatherSmallWords", "kGatherLargeWords"):
        known[name] = _cuda_int(src, name, known)
    want = (known["kGatherColWords"], known["kGatherTile"], known["kRun"],
            known["kGatherSmallWords"], known["kGatherLargeWords"])
    assert native._LIMITS["gather"] == want == (
        pk.GATHER_COL_WORDS, pk.GATHER_TILE, pk.GATHER_RUN,
        pk.GATHER_SMALL_WORDS, pk.GATHER_PARAM_WORDS)


def _record_batch(rng, n: int) -> pa.RecordBatch:
    def nulls():
        return rng.random(n) < 0.2

    words = np.array(["", "a", "abc", "a\x00", "héllo", "x" * 29],
                     dtype=object)
    return pa.RecordBatch.from_arrays([
        pa.array(rng.integers(-100, 100, n).astype(np.int8), mask=nulls()),
        pa.array(rng.integers(-2 ** 40, 2 ** 40, n), mask=nulls()),
        pa.array(rng.choice([-1.5, -0.0, np.nan, np.inf], n)
                 .astype(np.float32), mask=nulls()),
        pa.array(rng.random(n) < 0.5, mask=nulls()),
        pa.array(list(words[rng.integers(0, len(words), n)]),
                 type=pa.string(), mask=nulls()),
    ], names=["b", "l", "f", "z", "s"])


@pytest.mark.parametrize("n,m", [(1, 3), (97, 0), (500, 2049)])
def test_gather_plain_matches_jax_with_negative_indices(n, m):
    """The plain version against the JAX package's gather (its index
    clamped at 0 where the port's is negative, those rows then null with
    zero data and length), int8/int64/f32/bool/strings with nulls, a
    0-row perm included."""
    rng = np.random.default_rng(n * 31 + m)
    rb = _record_batch(rng, n)
    jb = JBatch.from_arrow(rb)
    leaves = jax.device_get([(c.data, c.validity, c.lengths)
                             for c in jb.columns])
    pb = PBatch.from_leaves(rb.schema, leaves, n, CPU)
    perm = rng.integers(-3, n, m).astype(np.int32)
    neg = perm < 0
    got = pk.gather_plain(pb.columns, torch.from_numpy(perm))
    want = jk.gather_columns(jb.columns, jnp.asarray(np.maximum(perm, 0)),
                             jnp.asarray(m, jnp.int32))
    for p, j in zip(got, jax.device_get([(c.data, c.validity, c.lengths)
                                         for c in want])):
        jd, jv, jl = (None if a is None else np.asarray(a)[:m].copy()
                      for a in j)
        jv[neg] = False
        jd[neg] = 0
        np.testing.assert_array_equal(p.validity.numpy(), jv)
        np.testing.assert_array_equal(p.data.numpy(), jd)
        if jl is None:
            assert p.lengths is None
        else:
            jl[neg] = 0
            np.testing.assert_array_equal(p.lengths.numpy(), jl)
