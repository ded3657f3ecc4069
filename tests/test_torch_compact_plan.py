"""The host side of K2 (the filter's compaction) of the PyTorch/CUDA port,
on the CPU.

On the card a compaction is two launches of ``csrc/compact.cu``: the count
(``srt_compact_count``: each tile ranks its kept rows once -- a thread's 16
consecutive flags, a warp scan, the warps' counts -- and writes their list
in rank order, takes its offset by the ticketed decoupled look-back, and
the last tile writes the total that the wrapper reads once) and the copy
over every column (``srt_compact_copy``: the column table of
``ops/kernels.py`` by value; a block a tile and a group of its columns
copies each column from the tile's list).  Here numpy executes both as the
kernels' blocks would,
on CPU memory by address, standing in for the library under
``_compact_cuda`` itself.  The result must equal the plain version, which
must equal the JAX package's ``compact``; every output element is written
once, and the look-back status is left zero.
"""
import ctypes
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
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.ops import kernels as pk
from spark_rapids_tpu_torch.ops import native

CPU = torch.device("cpu")
TILE, ITEMS = pk.TILE, 16
THREADS = TILE // ITEMS
SPLIT_TILES = 2 * 132
COL_WORDS = pk.GATHER_COL_WORDS


def _mem(addr: int, count: int, dtype) -> np.ndarray:
    """A writable numpy view of ``count`` items at host address ``addr``."""
    dt = np.dtype(dtype)
    if count == 0:
        return np.zeros(0, dt)
    raw = np.ctypeslib.as_array(
        ctypes.cast(addr, ctypes.POINTER(ctypes.c_uint8)),
        shape=(count * dt.itemsize,))
    return raw.view(dt)


class FakeCompact:
    """The K2 entry points of csrc/compact.cu, executed in numpy."""

    def __init__(self):
        self.calls = []
        self.writes = {}

    def _count(self, addr, size, idx):
        """Counts writes of the elements ``idx`` of the output at
        ``addr`` (``size`` elements)."""
        w = self.writes.setdefault(addr, np.zeros(size, np.int64))
        w += np.bincount(np.asarray(idx, np.int64), minlength=size)

    @staticmethod
    def _thread_bits(flags, n, nt):
        """The kernels' per-thread flags: tile x thread x 16 rows."""
        pad = np.zeros(nt * TILE, bool)
        pad[:n] = flags
        return pad.reshape(nt, THREADS, ITEMS)

    def srt_compact_count(self, keep, n, tile_offsets, rows, status,
                          stream):
        self.calls.append("count")
        assert n >= 1
        nt = -(-n // TILE)
        st = _mem(status, nt + 2, np.uint64)
        assert not st.any(), "the look-back status must be zero on entry"
        bits = self._thread_bits(_mem(keep, n, np.uint8) != 0, n, nt)
        # a block's ranks: the thread's count before it in its warp (a
        # shuffle scan), the warps before it, then its own bits in order
        cnt = bits.sum(2)
        incl = cnt.reshape(nt, THREADS // 32, 32).cumsum(2)
        warp_before = np.concatenate(
            [np.zeros((nt, 1), np.int64),
             incl[:, :, -1].cumsum(1)[:, :-1]], 1)
        pos = (incl - cnt.reshape(nt, -1, 32)
               + warp_before[:, :, None]).reshape(nt, THREADS)
        rank = (pos[:, :, None] + bits.cumsum(2) - 1).reshape(nt, TILE)
        kept_rows = bits.reshape(nt, TILE)
        tile_tot = kept_rows.sum(1)
        lst = _mem(rows, nt * TILE, np.uint16)
        self.listed = np.zeros(nt * TILE, bool)
        for tile in range(nt):
            r = np.flatnonzero(kept_rows[tile])
            slots = tile * TILE + rank[tile, r]
            assert (rank[tile, r] == np.arange(r.size)).all()
            lst[slots] = r
            self.listed[slots] = True
            self._count(("rows", rows), nt * TILE, slots)
        off = _mem(tile_offsets, nt + 1, np.int32)
        agg_flag, pre_flag = np.uint64(1 << 62), np.uint64(2 << 62)
        for tile in range(nt):            # tiles in ticket order
            st[0] += np.uint64(1)
            st[2 + tile] = agg_flag | np.uint64(tile_tot[tile])
            before, j = 0, tile - 1
            while j >= 0:                 # back to the nearest prefix
                s = int(st[2 + j])
                before += s & ((1 << 62) - 1)
                if s >> 62 == 2:
                    break
                j -= 1
            st[2 + tile] = pre_flag | np.uint64(before + int(tile_tot[tile]))
            off[tile] = before
            self._count(tile_offsets, nt + 1, [tile])
            if tile == nt - 1:
                off[nt] = before + int(tile_tot[tile])
                self._count(tile_offsets, nt + 1, [nt])
            st[1] += np.uint64(1)
        assert int(st[1]) == nt
        st[:] = 0                         # the last tile done clears it
        return 0

    def srt_compact_copy(self, words, nwords, ncols, words_dev, rows, n,
                         tile_offsets, stream):
        self.calls.append("copy")
        assert ncols >= 1 and n >= 1 and nwords == COL_WORDS * ncols
        assert (words_dev is not None) == (nwords > pk.COMPACT_PARAM_WORDS)
        tab = [int(x) for x in _mem(words_dev or words, nwords, np.int64)]
        nt = -(-n // TILE)
        groups = ncols if nt < SPLIT_TILES else 1
        assert nt * groups >= 1 and (groups == 1 or groups == ncols)
        toff = _mem(tile_offsets, nt + 1, np.int32).astype(np.int64)
        m = int(toff[nt])
        lst = _mem(rows, nt * TILE, np.uint16).astype(np.int64)
        # a block reads its tile's list: output row toff[tile] + q is the
        # tile's q-th kept row
        kept = np.diff(toff)
        tiles = np.repeat(np.arange(nt), kept)
        q = np.arange(m) - np.repeat(toff[:nt], kept)
        slot = tiles * TILE + q
        assert self.listed[slot].all(), "a list entry read but not written"
        src_rows = tiles * TILE + lst[slot]
        out = np.arange(m)
        assert src_rows.max(initial=-1) < n
        for j in range(ncols):
            c = tab[COL_WORDS * j:COL_WORDS * (j + 1)]
            rb, vec = c[6] & 0xFFFFFFFF, (c[6] >> 32) & 0xFF
            assert c[6] >> 40 == 0, "a compaction source has rows"
            assert vec == pk.vec_bytes(rb, c[0], c[1])
            assert (c[4] == 0) == (c[5] == 0)
            valid = _mem(c[2], n, np.uint8)[src_rows] != 0
            dv = _mem(c[3], m, np.uint8)
            dv[out] = valid
            self._count(c[3], m, out)
            if c[5]:
                dl = _mem(c[5], m, np.int32)
                dl[out] = np.where(valid, _mem(c[4], n, np.int32)[src_rows],
                                   0)
                self._count(c[5], m, out)
            src = _mem(c[0], n * rb, np.uint8).reshape(n, rb)
            dst = _mem(c[1], m * rb, np.uint8).reshape(m, rb)
            # one load a row, or the chunk path: vec-byte chunks, each once
            dst[out] = np.where(valid[:, None], src[src_rows], 0)
            chunks = (out[:, None] * (rb // vec)
                      + np.arange(rb // vec)[None, :]).reshape(-1)
            self._count(c[1], m * (rb // vec), chunks)
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeCompact()
    monkeypatch.setattr(native, "lib", lambda name: lib)
    monkeypatch.setattr(native, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(pk, "_STATUS", {})
    return lib


def _record_batch(rng, n: int) -> pa.RecordBatch:
    """int8-int64, bool, date, double (NaN, -0.0) and two string columns
    (a narrow one, one load a row, and a wide one, the chunk path), with
    nulls."""
    def nulls(p=0.15):
        return rng.random(n) < p

    narrow = np.array(["", "a", "ab", "abc", "z"], dtype=object)
    wide = np.array(["", "a", "héllo", "a\x00", "longer string here",
                     "x" * 29], dtype=object)
    return pa.RecordBatch.from_arrays([
        pa.array(rng.integers(-100, 100, n).astype(np.int8), mask=nulls()),
        pa.array(rng.integers(-3000, 3000, n).astype(np.int16),
                 mask=nulls()),
        pa.array(rng.integers(-5, 5, n).astype(np.int32), mask=nulls()),
        pa.array(rng.integers(-2**40, 2**40, n), mask=nulls()),
        pa.array(rng.random(n) < 0.5, mask=nulls()),
        pa.array(rng.integers(0, 20000, n).astype(np.int32),
                 mask=nulls()).cast(pa.date32()),
        pa.array(rng.choice([-1.5, -0.0, 0.0, 2.5, np.nan], n),
                 mask=nulls()),
        pa.array(list(narrow[rng.integers(0, len(narrow), n)]),
                 type=pa.string(), mask=nulls()),
        pa.array(list(wide[rng.integers(0, len(wide), n)]),
                 type=pa.string(), mask=nulls()),
    ], names=["b8", "h", "i", "l", "b", "dt", "d", "s4", "s"])


def _pair(rb):
    """(JAX batch, port batch) over the same leaves."""
    jb = JBatch.from_arrow(rb)
    n = int(jax.device_get(jb.num_rows))
    leaves = jax.device_get([(c.data, c.validity, c.lengths)
                             for c in jb.columns])
    return jb, PBatch.from_leaves(rb.schema, leaves, n, CPU)


def _same_cols(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a.validity, b.validity)
        assert a.data.shape == b.data.shape
        if a.data.dtype.is_floating_point:
            assert torch.equal(a.data.view(torch.int64),
                               b.data.view(torch.int64))
        else:
            assert torch.equal(a.data, b.data)
        assert (a.lengths is None) == (b.lengths is None)
        if a.lengths is not None:
            assert torch.equal(a.lengths, b.lengths)


def _check(fake, jb, pb, keep, jax_too: bool):
    n = pb.num_rows
    got = pk._compact_cuda(pb, torch.from_numpy(keep))
    want = pk.compact_plain(pb, torch.from_numpy(keep))
    assert got.num_rows == want.num_rows == int(keep.sum())
    _same_cols(got.columns, want.columns)
    m = got.num_rows
    assert fake.calls == (["count", "copy"] if m else ["count"]) if n \
        else fake.calls == []
    for addr, w in fake.writes.items():
        if isinstance(addr, tuple):       # the lists: each kept row once
            assert w.max(initial=0) <= 1 and w.sum() == m
            continue
        assert (w == 1).all(), "an output element written other than once"
    assert all(not s.any() for s in pk._STATUS.values())
    if jax_too:
        kp = np.zeros(jb.capacity, dtype=bool)
        kp[:n] = keep
        jw = jk.compact(jb, jnp.asarray(kp))
        assert int(jax.device_get(jw.num_rows)) == m
        for p, c in zip(got.columns, jax.device_get(
                [(c.data, c.validity, c.lengths) for c in jw.columns])):
            np.testing.assert_array_equal(p.validity.numpy(),
                                          np.asarray(c[1])[:m])
            jd = np.asarray(c[0])[:m]
            if jd.dtype.kind == "f":
                np.testing.assert_array_equal(p.data.numpy().view(np.int64),
                                              jd.view(np.int64))
            else:
                np.testing.assert_array_equal(p.data.numpy(), jd)
            if c[2] is not None:
                np.testing.assert_array_equal(p.lengths.numpy(),
                                              np.asarray(c[2])[:m])


_SIZES = [0, 1, 4095, 4096, 4097]


@pytest.mark.parametrize("share", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("n", _SIZES)
def test_executed_plan_matches_plain_and_jax(fake, n, share):
    rng = np.random.default_rng(n * 13 + int(share * 100))
    jb, pb = _pair(_record_batch(rng, n))
    _check(fake, jb, pb, rng.random(n) < share, jax_too=True)


@pytest.mark.parametrize("share", [0.0, 0.03, 0.5, 1.0])
def test_a_batch_past_the_split_tiles(fake, share):
    """2^20 + 1 rows: 257 tiles, each block a column; the plain version
    and, at one share, the JAX package."""
    n = (1 << 20) + 1
    rng = np.random.default_rng(int(share * 100) + 1)
    rb = _record_batch(rng, n)
    jax_too = share == 0.03
    jb, pb = _pair(rb) if jax_too else (None, PBatch.from_arrow(rb, CPU))
    _check(fake, jb, pb, rng.random(n) < share, jax_too=jax_too)


def test_one_group_of_every_column_past_the_split(fake):
    """At SPLIT_TILES tiles and more, one block takes every column of a
    tile (two narrow columns: the plain version only)."""
    n = SPLIT_TILES * TILE + 5
    rng = np.random.default_rng(3)
    rb = pa.RecordBatch.from_arrays([
        pa.array(rng.integers(0, 9, n).astype(np.int8),
                 mask=rng.random(n) < 0.1),
        pa.array(rng.random(n) < 0.5)], names=["a", "b"])
    pb = PBatch.from_arrow(rb, CPU)
    _check(fake, None, pb, rng.random(n) < 0.7, jax_too=False)


def test_long_tables_take_a_device_copy(fake):
    """Past the large parameter struct the table is read from a copy."""
    ncols = pk.COMPACT_PARAM_WORDS // COL_WORDS + 1
    n = 600
    rng = np.random.default_rng(9)
    rb = pa.RecordBatch.from_arrays(
        [pa.array(rng.integers(0, 99, n).astype(np.int16),
                  mask=rng.random(n) < 0.1) for _ in range(ncols)],
        names=[f"c{i}" for i in range(ncols)])
    pb = PBatch.from_arrow(rb, CPU)
    _check(fake, None, pb, rng.random(n) < 0.4, jax_too=False)


@pytest.mark.parametrize("nv", [1, 2, 3, 5, 16, 17, 255, 256, 300])
def test_chunk_steps_cover_each_chunk_once(nv):
    """The copy's chunk loop steps a thread's (row, column) without a
    division: it must visit every chunk of the kept rows once."""
    kept = 37
    total = kept * nv
    seen = np.zeros(total, np.int64)
    drow, dcol = THREADS // nv, THREADS - (THREADS // nv) * nv
    for t in range(THREADS):
        row, col = t // nv, t - (t // nv) * nv
        for q in range(t, total, THREADS):
            assert (row, col) == divmod(q, nv)
            seen[row * nv + col] += 1
            row += drow
            col += dcol
            if col >= nv:
                col -= nv
                row += 1
    assert (seen == 1).all()


def _cuda_int(src: str, name: str, known: dict) -> int:
    m = re.search(rf"constexpr [\w ]+ {name} = ([\w *]+);", src)
    assert m, name
    return eval(m.group(1), {}, known)


def test_compact_limits_match_the_cuda_source():
    """The constants ``ops/kernels.py`` shares with csrc/compact.cu are
    the ones ``srt_compact_limits`` reports, in order (on the card the
    loader compares them)."""
    csrc = Path(native.CSRC)
    common = (csrc / "common.cuh").read_text()
    known = {}
    for name in ("kThreads", "kItems", "kTile"):
        known[name] = _cuda_int(common, name, known)
    src = (csrc / "compact.cu").read_text()
    m = re.search(r"const int64_t v\[\] = \{([^}]*)\};",
                  src[src.index("int srt_compact_limits("):])
    names = [x.strip().replace("srt::", "") for x in m.group(1).split(",")]
    for name in names:
        if name not in known:
            known[name] = _cuda_int(src, name, known)
    assert known["kItems"] == ITEMS and known["kThreads"] == THREADS
    assert native._LIMITS["compact"] == tuple(known[x] for x in names) == (
        pk.TILE, COL_WORDS, pk.COMPACT_SMALL_WORDS, pk.COMPACT_PARAM_WORDS)
    assert _cuda_int(src, "kSplitTiles", known) == SPLIT_TILES
