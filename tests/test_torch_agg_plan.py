"""The host side of K4 (the segmented aggregate) of the PyTorch/CUDA port,
on the CPU.

On the card a group-by is three launches of ``csrc/segmented.cu``: the
boundary pass over every key column (``srt_seg_bounds``: flags, tile
offsets by a decoupled look-back, the tiles that hold a flag, G and S),
the tile launch over every aggregate (``srt_seg_agg_tiles``: the jobs of
``ops/segmented.py`` ``agg_plan`` grouped by input column in the table of
``agg_table``; a tile's starts, the groups that start and end in it, and
each job's head and tail pieces) and the combine launch over every
(spanning group, job) pair (``srt_seg_agg_combine``).  Here a few lines of
numpy execute the tables on CPU tensors as the kernels' blocks would --
a tile's 256 threads of 16 consecutive rows each, a thread's carry from the
ones before it, the pieces' slots, the combine's runs, shuffle tree and
warps -- standing in for the library under ``_segment_aggregate_cuda``
itself.  The result must equal the plain version (doubles within rtol
1e-12: the kernels sum in another order), which must equal the JAX
package's ``sorted_group_by``; every slot and output is written once, and
the look-back status is left zero.
"""
import ctypes
import re
from pathlib import Path

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu.ops import segmented as jsg
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops import segmented as psg
from spark_rapids_tpu_torch.ops import window as pw

CPU = torch.device("cpu")
TILE, ITEMS = psg.SEG_TILE, psg.SEG_ITEMS
THREADS = TILE // ITEMS


def _mem(addr: int, count: int, dtype) -> np.ndarray:
    """A writable numpy view of ``count`` items at host address ``addr``."""
    dt = np.dtype(dtype)
    if count == 0:
        return np.zeros(0, dt)
    raw = np.ctypeslib.as_array(
        ctypes.cast(addr, ctypes.POINTER(ctypes.c_uint8)),
        shape=(count * dt.itemsize,))
    return raw.view(dt)


def _table(words, nwords, words_dev):
    return [int(x) for x in _mem(words_dev or words, nwords, np.int64)]


class _Counted:
    """Writes by address: every output element must be written once."""

    def __init__(self):
        self.writes = {}

    def put(self, addr, count, dtype, i, value):
        arr = _mem(addr, count, dtype)
        arr[i] = value
        key = (addr, np.dtype(dtype).itemsize)
        self.writes.setdefault(key, np.zeros(count, np.int64))[i] += 1


def _ident(op):
    return (0.0 if op in (psg.OP_SUM_F, psg.OP_MIN_F, psg.OP_MAX_F) else 0,
            0)


def _nan_less(a, b):
    return a < b or (b != b and a == a)


def _comb(op, a, b):
    """Two states (acc, count) of the kernel's accumulator ``op``."""
    if op == psg.OP_SUM_I:
        s = (a[0] + b[0] + 2 ** 63) % 2 ** 64 - 2 ** 63
        return s, a[1] + b[1]
    if op == psg.OP_SUM_F:
        return float(np.float64(a[0]) + np.float64(b[0])), a[1] + b[1]
    if op in (psg.OP_COUNT, psg.OP_COUNT_STAR):
        return 0, a[1] + b[1]
    if op in (psg.OP_FIRST, psg.OP_FIRST_NN):
        return (a[0], a[1] + b[1]) if a[1] > 0 else b
    if op in (psg.OP_LAST, psg.OP_LAST_NN):
        return (b[0], a[1] + b[1]) if b[1] > 0 else a
    if a[1] == 0:
        return b
    if b[1] == 0:
        return a
    if op == psg.OP_MIN_I:
        take = b[0] < a[0]
    elif op == psg.OP_MAX_I:
        take = b[0] > a[0]
    elif op == psg.OP_MIN_F:
        take = _nan_less(b[0], a[0])
    else:
        take = _nan_less(a[0], b[0])
    return (b[0] if take else a[0]), a[1] + b[1]


def _elig(op, valid):
    return valid or op in (psg.OP_COUNT_STAR, psg.OP_FIRST, psg.OP_LAST)


def _lift(op, x, row):
    if op in (psg.OP_FIRST, psg.OP_LAST, psg.OP_FIRST_NN, psg.OP_LAST_NN):
        return row
    if op in (psg.OP_COUNT, psg.OP_COUNT_STAR):
        return 0
    if op in (psg.OP_SUM_F, psg.OP_MIN_F, psg.OP_MAX_F):
        v = float(x)
        return 0.0 if op != psg.OP_SUM_F and v == 0.0 else v
    return int(x)


_NP = {(psg._KIND_INT, 1): np.int8, (psg._KIND_INT, 2): np.int16,
       (psg._KIND_INT, 4): np.int32, (psg._KIND_INT, 8): np.int64,
       (psg._KIND_BOOL, 1): np.int8, (psg._KIND_FLOAT, 4): np.float32,
       (psg._KIND_FLOAT, 8): np.float64}


class FakeSegmented:
    """The K4 entry points of csrc/segmented.cu, executed in numpy on CPU
    memory as the kernels' blocks do."""

    def __init__(self):
        self.calls = []
        self.out = _Counted()
        self.slot_writes = None

    # -- srt_seg_bounds ---------------------------------------------------
    def srt_seg_bounds(self, words, nwords, ncols, words_dev, first, flags,
                       tile_offsets, span_tiles, status, n, stream):
        self.calls.append("bounds")
        assert nwords == psg.KEY_WORDS * ncols and n >= 1
        assert (words_dev is not None) == (nwords > psg.KEY_PARAM_WORDS)
        tab = _table(words, nwords, words_dev)
        diff = np.zeros(n, bool)
        for c in range(ncols):
            data, valid, lens, kw = tab[4 * c:4 * c + 4]
            kind, item = kw & 0xFF, kw >> 8
            if kind == psg._KIND_FLAG:
                diff |= _mem(data, n, np.uint8) != 0
                continue
            v = _mem(valid, n, np.uint8) != 0
            if kind == psg._KIND_STRING:
                m = _mem(data, n * item, np.uint8).reshape(n, item)
                ln = _mem(lens, n, np.int32)
                d = np.zeros(n, bool)
                d[1:] = (m[1:] != m[:-1]).any(1) | (ln[1:] != ln[:-1])
            else:
                x = _mem(data, n, _NP[(kind, item)])
                d = np.zeros(n, bool)
                if kind == psg._KIND_FLOAT:
                    d[1:] = (x[1:] != x[:-1]) & ~(np.isnan(x[1:])
                                                  & np.isnan(x[:-1]))
                else:
                    d[1:] = x[1:] != x[:-1]
            vp = np.roll(v, 1)
            diff[1:] |= ((v != vp) | (v & vp & d))[1:]
        f = diff.astype(np.uint8)
        f[0] = first
        out = _mem(flags, n, np.uint8)
        out[:] = f
        if tile_offsets is None:
            return 0
        nt = -(-n // TILE)
        st = _mem(status, nt + 2, np.int64)
        assert not st.any(), "the look-back status must be zero on entry"
        counts = np.add.reduceat(f.astype(np.int64), np.arange(0, n, TILE))
        off = _mem(tile_offsets, nt + 2, np.int32)
        off[:nt] = np.cumsum(counts) - counts
        off[nt] = counts.sum()
        full = np.flatnonzero(counts)
        off[nt + 1] = full.size
        _mem(span_tiles, nt, np.int32)[:full.size] = full
        return 0

    # -- the aggregate's table ---------------------------------------------
    @staticmethod
    def _parse(tab, ncols, njobs, nouts):
        cols = [tab[4 * c:4 * c + 4] for c in range(ncols)]
        jbase = 4 * ncols
        jobs = [tab[jbase + 2 * j:jbase + 2 * j + 2] for j in range(njobs)]
        obase = jbase + 2 * njobs
        outs = [tab[obase + 3 * o:obase + 3 * o + 3] for o in range(nouts)]
        return cols, jobs, outs

    def _finish(self, outs, jw, g, s, G):
        o0, no = jw[1] & 0xFFFFFFFF, jw[1] >> 32
        acc, cnt = s
        has = cnt > 0
        for o in outs[o0:o0 + no]:
            data, valid, w = o
            mode, kind, item = w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF
            if mode == psg.OUT_COUNT:
                self.out.put(data, G, np.int64, g, cnt)
                self.out.put(valid, G, np.uint8, g, 1)
            elif mode == psg.OUT_AVG:
                self.out.put(data, G, np.float64, g,
                             acc / cnt if has else 0.0)
                self.out.put(valid, G, np.uint8, g, int(has))
            elif mode == psg.OUT_PICK:
                self.out.put(data, G, np.int32, g, acc if has else -1)
            else:
                dt = _NP[(kind, item)]
                if kind == psg._KIND_FLOAT:
                    val = acc if has else 0.0
                else:
                    val = (int(acc) + 2 ** 63) % 2 ** 64 - 2 ** 63 if has \
                        else 0
                    bits = 8 * item
                    val = (val + 2 ** (bits - 1)) % 2 ** bits - 2 ** (bits - 1)
                self.out.put(data, G, dt, g, val)
                self.out.put(valid, G, np.uint8, g, int(has))

    def _slots(self, slots, njobs, nt):
        return _mem(slots, njobs * 2 * nt * 2, np.int64).reshape(
            njobs, 2 * nt, 2)

    @staticmethod
    def _pack(op, s):
        a = s[0]
        if op in (psg.OP_SUM_F, psg.OP_MIN_F, psg.OP_MAX_F):
            a = int(np.array([a], np.float64).view(np.int64)[0])
        return a, s[1]

    @staticmethod
    def _unpack(op, a, c):
        if op in (psg.OP_SUM_F, psg.OP_MIN_F, psg.OP_MAX_F):
            return float(np.array([a], np.int64).view(np.float64)[0]), c
        return int(a), int(c)

    # -- srt_seg_agg_tiles --------------------------------------------------
    def srt_seg_agg_tiles(self, words, nwords, ncols, njobs, nouts,
                          words_dev, flags, tile_offsets, starts, slots, n,
                          G, stream):
        self.calls.append("tiles")
        assert nwords == (psg.COL_WORDS * ncols + psg.JOB_WORDS * njobs
                          + psg.OUT_WORDS * nouts)
        assert (words_dev is not None) == (nwords > psg.AGG_PARAM_WORDS)
        assert (flags is None) == (tile_offsets is None)
        tab = _table(words, nwords, words_dev)
        cols, jobs, outs = self._parse(tab, ncols, njobs, nouts)
        nt = -(-n // TILE)
        f = _mem(flags, n, np.uint8) != 0 if flags is not None else \
            np.arange(n) == 0
        offs = _mem(tile_offsets, nt + 2, np.int32) \
            if tile_offsets is not None else None
        sl = self._slots(slots, njobs, nt) if njobs else None
        self.slot_writes = np.zeros((njobs, 2 * nt), np.int64)
        for tile in range(nt):
            base = tile * TILE
            last = min(base + TILE, n) - 1
            g0 = int(offs[tile]) if offs is not None else int(tile > 0)
            tf = f[base:last + 1]
            nflags = int(tf.sum())
            for k, r in enumerate(base + np.flatnonzero(tf)):
                self.out.put(starts, G, np.int32, g0 + k, r)
            for cw in cols:
                data, valid, kw, jw0 = cw
                kind, staged, item = kw & 0xFF, (kw >> 8) & 1, kw >> 16
                v = (_mem(valid, n, np.uint8) != 0) if valid else \
                    np.ones(n, bool)
                x = _mem(data, n, _NP[(kind, item)]) if staged else None
                j0, nj = jw0 & 0xFFFFFFFF, jw0 >> 32
                for j in range(j0, j0 + nj):
                    self._tile_job(jobs, outs, j, tile, base, last, f, v, x,
                                   g0, nflags, nt, sl, G)
        return 0

    def _tile_job(self, jobs, outs, j, tile, base, last, f, v, x, g0,
                  nflags, nt, sl, G):
        op = jobs[j][0]
        ident = _ident(op)

        def row(r, s):
            if _elig(op, v[r]):
                return _comb(op, s, (_lift(op, None if x is None else x[r],
                                           r), 1))
            return s

        def slot(i, s):
            sl[j, i] = self._pack(op, s)
            self.slot_writes[j, i] += 1
        # each thread's state after its last flag, then its carry: the
        # segmented scan over the threads before it
        tails, flagged = [], []
        for t in range(THREADS):
            s = ident
            rows = range(base + ITEMS * t, min(base + ITEMS * (t + 1),
                                               last + 1))
            for r in rows:
                if f[r]:
                    s = ident
                s = row(r, s)
            tails.append(s)
            flagged.append(any(f[r] for r in rows))
        carry, acc = [], ident
        for t in range(THREADS):
            carry.append(acc)
            acc = tails[t] if flagged[t] else _comb(op, acc, tails[t])
        L = -1
        for t in range(THREADS):
            run = carry[t]
            for r in range(base + ITEMS * t, min(base + ITEMS * (t + 1),
                                                 last + 1)):
                if f[r]:
                    if L < 0:
                        slot(2 * tile, run)
                    else:
                        self._finish(outs, jobs[j], g0 + L, run, G)
                    L += 1
                    run = ident
                run = row(r, run)
                if r == last:
                    if L < 0:
                        slot(2 * tile, run)
                        slot(2 * tile + 1, ident)
                    elif tile == nt - 1:
                        self._finish(outs, jobs[j], g0 + L, run, G)
                    else:
                        slot(2 * tile + 1, run)
        assert L == nflags - 1

    # -- srt_seg_agg_combine ------------------------------------------------
    def srt_seg_agg_combine(self, words, nwords, ncols, njobs, nouts,
                            words_dev, tile_offsets, span_tiles, nspans,
                            starts, slots, n, G, threads, stream):
        self.calls.append("combine")
        assert threads in (32, 256) and nspans >= 1
        tab = _table(words, nwords, words_dev)
        _cols, jobs, outs = self._parse(tab, ncols, njobs, nouts)
        nt = -(-n // TILE)
        spans = _mem(span_tiles, nt, np.int32) if span_tiles else None
        offs = _mem(tile_offsets, nt + 2, np.int32) if tile_offsets \
            else None
        st = _mem(starts, G, np.int32)
        sl = self._slots(slots, njobs, nt)
        for s in range(nspans):
            a = int(spans[s]) if spans is not None else 0
            if a >= nt - 1:
                continue
            g = (int(offs[a + 1]) if offs is not None else 1) - 1
            b = int(st[g + 1]) // TILE if g + 1 < G else nt - 1
            lo, hi = 2 * a + 1, 2 * b + 1
            for j in range(njobs):
                op = jobs[j][0]
                assert (self.slot_writes[j, lo:hi] == 1).all()
                pieces = [self._unpack(op, *sl[j, i]) for i in range(lo, hi)]
                chunk = -(-len(pieces) // threads)
                part = []
                for t in range(threads):
                    acc = _ident(op)
                    for p in pieces[t * chunk:(t + 1) * chunk]:
                        acc = _comb(op, acc, p)
                    part.append(acc)
                for w0 in range(0, threads, 32):  # each warp's ordered tree
                    off = 1
                    while off < 32:
                        for lane in range(0, 32, 2 * off):
                            part[w0 + lane] = _comb(op, part[w0 + lane],
                                                    part[w0 + lane + off])
                        off *= 2
                acc = part[0]
                for w0 in range(32, threads, 32):
                    acc = _comb(op, acc, part[w0])
                self._finish(outs, jobs[j], g, acc, G)
        return 0

    # -- K4s, executed by its plain formulation ---------------------------
    def srt_seg_string_minmax(self, is_max, data, lens, valid, w, flags, n,
                              tile_offsets, starts, G, slots, out_idx,
                              stream):
        self.calls.append("string")
        m = _mem(data, n * w, np.uint8).reshape(n, w)
        ln = _mem(lens, n, np.int32)
        v = _mem(valid, n, np.uint8) != 0
        st = list(_mem(starts, G, np.int32)) + [n]
        out = _mem(out_idx, G, np.int32)
        for g in range(G):
            best = -1
            for r in range(st[g], st[g + 1]):
                if not v[r]:
                    continue
                key = (bytes(m[r]), ln[r])
                if best < 0 or (key > bkey if is_max else key < bkey):
                    best, bkey = r, key
            out[g] = best
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeSegmented()
    monkeypatch.setattr(native, "lib", lambda name: lib)
    monkeypatch.setattr(native, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(psg, "_STATUS", {})
    return lib


# value columns: 2 l:int64  3 d:double  4 dt:date  5 b:bool  6 t:string
# 7 i:int32 (small, for wrapping sums kept exact in int64)
_OPS = [("sum", 2), ("sum", 3), ("sum", 7), ("avg", 3), ("avg", 7),
        ("sum", 3), ("avg", 3), ("count", 3), ("count", 6), ("count", 2),
        ("count_star", 0), ("min", 2), ("max", 2), ("min", 3), ("max", 3),
        ("min", 4), ("max", 4), ("min", 5), ("max", 5), ("min", 6),
        ("max", 6), ("first", 3), ("last", 3), ("first_non_null", 3),
        ("last_non_null", 3), ("first", 6), ("last_non_null", 6),
        ("count", 5), ("sum", 2)]


def _record_batch(rng, n: int, key_groups: int = 4) -> pa.RecordBatch:
    def nulls(p=0.12):
        return rng.random(n) < p

    keys = np.array(["x", "y", "", "zz", "w", "v"][:key_groups],
                    dtype=object)
    text = np.array(["", "a", "ab", "b", "abc", "zzz"], dtype=object)
    kd = rng.choice([-0.0, 0.0, 1.5, np.nan], n)
    return pa.RecordBatch.from_arrays([
        pa.array(list(keys[rng.integers(0, len(keys), n)]),
                 type=pa.string(), mask=nulls(0.05)),
        pa.array(kd, mask=nulls(0.05)),
        pa.array(rng.integers(-10**12, 10**12, n), mask=nulls()),
        pa.array(rng.choice([-1.25, -0.0, 0.0, 3.5, np.nan, 1e300, -7.0],
                            n) * rng.random(n), mask=nulls()),
        pa.array(rng.integers(0, 40000, n).astype(np.int32),
                 mask=nulls()).cast(pa.date32()),
        pa.array(rng.random(n) < 0.5, mask=nulls()),
        pa.array(list(text[rng.integers(0, len(text), n)]), type=pa.string(),
                 mask=nulls()),
        pa.array(rng.integers(-1000, 1000, n).astype(np.int32),
                 mask=nulls()),
    ], names=["k", "kd", "l", "d", "dt", "b", "t", "i"])


def _same(got, want, what):
    np.testing.assert_array_equal(got.validity.numpy(), want.validity.numpy(),
                                  err_msg=what)
    a, b = got.data.numpy(), want.data.numpy()
    if a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0.0,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)
    if want.lengths is not None:
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      want.lengths.numpy(), err_msg=what)


def _check(fake, rb, keys, ops, jax_too=True):
    """The executed tables against the plain version, and the plain
    version against the JAX package; returns the group count."""
    specs = [psg.AggSpec(o, c) for o, c in ops]
    pb = PBatch.from_arrow(rb, CPU)
    sb = psg.sort_batch(pb, [psg.SortOrder(i, True, True) for i in keys]) \
        if keys else pb
    gk, ga, g = psg._segment_aggregate_cuda(sb, keys, specs)
    wk, wa, wg = psg.segment_aggregate_plain(sb, keys, specs)
    assert g == wg
    for i, (a, b) in enumerate(zip(gk + ga, wk + wa)):
        _same(a, b, f"output {i} of {ops} by {keys}")
    for key, count in fake.out.writes.items():
        assert (count == 1).all(), f"an output at {key} written {count}"
    if fake.slot_writes is not None:
        # every slot at most once (the last tile's tail is never needed);
        # the combine checks that each slot it reads was written
        assert (fake.slot_writes <= 1).all()
    assert all(not s.any() for s in psg._STATUS.values())
    if jax_too:
        jb = JBatch.from_arrow(rb)
        jout = jsg.sorted_group_by(jb, keys, [jsg.AggSpec(o, c)
                                              for o, c in ops])
        assert int(jax.device_get(jout.num_rows)) == g
        jcols = jax.device_get([(c.data, c.validity, c.lengths)
                                for c in jout.columns])
        for i, (p, (jd, jv, jl)) in enumerate(zip(wk + wa, jcols)):
            np.testing.assert_array_equal(p.validity.numpy(),
                                          np.asarray(jv)[:g])
            pd = p.data.numpy()
            if pd.dtype.kind == "f":
                np.testing.assert_allclose(pd, np.asarray(jd)[:g],
                                           rtol=1e-12, equal_nan=True)
            else:
                np.testing.assert_array_equal(pd, np.asarray(jd)[:g])
            if jl is not None:
                np.testing.assert_array_equal(p.lengths.numpy(),
                                              np.asarray(jl)[:g])
    return g


@pytest.mark.parametrize("n", [1, 2, 97, 4097, 13_001])
@pytest.mark.parametrize("keys", [[0, 1], [1], []],
                         ids=["str+f64", "f64", "grand"])
def test_executed_tables_match_plain_and_jax(fake, n, keys):
    """Every op of _AGG_OPS but the percentile (its own test below), with
    duplicates, an avg beside a sum of its column and counts riding on
    other jobs; NaN, -0.0 and null keys and values; one row, one group
    across 3+ tiles (13,001 rows in a grand aggregate or in few key
    groups)."""
    rng = np.random.default_rng(n + 7 * len(keys))
    g = _check(fake, _record_batch(rng, n), keys, _OPS)
    # string min/max (K4s) needs the flags even in a grand aggregate
    assert fake.calls[:3] == ["bounds", "tiles", "combine"]
    assert g >= 1


@pytest.mark.parametrize("n", [1, 4096, 13_001])
def test_grand_aggregate_needs_no_boundary_pass(fake, n):
    """Without keys and string min/max the tile launch takes row 0 as the
    only flag: two launches."""
    rng = np.random.default_rng(n)
    ops = [o for o in _OPS if not (o[0] in ("min", "max") and o[1] == 6)]
    _check(fake, _record_batch(rng, n), [], ops)
    assert fake.calls == ["tiles", "combine"]


def test_one_row_segments_and_tile_edges(fake):
    """Keys that change on every row (one-row groups), then runs that end
    exactly on the tile boundaries (a group's start at a tile's first
    row: the head of that tile is empty)."""
    n = 3 * TILE + 5
    key = np.arange(n) // TILE
    rng = np.random.default_rng(3)
    x = rng.random(n) + 0.5  # no cancellation: the sums' order is free
    for k in (np.arange(n), key, np.minimum(key, 1)):
        rb = pa.RecordBatch.from_arrays(
            [pa.array(k.astype(np.int64)), pa.array(x,
                                                    mask=rng.random(n) < .1)],
            names=["k", "x"])
        _check(fake, rb, [0], [("sum", 1), ("count", 1), ("max", 1),
                               ("first_non_null", 1), ("count_star", 0)])


def test_zero_rows_and_empty_groups(fake):
    rng = np.random.default_rng(5)
    rb = _record_batch(rng, 0)
    for keys in ([0], []):
        _check(fake, rb, keys, [("sum", 3), ("count_star", 0), ("max", 6),
                                ("first", 2)])
    assert fake.calls == []  # no rows: no launch


def test_plan_deduplicates_jobs_and_outputs():
    """q1's 11 timed specs: 4 double sums (sum and its avg's sum twice),
    3 counts on those sums' jobs, count_star: 5 jobs, 8 outputs; an avg
    over an integer column keeps its own double job beside the int64
    sum."""
    rng = np.random.default_rng(1)
    sb = PBatch.from_arrow(_record_batch(rng, 50), CPU)
    specs = [psg.AggSpec(o, c) for o, c in [
        ("sum", 3), ("sum", 3), ("count", 3), ("avg", 3), ("sum", 2),
        ("avg", 2), ("count", 2), ("count_star", 0), ("count", 6),
        ("min", 6), ("first", 6)]]
    plan = psg.agg_plan(sb, specs)
    ops = [op for _c, op in plan.jobs]
    assert ops.count(psg.OP_SUM_F) == 2 and ops.count(psg.OP_SUM_I) == 1
    assert plan.spec_out[0] == plan.spec_out[1]
    assert plan.spec_out[9] is None  # string min: K4s
    # jobs grouped by column, outputs by job
    assert [c for c, _op in plan.jobs] == sorted(c for c, _op in plan.jobs)
    assert [o[0] for o in plan.outs] == sorted(o[0] for o in plan.outs)
    # count(t) rides on first(t)? no: first counts every row; its own job
    t_pos = plan.cols.index(6)
    assert (t_pos, psg.OP_COUNT) in plan.jobs
    # count(d) rides on the sum of d
    d_pos = plan.cols.index(3)
    cnt = plan.outs[plan.spec_out[2]]
    assert plan.jobs[cnt[0]] == (d_pos, psg.OP_SUM_F)


def test_long_tables_take_a_device_copy(fake):
    """More than the parameters hold: 33 keys (the boundary pass's
    table past 128 words) and ~170 columns x 4 jobs (the aggregate's past
    4000 words) go as device copies."""
    rng = np.random.default_rng(9)
    n = 300
    arrays = [pa.array(rng.integers(0, 2, n)) for _ in range(33)]
    arrays += [pa.array(rng.integers(-50, 50, n).astype(np.int32),
                        mask=rng.random(n) < 0.1) for _ in range(170)]
    rb = pa.RecordBatch.from_arrays(arrays,
                                    names=[f"c{i}" for i in range(203)])
    ops = [(o, c) for c in range(33, 203)
           for o in ("sum", "min", "max", "avg")]
    _check(fake, rb, list(range(33)), ops, jax_too=False)


@pytest.mark.parametrize("keys", [[1], []])
def test_percentile_counts_from_the_tile_launch(fake, keys):
    """A percentile's valid counts are a count job (riding on a sum of the
    same column); K4p (plain on the CPU) picks from the starts."""
    rng = np.random.default_rng(11)
    n = 5000
    rb = pa.RecordBatch.from_arrays([
        pa.array(rng.integers(0, 3, n)),
        pa.array(rng.integers(0, 7, n)),
        pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.2)],
        names=["k", "g", "x"])
    specs = [psg.AggSpec("percentile", 2, 0.5), psg.AggSpec("sum", 2),
             psg.AggSpec("percentile", 2, 0.9)]
    pb = PBatch.from_arrow(rb, CPU)
    order = [psg.SortOrder(i, True, True) for i in keys] + \
        [psg.SortOrder(2, True, False)]
    sb = psg.sort_batch(pb, order)
    gk, ga, g = psg._segment_aggregate_cuda(sb, keys, specs)
    wk, wa, wg = psg.segment_aggregate_plain(sb, keys, specs)
    assert g == wg
    for a, b in zip(gk + ga, wk + wa):
        _same(a, b, "percentile")


def test_window_flags_are_one_boundary_pass(fake):
    """The window's partition and order flags: one launch over all the
    keys each (row 0's flag 1 and 0), equal to the plain flags; with the
    tile offsets, as K4s's own pass over given flags."""
    rng = np.random.default_rng(12)
    rb = _record_batch(rng, 9000)
    pb = PBatch.from_arrow(rb, CPU)
    sb = psg.sort_batch(pb, [psg.SortOrder(i, True, True) for i in (0, 1)])
    want_part, want_order = pw._boundary_flags(sb, [0, 1], [3, 6])
    before = psg._segment_flags.launches
    part = psg._segment_flags([sb.columns[0], sb.columns[1]], sb.num_rows,
                              CPU, first=1)[0]
    order, offs, spans = psg._segment_flags([sb.columns[3], sb.columns[6]],
                                            sb.num_rows, CPU, first=0,
                                            offsets=True)
    assert psg._segment_flags.launches == before + 2
    np.testing.assert_array_equal(part.numpy(), want_part.numpy())
    np.testing.assert_array_equal(order.numpy(), want_order.numpy())
    f = part.numpy()
    flags, offs, spans = psg._segment_flags([part], sb.num_rows, CPU,
                                            offsets=True)
    np.testing.assert_array_equal(flags.numpy(), f)
    nt = -(-sb.num_rows // TILE)
    counts = [int(f[t * TILE:(t + 1) * TILE].sum()) for t in range(nt)]
    assert offs[:nt].tolist() == list(np.cumsum(counts) - counts)
    assert offs[nt:].tolist() == [sum(counts), sum(c > 0 for c in counts)]


def _cuda_int(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def test_segmented_limits_match_the_cuda_source():
    """The constants ``ops/segmented.py`` shares with csrc/segmented.cu are
    the ones ``srt_segmented_limits`` reports, in order."""
    csrc = Path(native.CSRC)
    common = (csrc / "common.cuh").read_text()
    src = (csrc / "segmented.cu").read_text()
    threads, items = _cuda_int(common, "kThreads"), _cuda_int(common,
                                                               "kItems")
    m = re.search(r"const int64_t v\[\] = \{([^}]*)\};",
                  src[src.index("srt_segmented_limits"):])
    names = [x.strip() for x in m.group(1).split(",")]
    known = {"kTile": threads * items, "kItems": items}
    for name in names:
        if name not in known:
            known[name] = _cuda_int(src, name)
    assert native._LIMITS["segmented"] == tuple(known[x] for x in names)
