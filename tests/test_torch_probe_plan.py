"""The host side of K5 (the join probe) and of K7's expansion over its
offsets, of the PyTorch/CUDA port, on the CPU.

On the card a build side is prepared once (K1's sort, then
``srt_join_build_keys``: the sorted keys with nulls rewritten to the dtype
max, nv, and the search layout -- a static tree over the sorted keys whose
nodes are one 32-byte sector, level j every F^j-th key, up to the first
level that fits the kernel's shared memory), and each stream batch is one
``srt_join_search`` launch: tiles of stream rows in ticket order; per row
the staged level searched in shared memory, one sector a level below it,
the leaf sector of the sorted keys, a gallop where a key's run leaves the
sector; the
clipped range, the join type's count, and the tile's exclusive offsets of
the counts from the decoupled look-back, with the int64 total written by
the last tile.  K7's ``srt_join_expand`` (the full-outer tail in the
same launch) then reads those offsets instead of K7's own scan.  Here
numpy executes the layout, the searches and the look-back as the
kernels' blocks would, on CPU memory by address, standing in for the
libraries under ``_build_prepare_cuda``,
``_search_cuda`` and ``_indices_cuda``.  The results must equal the plain
versions and the JAX package's ``build_prepare_fast``/``probe_fast``/
``join_probe``; every output is written once, the look-back status is left
zero, and the offsets equal the exclusive sum of the counts.
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
from spark_rapids_tpu.ops import join as jj
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.ops import join as pj
from spark_rapids_tpu_torch.ops import native

CPU = torch.device("cpu")
TILE, ITEMS = pj.PROBE_TILE, 16
THREADS = TILE // ITEMS
JT_CODES = {"inner": 0, "left": 1, "full": 1, "semi": 2, "anti": 3}
_NP = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def _mem(addr, count: int, dtype) -> np.ndarray:
    """A writable numpy view of ``count`` items at host address ``addr``."""
    dt = np.dtype(dtype)
    if count == 0 or not addr:
        return np.zeros(0, dt)
    raw = np.ctypeslib.as_array(
        ctypes.cast(addr, ctypes.POINTER(ctypes.c_uint8)),
        shape=(count * dt.itemsize,))
    return raw.view(dt)


def _bounds(a, length: int, x, upper: bool):
    """The kernel's ``bounds``: uniform steps over a[0, length)."""
    out = np.zeros(x.shape, np.int64)
    while length > 1:
        half = length >> 1
        v = a[out + half]
        out += np.where(~(x < v) if upper else (v < x), half, 0)
        length -= half
    if length == 1:
        v = a[out]
        out += (~(x < v) if upper else (v < x)).astype(np.int64)
    return out


class FakeProbe:
    """The K5 and K7 entry points, executed in numpy."""

    def __init__(self):
        self.calls = []
        self.writes = {}
        self.padding = {}
        self.levels_seen = []

    def _count(self, addr, size, idx):
        w = self.writes.setdefault(addr, np.zeros(size, np.int64))
        w += np.bincount(np.asarray(idx, np.int64).reshape(-1),
                         minlength=size)

    # -- K5 ----------------------------------------------------------------
    def srt_join_build_keys(self, key, valid, perm, n, item, skey, nv,
                            levels, k, stream):
        self.calls.append("build")
        dt = _NP[item]
        kk, sizes, offs, length = pj.search_levels(n, item)
        assert k == kk and (levels is not None) == (length > 0)
        if n <= 0:
            return 0
        r = _mem(perm, n, np.int32).astype(np.int64) if perm \
            else np.arange(n)
        v = _mem(valid, n, np.uint8)[r] != 0 if valid \
            else np.ones(n, bool)
        x = np.where(v, _mem(key, n, dt)[r], np.iinfo(dt).max).astype(dt)
        if skey:
            _mem(skey, n, dt)[:] = x
            self._count(skey, n, np.arange(n))
        if nv:
            assert valid and perm
            last = np.flatnonzero(v & ~np.append(v[1:], False))
            assert last.size <= 1 and not v[last[0] + 1:].any() \
                if last.size else True
            if last.size:
                _mem(nv, 1, np.int32)[0] = last[0] + 1
                self._count(nv, 1, [0])
        f = pj.NODE_BYTES // item
        lv = _mem(levels, length, dt)
        pad = np.ones(length, bool)
        for j in range(1, k + 1):
            idx = np.arange(sizes[j]) * f ** j
            lv[offs[j]:offs[j] + sizes[j]] = x[idx]
            self._count(levels, length, offs[j] + np.arange(sizes[j]))
            pad[offs[j]:offs[j] + sizes[j]] = False
        if length:
            self.padding[levels] = pad  # a level's tail to a whole node
        return 0

    def _tree(self, x, skey, nb, lv, k, dt, sizes, offs):
        """The kernel's ``tree_search``: [lo, hi) of every row."""
        f = pj.NODE_BYTES // np.dtype(dt).itemsize
        stage = skey if k == 0 else lv[offs[k]:offs[k] + sizes[k]]
        assert stage.size * np.dtype(dt).itemsize <= pj.STAGE_BYTES
        b = _bounds(stage, sizes[k], x, False)
        if k == 0:
            return b, _bounds(stage, nb, x, True)
        b = np.maximum(b - 1, 0)
        q = np.arange(f)
        for j in range(k - 1, 0, -1):
            level = lv[offs[j]:offs[j] + -(-sizes[j] // f) * f]
            idx = f * b[:, None] + q
            node = level[np.minimum(idx, level.size - 1)]
            c = ((idx < sizes[j]) & (node < x[:, None])).sum(1)
            b = f * b + np.maximum(c - 1, 0)
        p0 = f * b
        idx = p0[:, None] + q
        inside = idx < nb
        node = skey[np.minimum(idx, nb - 1)]
        c = (inside & (node < x[:, None])).sum(1)
        c2 = (inside & ~(x[:, None] < node)).sum(1)
        m = np.minimum(nb - p0, f)
        lo = p0 + c
        upper = np.searchsorted(skey, x, "right")   # what the gallop finds
        hi = np.where(c2 > c,
                      np.where((c2 < m) | (p0 + m == nb), p0 + c2, upper),
                      lo)
        nxt = (c2 == c) & (c == m) & (lo < nb)
        hi = np.where(nxt & ~(x < skey[np.minimum(lo, nb - 1)]), upper, hi)
        return lo, hi

    def srt_join_search(self, lkey, lvalid, n, skey, nb, nv, levels, k,
                        item, jt, start, cnt, out_cnt, offsets, total,
                        add_total, status, stream):
        self.calls.append("search")
        assert n >= 1
        dt = _NP[item]
        x = _mem(lkey, n, dt)
        sk = _mem(skey, nb, dt)
        kk, sizes, offs, length = pj.search_levels(nb, item)
        assert k == kk and (levels is not None) == (k > 0)
        self.levels_seen.append(k)
        lo, hi = self._tree(x, sk, nb, _mem(levels, length, dt), k, dt,
                            sizes, offs)
        nvv = int(_mem(nv, 1, np.int32)[0]) if nv else nb
        e = np.minimum(hi, nvv)
        s = np.minimum(lo, e)
        ok = _mem(lvalid, n, np.uint8) != 0 if lvalid else np.ones(n, bool)
        c = np.where(ok, e - s, 0).astype(np.int64)
        o = {0: c, 1: np.maximum(c, 1), 2: (c > 0).astype(np.int64),
             3: (c == 0).astype(np.int64)}[jt]
        rows = np.arange(n)
        if start:
            _mem(start, n, np.int32)[:] = s
            self._count(start, n, rows)
        if cnt:
            _mem(cnt, n, np.int32)[:] = c
            self._count(cnt, n, rows)
        _mem(out_cnt, n, np.int32)[:] = o
        self._count(out_cnt, n, rows)
        # the tiles: a thread's 16 consecutive counts, the warps' scans,
        # the look-back in ticket order; offsets wrap as int32
        nt = -(-n // TILE)
        st = _mem(status, nt + 2, np.uint64)
        assert not st.any(), "the look-back status must be zero on entry"
        pad = np.zeros(nt * TILE, np.int64)
        pad[:n] = o
        per = pad.reshape(nt, THREADS, ITEMS)
        incl = per.sum(2).reshape(nt, THREADS // 32, 32).cumsum(2)
        warp_before = np.concatenate(
            [np.zeros((nt, 1), np.int64),
             incl[:, :, -1].cumsum(1)[:, :-1]], 1)
        thread_before = (incl - per.sum(2).reshape(nt, -1, 32)
                         + warp_before[:, :, None]).reshape(nt, THREADS)
        local = thread_before[:, :, None] + per.cumsum(2) - per
        agg = per.sum((1, 2))
        before = np.concatenate([[0], np.cumsum(agg)[:-1]])
        off = _mem(offsets, n + 1, np.int32)
        off[:n] = ((before[:, None, None] + local).reshape(-1)[:n]
                   .astype(np.uint64).astype(np.uint32).view(np.int32))
        whole = int(before[-1] + agg[-1])
        off[n] = np.int64(whole).astype(np.uint32).view(np.int32)
        self._count(offsets, n + 1, np.arange(n + 1))
        t = _mem(total, 1, np.int64)
        t[0] = (t[0] + whole) if add_total else whole
        return 0

    # -- K7 ----------------------------------------------------------------
    def srt_join_offsets(self, v, n, status, out, stream):
        self.calls.append("offsets")
        c = _mem(v, n, np.int32).astype(np.int64)
        o = _mem(out, n + 1, np.int32)
        o[:n] = np.cumsum(c) - c
        o[n] = c.sum()
        return 0

    def srt_join_expand(self, offsets, cl, cnt, start, rperm, m,
                        take_right, unmatched, uoff, cr, li, ri, stream):
        """The expansion and, given the unmatched build rows, the
        full-outer tail: one launch (the blocks' walk is executed in
        tests/test_torch_expand_plan.py)."""
        self.calls.append("expand")
        off = _mem(offsets, cl + 1, np.int32).astype(np.int64)
        j = np.arange(min(m, int(off[cl])))
        row = np.searchsorted(off[:cl], j, "right") - 1
        k = j - off[row]
        _mem(li, m, np.int32)[j] = row
        self._count(li, m, j)
        if take_right:
            cn = _mem(cnt, cl, np.int32)[row]
            st = _mem(start, cl, np.int32)[row].astype(np.int64)
            hit = k < cn
            rp = _mem(rperm, int((st + k)[hit].max(initial=-1)) + 1,
                      np.int32)
            rv = np.full(j.size, -1, np.int64)
            rv[hit] = rp[(st + k)[hit]]
        else:
            rv = np.full(j.size, -1)
        _mem(ri, m, np.int32)[j] = rv
        self._count(ri, m, j)
        if unmatched:
            u = _mem(unmatched, cr, np.int32) != 0
            base = int(off[cl])
            slot = base + _mem(uoff, cr, np.int32)[u].astype(np.int64)
            _mem(li, m, np.int32)[slot] = -1
            _mem(ri, m, np.int32)[slot] = np.flatnonzero(u)
            self._count(li, m, slot)
            self._count(ri, m, slot)
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeProbe()
    monkeypatch.setattr(native, "lib", lambda name: lib)
    monkeypatch.setattr(native, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(pj, "_STATUS", {})
    return lib


def _side(rng, n: int, pool: int, dtype, null_p: float = 0.08,
          dups: int = 0) -> pa.RecordBatch:
    """One integral key with nulls and the dtype max as a genuine key;
    ``dups`` rows of the key 7 (a key with that many matches)."""
    k = rng.integers(0, pool, n).astype(dtype)
    k[rng.random(n) < 0.03] = np.iinfo(dtype).max
    k[rng.choice(n, min(dups, n), replace=False)] = 7
    return pa.RecordBatch.from_arrays(
        [pa.array(k, mask=rng.random(n) < null_p)], names=["k"])


def _pair(rb):
    jb = JBatch.from_arrow(rb)
    n = int(jax.device_get(jb.num_rows))
    leaves = jax.device_get([(c.data, c.validity, c.lengths)
                             for c in jb.columns])
    return jb, PBatch.from_leaves(rb.schema, leaves, n, CPU)


def _eq(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None, (what, i)
        else:
            assert torch.equal(a.to(b.dtype), b), (what, i)


def _written_once(fake):
    for addr, w in fake.writes.items():
        pad = fake.padding.get(addr, np.zeros(w.size, bool))
        assert (w[~pad] == 1).all() and not w[pad].any(), \
            "an output element written other than once"
    fake.writes.clear()
    fake.padding.clear()


def _probe_both(fake, pl, pr, jt, jax_sides=None):
    """The executed K5/K7 against the plain versions (and the JAX
    package's, given its sides): returns the probe's total."""
    col = pr.columns[0]
    prep = pj._build_prepare_cuda(col)
    want_prep = pj.build_prepare_fast_plain(pr, 0)
    _eq(prep, want_prep, "build")
    assert isinstance(prep, pj.PreparedBuild) and prep.layout.k == \
        pj.search_levels(col.capacity, col.data.element_size())[0]
    _written_once(fake)
    lcol = pl.columns[0]
    start, cnt, out_cnt, offsets, total = pj._search_cuda(
        lcol.data, lcol.validity, prep[0], prep[2], jt, None, True,
        prep.layout)
    _written_once(fake)
    arrays = pj.ProbeArrays((start, cnt, prep[1], out_cnt, None), offsets)
    want, wtotal = pj.probe_fast_plain(pl, 0, *want_prep, jt)
    _eq(tuple(arrays) + (total,), tuple(want) + (wtotal,), f"probe {jt}")
    oc = out_cnt.to(torch.int64)
    assert offsets.tolist() == [0] + torch.cumsum(oc, 0).tolist()
    assert all(not s.any() for s in pj._STATUS.values())
    n = int(total.item())
    calls = len(fake.calls)
    li_ri = pj._indices_cuda(pl.num_rows, arrays, jt, n)
    assert "offsets" not in fake.calls[calls:], "K7 scanned on a K5 path"
    _eq(li_ri, pj.join_indices_plain(pl.num_rows, want, jt, n),
        f"indices {jt}")
    _written_once(fake)
    if jax_sides is not None:
        jl, jr = jax_sides
        jskey, jperm, jnv = jj.build_prepare_fast(jr, 0)
        nr = pr.num_rows
        assert int(prep[2].item()) == int(jax.device_get(jnv))
        np.testing.assert_array_equal(prep[0].numpy(),
                                      np.asarray(jskey)[:nr])
        np.testing.assert_array_equal(prep[1].numpy(),
                                      np.asarray(jperm)[:nr])
        jprobe, jtotal = jj.probe_fast(jl, 0, jskey, jperm, jnv, jt)
        nl = pl.num_rows
        assert int(jax.device_get(jtotal)) == n
        for p, j in zip((start, cnt, out_cnt), (jprobe[0], jprobe[1],
                                                jprobe[3])):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j)[:nl])
    return n


@pytest.mark.parametrize("jt", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64])
def test_every_join_type_and_key_width_match_plain_and_jax(fake, dtype,
                                                           jt):
    rng = np.random.default_rng(np.dtype(dtype).itemsize * 10
                                + JT_CODES[jt])
    pool = 90 if dtype == np.int8 else 3000
    jl, pl = _pair(_side(rng, 5000, pool, dtype))
    jr, pr = _pair(_side(rng, 2500, pool, dtype, dups=40))
    assert _probe_both(fake, pl, pr, jt, (jl, jr)) > 0


def _level_edges(item: int):
    """Build sizes on both sides of each level boundary of the layout."""
    f, cap = pj.NODE_BYTES // item, pj.STAGE_BYTES // item
    return [cap, cap + 1, cap * f, cap * f + 1]


@pytest.mark.parametrize("item,nb", [(i, nb) for i in (1, 2, 4, 8)
                                     for nb in _level_edges(i)])
def test_build_sizes_at_every_layout_level(fake, item, nb):
    """The staged level and each level below it: k 0 at the stage's
    capacity, 1 past it, 2 past F times it; stream rows over 2 tiles."""
    dtype = _NP[item]
    rng = np.random.default_rng(nb + item)
    hi = min(np.iinfo(dtype).max, 4 * nb)
    keys = np.sort(rng.integers(np.iinfo(dtype).min, hi, nb)).astype(dtype)
    rb = pa.RecordBatch.from_arrays(
        [pa.array(rng.permutation(keys), mask=rng.random(nb) < 0.01)],
        names=["k"])
    pr = PBatch.from_arrow(rb, CPU)
    probe = np.concatenate([rng.choice(keys, 5000),
                            rng.integers(np.iinfo(dtype).min, hi, 3193)]
                           ).astype(dtype)
    pl = PBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array(probe, mask=rng.random(probe.size) < 0.04)], names=["k"]),
        CPU)
    # start and cnt are checked for every row; semi and anti keep the
    # expansion to a row a stream row (an int8 build of 2^20 keys holds
    # each value ~4,000 times)
    for jt in ("semi", "anti"):
        _probe_both(fake, pl, pr, jt)
    want_k = pj.search_levels(nb, item)[0]
    assert set(fake.levels_seen) == {want_k}
    assert want_k == (0 if nb <= pj.STAGE_BYTES // item else
                      1 if nb <= pj.STAGE_BYTES // item
                      * (pj.NODE_BYTES // item) else 2)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097])
def test_stream_tile_edges_and_a_key_of_4096_matches(fake, n):
    """Stream batches at the tile's edges against a build where one key
    matches 4096 rows (its run leaves every sector) and one key once."""
    rng = np.random.default_rng(n)
    bkeys = np.concatenate([np.full(4096, 7), np.arange(20_000, 29_000),
                            [2 ** 31 - 1]]).astype(np.int32)
    pr = PBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array(rng.permutation(bkeys))], names=["k"]), CPU)
    lk = rng.choice(np.array([7, 8, 20_001, 28_999, 2 ** 31 - 1, -5],
                             np.int32), n)
    pl = PBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array(lk, mask=rng.random(n) < 0.1)], names=["k"]), CPU)
    for jt in ("inner", "left", "semi", "anti"):
        _probe_both(fake, pl, pr, jt)


@pytest.mark.parametrize("nb", [0, 1])
def test_empty_and_one_row_builds(fake, nb):
    rng = np.random.default_rng(nb)
    pr = PBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array(np.array([7] * nb, np.int64))], names=["k"]), CPU)
    pl = PBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array(rng.integers(5, 9, 300), mask=rng.random(300) < 0.1)],
        names=["k"]), CPU)
    for jt in ("inner", "left", "semi", "anti"):
        _probe_both(fake, pl, pr, jt)


def test_all_null_build(fake):
    rng = np.random.default_rng(5)
    pr = PBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array([None] * 50, type=pa.int32())], names=["k"]), CPU)
    pl = PBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array(rng.integers(0, 9, 100).astype(np.int32))], names=["k"]),
        CPU)
    for jt in ("inner", "anti"):
        _probe_both(fake, pl, pr, jt)


@pytest.mark.parametrize("nl,nr", [(9000, 5000), (70_000, 9000),
                                   (20_000, 70_000)])
def test_rank_path_full_outer_takes_the_search_offsets(fake, nl, nr):
    """Full outer over rank ids (no validity, no nv; with the rank path's
    layout, staged whole or its levels written by a levels-only build, on
    either side): the second, anti search of the build ids adds its total
    and writes the tail's offsets; K7 reads both and scans nothing."""
    rng = np.random.default_rng(nl + nr)
    lid = rng.integers(0, nr // 8, nl).astype(np.int32)
    lid[rng.random(lid.size) < 0.05] = pj.I32MAX          # a null key
    rid = rng.integers(0, nr // 6, nr).astype(np.int32)
    rid[rng.random(rid.size) < 0.05] = pj.I32MAX - 1
    lid_t, rid_t = torch.from_numpy(lid), torch.from_numpy(rid)
    rperm = torch.from_numpy(np.argsort(rid, kind="stable").astype(np.int32))
    srid = rid_t[rperm.long()]
    slid = torch.sort(lid_t).values
    before = pj.rank_layout.launches
    lay_r, lay_l = pj.rank_layout(srid), pj.rank_layout(slid)
    assert pj.rank_layout.launches == before + sum(
        lay.k > 0 for lay in (lay_r, lay_l))
    start, cnt, out_cnt, offsets, total = pj._search_cuda(
        lid_t, None, srid, None, "full", None, True, lay_r)
    _s, _c, unmatched, uoff, total = pj._search_cuda(
        rid_t, None, slid, None, "anti", total, False, lay_l)
    assert _s is None and _c is None
    assert uoff.tolist() == [0] + torch.cumsum(
        unmatched.to(torch.int64), 0).tolist()
    _written_once(fake)
    arrays = pj.ProbeArrays((start, cnt, rperm, out_cnt, unmatched),
                            offsets, uoff)
    ws, wc, wo = pj._ranges_plain(lid_t, srid, None, None, "full")
    _u1, _u2, wu = pj._ranges_plain(rid_t, slid, None, None, "anti")
    _eq((start, cnt, out_cnt, unmatched), (ws, wc, wo, wu), "full ranges")
    n = int(total.item())
    assert n == int(wo.sum()) + int(wu.sum())
    calls = len(fake.calls)
    got = pj._indices_cuda(lid.size, arrays, "full", n)
    assert fake.calls[calls:] == ["expand"]
    _eq(got, pj.join_indices_plain(
        lid.size, (ws, wc, rperm, wo, wu), "full", n), "full indices")
    _written_once(fake)
    assert all(not s.any() for s in pj._STATUS.values())


def test_card_search_and_expansion_refuse_what_they_cannot_use(fake):
    """K5's search takes the sorted keys' layout and K7 the offsets K5
    wrote: arrays without them (the plain probe's) and a search without a
    layout raise, and nothing is launched."""
    rng = np.random.default_rng(2)
    pr = PBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array(rng.integers(0, 50, 300).astype(np.int32))], names=["k"]),
        CPU)
    pl = PBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array(rng.integers(0, 60, 700).astype(np.int32))], names=["k"]),
        CPU)
    prep = pj.build_prepare_fast_plain(pr, 0)
    arrays, total = pj.probe_fast_plain(pl, 0, *prep, "inner")
    n = int(total.item())
    with pytest.raises(ValueError, match="offsets K5's search wrote"):
        pj._indices_cuda(pl.num_rows, arrays, "inner", n)
    start, cnt, _p, out_cnt, _u = arrays
    off = torch.cat([torch.zeros(1, dtype=torch.int64),
                     torch.cumsum(out_cnt.to(torch.int64), 0)])
    full = pj.ProbeArrays((start, cnt, prep[1], out_cnt, out_cnt),
                          off.to(torch.int32))
    with pytest.raises(ValueError, match="offsets K5's search wrote"):
        pj._indices_cuda(pl.num_rows, full, "full", n)
    col = pl.columns[0]
    with pytest.raises(ValueError, match="search layout"):
        pj._search_cuda(col.data, col.validity, prep[0], prep[2], "inner",
                        None, True, None)
    assert fake.calls == []
    before = pj._offsets_cuda.launches
    got = pj._indices_cuda(pl.num_rows, pj.ProbeArrays(
        tuple(arrays), off.to(torch.int32)), "inner", n)
    assert fake.calls == ["expand"]
    assert pj._offsets_cuda.launches == before
    _eq(got, pj.join_indices_plain(pl.num_rows, arrays, "inner", n), "k7")


def test_jax_join_probe_totals_match(fake):
    """The rank path's reference: the JAX package's ``join_probe`` over
    one key gives the counts the executed search gives over the port's
    sorted keys."""
    rng = np.random.default_rng(17)
    jl, pl = _pair(_side(rng, 3000, 500, np.int32))
    jr, pr = _pair(_side(rng, 1500, 500, np.int32, dups=20))
    for jt in ("inner", "left", "semi", "anti"):
        n = _probe_both(fake, pl, pr, jt)
        jprobe, jtotal = jj.join_probe(jl, jr, [0], [0], jt)
        assert int(jax.device_get(jtotal)) == n
        np.testing.assert_array_equal(
            np.asarray(jprobe[1])[:pl.num_rows],
            pj.probe_fast_plain(pl, 0, *pj.build_prepare_fast_plain(pr, 0),
                                jt)[0][1].numpy())


def _cuda_int(src: str, name: str, known: dict) -> int:
    m = re.search(rf"constexpr [\w ]+ {name} = ([\w *]+);", src)
    assert m, name
    return eval(m.group(1), {}, known)


def test_probe_limits_match_the_cuda_source():
    """The constants ``ops/join.py`` shares with csrc/join_probe.cu are
    the ones ``srt_join_probe_limits`` reports, in order (on the card the
    loader compares them)."""
    csrc = Path(native.CSRC)
    common = (csrc / "common.cuh").read_text()
    known = {}
    for name in ("kThreads", "kItems", "kTile"):
        known[name] = _cuda_int(common, name, known)
    src = (csrc / "join_probe.cu").read_text()
    m = re.search(r"const int64_t v\[\] = \{([^}]*)\};",
                  src[src.index("int srt_join_probe_limits("):])
    names = [x.strip().replace("srt::", "") for x in m.group(1).split(",")]
    for name in names:
        if name not in known:
            known[name] = _cuda_int(src, name, known)
    assert known["kItems"] == ITEMS and known["kThreads"] == THREADS
    assert native._LIMITS["join_probe"] == tuple(known[x] for x in names) \
        == (pj.PROBE_TILE, pj.NODE_BYTES, pj.STAGE_BYTES, pj.MAX_LEVELS)
