"""The host side of K7's merge-path expansion, of the PyTorch/CUDA port,
on the CPU.

On the card ``_indices_cuda`` makes one ``srt_join_expand`` launch a call:
the stream rows' run ends (the offsets K5 wrote) merged with the output
slots, each block a share of EXPAND_THREADS x EXPAND_ITEMS merged items,
its two diagonals found by half the block each, probing 128 candidates a
step on global memory, each thread's diagonal found in the block's window
of offsets in shared memory and its items walked there, then the slots
taken in slot order (li, and ri from cnt, start and the build
permutation); blocks past the expansion's share take the full-outer tail.
``_offsets_cuda`` (K14's emit offsets) is one ``srt_join_offsets`` launch
with the decoupled look-back.  Here numpy executes those blocks and
threads on CPU memory by address, standing in for the library under the
real wrappers, against ``join_indices_plain`` and the JAX package's
``join_indices_from_probe``; every slot is written exactly once.
"""
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import join as jj
from spark_rapids_tpu_torch.ops import join as pj
from spark_rapids_tpu_torch.ops import native

NT, VT = pj.EXPAND_THREADS, pj.EXPAND_ITEMS
SHARE = NT * VT
TYPES = ["inner", "left", "semi", "anti", "full", "cross"]


def _mem(addr, count: int, dtype) -> np.ndarray:
    """A writable numpy view of ``count`` items at host address ``addr``."""
    dt = np.dtype(dtype)
    if count == 0 or not addr:
        return np.zeros(0, dt)
    raw = np.ctypeslib.as_array(
        ctypes.cast(addr, ctypes.POINTER(ctypes.c_uint8)),
        shape=(count * dt.itemsize,))
    return raw.view(dt)


def _block_split(off, cl: int, nslots: int, d: int) -> tuple:
    """The kernel's block_split for one diagonal (half the block's
    threads): (run ends among the first d merged items, dependent steps
    taken)."""
    probes = NT // 2
    lo, hi = max(0, d - nslots), min(d, cl)
    steps = 0
    lanes = np.arange(probes, dtype=np.int64)
    while lo < hi:
        step = (hi - lo + probes - 1) // probes
        at = lo + (lanes + 1) * step - 1
        valid = at < hi
        atc = np.where(valid, at, lo)
        pred = valid & (off[atc + 1].astype(np.int64) <= d - 1 - atc)
        c = int(pred.sum())
        assert pred[:c].all(), "the true probes must be a prefix"
        at_c = lo + (c + 1) * step - 1
        if c < probes and at_c < hi:
            hi = at_c
        lo = lo + c * step
        steps += 1
    return lo, steps


class FakeExpand:
    """K7's entry points, executed a block and a thread at a time."""

    def __init__(self):
        self.calls = []
        self.writes = {}
        self.max_steps = 0
        self.blocks_with_slots = []

    def _count(self, addr, size, idx):
        w = self.writes.setdefault(addr, np.zeros(size, np.int64))
        np.add.at(w, np.asarray(idx, np.int64), 1)

    def srt_join_expand(self, offsets, cl, cnt, start, rperm, m,
                        take_right, unmatched, uoff, cr, li, ri, stream):
        self.calls.append("expand")
        if m <= 0:
            return 0
        exp_blocks = -(-(cl + m) // SHARE)
        tail_blocks = -(-cr // SHARE) if unmatched else 0
        off = _mem(offsets, cl + 1, np.int32)
        out_l, out_r = _mem(li, m, np.int32), _mem(ri, m, np.int32)
        total_left = int(off[cl]) if unmatched else m
        assert total_left == int(off[cl]), "m is the expansion's total"
        items = cl + total_left
        cn = _mem(cnt, cl, np.int32)
        st = _mem(start, cl, np.int32)
        for blk in range(exp_blocks + tail_blocks):
            if blk >= exp_blocks:
                r0 = (blk - exp_blocks) * SHARE
                r = np.arange(r0, min(r0 + SHARE, cr))
                u = _mem(unmatched, cr, np.int32)[r] != 0
                slot = total_left + _mem(uoff, cr, np.int32)[r][u].astype(
                    np.int64)
                out_l[slot] = -1
                out_r[slot] = r[u]
                self._count(li, m, slot)
                self._count(ri, m, slot)
                continue
            d0 = blk * SHARE
            if d0 >= items:
                continue
            d1 = min(d0 + SHARE, items)
            (a0, s0), (a1, s1) = (_block_split(off, cl, total_left, d)
                                  for d in (d0, d1))
            self.max_steps = max(self.max_steps, s0, s1)
            b0 = d0 - a0
            na, nb = a1 - a0, d1 - a1 - b0
            if nb == 0:
                continue
            self.blocks_with_slots.append(blk)
            s_off = off[a0:a1 + 1].astype(np.int64)
            n = na + nb
            t = np.arange(NT)
            dl = np.minimum(t * VT, n)
            lo, hi = np.maximum(dl - nb, 0), np.minimum(dl, na)
            while (lo < hi).any():
                mid = (lo + hi) >> 1
                go = (lo < hi) & (s_off[np.minimum(mid + 1, na)]
                                  <= b0 + dl - 1 - mid)
                lo = np.where(go, mid + 1, lo)
                hi = np.where((lo < hi) & ~go, mid, hi)
            a, b = lo.copy(), dl - lo
            steps = np.minimum(n - dl, VT)
            s_row = np.full(nb, -9, np.int64)
            s_k = np.full(nb, -9, np.int64)
            staged = np.zeros(nb, np.int64)
            for v in range(VT):  # the walk, in shared memory only
                act = v < steps
                end = act & (a < na) & (
                    (b >= nb) | (s_off[np.minimum(a + 1, na)]
                                 <= b0 + np.minimum(b, nb)))
                slot = act & ~end
                a = a + end
                tt = np.flatnonzero(slot)
                s_row[b[tt]] = a0 + a[tt]
                s_k[b[tt]] = b0 + b[tt] - s_off[a[tt]]
                np.add.at(staged, b[tt], 1)
                b = b + slot
            assert (staged == 1).all(), "a slot staged other than once"
            # the slots in slot order
            s_li, s_ri = s_row, np.full(nb, -1, np.int64)
            if take_right:
                hit = s_k < cn[s_row]
                pos = st[s_row].astype(np.int64) + s_k
                rp = _mem(rperm, int(pos[hit].max(initial=-1)) + 1,
                          np.int32)
                s_ri[hit] = rp[pos[hit]]
            out_l[b0:b0 + nb] = s_li
            out_r[b0:b0 + nb] = s_ri
            self._count(li, m, np.arange(b0, b0 + nb))
            self._count(ri, m, np.arange(b0, b0 + nb))
        return 0

    def srt_join_offsets(self, v, n, status, out, stream):
        """One launch: tiles in ticket order, each publishing its sum
        and reading its prefix by the look-back."""
        self.calls.append("offsets")
        tile = pj.OFFSETS_TILE
        nt = max(-(-n // tile), 1)
        stt = _mem(status, nt + 2, np.uint64)
        assert not stt.any(), "the look-back status must be zero on entry"
        c = _mem(v, n, np.int32).astype(np.int64)
        o = _mem(out, n + 1, np.int32)
        sums = np.array([c[i * tile:(i + 1) * tile].sum()
                         for i in range(nt)], np.int64)
        for t in range(nt):  # tickets are handed out in tile order
            lo, hi = t * tile, min((t + 1) * tile, n)
            before = int(sums[:t].sum())
            o[lo:hi] = (before + np.cumsum(c[lo:hi]) - c[lo:hi]).astype(
                np.int32)
            if t == nt - 1:
                o[n] = np.int64(before + sums[t]).astype(np.int32)
        self._count(out, n + 1, np.arange(n + 1))
        return 0

    def srt_join_mark(self, ri, m, matched, stream):
        r = _mem(ri, m, np.int32)
        _mem(matched, int(r.max(initial=-1)) + 1, np.uint8)[r[r >= 0]] = 1
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeExpand()
    monkeypatch.setattr(native, "lib", lambda name: lib)
    monkeypatch.setattr(native, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(pj, "_SCAN_STATUS", {})
    return lib


def _arrays(rng, cl: int, cr: int, jt: str, shape: str):
    """Probe arrays with the offsets K5 writes, drawn directly (numpy):
    ``fuzz`` (60% of rows without a match, the rest 1-20), ``zeros``
    (stretches of rows without output longer than a block's share),
    ``giant`` (one row with 2^16 slots), ``unmatched`` (nothing matches;
    for full outer every build row is in the tail)."""
    if jt == "cross":
        cnt = np.full(cl, cr, np.int64)
        start = np.zeros(cl, np.int64)
        perm = np.arange(cr)
    else:
        cnt = np.where(rng.random(cl) < 0.6, 0, rng.integers(1, 21, cl))
        if shape == "zeros":
            cnt[rng.random(cl) < 0.9995] = 0
        elif shape == "giant" and cl:
            cnt[rng.integers(0, cl)] = 1 << 16
        elif shape == "unmatched":
            cnt[:] = 0
        cnt = np.minimum(cnt, cr)
        start = (rng.random(cl) * (cr - cnt + 1)).astype(np.int64)
        perm = rng.permutation(cr)
    out = {"inner": cnt, "cross": cnt, "left": np.maximum(cnt, 1),
           "full": np.maximum(cnt, 1), "semi": (cnt > 0).astype(np.int64),
           "anti": (cnt == 0).astype(np.int64)}[jt]
    unmatched = None
    if jt == "full":
        unmatched = (np.ones(cr, np.int64) if shape == "unmatched"
                     else (rng.random(cr) < 0.3).astype(np.int64))
    return start, cnt, perm, out, unmatched


def _tensors(start, cnt, perm, out, unmatched):
    def on(a):
        return torch.from_numpy(np.asarray(a, np.int32))

    def offsets(c):
        return on(np.concatenate([[0], np.cumsum(c)]))
    arrays = pj.ProbeArrays(
        (on(start), on(cnt), on(perm), on(out),
         None if unmatched is None else on(unmatched)), offsets(out),
        None if unmatched is None else offsets(unmatched))
    total = int(out.sum()) + (0 if unmatched is None
                              else int(unmatched.sum()))
    return arrays, total


def _expand_both(fake, cl, jt, raw, with_jax=False):
    arrays, total = _tensors(*raw)
    before = pj.join_indices_from_probe.launches
    calls = len(fake.calls)
    li, ri = pj._indices_cuda(cl, arrays, jt, total)
    pj.join_indices_from_probe.launches = before
    assert fake.calls[calls:] == ["expand"], "one launch a call"
    want = pj.join_indices_plain(cl, arrays, jt, total)
    assert torch.equal(li, want[0]) and torch.equal(ri, want[1]), jt
    if total:
        for addr in (li.data_ptr(), ri.data_ptr()):
            w = fake.writes.pop(addr)
            assert (w == 1).all(), "a slot written other than once"
        assert ri.data_ptr() == li.data_ptr() + 4 * total, \
            "li and ri are two views of one allocation"
    assert not fake.writes
    if with_jax and cl:
        start, cnt, perm, out, unmatched = raw
        j = jj.join_indices_from_probe(
            cl, tuple(None if a is None else jnp.asarray(a, jnp.int32)
                      for a in (start, cnt, perm, out, unmatched)),
            jt, total)
        jli, jri, ltake, rtake, jtotal = jax.device_get(j)
        assert int(jtotal) == total
        np.testing.assert_array_equal(np.where(ltake, jli, -1), li.numpy())
        np.testing.assert_array_equal(np.where(rtake, jri, -1), ri.numpy())
    return li, ri


@pytest.mark.parametrize("cl", [0, 1, 4095, 4096, 4097, (1 << 16) + 1])
@pytest.mark.parametrize("jt", TYPES)
def test_expansion_matches_plain_and_jax(fake, jt, cl):
    """Every join type, cross included, at stream sizes around the block
    share and the tiles; the JAX package's expansion too."""
    rng = np.random.default_rng(cl * 7 + TYPES.index(jt))
    cr = 3 if jt == "cross" else 900
    _expand_both(fake, cl, jt, _arrays(rng, cl, cr, jt, "fuzz"),
                 with_jax=cl <= 4097)


@pytest.mark.parametrize("jt", TYPES[:5])
def test_zero_stretches_longer_than_a_share(fake, jt):
    """Rows without output over many blocks' shares: those blocks leave
    without staging anything."""
    rng = np.random.default_rng(3 + TYPES.index(jt))
    cl = 40_000
    raw = _arrays(rng, cl, 500, jt, "zeros")
    _expand_both(fake, cl, jt, raw)
    if jt in ("inner", "semi"):
        assert len(fake.blocks_with_slots) < -(-cl // SHARE)


@pytest.mark.parametrize("jt", ["inner", "left", "full"])
def test_one_row_of_2_16_slots_spreads_over_blocks(fake, jt):
    """A stream row matching 2^16 build rows: its run crosses 32 blocks'
    shares, block edges fall inside it, and each block's search takes at
    most three 128-probe steps."""
    rng = np.random.default_rng(11)
    cl = 3000
    raw = _arrays(rng, cl, 1 << 17, jt, "giant")
    _expand_both(fake, cl, jt, raw, with_jax=True)
    assert len(fake.blocks_with_slots) >= (1 << 16) // SHARE
    assert fake.max_steps <= 3


def test_block_edges_at_a_run_end_and_inside_a_run(fake):
    """Runs sized so that block shares end exactly at a run's end, one
    item past it, and inside a run."""
    for lens in ([SHARE - 1], [SHARE - 2, 5], [1] * (SHARE // 2 - 1)
                 + [3000], [SHARE // 2 - 1] * 5):
        cnt = np.array(lens * 3, np.int64)
        cl = cnt.size
        raw = (np.zeros(cl, np.int64), cnt, np.arange(4096),
               cnt.copy(), None)
        _expand_both(fake, cl, "inner", raw)


def test_full_outer_all_build_rows_unmatched(fake):
    """Nothing matches: every stream row is one null-right slot and every
    build row a tail slot, written by the tail blocks of the same launch;
    and a stream batch of no rows (the tail alone)."""
    rng = np.random.default_rng(19)
    for cl in (5000, 0):
        raw = _arrays(rng, cl, 7000, "full", "unmatched")
        li, ri = _expand_both(fake, cl, "full", raw, with_jax=cl > 0)
        assert (li[cl:] == -1).all() and torch.equal(
            ri[cl:], torch.arange(7000, dtype=torch.int32))


def test_nothing_to_write_launches_nothing(fake):
    """A total of 0 (no slot): the entry returns without a launch."""
    raw = _arrays(np.random.default_rng(2), 300, 50, "inner", "unmatched")
    arrays, total = _tensors(*raw)
    assert total == 0
    li, ri = pj._indices_cuda(300, arrays, "inner", 0)
    assert li.numel() == ri.numel() == 0 and fake.calls == ["expand"]
    assert not fake.writes


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 3 * 4096 + 5])
def test_own_offsets_scan_one_launch(fake, n):
    """K7's own scan (K14's emit offsets): one launch, the status it
    needs, its output written once, equal to the exclusive cumsum."""
    rng = np.random.default_rng(n)
    c = torch.from_numpy(rng.integers(0, 50, n).astype(np.int32))
    before = pj._offsets_cuda.launches
    got = pj._offsets_cuda(native.lib("join_expand"), c, 0)
    assert pj._offsets_cuda.launches == before + 1
    assert fake.calls == ["offsets"]
    assert got.tolist() == [0] + torch.cumsum(c.long(), 0).tolist()
    (status,) = pj._SCAN_STATUS.values()
    assert status.numel() >= max(-(-n // pj.OFFSETS_TILE), 1) + 2
    assert (fake.writes.pop(got.data_ptr()) == 1).all()


def _cuda_int(src: str, name: str, known: dict) -> int:
    m = re.search(rf"constexpr [\w ]+ {name} = ([\w *]+);", src)
    assert m, name
    return eval(m.group(1), {}, known)


def test_expand_limits_match_the_cuda_source():
    """The constants ``ops/join.py`` shares with csrc/join_expand.cu are
    the ones ``srt_join_expand_limits`` reports, in order (on the card
    the loader compares them)."""
    csrc = Path(native.CSRC)
    known = {}
    common = (csrc / "common.cuh").read_text()
    for name in ("kThreads", "kItems", "kTile"):
        known[name] = _cuda_int(common, name, known)
    src = (csrc / "join_expand.cu").read_text()
    m = re.search(r"const int64_t v\[\] = \{([^}]*)\};",
                  src[src.index("int srt_join_expand_limits("):])
    names = [x.strip() for x in m.group(1).split(",")]
    for name in names:
        if name not in known:
            known[name] = _cuda_int(src, name, known)
    assert native._LIMITS["join_expand"] == tuple(
        known[x] for x in names) == (NT, VT, pj.OFFSETS_TILE)
    assert "srt_join_tail" not in src
