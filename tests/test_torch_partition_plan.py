"""The host side of K10's onesweep counting sort, of the PyTorch/CUDA
port, on the CPU.

On the card ``partition._order_cuda`` launches ``srt_partition_upsweep``
(a tile a block: the tile's bucket counts added into the scratch's global
counts; the passes' tickets and look-back states zeroed; the last block
done writes counts, the exclusive starts and each pass's digit bases and
zeroes the counts again) and then ``srt_partition_scatter`` once a pass
(one pass up to 255 partitions, a pass a byte of the bucket past it): a
tile a block in ticket order, stable ranks, the tile's digit counts
published and each digit's prefix read back over the earlier tiles
(decoupled look-back), every row written at base + prefix + rank.  Here
numpy executes those blocks by address on CPU memory, the upsweep's blocks
finishing in a shuffled order and the scatter's tiles interleaved at
random (a tile starts in ticket order; its look-back completes only once
every tile it reads has published), standing in for the library under the
real wrapper.  The results must equal ``_order_plain`` (a stable argsort
and a bincount) and the JAX package's ``_jit_group_by_part``; every output
is written once and the scratch's counts are zero again after a call.
"""
import ctypes
import re
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu.exec import exchange as jx
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops import partition as pt

CPU = torch.device("cpu")
TILE = pt.GROUP_TILE
RADIX = pt.ONE_PASS_BUCKETS
HEAD = pt.SCRATCH_HEAD_WORDS
DONE = pt.MAX_PARTS + 1            # the upsweep's ticket of finished blocks
TICKETS = DONE + 1                 # a ticket a pass
BASES = TICKETS + pt.MAX_PASSES    # RADIX digit bases a pass
AGG, PREFIX = np.uint64(1 << 62), np.uint64(2 << 62)
VALUE = np.uint64((1 << 62) - 1)


def _mem(addr, count: int, dtype) -> np.ndarray:
    """A writable numpy view of ``count`` items at host address ``addr``."""
    dt = np.dtype(dtype)
    if count == 0 or not addr:
        return np.zeros(0, dt)
    raw = np.ctypeslib.as_array(
        ctypes.cast(addr, ctypes.POINTER(ctypes.c_uint8)),
        shape=(count * dt.itemsize,))
    return raw.view(dt)


def _buckets(ids: np.ndarray, parts: int) -> np.ndarray:
    ids = ids.astype(np.int64)
    return np.where((ids >= 0) & (ids < parts), ids, parts)


class FakeGroup:
    """K10's two entry points, executed a block at a time."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.calls = []
        self.writes = {}

    def _count(self, addr, size, idx):
        w = self.writes.setdefault(addr, np.zeros(size, np.int64))
        np.add.at(w, np.asarray(idx, np.int64), 1)

    def _scratch(self, scratch, n, parts):
        words = pt.scratch_words(n, parts)
        sc = _mem(scratch, words, np.uint32)
        status = _mem(scratch + 4 * HEAD, (words - HEAD) // 2, np.uint64)
        return sc, status

    def srt_partition_upsweep(self, ids, n, parts, scratch, counts, starts,
                              stream):
        self.calls.append("upsweep")
        nbk = parts + 1
        sc, status = self._scratch(scratch, n, parts)
        assert not sc[:DONE + 1].any(), "the counts and ticket on entry"
        b = _buckets(_mem(ids, n, np.int32), parts)
        blocks = max(-(-n // TILE), 1)
        for blk in self.rng.permutation(blocks):
            status[:] = 0                   # the grid-stride zeroing
            if blk == 0:
                sc[TICKETS:TICKETS + pt.MAX_PASSES] = 0
            tile = b[blk * TILE:(blk + 1) * TILE]
            sc[:nbk] += np.bincount(tile, minlength=nbk).astype(np.uint32)
            sc[DONE] += 1
            if sc[DONE] != blocks:
                continue
            # the last block done
            c = sc[:nbk].astype(np.int64)
            excl = np.cumsum(c) - c
            _mem(counts, parts, np.int32)[:] = c[:parts]
            _mem(starts, parts, np.int32)[:] = excl[:parts]
            self._count(counts, parts, np.arange(parts))
            self._count(starts, parts, np.arange(parts))
            passes = pt.group_passes(parts)
            if len(passes) == 1:
                base = np.zeros(RADIX, np.int64)
                base[:nbk] = excl
                sc[BASES:BASES + RADIX] = base
            else:
                idx = np.arange(nbk)
                for p, dig in enumerate((idx & 255, idx >> 8)):
                    h = np.bincount(dig, weights=c, minlength=RADIX)
                    sc[BASES + p * RADIX:BASES + (p + 1) * RADIX] = \
                        (np.cumsum(h) - h).astype(np.uint32)
            sc[:nbk] = 0
            sc[DONE] = 0
        return 0

    def srt_partition_scatter(self, ids, n, parts, p, perm_in, perm_out,
                              scratch, stream):
        self.calls.append(f"scatter{p}")
        passes = pt.group_passes(parts)
        assert 0 <= p < len(passes) and (p == 0) == (perm_in is None)
        nt = -(-n // TILE)
        if nt == 0:
            return 0
        ndig = passes[p]
        sc, status = self._scratch(scratch, n, parts)
        st = status[nt * sum(passes[:p]):nt * sum(passes[:p + 1])] \
            .reshape(nt, ndig)
        assert not st.any(), "the pass's look-back state zero on entry"
        assert sc[TICKETS + p] == 0
        base = sc[BASES + p * RADIX:BASES + p * RADIX + ndig].astype(
            np.int64)
        vals = (_mem(perm_in, n, np.int32).astype(np.int64)
                if perm_in else np.arange(n))
        dig = (_buckets(_mem(ids, n, np.int32)[vals], parts) >> (8 * p)) \
            & 255
        assert dig.max(initial=0) < ndig
        out = _mem(perm_out, n, np.int32)
        started, done = 0, set()
        cnts = {}
        while len(done) < nt:
            ready = [t for t in range(started) if t not in done
                     and self._walk(st, t) is not None]
            moves = ready + (["start"] if started < nt else [])
            move = moves[self.rng.integers(len(moves))]
            if move == "start":
                t = started
                sc[TICKETS + p] += 1
                started += 1
                c = np.bincount(dig[t * TILE:(t + 1) * TILE],
                                minlength=ndig).astype(np.uint64)
                cnts[t] = c
                st[t] = (PREFIX if t == 0 else AGG) | c
                continue
            t = move
            excl = self._walk(st, t)
            st[t] = PREFIX | (excl + cnts[t])
            lo, hi = t * TILE, min((t + 1) * TILE, n)
            td = dig[lo:hi]
            order = np.argsort(td, kind="stable")
            c = cnts[t].astype(np.int64)
            first = np.cumsum(c) - c            # the digit's start in tile
            rank = np.empty(hi - lo, np.int64)
            rank[order] = np.arange(hi - lo) - first[td[order]]
            dst = base[td] + excl.astype(np.int64)[td] + rank
            out[dst] = vals[lo:hi]
            self._count(perm_out, n, dst)
            done.add(t)
        return 0

    @staticmethod
    def _walk(st, t):
        """Tile t's look-back for every digit: the exclusive prefixes, or
        None where a digit meets a tile that has published nothing (its
        thread would spin)."""
        if t == 0:
            return np.zeros(st.shape[1], np.uint64)
        excl = np.zeros(st.shape[1], np.uint64)
        open_ = np.ones(st.shape[1], bool)
        for j in range(t - 1, -1, -1):
            s = st[j]
            if (open_ & (s == 0)).any():
                return None
            excl[open_] += s[open_] & VALUE
            open_ &= (s & PREFIX) == 0
            if not open_.any():
                return excl
        raise AssertionError("tile 0 publishes a prefix")


@pytest.fixture
def fake(monkeypatch, request):
    lib = FakeGroup(zlib.crc32(request.node.name.encode()))
    monkeypatch.setattr(native, "lib", lambda name: lib)
    monkeypatch.setattr(native, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(pt, "_STATUS", {})
    return lib


def _order_both(fake, ids: np.ndarray, parts: int, calls: int = 2):
    """K10's order through the wrapper, ``calls`` times on one scratch,
    against the plain version: equal, each output written once, the
    scratch's counts and ticket zero again."""
    t = torch.from_numpy(ids.astype(np.int32))
    want = pt._order_plain(t, parts)
    npass = len(pt.group_passes(parts))
    for _ in range(calls):
        before = pt.group_by_part.launches
        k = len(fake.calls)
        got = pt._order_cuda(t, parts)
        assert pt.group_by_part.launches == before + 1
        assert fake.calls[k:] == ["upsweep"] + [f"scatter{p}"
                                                for p in range(npass)]
        for a, b in zip(got, want):
            assert a.dtype == torch.int32 and torch.equal(a, b)
        for addr, w in fake.writes.items():
            assert (w == 1).all(), "an output written other than once"
        fake.writes.clear()
        (sc,) = pt._STATUS.values()
        assert not sc.view(torch.int32)[:DONE + 1].any()
    return got


def _jax_group(ids: np.ndarray, parts: int):
    """The JAX package's grouping of a row-index column by ``ids`` (all
    in [0, parts)): (the grouped row indices, counts, starts)."""
    n = ids.size
    jb = JBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array(np.arange(n, dtype=np.int32))], names=["row"]))
    cap = jb.capacity
    jids = jnp.asarray(np.concatenate([ids, np.zeros(cap - n)]).astype(
        np.int32))
    grouped, counts, starts = jax.device_get(
        jx._jit_group_by_part(jb, jids, parts))
    return (np.asarray(grouped.columns[0].data)[:n], np.asarray(counts),
            np.asarray(starts))


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 5 * 4096 + 3])
@pytest.mark.parametrize("parts", [1, 8, 200, 255, 256, 5000])
def test_order_matches_plain_and_jax(fake, parts, n):
    """One pass up to 255 partitions, two past it; the tile edges; the
    look-back over several tiles; the JAX package's grouping."""
    rng = np.random.default_rng(n + parts)
    ids = rng.integers(0, parts, n)
    perm, counts, starts = _order_both(fake, ids, parts)
    jperm, jcounts, jstarts = _jax_group(ids, parts)
    np.testing.assert_array_equal(perm.numpy(), jperm)
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    np.testing.assert_array_equal(starts.numpy(), jstarts)


@pytest.mark.parametrize("parts", [1, 8, 255, 256, 5000, pt.MAX_PARTS])
def test_ids_outside_the_partitions_go_last(fake, parts):
    """Negative ids, ids of P and past it, and int32's extremes: bucket P,
    after every partition, in row order, counted in no partition."""
    rng = np.random.default_rng(parts)
    n = 3 * 4096 + 77
    ids = rng.integers(-3, parts + 3, n)
    ids[rng.random(n) < 0.05] = np.iinfo(np.int32).min
    ids[rng.random(n) < 0.05] = np.iinfo(np.int32).max
    perm, counts, starts = _order_both(fake, ids, parts)
    inside = int(((ids >= 0) & (ids < parts)).sum())
    assert int(counts.sum()) == inside
    tail = perm[inside:].numpy()
    assert (np.diff(tail) > 0).all()
    assert not ((ids[tail] >= 0) & (ids[tail] < parts)).any()


@pytest.mark.parametrize("parts", [1, 8, 300])
def test_one_bucket_holds_everything(fake, parts):
    """Every row in one partition (its digit run crosses every tile), then
    every row outside [0, P)."""
    n = 4 * 4096 + 9
    for v in (parts - 1, parts):
        perm, counts, _ = _order_both(fake, np.full(n, v), parts)
        assert torch.equal(perm, torch.arange(n, dtype=torch.int32))
        assert int(counts.sum()) == (n if v < parts else 0)


@pytest.mark.parametrize("parts", [8, 5000])
def test_empty_batch(fake, parts):
    """0 rows: the upsweep's one block writes zero counts and starts; the
    scatter launches nothing."""
    perm, counts, starts = _order_both(fake, np.zeros(0), parts)
    assert perm.numel() == 0 and not counts.any() and not starts.any()


def test_group_by_part_gathers_through_k3(fake, monkeypatch):
    """The wrapper's gather is K3 over K10's permutation: the grouped
    batch equals the plain version's."""
    from spark_rapids_tpu_torch.ops import kernels as K
    monkeypatch.setattr(pt, "gather_columns", K.gather_plain)
    rng = np.random.default_rng(5)
    n = 9000
    rb = pa.RecordBatch.from_arrays(
        [pa.array(rng.integers(0, 100, n)),
         pa.array(rng.random(n), mask=rng.random(n) < 0.1)],
        names=["a", "b"])
    pb = PBatch.from_arrow(rb, CPU)
    ids = torch.from_numpy(rng.integers(-1, 9, n).astype(np.int32))
    got, counts, starts = pt._group_cuda(pb, ids, 8)
    want, wcounts, wstarts = pt.group_by_part_plain(pb, ids, 8)
    assert torch.equal(counts, wcounts) and torch.equal(starts, wstarts)
    for a, b in zip(got.columns, want.columns):
        assert torch.equal(a.validity, b.validity)
        assert torch.equal(a.data, b.data)


def test_wrapper_refuses_what_it_cannot_group(fake):
    with pytest.raises(ValueError, match="num_parts"):
        pt._order_cuda(torch.zeros(5, dtype=torch.int32), pt.MAX_PARTS + 1)
    with pytest.raises(ValueError, match="int32"):
        pt._order_cuda(torch.zeros(5, dtype=torch.int64), 8)
    assert fake.calls == []


def _cuda_int(src: str, name: str, known: dict) -> int:
    m = re.search(rf"constexpr [\w ]+ {name} =\s*([^;]+);", src)
    assert m, name
    expr = m.group(1).replace("(long long)", "").replace("~1ll", "~1")
    return eval(expr, {}, known)


def test_group_limits_match_the_cuda_source():
    """The constants ``ops/partition.py`` shares with
    csrc/partition_group.cu are the ones ``srt_partition_group_limits``
    reports, in order (on the card the loader compares them), and the
    scratch layout the fake reads is the source's."""
    src = (Path(native.CSRC) / "partition_group.cu").read_text()
    known = {}
    for name in ("kPartThreads", "kPartItems", "kPartTile", "kRadix",
                 "kMaxPasses", "kMaxParts", "kMaxBuckets", "kDoneWord",
                 "kTicketWord", "kBaseWord", "kStatusWord"):
        known[name] = _cuda_int(src, name, known)
    m = re.search(r"const int64_t v\[\] = \{([^}]*)\};",
                  src[src.index("int srt_partition_group_limits("):])
    names = [x.strip() for x in m.group(1).split(",")]
    assert native._LIMITS["partition_group"] == tuple(
        known[x] for x in names) == (TILE, RADIX, pt.MAX_PASSES,
                                     pt.MAX_PARTS, HEAD)
    assert (known["kDoneWord"], known["kTicketWord"],
            known["kBaseWord"]) == (DONE, TICKETS, BASES)
    assert "scan_exclusive_kernel" not in src
