"""The host side of K1 (sort permutation) and K15a (mesh pack) of the
PyTorch/CUDA port, on the CPU.

K1 sorts only the key bits that vary.  Its plan kernel reduces each key
field's OR and AND per block; ``ops/sort.py``'s ``varying_masks`` folds
them and ``sort_plan`` packs the varying bits into one 32-bit word or a few
64-bit words, which the card sorts one 8-bit digit at a time, the least
significant word first (``digit_passes``).  Here a numpy model of the key
fields (``csrc/sort_key.cuh`` ``key_field``) feeds the same functions, the
words are built from the plan's segments and sorted digit by digit with a
stable argsort, and the permutation must equal the plain version's and the
JAX package's.  K15a packs a shard into a send buffer in tiles of one
(destination, column) block each (``pack_plan``); a few lines of numpy
execute the plan on CPU bytes, chunk by chunk as the kernel's threads do,
and the buffer must equal ``mesh_pack_plain``'s with every byte written
exactly once.
"""
import bisect
import zlib

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu.ops import sort as js
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import mesh_exchange as ME
from spark_rapids_tpu_torch.ops import sort as ps

CPU = torch.device("cpu")
U64 = np.uint64


# ---------------------------------------------------------------------------
# K1: seeded keys through both packages
# ---------------------------------------------------------------------------

_FLOATS = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.5, 1e-30]
_WORDS = [b"", b"a", b"a\x00", b"a\x00\x00", b"ab", b"abc", b"b", b"\x00",
          b"zz", b"\xff", "é".encode(), b"abcdefghijklm", b"Q" * 64,
          b"abcdefghijklmnopqrstuvwxyz0123456789" + b"\x00" * 5]


def _array(rng, kind: str, n: int, null_p: float):
    """One seeded arrow column of ``kind``: int8..int64, float, double,
    bool, date or s<W> (strings of at most W bytes, NUL tails among
    them); ``const`` kinds hold one value, ``null`` kinds are all null."""
    base = kind.split(":")[0]
    mask = rng.random(n) < null_p
    if kind.endswith(":null"):
        mask = np.ones(n, bool)
    const = kind.endswith(":const")

    def pick(vals):
        vals = np.asarray(vals)
        return np.full(n, vals[0]) if const else \
            vals[rng.integers(0, len(vals), n)]

    if base.startswith("s"):
        w = int(base[1:])
        words = [x[:w] for x in _WORDS]
        strs = [words[i].decode("latin-1") for i in
                (np.zeros(n, int) + 3 if const
                 else rng.integers(0, len(words), n))]
        arr = pa.array([s.encode("latin-1") for s in strs], pa.binary(),
                       mask=mask).cast(pa.string(), safe=False)
        return arr, {"width": w}
    if base in ("float", "double"):
        dt = np.float32 if base == "float" else np.float64
        return pa.array(pick(_FLOATS).astype(dt), mask=mask), {}
    if base == "bool":
        return pa.array(pick([True, False]).astype(bool), mask=mask), {}
    if base == "date":
        return pa.array(pick(np.arange(-3, 9)).astype(np.int32),
                        mask=mask).cast(pa.date32()), {}
    bits = int(base[3:])
    dt = {8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}[bits]
    lo = -(1 << (bits - 1))
    vals = np.array([lo, -1, 0, 1, 5, (1 << (bits - 1)) - 1], dtype=dt)
    return pa.array(pick(vals), mask=mask), {}


def _batches(rng, kinds, n: int, null_p: float = 0.15):
    arrays, widths = [], {}
    for i, k in enumerate(kinds):
        arr, extra = _array(rng, k, n, null_p)
        arrays.append(arr)
        if "width" in extra:
            widths[f"c{i}"] = extra["width"]
    rb = pa.RecordBatch.from_arrays(arrays,
                                    names=[f"c{i}" for i in range(len(kinds))])
    return _pair(rb, widths)


def _pair(rb, widths):
    jb = JBatch.from_arrow(rb, string_widths=widths)
    n = int(jax.device_get(jb.num_rows))
    leaves = jax.device_get([(c.data, c.validity, c.lengths)
                             for c in jb.columns])
    return jb, PBatch.from_leaves(rb.schema, leaves, n, CPU)


# ---------------------------------------------------------------------------
# K1: a numpy model of the key fields and the passes
# ---------------------------------------------------------------------------

def _model_fields(col: DeviceColumn, kind: int, item: int, asc: bool,
                  nf: bool) -> list[np.ndarray]:
    """Each field of the key, most significant first, as uint64 per row
    (csrc/sort_key.cuh key_field, written from its comment)."""
    valid = col.validity.numpy().astype(bool)
    out = [np.where(valid == nf, 1, 0).astype(U64)]
    data = col.data.numpy()
    if kind == 3:  # string at packed width item
        n, w = data.shape
        padded = np.zeros((n, item), np.uint8)
        padded[:, :min(w, item)] = data[:, :item]
        b = padded.reshape(n, item // 4, 4).astype(U64)
        words = (b[..., 0] << U64(24)) | (b[..., 1] << U64(16)) \
            | (b[..., 2] << U64(8)) | b[..., 3]
        for i in range(item // 4):
            out.append(words[:, i] if asc else words[:, i] ^ U64(0xFFFFFFFF))
        lens = col.lengths.numpy().astype(np.int64)
        out.append((lens if asc else item - lens).astype(U64))
        return out
    if kind == 2:
        v = data.astype(bool).astype(U64)
        return out + [v if asc else U64(1) - v]
    bits = 8 * item
    mask = U64((1 << bits) - 1)
    sign = U64(1 << (bits - 1))
    if kind == 0:
        u = data.astype(np.int64).view(U64) & mask
        u = u ^ sign
        return out + [u if asc else u ^ mask]
    x = data.copy()
    nan = np.isnan(x)
    x[nan | (x == 0)] = 0
    if not asc:
        x = -x
    x[x == 0] = 0  # -0.0 -> +0.0
    b = x.view(np.uint32 if bits == 32 else U64).astype(U64)
    key = np.where(b & sign, (~b) & mask, b | sign)
    flag = (nan if asc else ~nan).astype(U64)
    return out + [flag, key]


def _model(pb, orders, block_rows: int = 7):
    """The plan the wrapper derives from per-block partials (blocks of
    ``block_rows`` rows and one empty block, as a launch with more blocks
    than tiles writes), the words built from its segments, and the
    permutation of the LSD digit passes."""
    n = pb.num_rows
    fields, field_bits = [], []
    for o in orders:
        c = pb.columns[o.child_index]
        w = ps.packed_width(c) if c.is_string else None
        kind, item, bits = ps.key_layout(c, w)
        fb = ps.key_field_bits(kind, item)
        assert sum(fb) == bits
        fs = _model_fields(c, kind, item, o.ascending, o.resolved_nulls_first)
        assert len(fs) == len(fb)
        for f, b in zip(fs, fb):
            assert b == 64 or not (f >> U64(b)).any()
        fields.append(fs)
        field_bits.append(fb)
    parts = []  # per field its ORs, then its ANDs, over the blocks
    for f in (f for fs in fields for f in fs):
        blocks = [f[lo:lo + block_rows] for lo in range(0, n, block_rows)]
        # a last block without rows, as a launch of more blocks than tiles
        parts.append([np.bitwise_or.reduce(b) for b in blocks] + [U64(0)])
        parts.append([np.bitwise_and.reduce(b) for b in blocks]
                     + [U64(0xFFFFFFFFFFFFFFFF)])
    masks = ps.varying_masks(np.array(parts, dtype=U64), field_bits)
    plan = ps.sort_plan(field_bits, masks)
    return fields, field_bits, masks, plan


def _words(fields, plan, n: int) -> list[np.ndarray]:
    """The encode kernel's words: each segment's bits moved into place."""
    out = [np.zeros(n, U64) for _ in plan.words]
    for k, f, shift, length, word, dst in plan.segments:
        v = (fields[k][f] >> U64(shift)) & U64((1 << length) - 1)
        out[word] |= v << U64(dst)
    return out


def _lsd(words, plan, n: int) -> np.ndarray:
    perm = np.arange(n)
    for w, passes in zip(words, plan.passes):
        for shift, width in passes:
            d = (w[perm] >> U64(shift)) & U64((1 << width) - 1)
            perm = perm[np.argsort(d, kind="stable")]
    return perm


def _decode_segments(plan):
    """The segment words as the encode kernel reads them."""
    out, word = [], 0
    for s in ps.segment_words(plan):
        out.append(((s >> 34) & 0xFFFF, (s >> 18) & 0xFFFF, s & 63,
                    ((s >> 6) & 63) + 1, word, (s >> 12) & 63))
        word += (s >> 50) & 1
    return tuple(out)


def _check(jb, pb, specs, want_bits=None):
    n = pb.num_rows
    porders = [ps.SortOrder(i, a, nf) for i, a, nf in specs]
    jorders = [js.SortOrder(i, a, nf) for i, a, nf in specs]
    fields, field_bits, masks, plan = _model(pb, porders)
    # kept bits: exactly the set bits of the masks, each varying
    assert plan.bits == sum(bin(m).count("1") for ms in masks for m in ms)
    if want_bits is not None:
        assert plan.bits == want_bits
    assert plan.wide == (plan.bits > 32)
    assert sum(plan.words) == plan.bits
    assert all(b <= (64 if plan.wide else 32) for b in plan.words)
    assert all(sum(w for _s, w in p) == b and all(w <= 8 for _s, w in p)
               for p, b in zip(plan.passes, plan.words))
    for k, fs in enumerate(fields):
        for f, v in enumerate(fs):
            varying = int(np.bitwise_or.reduce(v) ^ np.bitwise_and.reduce(v)) \
                if n else 0
            assert masks[k][f] == varying
    if plan.segments:
        assert _decode_segments(plan) == plan.segments
    words = _words(fields, plan, n)
    got = _lsd(words, plan, n)
    plain = ps.sort_permutation_plain(pb, porders).numpy()
    want = np.asarray(jax.device_get(js.sort_permutation(jb, jorders)))[:n]
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(got, want)
    # every bit kept (pack_keys' limbs) orders the rows the same way
    full = ps.sort_plan(field_bits, [[(1 << b) - 1 for b in fb]
                                     for fb in field_bits], wide=True)
    assert full.bits == sum(map(sum, field_bits))
    assert len(full.words) == -(-full.bits // 64)
    np.testing.assert_array_equal(_lsd(_words(fields, full, n), full, n),
                                  want)
    return plan


_CASES = [
    # (kinds, key specs (column, ascending, nulls_first), rows)
    (["int8"], [(0, True, None)], 201),
    (["int16"], [(0, False, None)], 201),
    (["int32"], [(0, True, False)], 201),
    (["int64"], [(0, False, True)], 201),
    (["float"], [(0, True, None)], 201),
    (["double"], [(0, False, None)], 201),
    (["double"], [(0, True, False)], 201),
    (["bool"], [(0, False, False)], 201),
    (["date"], [(0, True, True)], 201),
    (["s1"], [(0, True, None)], 201),
    (["s4"], [(0, False, None)], 201),
    (["s13"], [(0, True, False)], 201),
    (["s64"], [(0, False, True)], 201),
    (["s13", "int32"], [(0, False, None), (1, True, None)], 255),
    (["double", "s4", "int8"], [(1, True, False), (0, False, True),
                                (2, True, None)], 255),
    (["bool", "int16", "float", "s64"],
     [(3, False, None), (1, True, True), (0, True, False), (2, False, None)],
     255),
    (["int64", "s1", "date", "double", "bool"],
     [(i, i % 2 == 0, i % 3 == 0) for i in range(5)], 255),
    (["s13", "int32", "s4", "int8", "double", "bool"],
     [(5, True, None), (0, False, False), (3, True, True), (1, False, None),
      (2, True, False), (4, False, True)], 255),
    # constant and all-null columns beside varying ones
    (["int32:const", "s13:const", "double"],
     [(0, True, None), (1, False, None), (2, True, None)], 201),
    (["int64:null", "s4:null", "int16"],
     [(0, False, True), (1, True, False), (2, False, None)], 201),
    # n = 0, 1 and odd
    (["int32", "s4"], [(0, True, None), (1, False, None)], 0),
    (["int32", "s4"], [(0, True, None), (1, False, None)], 1),
    (["float", "s64"], [(1, True, None), (0, False, None)], 3),
]


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_k1_plan_model_matches_plain_and_jax(case):
    """Over seeded keys of every type (NaN, -0.0, +-inf, NUL tails,
    strings at W 1, 4, 13 and 64), both directions and null orders, one to
    six keys, constant and all-null columns and n of 0, 1 and odd: the
    varying bits, compacted and sorted digit by digit, least significant
    word first, give the plain version's and the JAX package's
    permutation."""
    kinds, specs, n = _CASES[case]
    rng = np.random.default_rng(zlib.crc32(repr(_CASES[case]).encode()))
    jb, pb = _batches(rng, kinds, n)
    plan = _check(jb, pb, specs)
    if n <= 1:
        assert plan.bits == 0 and plan.words == ()


def test_k1_plan_all_equal_rows_is_the_identity():
    """Rows equal on every key keep no bit: no word, no pass."""
    rng = np.random.default_rng(4)
    jb, pb = _batches(rng, ["int32:const", "s13:const", "double:null"], 99,
                      null_p=0.0)
    plan = _check(jb, pb, [(0, True, None), (1, False, None),
                           (2, True, True)], want_bits=0)
    assert plan.segments == () and plan.passes == ()


def test_k1_plan_lowest_bit_only():
    """One row differs from the rest only in its lowest bit: one kept
    bit, one 1-bit pass, and that row moves."""
    v = np.full(37, 6, np.int64)
    v[11] = 7
    rb = pa.RecordBatch.from_arrays([pa.array(v)], names=["c0"])
    jb, pb = _pair(rb, {})
    plan = _check(jb, pb, [(0, False, None)], want_bits=1)
    assert plan.passes == (((0, 1),),)
    got = ps.sort_permutation_plain(pb, [ps.SortOrder(0, False)]).numpy()
    assert got[0] == 11


def test_k1_plan_wide_keys_take_several_words():
    """Random int64s under a random double and a wide string vary in more
    than 64 bits: 64-bit words, the top one partial, nine or more digit
    passes, a field split across two words."""
    rng = np.random.default_rng(12)
    n = 300
    rb = pa.RecordBatch.from_arrays([
        pa.array(rng.integers(-2 ** 62, 2 ** 62, n)),
        pa.array(rng.standard_normal(n)),
        pa.array([rng.integers(97, 123, int(rng.integers(0, 30)))
                  .astype(np.uint8).tobytes().decode() for _ in range(n)])],
        names=["c0", "c1", "c2"])
    jb, pb = _pair(rb, {"c2": 32})
    plan = _check(jb, pb, [(2, True, None), (1, False, None),
                           (0, True, None)])
    assert plan.wide and len(plan.words) >= 3
    assert sum(len(p) for p in plan.passes) >= 9
    words = {}
    for k, f, *_rest, word, _dst in plan.segments:
        words.setdefault((k, f), set()).add(word)
    assert any(len(ws) > 1 for ws in words.values())


def test_k1_sort_plan_runs_and_limits():
    """The compaction itself: runs of set bits, least significant field
    first; a run split at a word edge; one 32-bit word up to 32 bits;
    the segment words' bit fields; keys or fields past 16 bits raise."""
    plan = ps.sort_plan([[1, 32, 3], [1, 32, 3]],
                        [[0, 0x1F << 24, 0], [0, 0x09 << 24, 0]])
    assert plan == ps.SortPlan(7, False, (7,), (
        (1, 1, 24, 1, 0, 0), (1, 1, 27, 1, 0, 1), (0, 1, 24, 5, 0, 2)))
    assert plan.passes == (((0, 7),),)
    assert ps.segment_words(plan) == [
        24 | 1 << 18 | 1 << 34, 27 | 1 << 12 | 1 << 18 | 1 << 34,
        24 | 4 << 6 | 2 << 12 | 1 << 18 | 1 << 50]
    p33 = ps.sort_plan([[33]], [[(1 << 33) - 1]])
    assert p33.wide and p33.words == (33,)
    assert [len(p) for p in p33.passes] == [5]
    split = ps.sort_plan([[64], [64]], [[1 << 63 | 1], [(1 << 64) - 1]])
    assert split.words == (64, 2)
    assert split.segments == ((1, 0, 0, 64, 0, 0), (0, 0, 0, 1, 1, 0),
                              (0, 0, 63, 1, 1, 1))
    assert ps.digit_passes(17) == ((0, 8), (8, 8), (16, 1))
    big = ps.SortPlan(1, False, (1,), ((0x10000, 0, 0, 1, 0, 0),))
    with pytest.raises(ValueError, match="65536"):
        ps.segment_words(big)


# ---------------------------------------------------------------------------
# K15a: the tile plan on CPU bytes
# ---------------------------------------------------------------------------

def _views(tensors):
    views = sorted((t.data_ptr(), id(t), t.reshape(-1).view(torch.uint8))
                   for t in tensors if t.numel())
    bases = [v[0] for v in views]

    def at(addr, n):
        i = bisect.bisect_right(bases, addr) - 1
        for base, _i, b in views[max(i - 2, 0):i + 1]:
            if base <= addr and addr + n <= base + b.numel():
                return b[addr - base:addr - base + n]
        raise AssertionError(f"{n} bytes at {addr:#x} lie outside every "
                             "tensor")
    return at


def _a16(x: int) -> int:
    return (x + 15) // 16 * 16


def _run_pack(words, ntiles, ncols: int, P: int, perm, out, leaves,
              tile_rows: int, seen):
    """Execute a K15a plan on CPU bytes, tile by tile and 16-byte chunk by
    chunk, as the kernel's blocks do; ``seen`` counts the writes of each
    output byte."""
    at = _views(leaves)
    cw = ME.PACK_COL_WORDS
    cols = [words[cw * j:cw * (j + 1)] for j in range(ncols)]
    prefix = words[cw * ncols:cw * ncols + P + 1]
    offs = words[cw * ncols + P + 1:]
    assert len(offs) == P * ncols and ntiles % (P * ncols) == 0
    buf = out.view(torch.uint8).numpy()
    perm = perm.numpy()

    def chunks(dst, nbytes, row_bytes, base, rows, rb_src=None):
        """Write the 16-byte chunks of buf[dst, dst + nbytes): byte b is
        byte b % row_bytes of source row rows[b // row_bytes] at ``base``
        (None: the validity as 0/1), zero past the tile's rows."""
        assert dst % 16 == 0 and nbytes % 16 == 0
        b = np.arange(nbytes)
        r, off = np.divmod(b, row_bytes) if row_bytes else (b, b)
        live = r < len(rows)
        val = np.zeros(nbytes, np.uint8)
        if live.any():
            src = rows[r[live]].astype(np.int64)
            hi = int(src.max()) + 1
            leaf = at(base, hi * row_bytes).numpy()
            val[live] = leaf[src * row_bytes + off[live]]
            if rb_src == "valid":
                val = (val != 0).astype(np.uint8)
        buf[dst:dst + nbytes] = val
        seen[dst:dst + nbytes] += 1

    for t in range(ntiles):
        j, d, k = t % ncols, t // ncols % P, t // (ncols * P)
        data, valid, lens, rbv = cols[j]
        rb, vec = rbv & 0xFFFFFFFF, rbv >> 32
        assert vec in (1, 2, 4, 8, 16) and data % vec == 0
        assert rb % vec == 0 or rb == 0
        rows = prefix[d + 1] - prefix[d]
        r0 = k * tile_rows
        if r0 >= rows:
            continue
        nr = min(tile_rows, rows - r0)
        last = r0 + nr == rows
        src = perm[prefix[d] + r0:prefix[d] + r0 + nr]
        blk = offs[d * ncols + j]
        dbytes = _a16(rows * rb)
        if rb:
            chunks(blk + r0 * rb, dbytes - r0 * rb if last else nr * rb, rb,
                   data, src)
        after = blk + dbytes
        if lens:
            chunks(after + 4 * r0, _a16(4 * rows) - 4 * r0 if last
                   else 4 * nr, 4, lens, src)
            after += _a16(4 * rows)
        chunks(after + r0, _a16(rows) - r0 if last else nr, 1, valid, src,
               "valid")


def _shard(rng, n: int, w: int, lo: int = 0) -> list[DeviceColumn]:
    """A shard's columns (int8, int16, int32, int64, double, bool, a
    string of width ``w`` and an int32 array), cut at row ``lo`` of a
    longer column so that their addresses are not 16-byte aligned."""
    m = n + lo

    def valid():
        return torch.from_numpy(rng.random(m) < 0.8)[lo:]

    cols = []
    for np_t, dt in ((np.int8, T.ByteType()), (np.int16, T.ShortType()),
                     (np.int32, T.IntegerType()), (np.int64, T.LongType()),
                     (np.float64, T.DoubleType())):
        cols.append(DeviceColumn(torch.from_numpy(
            rng.integers(-99, 99, m).astype(np_t))[lo:], valid(), dt))
    cols.append(DeviceColumn(torch.from_numpy(rng.random(m) < .5)[lo:],
                             valid(), T.BooleanType()))
    cols.append(DeviceColumn(
        torch.from_numpy(rng.integers(0, 256, (m, w)).astype(np.uint8))[lo:],
        valid(), T.StringType(),
        torch.from_numpy(rng.integers(0, w + 1, m).astype(np.int32))[lo:]))
    aw = w // 4 + 1
    cols.append(DeviceColumn(
        torch.from_numpy(rng.integers(-5, 5, (m, aw)).astype(np.int32))[lo:],
        valid(), T.ArrayType(T.IntegerType()),
        torch.from_numpy(rng.integers(0, aw + 1, m).astype(np.int32))[lo:]))
    return cols


def _pack_check(cols, counts, perm, tile_rows: int):
    layout = ME.pack_layout(cols, counts)
    words, ntiles = ME.pack_plan(cols, counts, layout, tile_rows)
    P, ncols = len(counts), len(cols)
    assert len(words) == ME.PACK_COL_WORDS * ncols + P * ncols + P + 1
    assert ntiles == max(-(-c // tile_rows) for c in counts) * P * ncols
    out = torch.full((layout[0][-1],), 0xA5, dtype=torch.uint8)  # poison
    seen = np.zeros(out.numel(), np.int32)
    leaves = [t for c in cols for t in (c.data, c.validity, c.lengths)
              if t is not None] + [out]
    _run_pack(words, ntiles, ncols, P, perm, out, leaves, tile_rows, seen)
    assert (seen == 1).all(), "every byte of the buffer written once"
    want = ME.mesh_pack_plain(cols, perm, counts)
    assert torch.equal(out, want)
    return words


@pytest.mark.parametrize("seed", range(10))
def test_k15a_plan_matches_plain(seed):
    """Fuzzed shards (P 1-64, empty sections, slices at odd row offsets,
    string widths 1 to 64, tiles of 16 to 2048 rows, so blocks of one
    tile, of many and of a partial last one): the plan, executed on CPU
    bytes, gives mesh_pack_plain's buffer, pads zero, every byte written
    exactly once."""
    rng = np.random.default_rng(seed)
    p = [1, 2, 3, 8, 64][seed % 5]
    counts = [0 if rng.random() < 0.3 else int(rng.integers(1, 70))
              for _ in range(p)]
    n = sum(counts)
    w = int(rng.choice([1, 4, 13, 16, 64]))
    cols = _shard(rng, n, w, lo=int(rng.integers(0, 7)))
    # K10's order: rows grouped by destination, in row order within one
    ids = rng.permutation(np.repeat(np.arange(p), counts))
    perm = torch.from_numpy(np.argsort(ids, kind="stable").astype(np.int32))
    _pack_check(cols, counts, perm,
                [16, 32, 48, ME.PACK_TILE_ROWS][seed % 4])


def test_k15a_plan_past_the_parameters():
    """A large mesh (P 4096, one int32 column, sections of 0-3 rows):
    the table outgrows the kernel's parameters, and the wrapper hands the
    kernel a device copy; executed on CPU bytes it is still exact."""
    rng = np.random.default_rng(40)
    counts = [int(c) for c in rng.integers(0, 4, 4096)]
    n = sum(counts)
    col = DeviceColumn(torch.from_numpy(rng.integers(-9, 9, n)
                                        .astype(np.int32)),
                       torch.from_numpy(rng.random(n) < 0.9),
                       T.IntegerType())
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    words = _pack_check([col], counts, perm, ME.PACK_TILE_ROWS)
    assert len(words) > ME.UNPACK_PARAM_WORDS
    small = ME.pack_plan([col], [n], ME.pack_layout([col], [n]))[0]
    assert len(small) <= ME.UNPACK_SMALL_WORDS


def _meta(col: DeviceColumn) -> DeviceColumn:
    m = torch.device("meta")
    return DeviceColumn(col.data.to(m), col.validity.to(m), col.dtype,
                        None if col.lengths is None else col.lengths.to(m))


def _no_kernel(name):
    raise RuntimeError(f"no {name} kernel")


def test_k1_and_k15a_wrappers_launch_or_raise_off_the_cpu(monkeypatch):
    """Off the CPU both wrappers launch their kernels or raise: neither
    takes its plain version, and neither counts a launch it did not
    make."""
    monkeypatch.setattr(ps.native, "lib", _no_kernel)
    monkeypatch.setattr(ME.native, "lib", _no_kernel)
    rng = np.random.default_rng(6)
    _jb, pb = _batches(rng, ["int32", "s4"], 9)
    mb = PBatch([_meta(c) for c in pb.columns], 9, pb.schema,
                torch.device("meta"))
    before = ps.sort_permutation.launches
    with pytest.raises(RuntimeError, match="no sort kernel"):
        ps.sort_permutation(mb, [ps.SortOrder(0), ps.SortOrder(1, False)])
    with pytest.raises(RuntimeError, match="no sort kernel"):
        ps.pack_keys(mb.columns, [ps.SortOrder(0), ps.SortOrder(1)])
    assert ps.sort_permutation.launches == before
    cols = [_meta(c) for c in _shard(rng, 9, 8)]
    perm = torch.arange(9, dtype=torch.int32, device="meta")
    before = ME.mesh_pack.launches
    with pytest.raises(RuntimeError, match="no mesh_exchange kernel"):
        ME.mesh_pack(cols, perm, [4, 5])
    assert ME.mesh_pack.launches == before
