"""The host side of the exchange kernels K11 (range-partition ids) and K15b
(mesh unpack) of the PyTorch/CUDA port, on the CPU.

K11 reads each row's key columns in place through descriptors and compares
them with the bounds field by field in K1's order (``csrc/sort_key.cuh``).
Here the descriptors are held against ``ops/sort.py``'s ``key_layout`` and
``packed_width`` (the layout ``pack_keys`` packs), and a numpy model of the
fields, compared lexicographically, against K11's plain version, which ranks
by the reference's method.  K15b copies a destination's segments as a list
of byte spans cut into tiles (``unpack_plan``); a few lines of torch execute
the plan on CPU bytes, tile by tile, and the columns must equal
``mesh_unpack_plain``'s with every output byte written exactly once.  Off
the CPU both wrappers launch their kernel or raise.
"""
import bisect
import re
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import mesh_exchange as ME
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops import range_partition as RP
from spark_rapids_tpu_torch.ops.sort import (SortOrder, key_layout,
                                             packed_width)

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------

def _string_col(rng, n: int, w: int, words) -> DeviceColumn:
    """n rows drawn from ``words`` at matrix width ``w`` (any width, not
    only the scan's powers of two), ~10% null, null rows zeroed."""
    idx = rng.integers(0, len(words), n)
    valid = rng.random(n) >= 0.1
    data = np.zeros((n, w), np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        if valid[i]:
            bs = words[idx[i]][:w]
            data[i, :len(bs)] = np.frombuffer(bs, np.uint8)
            lens[i] = len(bs)
    return DeviceColumn(torch.from_numpy(data), torch.from_numpy(valid),
                        T.StringType(), torch.from_numpy(lens))


_WORDS = [b"", b"a", b"a\x00", b"ab", b"abc", b"abcd", b"abcde", b"b",
          "é".encode(), b"\xff\xfe", b"zzzz zzzz zzzz", b"the quick brown"]


def _fixed_col(rng, n: int, kind: str) -> DeviceColumn:
    valid = rng.random(n) >= 0.1
    if kind == "int8":
        v, dt = rng.integers(-128, 128, n).astype(np.int8), T.ByteType()
    elif kind == "int16":
        v, dt = rng.integers(-3, 3, n).astype(np.int16) * 10000, \
            T.ShortType()
    elif kind == "int32":
        v, dt = rng.integers(-4, 4, n).astype(np.int32), T.IntegerType()
    elif kind == "int64":
        v, dt = rng.integers(-3, 3, n) * 2 ** 61, T.LongType()
    elif kind == "bool":
        v, dt = rng.random(n) < 0.5, T.BooleanType()
    elif kind == "float":
        v = rng.choice(np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5,
                                 -2.5], np.float32), n)
        dt = T.FloatType()
    else:
        v = rng.choice(np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e300,
                                 -1e-300, 2.5]), n)
        dt = T.DoubleType()
    v = np.where(valid, v, np.zeros((), v.dtype))
    return DeviceColumn(torch.from_numpy(v), torch.from_numpy(valid), dt)


def _col(rng, n: int, kind: str) -> DeviceColumn:
    if kind.startswith("s"):
        return _string_col(rng, n, int(kind[1:]), _WORDS)
    return _fixed_col(rng, n, kind)


def _key_fields(col: DeviceColumn, kind: int, width: int, asc: bool,
                nf: bool) -> list[list[int]]:
    """Per row, the key's fields most significant first, as
    csrc/sort_key.cuh ``key_field`` defines them (numpy model)."""
    valid = col.validity.numpy()
    rows = [[1 if bool(v) == nf else 0] for v in valid]
    if kind == 3:  # string: big-endian words at width W, then the length
        data = col.data.numpy()
        item = data.shape[1]
        padded = np.zeros((len(valid), width), np.uint8)
        padded[:, :item] = data
        words = padded.reshape(len(valid), width // 4, 4).astype(np.uint64)
        words = (words[..., 0] << 24) | (words[..., 1] << 16) \
            | (words[..., 2] << 8) | words[..., 3]
        lens = col.lengths.numpy()
        for i, r in enumerate(rows):
            r += [int(x) if asc else int(x) ^ 0xFFFFFFFF for x in words[i]]
            r.append(int(lens[i]) if asc else width - int(lens[i]))
        return rows
    data = col.data.numpy()
    if kind == 2:  # bool
        for r, x in zip(rows, data):
            r.append(int(bool(x)) if asc else 1 - int(bool(x)))
        return rows
    bits = 8 * data.dtype.itemsize
    mask = (1 << bits) - 1
    if kind == 0:  # int: sign bit flipped, complemented when descending
        for r, x in zip(rows, data):
            u = (int(x) & mask) ^ (1 << (bits - 1))
            r.append(u if asc else u ^ mask)
        return rows
    utype = np.uint32 if bits == 32 else np.uint64
    for r, x in zip(rows, data):  # float: NaN flag, then the value
        nan = bool(np.isnan(x))
        y = data.dtype.type(0) if nan or x == 0 else x
        if not asc:
            y = -y
        if y == 0:
            y = data.dtype.type(0)
        b = int(np.array([y], data.dtype).view(utype)[0])
        sign = 1 << (bits - 1)
        r += [1 if asc == nan else 0,
              (b ^ mask) if b & sign else (b | sign)]
    return rows


_K11_MIXES = [["int32"], ["int8"], ["int16"], ["int64"], ["bool"],
              ["float"], ["double"], ["s4"], ["s13"], ["s64"],
              ["int32", "double"], ["s16", "int16", "bool"],
              ["double", "s13", "int8"], ["s64", "s64", "s64"]]


@pytest.mark.parametrize("mix", range(len(_K11_MIXES)))
def test_k11_descriptors_agree_with_key_layout(mix):
    """Each key's descriptor words (sort_key.cuh SortKey) name its data,
    validity and lengths, its kind and packed width as ``key_layout`` and
    ``packed_width`` give them (strings at the wider of the rows' and the
    bounds' widths), its direction and null order; its fields' bits add
    up to ``key_layout``'s."""
    rng = np.random.default_rng(mix)
    kinds = _K11_MIXES[mix]
    orders = [SortOrder(i, bool(rng.random() < .5), bool(rng.random() < .5))
              for i in range(len(kinds))]
    rows = [_col(rng, 50, k) for k in kinds]
    # bounds: strings at a different matrix width than the rows
    bcols = [_string_col(rng, 7, c.max_len + 12, _WORDS) if c.is_string
             else _col(rng, 7, k) for c, k in zip(rows, kinds)]
    bounds = RP.RangeBounds(bcols, orders)
    widths = bounds.widths(rows)
    statics = [RP._key_static(c, o, w) for c, o, w in
               zip(bcols, orders, widths)]
    words = RP.key_descriptors(rows, statics)
    assert len(words) == RP.KEY_WORDS * len(rows)
    for i, (c, b, o) in enumerate(zip(rows, bcols, orders)):
        d = words[RP.KEY_WORDS * i:RP.KEY_WORDS * (i + 1)]
        kind, item, bits = key_layout(c, widths[i])
        assert d[:2] == [c.data.data_ptr(), c.validity.data_ptr()]
        assert d[2] == (c.lengths.data_ptr() if c.is_string else 0)
        assert d[3] == kind
        assert d[6:] == [int(o.ascending), int(o.resolved_nulls_first)]
        if c.is_string:
            assert widths[i] == max(packed_width(c), packed_width(b))
            assert d[4] == c.max_len and d[5] == widths[i] == item
        else:
            assert widths[i] is None
            assert d[4] == item == key_layout(b)[1] and d[5] == 0
        fields = _key_fields(c, kind, d[5], bool(d[6]), bool(d[7]))
        assert len(fields[0]) == RP.key_field_count(kind, d[5])
        # the fields' bit widths, as key_field masks them
        widths_bits = [1] + ([32] * (d[5] // 4) + [d[5].bit_length()]
                             if kind == 3 else
                             [1, 8 * item] if kind == 1 else
                             [1] if kind == 2 else [8 * item])
        assert sum(widths_bits) == bits
        for r in fields:
            assert all(0 <= f < (1 << b) for f, b in zip(r, widths_bits))


@pytest.mark.parametrize("nb", [0, 1, 9, 40])
@pytest.mark.parametrize("mix", range(len(_K11_MIXES)))
def test_k11_field_order_matches_plain(mix, nb):
    """Comparing rows with bounds field by field, key by key (what K11's
    kernel does) counts the same bounds below each row as the plain
    version's ranks: rows that tie on every key but the last, nulls both
    first and last, NaN, +-0.0, +-inf, NUL bytes and rows narrower than
    the bounds."""
    rng = np.random.default_rng(100 + 7 * mix + nb)
    kinds = _K11_MIXES[mix]
    n = 120
    orders = [SortOrder(i, bool(rng.random() < .5), bool(rng.random() < .5))
              for i in range(len(kinds))]
    rows = [_col(rng, n, k) for k in kinds]
    bcols = [_string_col(rng, nb, c.max_len + 4, _WORDS) if c.is_string
             else _col(rng, nb, k) for c, k in zip(rows, kinds)]
    # ties on every key but the last: bounds copy some rows' upper keys
    for b, c in zip(bcols[:-1], rows[:-1]):
        for i in range(0, nb, 2):
            b.validity[i] = c.validity[i]
            if c.is_string:
                b.data[i] = 0
                b.data[i, :c.max_len] = c.data[i]
                b.lengths[i] = c.lengths[i]
            else:
                b.data[i] = c.data[i]
    bounds = RP.RangeBounds(bcols, orders)
    widths = bounds.widths(rows)

    def fields(cols):
        per_key = []
        for c, o, w in zip(cols, orders, widths):
            kind, item, _bits = key_layout(c, w)
            per_key.append(_key_fields(c, kind, item if kind == 3 else 0,
                                       o.ascending, o.resolved_nulls_first))
        return [tuple(f for k in r for f in k) for r in zip(*per_key)] \
            if per_key[0] else []

    rf, bf = fields(rows), fields(bcols)
    want = [sum(1 for b in bf if b < r) for r in rf]
    got = RP.range_partition_ids_plain(rows, bounds)
    assert got.tolist() == want


def _meta(col: DeviceColumn) -> DeviceColumn:
    m = torch.device("meta")
    return DeviceColumn(col.data.to(m), col.validity.to(m), col.dtype,
                        None if col.lengths is None else col.lengths.to(m))


def _no_kernel(name):
    raise RuntimeError(f"no {name} kernel")


def test_k11_wrapper_launches_or_raises_off_the_cpu(monkeypatch):
    """Off the CPU K11's wrapper launches its kernel or raises: it never
    takes the plain version, and counts no launch it did not make."""
    monkeypatch.setattr(RP.native, "lib", _no_kernel)
    rng = np.random.default_rng(3)
    keys = [_meta(_col(rng, 5, "int32")), _meta(_col(rng, 5, "s8"))]
    bounds = RP.RangeBounds([_meta(_col(rng, 2, "int32")),
                             _meta(_col(rng, 2, "s8"))],
                            [SortOrder(0), SortOrder(1, False)])
    before = RP.range_partition_ids.launches
    with pytest.raises(RuntimeError, match="no range_partition kernel"):
        RP.range_partition_ids(keys, bounds)
    assert RP.range_partition_ids.launches == before


# ---------------------------------------------------------------------------
# K15b
# ---------------------------------------------------------------------------

def _leaves(cols):
    return [t for c in cols for t in (c.data, c.validity, c.lengths)
            if t is not None]


def _run_plan(words, nspans, ntiles, leaves, tile, seen):
    """Execute a K15b plan on CPU bytes, tile by tile, as the kernel's
    blocks do; ``seen`` counts the writes of each output byte."""
    views = sorted((t.data_ptr(), id(t), t.reshape(-1).view(torch.uint8))
                   for t in leaves if t.numel())
    bases = [v[0] for v in views]

    def at(addr, n):
        i = bisect.bisect_right(bases, addr) - 1
        for base, _i, b in views[max(i - 2, 0):i + 1]:
            if base <= addr and addr + n <= base + b.numel():
                return b[addr - base:addr - base + n]
        raise AssertionError(f"{n} bytes at {addr:#x} lie outside every "
                             "leaf")

    spans = [words[ME.SPAN_WORDS * i:ME.SPAN_WORDS * (i + 1)]
             for i in range(nspans)]
    starts = words[ME.SPAN_WORDS * nspans:]
    assert len(starts) == nspans + 1 and starts[0] == 0
    assert starts[-1] == ntiles
    for s, (src, dst, rows, sw, dw) in enumerate(spans):
        assert rows > 0 and 0 < sw <= dw
        for k in range(starts[s + 1] - starts[s]):
            if sw == dw:
                lo = k * tile
                n = min(tile, rows * dw - lo)
                assert n > 0
                at(dst + lo, n)[:] = at(src + lo, n)
                seen[(dst + lo, n)] = seen.get((dst + lo, n), 0) + 1
            else:
                per = max(1, tile // dw)
                r0 = k * per
                nr = min(per, rows - r0)
                assert nr > 0
                o = at(dst + r0 * dw, nr * dw).view(nr, dw)
                o[:, :sw] = at(src + r0 * sw, nr * sw).view(nr, sw)
                o[:, sw:] = 0
                seen[(dst + r0 * dw, nr * dw)] = \
                    seen.get((dst + r0 * dw, nr * dw), 0) + 1


def _segment(rng, n: int, w: int) -> list[DeviceColumn]:
    """One source's columns: int8, int16, int32, int64, float64, bool, a
    string of width ``w`` and an int32 array of width ``w // 4 + 1``."""
    def valid():
        return torch.from_numpy(rng.random(n) < 0.8)

    cols = []
    for np_t, dt in ((np.int8, T.ByteType()), (np.int16, T.ShortType()),
                     (np.int32, T.IntegerType()), (np.int64, T.LongType()),
                     (np.float64, T.DoubleType())):
        cols.append(DeviceColumn(torch.from_numpy(
            rng.integers(-99, 99, n).astype(np_t)), valid(), dt))
    cols.append(DeviceColumn(torch.from_numpy(rng.random(n) < .5), valid(),
                             T.BooleanType()))
    cols.append(DeviceColumn(
        torch.from_numpy(rng.integers(0, 256, (n, w)).astype(np.uint8)),
        valid(), T.StringType(),
        torch.from_numpy(rng.integers(0, w + 1, n).astype(np.int32))))
    aw = w // 4 + 1
    cols.append(DeviceColumn(
        torch.from_numpy(rng.integers(-5, 5, (n, aw)).astype(np.int32)),
        valid(), T.ArrayType(T.IntegerType()),
        torch.from_numpy(rng.integers(0, aw + 1, n).astype(np.int32))))
    return cols


@pytest.mark.parametrize("seed", range(12))
def test_k15b_plan_matches_plain(seed):
    """Fuzzed destinations (P 1-64, odd row counts, 0-row sources between
    non-empty ones, string and array widths that differ between sources,
    tiles down to 16 bytes, so spans under a tile and under 16 bytes):
    the plan, executed on CPU bytes, gives mesh_unpack_plain's columns,
    and writes every output byte exactly once."""
    rng = np.random.default_rng(seed)
    p = [1, 2, 3, 8, 64][seed % 5]
    counts = [0 if rng.random() < 0.25 else int(rng.integers(1, 40))
              for _ in range(p)]
    if sum(counts) == 0:
        counts[-1] = 3
    segments = [_segment(rng, c, int(rng.choice([4, 8, 13, 16, 64])))
                for c in counts]
    out = ME.unpack_outputs(segments, counts, CPU)
    for c in out:  # poison: every byte must be written
        c.data.view(torch.uint8).fill_(0xA5)
        c.validity.view(torch.uint8).fill_(7)
        if c.lengths is not None:
            c.lengths.fill_(-9)
    tile = [16, 48, 1000, ME.UNPACK_TILE][seed % 4]
    words, nspans, ntiles = ME.unpack_plan(segments, counts, out, tile)
    seen = {}
    _run_plan(words, nspans, ntiles,
              [t for s in segments for t in _leaves(s)] + _leaves(out),
              tile, seen)
    want = ME.mesh_unpack_plain(segments, counts)
    for g, w in zip(out, want):
        assert torch.equal(g.data, w.data)
        assert torch.equal(g.validity, w.validity)
        assert (g.lengths is None) == (w.lengths is None)
        assert g.lengths is None or torch.equal(g.lengths, w.lengths)
    # every output byte covered by exactly one tile
    cover = {t.data_ptr(): torch.zeros(t.numel() * t.element_size(),
                                       dtype=torch.int32)
             for t in _leaves(out) if t.numel()}
    for (addr, n), k in seen.items():
        assert k == 1
        base = max(b for b in cover if b <= addr)
        cover[base][addr - base:addr - base + n] += 1
    assert all(bool((c == 1).all()) for c in cover.values())


def test_k15b_plan_tables_and_sections():
    """Sections of a K15a send buffer (16-byte aligned blocks) and shard
    columns at odd row offsets mix in one plan; the table outgrows the
    kernel's parameters only at a large mesh (P 4096), where the wrapper
    hands the kernel a device copy."""
    rng = np.random.default_rng(5)
    src = _segment(rng, 37, 8)
    counts = [5, 0, 11, 21]
    perm = torch.arange(37, dtype=torch.int32)
    buf, (sections, blocks) = ME.mesh_pack(src, perm, counts)
    segs = [ME.section_columns(buf[sections[d]:sections[d + 1]], src,
                               counts[d], blocks[d], sections[d])
            for d in range(4)]
    # shard columns: a slice at an odd row offset beside the sections
    shard = [DeviceColumn(c.data[3:10], c.validity[3:10], c.dtype,
                          None if c.lengths is None else c.lengths[3:10])
             for c in _segment(rng, 12, 16)]
    segments, cnt = segs + [shard], counts + [7]
    out = ME.unpack_outputs(segments, cnt, CPU)
    words, nspans, ntiles = ME.unpack_plan(segments, cnt, out)
    assert len(words) == 6 * nspans + 1 <= ME.UNPACK_PARAM_WORDS
    seen = {}
    _run_plan(words, nspans, ntiles,
              [buf] + [t for s in segments[4:] for t in _leaves(s)]
              + _leaves(out), ME.UNPACK_TILE, seen)
    for g, w in zip(out, ME.mesh_unpack_plain(segments, cnt)):
        assert torch.equal(g.data, w.data)
        assert torch.equal(g.validity, w.validity)
        assert g.lengths is None or torch.equal(g.lengths, w.lengths)
    # P 4096, one row each, one int32 column: 2 spans a source
    col = DeviceColumn(torch.arange(4096, dtype=torch.int32),
                       torch.ones(4096, dtype=torch.bool), T.IntegerType())
    big = [[DeviceColumn(col.data[i:i + 1], col.validity[i:i + 1],
                         col.dtype)] for i in range(4096)]
    out = ME.unpack_outputs(big, [1] * 4096, CPU)
    words, nspans, ntiles = ME.unpack_plan(big, [1] * 4096, out)
    assert nspans == ntiles == 8192
    assert len(words) > ME.UNPACK_PARAM_WORDS


def test_k15b_plan_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(8)
    seg = _segment(rng, 6, 8)
    bad_valid = [DeviceColumn(c.data, c.validity.to(torch.uint8), c.dtype,
                              c.lengths) for c in seg]
    strided = [DeviceColumn(c.data[::2], c.validity[::2], c.dtype,
                            None if c.lengths is None else c.lengths[::2])
               for c in seg]
    for segs, counts in (([seg, bad_valid], [6, 6]),
                         ([seg, strided], [6, 3]),
                         ([seg, seg], [6, 5])):
        out = ME.unpack_outputs(segs, counts, CPU)
        with pytest.raises(ValueError, match="segment column"):
            ME.unpack_plan(segs, counts, out)


def test_k15b_wrapper_launches_or_raises_off_the_cpu(monkeypatch):
    monkeypatch.setattr(ME.native, "lib", _no_kernel)
    seg = [_meta(c) for c in _segment(np.random.default_rng(2), 4, 8)]
    before = ME.mesh_unpack.launches
    with pytest.raises(RuntimeError, match="no mesh_exchange kernel"):
        ME.mesh_unpack([seg, seg], [4, 4])
    assert ME.mesh_unpack.launches == before


def test_arrow_batches_take_the_same_plan():
    """Columns as the scan makes them (pyarrow, power-of-two string
    widths) through the plan, against the plain version."""
    rng = np.random.default_rng(11)
    batches = []
    for n, words in ((9, ["a", "bb", None]), (0, ["x"]),
                     (14, ["longer string", "", None])):
        rb = pa.record_batch([
            pa.array(rng.integers(0, 9, n).astype(np.int32)),
            pa.array([words[i % len(words)] for i in range(n)],
                     pa.string())], names=["i", "s"])
        batches.append(ColumnBatch.from_arrow(rb, CPU, codec=False))
    segs = [b.columns for b in batches]
    counts = [b.num_rows for b in batches]
    out = ME.unpack_outputs(segs, counts, CPU)
    words, nspans, ntiles = ME.unpack_plan(segs, counts, out)
    _run_plan(words, nspans, ntiles,
              [t for s in segs for t in _leaves(s)] + _leaves(out),
              ME.UNPACK_TILE, {})
    for g, w in zip(out, ME.mesh_unpack_plain(segs, counts)):
        assert torch.equal(g.data, w.data)
        assert torch.equal(g.validity, w.validity)


# ---------------------------------------------------------------------------
# the constants each wrapper shares with its kernel
# ---------------------------------------------------------------------------

def _cuda_int(src: str, name: str) -> int:
    """The value of ``constexpr ... name = <int expression>;`` in src."""
    m = re.search(rf"constexpr [\w ]+ {name} = ([\d *]+);", src)
    assert m, name
    return eval(m.group(1))


@pytest.mark.parametrize("name,consts", [
    ("range_partition", ["sizeof(SortKey)", "kParamKeys", "kTopWords",
                         "kSharedBytes"]),
    ("mesh_exchange", ["kSpanWords", "kTileBytes", "kUnpackSmallWords",
                       "kUnpackLargeWords"])])
def test_shared_limits_match_the_cuda_source(name, consts):
    """The constants a wrapper registers with ``native.share_limits`` are
    the ones its ``srt_<name>_limits`` reports, in the same order: here
    read from the source (on the card the loader compares them)."""
    src = (Path(native.CSRC) / native.SOURCES[name]).read_text()
    assert re.search(rf"\bint srt_{name}_limits\(", src)
    want = []
    for c in consts:
        if c == "sizeof(SortKey)":
            key = (Path(native.CSRC) / "sort_key.cuh").read_text()
            body = re.search(r"struct SortKey \{([^}]*)\};", key).group(1)
            assert set(re.findall(r"\b(long long|\w+)\s+\w", body)) \
                == {"long long"}
            want.append(len(re.findall(r"\w+\s*[,;]", body)))
        else:
            want.append(_cuda_int(src, c))
    assert native._LIMITS[name] == tuple(want)
    assert (RP.KEY_WORDS, RP.PARAM_KEYS, RP.TOP_WORDS, RP.SHARED_BYTES) \
        == native._LIMITS["range_partition"]
    assert (ME.SPAN_WORDS, ME.UNPACK_TILE, ME.UNPACK_SMALL_WORDS,
            ME.UNPACK_PARAM_WORDS) == native._LIMITS["mesh_exchange"]
