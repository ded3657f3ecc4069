"""Lexicographic sort with Spark null ordering (K1).

Port of ``spark_rapids_tpu/ops/sort.py``.  The reference sorts one stable
multi-operand ``lax.sort`` over, per key column, a null indicator and the
encoded key (``encode_key_operands``):

* ints/date/timestamp: the value (descending: bitwise NOT);
* bool: the value as 0/1 (descending: inverted);
* floats: a NaN flag (NaN is the largest value) and the value with NaN and
  -0.0 mapped to +0.0 (descending: negated);
* strings: the byte matrix as big-endian uint32 words, then the length
  (descending: every word and the length inverted).

``sort_permutation`` returns the same permutation.  On CUDA it runs the
LSD radix sort of ``csrc/sort.cu`` over only the key bits that vary: one
kernel reduces each order-preserving key field's OR and AND over the rows
(the call's one host read), :func:`sort_plan` keeps the bits where they
differ, a second kernel packs them into one 32-bit word or a few 64-bit
words, and an onesweep pass sorts each 8-bit digit (an upsweep and a scan
a word, one scatter a digit).  On the CPU its plain version chains stable
``torch.sort`` calls from the least significant operand up, in int64 and
float64 (torch on the CPU has no uint32 shifts or adds).

Port batches have no padding rows, so the reference's leading pad flag is
constant here and drops out.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import gather_columns, ptr

__all__ = ["SortOrder", "sort_batch", "sort_permutation",
           "sort_permutation_plain", "encode_key_operands",
           "normalize_floats", "chain_sort", "pack_keys", "packed_width",
           "key_layout", "key_field_bits", "SortPlan", "sort_plan",
           "segment_words", "digit_passes", "varying_masks"]


@dataclass(frozen=True)
class SortOrder:
    """One sort key: column index + direction + null ordering."""
    child_index: int
    ascending: bool = True
    nulls_first: bool | None = None  # None = Spark default (first iff asc)

    @property
    def resolved_nulls_first(self) -> bool:
        if self.nulls_first is None:
            return self.ascending  # Spark: asc -> nulls first, desc -> last
        return self.nulls_first


def normalize_floats(x: torch.Tensor) -> torch.Tensor:
    """-0.0 -> +0.0 (NaN passes through)."""
    return torch.where(x == 0, torch.zeros((), dtype=x.dtype,
                                           device=x.device), x)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def string_key_words(col: DeviceColumn) -> list[torch.Tensor]:
    """Byte matrix -> big-endian uint32 words, each held in int64."""
    w = col.max_len
    nwords = (w + 3) // 4
    data = col.data
    if w % 4:
        data = torch.nn.functional.pad(data, (0, 4 * nwords - w))
    b = data.reshape(col.capacity, nwords, 4).to(torch.int64)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return [words[:, i] for i in range(nwords)]


def encode_key_operands(col: DeviceColumn, ascending: bool = True
                        ) -> list[torch.Tensor]:
    """A column's sort operands, most significant first, as int64 or
    float64 tensors ordered exactly as the reference's operands."""
    dt = col.dtype
    if isinstance(dt, T.StringType):
        words = string_key_words(col) + [col.lengths.to(torch.int64)]
        return words if ascending else [-wd for wd in words]
    if isinstance(dt, T.BooleanType):
        v = col.data.to(torch.int64)
        return [v] if ascending else [1 - v]
    if dt.fractional:
        x = normalize_floats(col.data.to(torch.float64))
        isnan = torch.isnan(x)
        nan_key = (isnan if ascending else ~isnan).to(torch.int64)
        v = torch.where(isnan, torch.zeros((), dtype=x.dtype,
                                           device=x.device), x)
        return [nan_key, v if ascending else -v]
    v = col.data.to(torch.int64)
    return [v] if ascending else [~v]


def chain_sort(operands: list[torch.Tensor], n: int,
               device) -> torch.Tensor:
    """Stable lexicographic argsort (operands most significant first) by
    stable sorts from the least significant operand up; int64 result."""
    perm = torch.arange(n, dtype=torch.int64, device=device)
    for op in reversed(operands):
        _, idx = torch.sort(op[perm], stable=True)
        perm = perm[idx]
    return perm


def _operands(batch: ColumnBatch, orders: list[SortOrder]) -> list:
    ops: list[torch.Tensor] = []
    for o in orders:
        col = batch.columns[o.child_index]
        # reference null indicator: valid rows 1 under nulls-first, 0 else
        nf = o.resolved_nulls_first
        ops.append((col.validity if nf else ~col.validity).to(torch.int64))
        ops.extend(encode_key_operands(col, o.ascending))
    return ops


def sort_permutation_plain(batch: ColumnBatch,
                           orders: list[SortOrder]) -> torch.Tensor:
    """Plain PyTorch version of :func:`sort_permutation` (any device)."""
    perm = chain_sort(_operands(batch, orders), batch.num_rows, batch.device)
    return perm.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA: key plan, compacted encode, onesweep LSD radix sort (csrc/sort.cu)
# ---------------------------------------------------------------------------

_KIND_INT, _KIND_FLOAT, _KIND_BOOL, _KIND_STRING = 0, 1, 2, 3

#: int64 words of one key descriptor (csrc/sort_key.cuh ``SortKey``)
KEY_WORDS = 8
#: most keys whose descriptors travel in the kernels' parameters
#: (csrc/sort.cu ``kParamKeys``); more are read from a device copy
PARAM_KEYS = 32
#: most segments in the encode kernel's parameters (``kLargeSegs``);
#: more are read from a device copy
LARGE_SEGS = 2048
#: rows of a plan, upsweep or scatter tile (``kSortTile``)
SORT_TILE = 4096
#: most blocks of a plan launch (``kPlanBlocks``): one partial each
PLAN_BLOCKS = 1056
#: digit passes of a 64-bit word (``kMaxPasses``)
MAX_PASSES = 8
#: the most rows K1 sorts on the card (``kMaxRows``): look-back counts
#: hold 30 bits
MAX_ROWS = (1 << 30) - 1
_RADIX = 256
# the kernel library must report the same constants when it is loaded
native.share_limits("sort", (KEY_WORDS, PARAM_KEYS, LARGE_SEGS, SORT_TILE,
                             PLAN_BLOCKS, MAX_PASSES, MAX_ROWS))


def key_layout(col: DeviceColumn, width: int | None = None
               ) -> tuple[int, int, int]:
    """(kind, item, bits) of a key column in the packed key: item is the
    byte size (the packed width W for strings: ``width``, default the
    matrix's); bits counts the null indicator and every field
    (csrc/sort_key.cuh key_field)."""
    dt = col.dtype
    if isinstance(dt, T.StringType):
        w = col.max_len if width is None else width
        if w % 4:
            raise ValueError(f"string width {w} is not a multiple of 4")
        return _KIND_STRING, w, 1 + 32 * (w // 4) + w.bit_length()
    if isinstance(dt, T.BooleanType):
        return _KIND_BOOL, 1, 2
    item = col.data.element_size()
    if dt.fractional:
        return _KIND_FLOAT, item, 2 + 8 * item
    return _KIND_INT, item, 1 + 8 * item


def key_field_bits(kind: int, item: int) -> list[int]:
    """Bit widths of a key's fields, most significant first
    (csrc/sort_key.cuh ``key_field``): the null indicator, then the value
    (a float: its NaN flag and the value; a string at packed width
    ``item``: a 32-bit word per 4 bytes and the length).  They add up to
    :func:`key_layout`'s bits."""
    if kind == _KIND_STRING:
        return [1] + [32] * (item // 4) + [item.bit_length()]
    if kind == _KIND_BOOL:
        return [1, 1]
    if kind == _KIND_FLOAT:
        return [1, 1, 8 * item]
    return [1, 8 * item]


def packed_width(col: DeviceColumn) -> int:
    """The smallest packed width of a string key: its matrix width
    rounded up to a multiple of 4."""
    return -(-col.max_len // 4) * 4


@dataclass(frozen=True)
class SortPlan:
    """Where K1's kept key bits go (:func:`sort_plan`): ``bits`` in all,
    in 64-bit words (``wide``) or one 32-bit word; ``words`` the bits of
    each word, least significant first; ``segments`` the runs ``(key,
    field, shift, length, word, dst)``: bits ``[shift, shift + length)``
    of field ``field`` of key ``key`` (0 = the most significant key and
    field) go to bits ``[dst, dst + length)`` of word ``word``, in word
    order."""
    bits: int
    wide: bool
    words: tuple
    segments: tuple

    @property
    def passes(self) -> tuple:
        """Each word's digit passes (:func:`digit_passes`)."""
        return tuple(digit_passes(b) for b in self.words)


def digit_passes(bits: int) -> tuple:
    """``(shift, width)`` of the 8-bit digits of a word of ``bits`` bits,
    least significant first; the last is only as wide as what is left
    (csrc/sort.cu ``sort_word``)."""
    return tuple((s, min(8, bits - s)) for s in range(0, bits, 8))


def varying_masks(partials, field_bits: list[list[int]]) -> list[list[int]]:
    """Fold the plan kernel's per-block results (uint64 ``[2 * nfields,
    blocks]``: row 2g the OR of field g over each block's rows, row 2g + 1
    its AND, fields in key order; a block without rows gives 0 and ~0)
    into each field's varying bits, per key: a bit set in some rows and
    clear in others, OR & ~AND (OR ^ AND where there are rows, nothing
    where there are none)."""
    nfields = sum(map(len, field_bits))
    part = np.asarray(partials, dtype=np.uint64).reshape(2 * nfields, -1)
    ors = np.bitwise_or.reduce(part[0::2], axis=1)
    ands = np.bitwise_and.reduce(part[1::2], axis=1)
    flat = (ors & ~ands).tolist()
    out, at = [], 0
    for fb in field_bits:
        out.append(flat[at:at + len(fb)])
        at += len(fb)
    return out


def sort_plan(field_bits: list[list[int]], masks: list[list[int]],
              wide: bool | None = None) -> SortPlan:
    """The compaction of the bits set in ``masks`` (per key, per field,
    most significant first, as :func:`key_field_bits`): packed from the
    least significant field's lowest bit up, so that the first key lands
    in the most significant bits, into one 32-bit word where they fit
    (``wide`` None) else 64-bit words.  Kept bits order rows as the whole
    key does when every other bit is the same in all of them.  Every mask
    at ``(1 << bits) - 1`` with ``wide`` True gives :func:`pack_keys`'
    limbs."""
    runs = []
    for k in range(len(field_bits) - 1, -1, -1):
        for f in range(len(field_bits[k]) - 1, -1, -1):
            m, shift = int(masks[k][f]) & ((1 << field_bits[k][f]) - 1), 0
            while m:
                low = (m & -m).bit_length() - 1
                m >>= low
                shift += low
                length = (m ^ (m + 1)).bit_length() - 1  # trailing ones
                runs.append((k, f, shift, length))
                m >>= length
                shift += length
    total = sum(r[3] for r in runs)
    if wide is None:
        wide = total > 32
    wb = 64 if wide else 32
    segs, pos = [], 0
    for k, f, shift, length in runs:
        while length:
            word, dst = divmod(pos, wb)
            take = min(length, wb - dst)
            segs.append((k, f, shift, take, word, dst))
            shift += take
            length -= take
            pos += take
    words = tuple(min(wb, total - w) for w in range(0, total, wb))
    return SortPlan(total, wide, words, tuple(segs))


def segment_words(plan: SortPlan) -> list[int]:
    """The plan's segments as csrc/sort.cu's encode kernel reads them, one
    int64 each: the shift, length - 1 and dst (6 bits each), the field and
    the key (16 bits each), and bit 50 on the last segment of a word."""
    segs = plan.segments
    out = []
    for i, (k, f, shift, length, word, dst) in enumerate(segs):
        if k > 0xFFFF or f > 0xFFFF:
            raise ValueError(f"sort key {k} field {f}: at most 65536 keys "
                             "and fields a key")
        end = i + 1 == len(segs) or segs[i + 1][4] != word
        out.append(shift | (length - 1) << 6 | dst << 12 | f << 18
                   | k << 34 | int(end) << 50)
    return out


def _key_descriptors(cols: list[DeviceColumn], orders: list[SortOrder],
                     widths: list[int | None] | None = None):
    """K1's descriptor words of the key columns (:data:`KEY_WORDS` a key,
    csrc/sort_key.cuh ``SortKey``: data, validity and lengths addresses,
    kind, item (a string's matrix width), packed width, asc,
    nulls_first), each key's field bits, and the tensors they point to.
    A string key packs at ``widths[i]`` (default :func:`packed_width`),
    read in place at its matrix width.  Raises unless every key has the
    first's rows on its device."""
    words, field_bits, keep = [], [], []
    n = cols[0].capacity
    gdev = cols[0].data.get_device()
    if widths is None:
        widths = [None] * len(cols)
    for c, o, w in zip(cols, orders, widths):
        if c.capacity != n or c.data.get_device() != gdev:
            raise ValueError(f"sort key of {c.capacity} rows on "
                             f"{c.data.device}: {n} rows on "
                             f"{cols[0].data.device} expected")
        if c.is_string and w is None:
            w = packed_width(c)
        kind, item, _bits = key_layout(c, w)
        d, v = c.data.contiguous(), c.validity.contiguous()
        ln = None
        if kind == _KIND_STRING:
            ln = c.lengths.to(torch.int32).contiguous()
            words += (d.data_ptr(), v.data_ptr(), ln.data_ptr(), kind,
                      c.max_len, item, int(o.ascending),
                      int(o.resolved_nulls_first))
        else:
            words += (d.data_ptr(), v.data_ptr(), 0, kind, item, 0,
                      int(o.ascending), int(o.resolved_nulls_first))
        field_bits.append(key_field_bits(kind, item))
        keep += (d, v, ln)
    return words, field_bits, keep


def _encode(lib, keys, nkeys: int, plan: SortPlan, n: int, out: int,
            zero: int | None, nzero: int, dev, stream) -> None:
    """Pack the plan's bits of every row into the words at address
    ``out`` (csrc/sort.cu ``srt_sort_encode``); zero the ``nzero`` uint32
    at ``zero`` in the same launch."""
    host, keys_dev = keys
    segs = segment_words(plan)
    seg_host, segs_dev = native.param_table(segs, len(segs) > LARGE_SEGS,
                                            dev)
    native.check(lib.srt_sort_encode(
        host.buffer_info()[0], ptr(keys_dev), nkeys, seg_host.buffer_info()[0],
        ptr(segs_dev), len(segs), int(plan.wide), n, out, zero, nzero,
        stream), "srt_sort_encode")


def pack_keys(cols: list[DeviceColumn], orders: list[SortOrder],
              widths: list[int | None] | None = None) -> torch.Tensor:
    """K1's packed order-preserving key of ``cols`` (one ``SortOrder``
    each, for its direction and null order) on their CUDA device: int64
    limbs ``[nlimbs, n]``, limb 0 least significant, the first column in
    the most significant bits.  ``widths[i]`` is the packed width of a
    string column (default :func:`packed_width`); rows packed at the same
    widths compare as their keys do.  Every bit is kept: the sort's own
    encode with each field's whole mask."""
    lib = native.lib("sort")
    n = cols[0].capacity
    words, field_bits, _keep = _key_descriptors(cols, orders, widths)
    dev = cols[0].device
    plan = sort_plan(field_bits, [[(1 << b) - 1 for b in fb]
                                  for fb in field_bits], wide=True)
    limbs = torch.empty((len(plan.words), n), dtype=torch.int64, device=dev)
    _encode(lib, native.param_table(words, len(cols) > PARAM_KEYS, dev),
            len(cols), plan, n, limbs.data_ptr(), None, 0, dev,
            native.stream_ptr(dev))
    return limbs


def _sort_permutation_cuda(batch: ColumnBatch,
                           orders: list[SortOrder]) -> torch.Tensor:
    lib = native.lib("sort")
    n = batch.num_rows
    if n > MAX_ROWS:
        raise ValueError(f"K1 sorts at most {MAX_ROWS} rows, got {n}")
    dev = batch.device
    stream = native.stream_ptr(dev)
    nkeys = len(orders)
    words, field_bits, _keep = _key_descriptors(
        [batch.columns[o.child_index] for o in orders], orders)
    keys = native.param_table(words, nkeys > PARAM_KEYS, dev)
    nfields = sum(map(len, field_bits))
    ntiles = -(-n // SORT_TILE)
    grid = min(PLAN_BLOCKS, ntiles)
    partials = torch.empty((2 * nfields, grid), dtype=torch.int64,
                           device=dev)
    native.check(lib.srt_sort_plan(
        keys[0].buffer_info()[0], ptr(keys[1]), nkeys, nfields, n,
        ptr(partials), grid, stream), "srt_sort_plan")
    sort_permutation.launches += 1
    # the permutation's buffers, allocated while the plan kernel runs
    vals = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    # the call's one host read: which bits of the key vary
    plan = sort_plan(field_bits, varying_masks(
        partials.cpu().numpy().view(np.uint64), field_bits))
    if not plan.bits:
        return torch.arange(n, dtype=torch.int32, device=dev)
    nw = len(plan.words)
    kb = 8 if plan.wide else 4
    passes = max(len(p) for p in plan.passes)
    hist_words = MAX_PASSES * _RADIX
    # one scratch buffer: the encoded words, two key buffers where a word
    # takes more than one pass, then uint32 histograms (a set a word),
    # digit offsets, tickets and the look-back state
    wbytes = kb * n
    ints_at = (nw + (2 if passes > 1 else 0)) * wbytes
    nints = (nw + 1) * hist_words + MAX_PASSES + passes * ntiles * _RADIX
    work = torch.empty(ints_at + 4 * nints, dtype=torch.uint8, device=dev)
    at = work.data_ptr()
    keys_a = at + nw * wbytes
    hist = at + ints_at
    base = hist + 4 * nw * hist_words
    tickets = base + 4 * hist_words
    status = tickets + 4 * MAX_PASSES
    _encode(lib, keys, nkeys, plan, n, at, hist, nw * hist_words, dev,
            stream)
    if nw > 1:  # a later word's first pass reads the permutation so far
        vals.append(torch.empty(n, dtype=torch.int32, device=dev))
    cur = None
    for w, bits in enumerate(plan.words):
        a, b = [i for i in range(len(vals)) if i != cur][:2]
        where = ctypes.c_int(-1)
        native.check(lib.srt_sort_word(
            at + w * wbytes, kb, bits,
            None if cur is None else vals[cur].data_ptr(), n, keys_a,
            keys_a + wbytes, vals[a].data_ptr(), vals[b].data_ptr(),
            hist + 4 * w * hist_words, base, status, tickets,
            ctypes.byref(where), stream), "srt_sort_word")
        cur = a if where.value == 0 else b
    return vals[cur]


def sort_permutation(batch: ColumnBatch,
                     orders: list[SortOrder]) -> torch.Tensor:
    """The stable permutation (int32[num_rows]) that sorts the batch."""
    if batch.device.type == "cpu":
        return sort_permutation_plain(batch, orders)
    if batch.num_rows == 0:
        return torch.empty(0, dtype=torch.int32, device=batch.device)
    return _sort_permutation_cuda(batch, orders)


sort_permutation.launches = 0


def sort_batch(batch: ColumnBatch, orders: list[SortOrder]) -> ColumnBatch:
    perm = sort_permutation(batch, orders)
    cols = gather_columns(batch.columns, perm)
    return ColumnBatch(cols, batch.num_rows, batch.schema, batch.device)
