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
LSD radix sort of ``csrc/sort.cu``, which packs those operands into wide
order-preserving integers; on the CPU its plain version chains stable
``torch.sort`` calls from the least significant operand up, in int64 and
float64 (torch on the CPU has no uint32 shifts or adds).

Port batches have no padding rows, so the reference's leading pad flag is
constant here and drops out.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import (gather_columns, num_tiles,
                                                ptr)

__all__ = ["SortOrder", "sort_batch", "sort_permutation",
           "sort_permutation_plain", "encode_key_operands",
           "normalize_floats", "chain_sort", "pack_keys", "packed_width"]


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
# CUDA: packed keys + LSD radix sort (csrc/sort.cu)
# ---------------------------------------------------------------------------

_KIND_INT, _KIND_FLOAT, _KIND_BOOL, _KIND_STRING = 0, 1, 2, 3


def key_layout(col: DeviceColumn, width: int | None = None
               ) -> tuple[int, int, int]:
    """(kind, item, bits) of a key column in the packed key: item is the
    byte size (the packed width W for strings: ``width``, default the
    matrix's); bits counts the null indicator and every field
    (csrc/sort.cu encode_kernel)."""
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


def packed_width(col: DeviceColumn) -> int:
    """The smallest packed width of a string key: its matrix width
    rounded up to a multiple of 4."""
    return -(-col.max_len // 4) * 4


def pack_keys(cols: list[DeviceColumn], orders: list[SortOrder],
              widths: list[int | None] | None = None) -> torch.Tensor:
    """K1's packed order-preserving key of ``cols`` (one ``SortOrder``
    each, for its direction and null order) on their CUDA device: int64
    limbs ``[nlimbs, n]``, limb 0 least significant, the first column in
    the most significant bits.  ``widths[i]`` is the packed width of a
    string column (default :func:`packed_width`); rows packed at the same
    widths compare as their keys do."""
    lib = native.lib("sort")
    n = cols[0].capacity
    dev = cols[0].device
    if widths is None:
        widths = [None] * len(cols)
    widths = [packed_width(c) if c.is_string and w is None else w
              for c, w in zip(cols, widths)]
    layouts = [key_layout(c, w) for c, w in zip(cols, widths)]
    total = sum(bits for _k, _i, bits in layouts)
    limbs = torch.zeros((max(1, (total + 63) // 64), n), dtype=torch.int64,
                        device=dev)
    pos = 0
    # least significant key first
    for o, c, (kind, item, bits) in reversed(list(zip(orders, cols,
                                                      layouts))):
        data = c.data.contiguous()
        row_bytes = item
        if kind == _KIND_STRING:
            row_bytes = packed_width(c)
            if row_bytes != c.max_len:
                data = torch.nn.functional.pad(data,
                                               (0, row_bytes - c.max_len))
            elif data.data_ptr() % 4:
                data = data.clone()
        valid = c.validity.contiguous()
        lens = None if c.lengths is None else c.lengths.contiguous()
        native.check(lib.srt_sort_encode(
            ptr(data), ptr(valid), ptr(lens), kind, row_bytes, item,
            int(o.ascending), int(o.resolved_nulls_first), pos, ptr(limbs),
            n, native.stream_ptr(dev)), "srt_sort_encode")
        pos += bits
    return limbs


def _sort_permutation_cuda(batch: ColumnBatch,
                           orders: list[SortOrder]) -> torch.Tensor:
    lib = native.lib("sort")
    n = batch.num_rows
    dev = batch.device
    stream = native.stream_ptr(dev)
    limbs = pack_keys([batch.columns[o.child_index] for o in orders],
                      orders)
    nlimbs = limbs.shape[0]
    or_and = torch.tensor([0, -1] * nlimbs, dtype=torch.int64, device=dev)
    native.check(lib.srt_sort_or_and(ptr(limbs), n, nlimbs, ptr(or_and),
                                     stream), "srt_sort_or_and")
    oa = [v & 0xFFFFFFFFFFFFFFFF for v in or_and.tolist()]
    nt = num_tiles(n)
    perm = None
    bufs = None
    for li in range(nlimbs):
        varying = oa[2 * li] ^ oa[2 * li + 1]
        mask = sum(1 << d for d in range(8) if (varying >> (8 * d)) & 0xFF)
        if not mask:
            continue
        if bufs is None:
            bufs = dict(
                keys_a=torch.empty(n, dtype=torch.int64, device=dev),
                keys_b=torch.empty(n, dtype=torch.int64, device=dev),
                vals=[torch.empty(n, dtype=torch.int32, device=dev)
                      for _ in range(3)],
                counts=torch.empty(256 * nt, dtype=torch.int32, device=dev),
                offsets=torch.empty(256 * nt + 1, dtype=torch.int32,
                                    device=dev))
        a, b = [v for v in bufs["vals"] if v is not perm][:2]
        where = ctypes.c_int(-1)
        native.check(lib.srt_sort_limb(
            ptr(limbs[li]), ptr(perm), n, mask, ptr(bufs["keys_a"]),
            ptr(bufs["keys_b"]), ptr(a), ptr(b), ptr(bufs["counts"]),
            ptr(bufs["offsets"]), ctypes.byref(where), stream),
            "srt_sort_limb")
        perm = a if where.value == 0 else b
    if perm is None:
        perm = torch.arange(n, dtype=torch.int32, device=dev)
    sort_permutation.launches += 1
    return perm


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
