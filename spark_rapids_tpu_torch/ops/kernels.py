"""Core batch kernels: compaction (K2), gather (K3), concat, slice.

Port of ``spark_rapids_tpu/ops/kernels.py``.  ``compact`` and
``gather_columns`` each have a hand-written CUDA kernel
(``csrc/compact.cu``, ``csrc/gather.cu``) and, beside it, a plain PyTorch
version of the same function.  A wrapper takes the plain version only for
a tensor on the CPU; on a CUDA tensor it launches its kernel or raises.
Each wrapper counts its kernel launches in its ``launches`` attribute.

``concat_batches`` is a plain ``torch.cat``: port batches carry no
padding, so there are no real rows to front-pack.
"""
from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import native

__all__ = ["compact", "compact_plain", "gather_columns", "gather_plain",
           "gather_table", "vec_bytes", "take", "concat_batches",
           "slice_batch", "slice_rows", "TILE"]

#: rows per tile of the flag-scan kernels (csrc/common.cuh kTile)
TILE = 4096


def ptr(t: torch.Tensor | None) -> int | None:
    """Raw device address of a contiguous tensor (None passes NULL)."""
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    return t.data_ptr()


def num_tiles(n: int) -> int:
    return (n + TILE - 1) // TILE


def _empty_like_rows(col: DeviceColumn, m: int) -> DeviceColumn:
    dev = col.data.device
    data = torch.empty((m,) + tuple(col.data.shape[1:]), dtype=col.data.dtype,
                       device=dev)
    lengths = None if col.lengths is None else \
        torch.empty(m, dtype=torch.int32, device=dev)
    return DeviceColumn(data, torch.empty(m, dtype=torch.bool, device=dev),
                        col.dtype, lengths)


def _contig(col: DeviceColumn) -> DeviceColumn:
    if col.data.is_contiguous() and col.validity.is_contiguous() and (
            col.lengths is None or col.lengths.is_contiguous()):
        return col
    return DeviceColumn(col.data.contiguous(), col.validity.contiguous(),
                        col.dtype, None if col.lengths is None
                        else col.lengths.contiguous())


# ---------------------------------------------------------------------------
# K2: compaction
# ---------------------------------------------------------------------------

def compact(batch: ColumnBatch, keep: torch.Tensor) -> ColumnBatch:
    """Filter: keep rows where ``keep`` (bool[num_rows]) is True, in order.

    Null slots of the output are zeroed.  On CUDA this syncs once, to read
    the output row count."""
    if keep.device.type == "cpu":
        return compact_plain(batch, keep)
    return _compact_cuda(batch, keep)


compact.launches = 0


def compact_plain(batch: ColumnBatch, keep: torch.Tensor) -> ColumnBatch:
    """Plain PyTorch version of :func:`compact` (any device)."""
    idx = torch.nonzero(keep, as_tuple=False).squeeze(1)
    cols = [_gather_column_plain(c, idx) for c in batch.columns]
    return ColumnBatch(cols, idx.numel(), batch.schema, batch.device)


#: K2's look-back status by (device, stream): zero between launches (the
#: last tile of each count launch clears it), grown as needed
_STATUS: dict = {}
#: table words of the copy kernel's small and large parameter struct
#: (csrc/compact.cu ``kSmallWords``, ``kLargeWords``); a longer table is
#: read from a device copy
COMPACT_SMALL_WORDS = 480
COMPACT_PARAM_WORDS = 4000


def _compact_cuda(batch: ColumnBatch, keep: torch.Tensor) -> ColumnBatch:
    """K2 on the card: ``srt_compact_count`` (each tile's list of kept
    rows and its offset by the look-back, the total read once on the
    host), then ``srt_compact_copy`` over every column (the table of
    :func:`gather_table`'s words by value) into one allocation a leaf."""
    lib = native.lib("compact")
    n = batch.num_rows
    dev = keep.device
    if keep.shape != (n,) or keep.dtype != torch.bool:
        raise ValueError(f"keep must be bool[{n}], got {keep.dtype}"
                         f"{tuple(keep.shape)}")
    if n == 0:
        return ColumnBatch([_empty_like_rows(c, 0) for c in batch.columns],
                           0, batch.schema, batch.device)
    keep = keep.contiguous()
    stream = native.stream_ptr(dev)
    nt = num_tiles(n)
    # the tile offsets (int32[nt + 1]), then each tile's list of kept rows
    # (uint16[nt * TILE]) from a 16-byte boundary
    head = -(-(nt + 1) // 4) * 4
    scratch = torch.empty(head + nt * TILE // 2, dtype=torch.int32,
                          device=dev)
    rows = scratch.data_ptr() + 4 * head
    status = native.lookback_status(_STATUS, dev, stream, nt)
    native.check(lib.srt_compact_count(ptr(keep), n, scratch.data_ptr(),
                                       rows, ptr(status), stream),
                 "srt_compact_count")
    srcs = [_contig(c) for c in batch.columns]
    m = int(scratch[nt].item())
    outs = [_empty_like_rows(c, m) for c in srcs]
    if m > 0 and srcs:
        words = gather_table(srcs, outs)
        host, dev_tab = native.param_table(
            words, len(words) > COMPACT_PARAM_WORDS, dev)
        native.check(lib.srt_compact_copy(
            host.buffer_info()[0], len(words), len(srcs), ptr(dev_tab),
            rows, n, scratch.data_ptr(), stream), "srt_compact_copy")
    compact.launches += 1
    return ColumnBatch(outs, m, batch.schema, batch.device)


# ---------------------------------------------------------------------------
# K3: gather
# ---------------------------------------------------------------------------

def gather_columns(cols: Sequence[DeviceColumn],
                   perm: torch.Tensor) -> list[DeviceColumn]:
    """Rows ``perm`` (int32) of each column; a negative index gives a null
    row.  Null slots of the output are zeroed."""
    if perm.device.type == "cpu":
        return gather_plain(cols, perm)
    return _gather_cuda(cols, perm)


gather_columns.launches = 0


def gather_plain(cols: Sequence[DeviceColumn],
                 perm: torch.Tensor) -> list[DeviceColumn]:
    """Plain PyTorch version of :func:`gather_columns` (any device)."""
    return [_gather_column_plain(c, perm) for c in cols]


def _gather_column_plain(col: DeviceColumn, perm: torch.Tensor
                         ) -> DeviceColumn:
    idx = perm.long()
    inb = idx >= 0
    safe = idx.clamp(min=0)
    if col.capacity == 0:
        safe = torch.zeros_like(safe)
        valid = torch.zeros_like(inb)
        data = torch.zeros((idx.numel(),) + tuple(col.data.shape[1:]),
                           dtype=col.data.dtype, device=col.data.device)
        lengths = None if col.lengths is None else \
            torch.zeros(idx.numel(), dtype=torch.int32, device=idx.device)
        return DeviceColumn(data, valid, col.dtype, lengths)
    valid = col.validity[safe] & inb
    zero = torch.zeros((), dtype=col.data.dtype, device=col.data.device)
    if col.is_var_width:
        data = torch.where(valid[:, None], col.data[safe], zero)
        lengths = torch.where(valid, col.lengths[safe],
                              torch.zeros((), dtype=torch.int32,
                                          device=valid.device))
        return DeviceColumn(data, valid, col.dtype, lengths)
    return DeviceColumn(torch.where(valid, col.data[safe], zero), valid,
                        col.dtype)


#: table words a column of the gather kernel (csrc/gather.cu
#: ``kGatherColWords``): source and destination data, validity and
#: lengths, then row bytes | vec << 32 | empty << 40
GATHER_COL_WORDS = 7
#: output rows a tile and rows a thread, 32 apart (``kGatherTile``,
#: ``kRun``)
GATHER_TILE = 2048
GATHER_RUN = 8
#: table words of the kernel's small and large parameter struct
#: (``kGatherSmallWords``, ``kGatherLargeWords``); a longer table is read
#: from a device copy
GATHER_SMALL_WORDS = 480
GATHER_PARAM_WORDS = 4000
native.share_limits("gather", (GATHER_COL_WORDS, GATHER_TILE, GATHER_RUN,
                               GATHER_SMALL_WORDS, GATHER_PARAM_WORDS))
native.share_limits("compact", (TILE, GATHER_COL_WORDS, COMPACT_SMALL_WORDS,
                                COMPACT_PARAM_WORDS))


def vec_bytes(row_bytes: int, *addresses: int) -> int:
    """The widest power-of-two load, at most 16 bytes, that divides the
    row bytes and every address (csrc/common.cuh ``pick_vec_bytes``)."""
    bits = row_bytes
    for a in addresses:
        bits |= a
    v = 16
    while v > 1 and bits & (v - 1):
        v >>= 1
    return v


def gather_table(srcs: Sequence[DeviceColumn],
                 outs: Sequence[DeviceColumn]) -> list[int]:
    """The gather kernel's table (:data:`GATHER_COL_WORDS` int64 words a
    column): the addresses of each source's and output's data, validity
    and lengths (0 for a fixed-width column), then its row bytes, the
    widest load that divides them and both data addresses (a row is one
    load where the two are equal) and whether the source has no rows (its
    every output row is null).  Sources and outputs must be contiguous
    (the wrapper's ``_contig`` and fresh allocations)."""
    words = []
    for c, o in zip(srcs, outs):
        rb = c.row_bytes
        src, dst = c.data.data_ptr(), o.data.data_ptr()
        words += (src, dst, c.validity.data_ptr(), o.validity.data_ptr(),
                  0 if c.lengths is None else c.lengths.data_ptr(),
                  0 if o.lengths is None else o.lengths.data_ptr(),
                  rb | vec_bytes(rb, src, dst) << 32
                  | int(c.capacity == 0) << 40)
    return words


def _gather_cuda(cols: Sequence[DeviceColumn],
                 perm: torch.Tensor) -> list[DeviceColumn]:
    lib = native.lib("gather")
    if perm.dtype != torch.int32 or perm.dim() != 1:
        raise ValueError(f"perm must be int32[m], got {perm.dtype}"
                         f"{tuple(perm.shape)}")
    perm = perm.contiguous()
    m = perm.numel()
    srcs, outs = [], []
    for c in cols:
        if c.data.device != perm.device:
            raise ValueError(f"column on {c.data.device}, perm on "
                             f"{perm.device}")
        srcs.append(_contig(c))
        outs.append(_empty_like_rows(c, m))
    if m == 0 or not outs:
        return outs
    words = gather_table(srcs, outs)
    host, dev_tab = native.param_table(words, len(words) > GATHER_PARAM_WORDS,
                                       perm.device)
    native.check(lib.srt_gather(
        host.buffer_info()[0], len(words), len(outs), ptr(dev_tab),
        ptr(perm), m, native.stream_ptr(perm.device)), "srt_gather")
    gather_columns.launches += 1
    return outs


def take(batch: ColumnBatch, indices: torch.Tensor) -> ColumnBatch:
    """Gather rows at ``indices`` (int32) into a new batch."""
    cols = gather_columns(batch.columns, indices)
    return ColumnBatch(cols, indices.numel(), batch.schema, batch.device)


# ---------------------------------------------------------------------------
# concat / slice (plain torch: no kernel of their own)
# ---------------------------------------------------------------------------

def concat_batches(batches: Sequence[ColumnBatch]) -> ColumnBatch:
    """Concatenate batches row-wise; string matrices are zero-padded to
    the widest input."""
    if not batches:
        raise ValueError("concat of zero batches")
    schema = batches[0].schema
    cols = []
    for ci in range(batches[0].num_columns):
        parts = [b.columns[ci] for b in batches]
        validity = torch.cat([p.validity for p in parts])
        if parts[0].is_var_width:
            w = max(p.max_len for p in parts)
            data = torch.cat([torch.nn.functional.pad(p.data,
                                                      (0, w - p.max_len))
                              for p in parts])
            lengths = torch.cat([p.lengths for p in parts])
            cols.append(DeviceColumn(data, validity, parts[0].dtype,
                                     lengths))
        else:
            cols.append(DeviceColumn(torch.cat([p.data for p in parts]),
                                     validity, parts[0].dtype))
    return ColumnBatch(cols, sum(b.num_rows for b in batches), schema,
                       batches[0].device)


def slice_rows(batch: ColumnBatch, lo: int, hi: int) -> ColumnBatch:
    """Rows ``[lo, hi)`` as their own batch (views, no copy)."""
    lo, hi = max(lo, 0), min(hi, batch.num_rows)
    hi = max(hi, lo)
    cols = [DeviceColumn(c.data[lo:hi], c.validity[lo:hi], c.dtype,
                         None if c.lengths is None else c.lengths[lo:hi])
            for c in batch.columns]
    return ColumnBatch(cols, hi - lo, batch.schema, batch.device)


def slice_batch(batch: ColumnBatch, limit: int) -> ColumnBatch:
    """Keep the first ``limit`` rows (GpuLocalLimit)."""
    return slice_rows(batch, 0, limit)
