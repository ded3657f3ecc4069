"""Shuffle partitioning kernels: murmur3 partition ids (K9) and grouping
rows by partition (K10).

Port of ``spark_rapids_tpu/parallel/mesh_shuffle.py:50``
``partition_ids_for_keys`` (over ``expr/hashing.py`` ``murmur3_val``) and
``spark_rapids_tpu/exec/exchange.py:62`` ``_jit_group_by_part`` / ``:83``
``_jit_slice_part``.  The mesh shuffle itself is Queue 1 item 10; the
partition id lives here so that the local exchange needs nothing of it.

* K9, ``csrc/hash_partition.cu``: one thread per row folds every key
  column into the running uint32 murmur3 seed, in key order, and writes
  ``pmod(int32(h), P)`` (or the hash itself for :class:`Murmur3Hash`).
* K10, ``csrc/partition_group.cu``: a stable counting sort of the row
  indices by partition id (per-tile histogram, one scan over P x tiles,
  a warp-per-tile stable scatter) plus ``counts`` and exclusive
  ``starts``; the columns are then gathered through K3.

Beside each kernel is its plain PyTorch version.  A wrapper takes it only
for a tensor on the CPU; on a CUDA tensor it launches its kernel or
raises.  Each wrapper counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import torch_dtype
from spark_rapids_tpu_torch.expr.core import Val
from spark_rapids_tpu_torch.expr.hashing import (DEFAULT_SEED, murmur3_val,
                                                 to_int32)
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import (gather_columns, gather_plain,
                                                num_tiles, ptr, slice_rows)

__all__ = ["partition_ids_for_keys", "partition_ids_plain",
           "murmur3_columns", "group_by_part", "group_by_part_plain",
           "slice_part", "MAX_PARTS"]

#: key kind codes of csrc/hash_partition.cu
_I8, _I16, _I32, _I64, _F32, _F64, _BOOL, _STR = range(8)
_KINDS = ((T.ByteType, _I8), (T.ShortType, _I16),
          ((T.IntegerType, T.DateType), _I32),
          ((T.LongType, T.TimestampType), _I64), (T.FloatType, _F32),
          (T.DoubleType, _F64), ((T.BooleanType, T.NullType), _BOOL),
          (T.StringType, _STR))
#: key columns one launch of K9 folds (csrc/hash_partition.cu kMaxKeys);
#: more keys chain launches through the running hash
_MAX_KEYS = 16
#: most partitions K10 groups into: its scatter keeps 4 warps x (P + 1)
#: int32 counters in shared memory (227 KB a block on the H100)
MAX_PARTS = 232448 // 16 - 1


def _kind(dt: T.DataType) -> int:
    for types, code in _KINDS:
        if isinstance(dt, types):
            return code
    raise TypeError(f"murmur3 of a {dt} column is not supported")


def _hash_plain(cols: Sequence, n: int, device, seed: int) -> torch.Tensor:
    h = torch.full((n,), seed, dtype=torch.int64, device=device)
    for c in cols:
        h = murmur3_val(Val(c.data, c.validity, c.lengths, c.dtype), h)
    return h


def _pmod(h: torch.Tensor, num_parts: int) -> torch.Tensor:
    s = to_int32(h).to(torch.int64)
    return (((s % num_parts) + num_parts) % num_parts).to(torch.int32)


def _hash_cuda(cols: Sequence, n: int, device, seed: int,
               num_parts: int) -> torch.Tensor:
    """One K9 launch per 16 key columns: int32[n] partition ids
    (``num_parts`` > 0) or hash bits (``num_parts`` == 0)."""
    lib = native.lib("hash_partition")
    out = torch.empty(n, dtype=torch.int32, device=device)
    stream = native.stream_ptr(device)
    chunks = [cols[i:i + _MAX_KEYS] for i in range(0, len(cols), _MAX_KEYS)]
    keep = []  # contiguous copies stay alive until the launches are queued
    for ci, chunk in enumerate(chunks or [[]]):
        nk = len(chunk)
        kinds = (ctypes.c_int * max(nk, 1))()
        widths = (ctypes.c_int * max(nk, 1))()
        data = (ctypes.c_int64 * max(nk, 1))()
        valid = (ctypes.c_int64 * max(nk, 1))()
        lens = (ctypes.c_int64 * max(nk, 1))()
        for k, c in enumerate(chunk):
            if c.data.device != out.device:
                raise ValueError(f"key column on {c.data.device}, expected "
                                 f"{out.device}")
            d = c.data.contiguous()
            v = c.validity.contiguous()
            kinds[k] = _kind(c.dtype)
            if d.shape[0] != n or v.shape != (n,) or v.dtype != torch.bool \
                    or d.dtype != torch_dtype(c.dtype) \
                    or d.dim() != (2 if kinds[k] == _STR else 1):
                raise ValueError(f"key column of {c.dtype}: data "
                                 f"{d.dtype}{tuple(d.shape)}, validity "
                                 f"{v.dtype}{tuple(v.shape)}, {n} rows "
                                 "expected")
            if kinds[k] == _STR:
                ln = c.lengths.to(torch.int32).contiguous()
                widths[k] = d.shape[1]
                lens[k] = ptr(ln)
                keep.append(ln)
            data[k], valid[k] = ptr(d), ptr(v)
            keep += [d, v]
        last = ci == len(chunks) - 1 or not chunks
        native.check(lib.srt_hash_partition(
            ctypes.addressof(kinds), ctypes.addressof(widths),
            ctypes.addressof(data), ctypes.addressof(valid),
            ctypes.addressof(lens), nk, n, ptr(out) if ci else None,
            seed & 0xFFFFFFFF, num_parts if last else 0, ptr(out), stream),
            "srt_hash_partition")
    return out


# ---------------------------------------------------------------------------
# K9: murmur3 partition ids
# ---------------------------------------------------------------------------

def partition_ids_for_keys(batch: ColumnBatch, key_indices: Sequence[int],
                           num_parts: int) -> torch.Tensor:
    """int32[num_rows]: ``pmod(murmur3(keys), num_parts)`` per row,
    bit-exact with Spark's HashPartitioning(Murmur3Hash)."""
    if num_parts < 1:
        raise ValueError(f"num_parts must be positive, got {num_parts}")
    cols = [batch.columns[k] for k in key_indices]
    if batch.device.type == "cpu":
        return partition_ids_plain(cols, batch.num_rows, num_parts)
    out = _hash_cuda(cols, batch.num_rows, batch.device, DEFAULT_SEED,
                     num_parts)
    partition_ids_for_keys.launches += 1
    return out


partition_ids_for_keys.launches = 0


def partition_ids_plain(cols: Sequence, n: int,
                        num_parts: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`partition_ids_for_keys` over the
    key columns (any device)."""
    device = cols[0].data.device if cols else torch.device("cpu")
    return _pmod(_hash_plain(cols, n, device, DEFAULT_SEED), num_parts)


def murmur3_columns(cols: Sequence, n: int, device,
                    seed: int = DEFAULT_SEED) -> torch.Tensor:
    """int32[n] Spark ``hash(cols...)`` with ``seed`` (the Murmur3Hash
    expression); ``cols`` hold data, validity, lengths and dtype."""
    device = torch.device(device)
    if device.type == "cpu":
        return to_int32(_hash_plain(cols, n, device, seed))
    out = _hash_cuda(cols, n, device, seed, 0)
    murmur3_columns.launches += 1
    return out


murmur3_columns.launches = 0


# ---------------------------------------------------------------------------
# K10: group rows by partition
# ---------------------------------------------------------------------------

def group_by_part(batch: ColumnBatch, ids: torch.Tensor, num_parts: int):
    """Rows grouped by partition id, stably: ``(grouped, counts, starts)``
    with ``counts``/``starts`` int32[num_parts] on the batch's device
    (partition p is rows ``[starts[p], starts[p] + counts[p])`` of
    ``grouped``).  Rows whose id is outside [0, num_parts) go last and
    are in no partition (the reference's padding rows)."""
    if ids.device.type == "cpu":
        return group_by_part_plain(batch, ids, num_parts)
    return _group_cuda(batch, ids, num_parts)


group_by_part.launches = 0


def _buckets(ids: torch.Tensor, num_parts: int) -> torch.Tensor:
    inside = (ids >= 0) & (ids < num_parts)
    return torch.where(inside, ids.to(torch.int64),
                       torch.full((), num_parts, dtype=torch.int64,
                                  device=ids.device))


def group_by_part_plain(batch: ColumnBatch, ids: torch.Tensor,
                        num_parts: int):
    """Plain PyTorch version of :func:`group_by_part` (any device): a
    stable argsort of the ids and a bincount."""
    b = _buckets(ids, num_parts)
    perm = torch.argsort(b, stable=True).to(torch.int32)
    counts = torch.bincount(b, minlength=num_parts + 1)[:num_parts] \
        .to(torch.int32)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    cols = gather_plain(batch.columns, perm)
    return (ColumnBatch(cols, batch.num_rows, batch.schema, batch.device),
            counts, starts)


def _group_cuda(batch: ColumnBatch, ids: torch.Tensor, num_parts: int):
    lib = native.lib("partition_group")
    n = batch.num_rows
    if ids.dtype != torch.int32 or ids.shape != (n,):
        raise ValueError(f"ids must be int32[{n}], got {ids.dtype}"
                         f"{tuple(ids.shape)}")
    if not 1 <= num_parts <= MAX_PARTS:
        raise ValueError(f"num_parts must be in [1, {MAX_PARTS}], got "
                         f"{num_parts}")
    ids = ids.contiguous()
    dev = ids.device
    nt = num_tiles(n)
    m = (num_parts + 1) * nt
    hist = torch.empty(max(m, 1), dtype=torch.int32, device=dev)
    offsets = torch.empty(m + 1, dtype=torch.int32, device=dev)
    counts = torch.empty(num_parts, dtype=torch.int32, device=dev)
    starts = torch.empty(num_parts, dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    native.check(lib.srt_partition_group(
        ptr(ids), n, num_parts, ptr(hist), ptr(offsets), ptr(counts),
        ptr(starts), ptr(perm), native.stream_ptr(dev)),
        "srt_partition_group")
    group_by_part.launches += 1
    cols = gather_columns(batch.columns, perm)
    return (ColumnBatch(cols, n, batch.schema, batch.device), counts,
            starts)


def slice_part(grouped: ColumnBatch, start: int, count: int) -> ColumnBatch:
    """Partition rows ``[start, start + count)`` of a grouped batch, as a
    view (the reference copies into a fresh capacity only because XLA
    needs static shapes)."""
    return slice_rows(grouped, start, start + count)
