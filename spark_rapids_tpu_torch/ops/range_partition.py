"""Range-partition ids (K11) and round-robin ids.

Port of ``spark_rapids_tpu/exec/partitioning.py``'s device paths:
``RangePartitioning.device_ids`` :258-268 over ``_rank_operands`` :157 and
``_combined_rank_ids`` :170, and ``RoundRobinPartitioning.device_ids``
:131-134.

The reference ranks a batch's rows together with the P - 1 bound rows in
one stable multi-operand sort, takes dense ranks (equal keys, one rank)
and counts, for each row, the bound ranks strictly below its own
(``searchsorted(..., side="left")``).  That is the number of bounds whose
sort key is strictly less than the row's, where equal means the same key:
null == null, NaN == NaN (the largest value), -0.0 == 0.0.

* K11, ``csrc/range_partition.cu``: rows and bounds are packed into K1's
  order-preserving limbs at one layout (:func:`~.sort.pack_keys`; string
  keys at the wider of the two widths, so that a batch narrower than the
  bounds compares with them), and one thread per row binary-searches the
  bounds' limbs, held in shared memory, for the first bound not below it.
  No sort and no host sync per batch.
* :func:`range_partition_ids_plain` keeps the reference's method: a
  combined stable sort, dense ranks from key changes, ``searchsorted``.
* :func:`round_robin_ids` is elementwise index arithmetic (the reference's
  is an XLA iota), not a hand kernel.

The wrapper takes its plain version only for CPU tensors; on a CUDA tensor
it launches its kernel or raises, and counts each launch in
``range_partition_ids.launches``.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import ptr
from spark_rapids_tpu_torch.ops.segmented import _cols_differ
from spark_rapids_tpu_torch.ops.sort import (SortOrder, chain_sort,
                                             encode_key_operands, pack_keys,
                                             packed_width)

__all__ = ["RangeBounds", "range_partition_ids", "range_partition_ids_plain",
           "round_robin_ids"]


class RangeBounds:
    """The bound rows of a range partitioning: one column per sort key,
    in key order, ascending under ``orders`` (``orders[i]`` orders
    ``cols[i]``).  Their packed limbs are kept per layout, so a batch
    packs them once."""

    def __init__(self, cols: list[DeviceColumn], orders: list[SortOrder]):
        self.cols = list(cols)
        self.orders = list(orders)
        self._packed: dict[tuple, torch.Tensor] = {}

    @property
    def count(self) -> int:
        return self.cols[0].capacity

    def packed(self, widths: tuple) -> torch.Tensor:
        """int64 ``[count, nlimbs]``: each bound's limbs, least
        significant first, at the string widths ``widths``."""
        got = self._packed.get(widths)
        if got is None:
            got = pack_keys(self.cols, self.orders, list(widths)).t() \
                .contiguous()
            self._packed[widths] = got
        return got


def range_partition_ids(keys: list[DeviceColumn],
                        bounds: RangeBounds) -> torch.Tensor:
    """int32 partition id of each row: the number of bounds whose key
    (``keys`` under ``bounds.orders``) is strictly below the row's."""
    if keys[0].device.type == "cpu":
        return range_partition_ids_plain(keys, bounds)
    return _range_partition_cuda(keys, bounds)


range_partition_ids.launches = 0


def _range_partition_cuda(keys: list[DeviceColumn],
                          bounds: RangeBounds) -> torch.Tensor:
    n = keys[0].capacity
    dev = keys[0].device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    widths = tuple(max(packed_width(k), packed_width(b)) if k.is_string
                   else None for k, b in zip(keys, bounds.cols))
    rows = pack_keys(keys, bounds.orders, list(widths))
    packed = bounds.packed(widths)
    lib = native.lib("range_partition")
    native.check(lib.srt_range_partition(
        ptr(rows), n, rows.shape[0], ptr(packed), packed.shape[0], ptr(out),
        native.stream_ptr(dev)), "srt_range_partition")
    range_partition_ids.launches += 1
    return out


def _stack(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    """Rows of ``a`` then ``b``; string matrices padded to the wider."""
    validity = torch.cat([a.validity, b.validity])
    if not a.is_string:
        return DeviceColumn(torch.cat([a.data, b.data]), validity, a.dtype)
    w = max(a.max_len, b.max_len)
    pad = torch.nn.functional.pad
    return DeviceColumn(torch.cat([pad(a.data, (0, w - a.max_len)),
                                   pad(b.data, (0, w - b.max_len))]),
                        validity, a.dtype,
                        torch.cat([a.lengths, b.lengths]))


def range_partition_ids_plain(keys: list[DeviceColumn],
                              bounds: RangeBounds) -> torch.Tensor:
    """Plain PyTorch version of :func:`range_partition_ids` (any device),
    by the reference's method: dense ranks of rows and bounds from one
    stable sort, then the bound ranks below each row's."""
    n = keys[0].capacity
    nb = bounds.count
    dev = keys[0].device
    comb = [_stack(k, b) for k, b in zip(keys, bounds.cols)]
    operands = []
    for o, c in zip(bounds.orders, comb):
        nf = o.resolved_nulls_first
        operands.append((c.validity if nf else ~c.validity).to(torch.int64))
        operands.extend(encode_key_operands(c, o.ascending))
    order = chain_sort(operands, n + nb, dev)
    differ = torch.zeros(n + nb, dtype=torch.bool, device=dev)
    for c in comb:
        sc = DeviceColumn(c.data[order], c.validity[order], c.dtype,
                          None if c.lengths is None else c.lengths[order])
        differ |= _cols_differ(sc)
    differ[:1] = False
    ranks = torch.empty(n + nb, dtype=torch.int64, device=dev)
    ranks[order] = torch.cumsum(differ.to(torch.int64), 0)
    bound_ranks = torch.sort(ranks[n:]).values
    return torch.searchsorted(bound_ranks, ranks[:n],
                              side="left").to(torch.int32)


def round_robin_ids(num_rows: int, offset: int, num_partitions: int,
                    device) -> torch.Tensor:
    """int32 ``(offset + i) % num_partitions`` for the batch's rows ``i``;
    ``offset`` is the batch's first row in the whole map side."""
    return ((torch.arange(num_rows, dtype=torch.int64, device=device)
             + offset) % num_partitions).to(torch.int32)
