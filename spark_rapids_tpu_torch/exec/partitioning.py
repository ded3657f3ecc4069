"""Partitioning strategies of the shuffle exchange (port of
``spark_rapids_tpu/exec/partitioning.py``: ``Partitioning`` :43,
``_augment_device`` :63, ``HashPartitioning`` :75,
``RoundRobinPartitioning`` :107, ``SinglePartitioning`` :142,
``RangePartitioning`` :205).

Partition ids are computed on the batch's device: Spark-bit-exact murmur3
pmod for hash partitioning (K9, ``ops/partition.py``), the running row
index mod P for round-robin, and for range partitioning the number of
bounds strictly below the row under the sort order (K11,
``ops/range_partition.py``).  Round-robin and range partitioning need
every map batch first (:meth:`Partitioning.prepare`): the batches' row
offsets, and the range bounds.
"""
from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.expr.core import (BoundReference, Expression,
                                              bind, eval_device)
from spark_rapids_tpu_torch.ops.kernels import concat_batches, gather_columns
from spark_rapids_tpu_torch.ops.partition import partition_ids_for_keys
from spark_rapids_tpu_torch.ops.range_partition import (RangeBounds,
                                                        range_partition_ids,
                                                        round_robin_ids)
from spark_rapids_tpu_torch.ops.sort import SortOrder, sort_permutation

__all__ = ["Partitioning", "HashPartitioning", "SinglePartitioning",
           "RoundRobinPartitioning", "RangePartitioning"]


class Partitioning:
    """Computes int32 partition ids per row of a device batch."""

    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions

    #: whether :meth:`prepare` needs the whole map side (the exchange
    #: then holds every map batch before it partitions the first)
    needs_prepare = False

    def bind(self, schema: T.Schema) -> None:
        """Resolve key expressions against the child schema."""

    def prepare(self, batches: Sequence[ColumnBatch]) -> None:
        """One-time setup over every map batch, in map order; the exchange
        calls it before the first :meth:`device_ids`."""

    def device_ids(self, batch: ColumnBatch,
                   batch_index: int) -> torch.Tensor:
        raise NotImplementedError


def _augment_device(batch: ColumnBatch, bound_keys) -> tuple:
    """(batch with every non-column key appended as ``_pk{i}``, key column
    indices); plain column keys are used in place."""
    cols = list(batch.columns)
    fields = list(batch.schema.fields)
    idx = []
    for i, k in enumerate(bound_keys):
        if isinstance(k, BoundReference):
            idx.append(k.index)
            continue
        cols.append(eval_device(k, batch))
        fields.append(T.StructField(f"_pk{i}", k.dtype, True))
        idx.append(len(cols) - 1)
    return (ColumnBatch(cols, batch.num_rows, T.Schema(fields),
                        batch.device), idx)


class HashPartitioning(Partitioning):
    """Spark-bit-exact murmur3 pmod (reference GpuHashPartitioning)."""

    def __init__(self, keys: Sequence[Expression], num_partitions: int):
        super().__init__(num_partitions)
        self._keys = list(keys)
        self._bound = None

    def bind(self, schema: T.Schema) -> None:
        self._bound = [bind(k, schema) for k in self._keys]

    def device_ids(self, batch: ColumnBatch,
                   batch_index: int) -> torch.Tensor:
        b2, idx = _augment_device(batch, self._bound)
        return partition_ids_for_keys(b2, idx, self.num_partitions)


class SinglePartitioning(Partitioning):
    def __init__(self):
        super().__init__(1)

    def device_ids(self, batch: ColumnBatch,
                   batch_index: int) -> torch.Tensor:
        return torch.zeros(batch.num_rows, dtype=torch.int32,
                           device=batch.device)


class RoundRobinPartitioning(Partitioning):
    """Even distribution by running row index (reference
    GpuRoundRobinPartitioning; deterministic, with no random start, as in
    the reference).  The offsets come from the batches' host-known row
    counts: no sync."""

    needs_prepare = True

    def __init__(self, num_partitions: int):
        super().__init__(num_partitions)
        self._offsets: list[int] = []

    def prepare(self, batches: Sequence[ColumnBatch]) -> None:
        off = 0
        self._offsets = []
        for b in batches:
            self._offsets.append(off)
            off += b.num_rows

    def device_ids(self, batch: ColumnBatch,
                   batch_index: int) -> torch.Tensor:
        return round_robin_ids(batch.num_rows, self._offsets[batch_index],
                               self.num_partitions, batch.device)


class RangePartitioning(Partitioning):
    """Ordered partitioning by quantile bounds (reference
    GpuRangePartitioning + GpuRangePartitioner).

    :meth:`prepare` takes the P - 1 bounds at positions
    ``clip((i * n) // P, 0, n - 1)``, i = 1..P-1, of the whole map side in
    sort order: the key columns alone are concatenated, ordered by K1's
    permutation and the bound rows gathered with K3 (the reference sorts
    every column of the concatenated input; the bounds are the same).  A
    row's partition is the number of bounds strictly below it (Spark's
    RangePartitioner.getPartition), K11.  No input or P = 1: every row
    goes to partition 0.
    """

    needs_prepare = True

    def __init__(self, orders: Sequence, num_partitions: int):
        super().__init__(num_partitions)
        if not orders:
            raise ValueError("range partitioning needs at least one order")
        self._orders_raw = list(orders)
        self._orders: list[SortOrder] = []
        self._bounds: RangeBounds | None = None

    def bind(self, schema: T.Schema) -> None:
        from spark_rapids_tpu_torch.exec.sortexec import resolve_orders
        self._orders = resolve_orders(self._orders_raw, schema)

    def _key_batch(self, batch: ColumnBatch) -> ColumnBatch:
        idx = [o.child_index for o in self._orders]
        return ColumnBatch([batch.columns[i] for i in idx], batch.num_rows,
                           T.Schema([batch.schema.fields[i] for i in idx]),
                           batch.device)

    def prepare(self, batches: Sequence[ColumnBatch]) -> None:
        self._bounds = None
        n = sum(b.num_rows for b in batches)
        if self.num_partitions <= 1 or n == 0:
            return
        keys = concat_batches([self._key_batch(b) for b in batches])
        orders = [SortOrder(i, o.ascending, o.nulls_first)
                  for i, o in enumerate(self._orders)]
        perm = sort_permutation(keys, orders)
        pos = torch.clamp(torch.arange(1, self.num_partitions,
                                       dtype=torch.int64) * n
                          // self.num_partitions, 0, n - 1)
        rows = perm[pos.to(keys.device)]
        self._bounds = RangeBounds(gather_columns(keys.columns, rows),
                                   orders)

    def device_ids(self, batch: ColumnBatch,
                   batch_index: int) -> torch.Tensor:
        if self._bounds is None:
            return torch.zeros(batch.num_rows, dtype=torch.int32,
                               device=batch.device)
        return range_partition_ids(list(self._key_batch(batch).columns),
                                   self._bounds)
