"""Partitioning strategies of the shuffle exchange (port of
``spark_rapids_tpu/exec/partitioning.py``: ``Partitioning`` :43,
``_augment_device`` :63, ``HashPartitioning`` :75, ``SinglePartitioning``
:142).

Partition ids are computed on the batch's device: Spark-bit-exact murmur3
pmod for hash partitioning (K9, ``ops/partition.py``).  Round-robin and
range partitioning need the K11 family (running row offsets; range bounds
from a combined rank sort) and raise until it is ported.
"""
from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.expr.core import (BoundReference, Expression,
                                              bind, eval_device)
from spark_rapids_tpu_torch.ops.partition import partition_ids_for_keys

__all__ = ["Partitioning", "HashPartitioning", "SinglePartitioning",
           "RoundRobinPartitioning", "RangePartitioning"]

_K11 = ("needs the K11 kernels (ROADMAP.md Queue 2 K11: round-robin ids, "
        "range bounds), which are not ported yet")


class Partitioning:
    """Computes int32 partition ids per row of a device batch."""

    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions

    def bind(self, schema: T.Schema) -> None:
        """Resolve key expressions against the child schema."""

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
    """Even distribution by running row index: not ported yet."""

    def __init__(self, num_partitions: int):
        raise NotImplementedError(f"round-robin partitioning {_K11}")


class RangePartitioning(Partitioning):
    """Sampled-bounds range partitioning: not ported yet."""

    def __init__(self, orders: Sequence, num_partitions: int):
        raise NotImplementedError(f"range partitioning {_K11}")
