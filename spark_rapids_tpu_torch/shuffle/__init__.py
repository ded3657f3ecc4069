"""Shuffle transport SPI (port of ``spark_rapids_tpu/shuffle/__init__.py``).

A transport owns one execution's map-output storage and the plane that
moves partition batches to consumers (reference RapidsShuffleTransport,
RapidsShuffleTransport.scala:378-460).  The exchange writes every map
batch's partition pieces, then consumers fetch per reduce partition.
``LocalShuffleTransport`` (``shuffle/local.py``) is the single-process
plane; the TCP plane and its retrying fetch are Queue 1 item 10.
"""
from __future__ import annotations

import importlib
from typing import Iterable, Protocol, runtime_checkable

from spark_rapids_tpu_torch.conf import SHUFFLE_TRANSPORT_CLASS, TorchConf

__all__ = ["ShuffleTransport", "make_transport"]


@runtime_checkable
class ShuffleTransport(Protocol):
    """Transport SPI: store map outputs, serve reduce partitions."""

    def write_partition(self, shuffle_id, map_id: int, part_id: int,
                        batch) -> None:
        """Store one map-output batch for (shuffle, map, partition)."""
        ...

    def fetch_partition(self, shuffle_id, part_id: int, lo: int = 0,
                        hi: int | None = None) -> Iterable:
        """Batches of one reduce partition in map order, restricted to the
        batch slice [lo, hi) (hi=None -> end)."""
        ...

    def release_shuffle(self, shuffle_id) -> int:
        """Drop every map output of one shuffle; returns the bytes freed."""
        ...


def make_transport(conf: TorchConf, ctx=None) -> ShuffleTransport:
    """Load the transport class named by
    ``spark.rapids.shuffle.transport.class`` (reference makeTransport,
    RapidsShuffleTransport.scala:638-658)."""
    path = conf.get(SHUFFLE_TRANSPORT_CLASS)
    mod_name, _, cls_name = path.rpartition(".")
    try:
        cls = getattr(importlib.import_module(mod_name), cls_name)
    except (ImportError, AttributeError) as e:
        raise ValueError(
            f"cannot load shuffle transport {path!r}: {e}") from e
    return cls(conf, ctx)
