"""LocalShuffleTransport: the single-process shuffle data plane (port of
``spark_rapids_tpu/shuffle/local.py:61``).

Map-output batches stay on the device, each in a ``_Slot`` of its reduce
partition, in map-batch order; the adaptive reader reads the per-partition
sizes and fetches ``(lo, hi)`` slices of a partition's slots.  Codec
``none`` is the only one: serialized and compressed outputs (lz4, zstd)
need the serializer and ``native/lz4.cpp`` (ROADMAP.md Queue 1 item 6).

What the port leaves out, each with its ROADMAP.md line: spilling the
slots through the BufferCatalog (Queue 1 item 6; until then a slot holds a
plain device batch), the fault registry and the map-output epochs and
invalidation of stage recovery (``exec/recovery.py``, Queue 1 item 9),
the cluster inventory/aliasing calls (Queue 1 item 10) and the metrics
registry.  The port drains partitions on one thread, so the store takes
no lock.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

from spark_rapids_tpu_torch.conf import SHUFFLE_COMPRESSION_CODEC, TorchConf

__all__ = ["LocalShuffleTransport"]


@dataclass
class _Slot:
    """One map-output batch's place in a reduce partition's fetch order."""
    map_id: int
    batch: object
    size: int
    rows: int


class LocalShuffleTransport:
    """In-process ShuffleTransport (see shuffle/__init__.py SPI)."""

    def __init__(self, conf: TorchConf, ctx=None):
        codec = conf.get(SHUFFLE_COMPRESSION_CODEC)
        if codec != "none":
            raise NotImplementedError(
                f"shuffle codec {codec!r} needs the serializer and codecs "
                "(ROADMAP.md Queue 1 item 6); the port stores map outputs "
                "uncompressed (codec none)")
        #: (shuffle_id, part_id) -> slots in map-batch order
        self._store: dict[tuple, list[_Slot]] = {}

    def write_partition(self, shuffle_id, map_id: int, part_id: int,
                        batch) -> None:
        self._store.setdefault((shuffle_id, part_id), []).append(_Slot(
            map_id, batch, batch.device_size_bytes(), batch.num_rows))

    def _slots(self, shuffle_id, part_id: int) -> list[_Slot]:
        return self._store.get((shuffle_id, part_id), [])

    def _parts(self, shuffle_id):
        return ((pid, slots) for (sid, pid), slots in self._store.items()
                if sid == shuffle_id)

    def partition_sizes(self, shuffle_id) -> dict[int, int]:
        """Map-output bytes per reduce partition (reference MapStatus
        sizes feeding AQE's coalescing decisions)."""
        return {pid: sum(s.size for s in slots)
                for pid, slots in self._parts(shuffle_id)}

    def partition_rows(self, shuffle_id) -> dict[int, int]:
        """Exact row counts per reduce partition."""
        return {pid: sum(s.rows for s in slots)
                for pid, slots in self._parts(shuffle_id)}

    def batch_sizes(self, shuffle_id, part_id: int) -> list[int]:
        """Per-map-batch sizes of one reduce partition, in fetch order --
        the granularity the adaptive reader splits skewed partitions at."""
        return [s.size for s in self._slots(shuffle_id, part_id)]

    def fetch_partition(self, shuffle_id, part_id: int, lo: int = 0,
                        hi: int | None = None) -> Iterable:
        """One reduce partition's batches, optionally only the map-batch
        slice [lo, hi)."""
        for slot in self._slots(shuffle_id, part_id)[lo:hi]:
            yield slot.batch

    def release_shuffle(self, shuffle_id) -> int:
        """Drop every slot of one shuffle; returns the bytes released."""
        freed = 0
        for key in [k for k in self._store if k[0] == shuffle_id]:
            freed += sum(s.size for s in self._store.pop(key))
        return freed
