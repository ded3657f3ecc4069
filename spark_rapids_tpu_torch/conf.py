"""Typed configuration registry of the port.

A copy of the part of ``spark_rapids_tpu/conf.py`` that the port reads:
the registry machinery and the entries consulted by the scan, the
coalesce planner, explain, the device budget and the shuffle exchange
(the reference keeps the adaptive entries in
``spark_rapids_tpu/exec/exchange.py:42-56``).  Keys, defaults and parsing
are the reference package's, so one settings dict configures both
packages the same way.
"""
from __future__ import annotations

import re
from typing import Any, Callable

__all__ = ["ConfEntry", "TorchConf", "register", "parse_bytes"]

_BYTE_SUFFIXES = {
    "b": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40,
}


def _bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")


def parse_bytes(v) -> int:
    """Parse '512m', '2g', plain ints (Spark byte units)."""
    if isinstance(v, (int, float)):
        return int(v)
    m = re.fullmatch(r"\s*(\d+)\s*([bkmgt]?)b?\s*", str(v).lower())
    if not m:
        raise ValueError(f"cannot parse byte size: {v!r}")
    return int(m.group(1)) * _BYTE_SUFFIXES.get(m.group(2) or "b", 1)


class ConfEntry:
    def __init__(self, key: str, default: Any, doc: str, *,
                 conv: Callable[[Any], Any] | None = None,
                 check: Callable[[Any], bool] | None = None,
                 check_doc: str = ""):
        self.key = key
        self.default = default
        self.doc = doc
        self.conv = conv
        self.check = check
        self.check_doc = check_doc

    def get(self, settings: dict) -> Any:
        if self.key in settings:
            v = settings[self.key]
            if self.conv is not None:
                v = self.conv(v)
            if self.check is not None and not self.check(v):
                raise ValueError(f"{self.key}={v!r}: {self.check_doc}")
            return v
        return self.default


_REGISTRY: dict[str, ConfEntry] = {}


def register(entry: ConfEntry) -> ConfEntry:
    _REGISTRY[entry.key] = entry
    return entry


EXPLAIN = register(ConfEntry(
    "spark.rapids.sql.explain", "NONE",
    "Explain the planned tree on every query: NONE, ALL, or NOT_ON_TPU "
    "(the port places every operator of this slice on the device, so "
    "NOT_ON_TPU prints nothing).",
    check=lambda v: v in ("NONE", "ALL", "NOT_ON_TPU"),
    check_doc="must be NONE|ALL|NOT_ON_TPU"))

BATCH_SIZE_BYTES = register(ConfEntry(
    "spark.rapids.sql.batchSizeBytes", 1 << 30,
    "Target byte size for coalesced device batches; the CoalesceGoal "
    "target.", conv=parse_bytes))

MAX_READER_BATCH_SIZE_BYTES = register(ConfEntry(
    "spark.rapids.sql.reader.batchSizeBytes", 1 << 30,
    "Soft cap on bytes per scan batch, converted to a row cap through a "
    "static schema width estimate (io/scan.py). Combines with "
    "spark.rapids.sql.reader.batchRows.", conv=parse_bytes))

BATCH_ROWS = register(ConfEntry(
    "spark.rapids.sql.reader.batchRows", 1 << 22,
    "Max rows per decoded scan batch.", conv=int))

HBM_ALLOC_FRACTION = register(ConfEntry(
    "spark.rapids.memory.tpu.allocFraction", 0.75,
    "Fraction of device memory the buffer store may occupy before "
    "spilling (the reference package's key, read for the CUDA card).",
    conv=float))

DEVICE_RESERVE = register(ConfEntry(
    "spark.rapids.memory.tpu.reserve", 256 << 20,
    "Device memory held back from the buffer store's budget for kernel "
    "scratch and runtime allocations.", conv=parse_bytes))


SHUFFLE_PARTITIONS = register(ConfEntry(
    "spark.sql.shuffle.partitions", 8,
    "Number of shuffle partitions for exchanges (Spark's own knob; honored "
    "here for parity).", conv=int))

ADAPTIVE_ENABLED = register(ConfEntry(
    "spark.sql.adaptive.enabled", True,
    "Adaptive execution: coalesce small shuffle output partitions using "
    "the map-output sizes (reference GpuCustomShuffleReaderExec + "
    "GpuTransitionOverrides.optimizeAdaptiveTransitions :51-94).",
    conv=_bool))

ADVISORY_PARTITION_BYTES = register(ConfEntry(
    "spark.sql.adaptive.advisoryPartitionSizeInBytes", 64 << 20,
    "Target post-shuffle partition size for adaptive coalescing.",
    conv=int))

SKEWED_PARTITION_THRESHOLD = register(ConfEntry(
    "spark.sql.adaptive.skewedPartitionThresholdInBytes", 256 << 20,
    "A shuffle output partition larger than this is skewed: the adaptive "
    "reader splits it into multiple reader groups at map-batch "
    "granularity targeting advisoryPartitionSizeInBytes each (the skew "
    "half of Spark 3.0 AQE; small partitions are coalesced, large ones "
    "split).", conv=int))

SHUFFLE_COMPRESSION_CODEC = register(ConfEntry(
    "spark.rapids.shuffle.compression.codec", "none",
    "Codec for shuffle partition buffers: none, lz4 (native C++ block "
    "codec, native/lz4.cpp) or zstd. (ref RapidsConf.scala:729, "
    "NvcompLZ4CompressionCodec.scala:25)  The port stores map outputs "
    "uncompressed on the device; lz4 and zstd raise NotImplementedError "
    "until the serializer and codecs are ported (ROADMAP.md Queue 1 "
    "item 7).",
    check=lambda v: v in ("none", "lz4", "zstd"),
    check_doc="must be none|lz4|zstd"))

SHUFFLE_TRANSPORT_CLASS = register(ConfEntry(
    "spark.rapids.shuffle.transport.class",
    "spark_rapids_tpu_torch.shuffle.local.LocalShuffleTransport",
    "Fully qualified class of the shuffle transport implementation, loaded "
    "by reflection. (ref RapidsConf.scala:652, "
    "RapidsShuffleTransport.scala:638)  The port loads its own transports "
    "only.",
    check=lambda v: str(v).startswith("spark_rapids_tpu_torch."),
    check_doc="must name a class of the spark_rapids_tpu_torch package"))


class TorchConf:
    """An immutable snapshot of settings, queried through typed entries."""

    def __init__(self, settings: dict | None = None):
        self.settings = dict(settings or {})

    def get(self, entry: ConfEntry):
        return entry.get(self.settings)

    @property
    def explain(self) -> str:
        return self.get(EXPLAIN)

    @property
    def batch_size_bytes(self) -> int:
        return self.get(BATCH_SIZE_BYTES)

    @property
    def shuffle_partitions(self) -> int:
        return self.get(SHUFFLE_PARTITIONS)
