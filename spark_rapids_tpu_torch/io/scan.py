"""File scans (port of ``spark_rapids_tpu/io/scan.py:149`` FileScanExec,
:532 ParquetScanExec and :611 CsvScanExec).

pyarrow decodes on the host -- parquet with column pruning, CSV through
``pyarrow.csv`` with an explicit schema -- in batches of at most
``_effective_batch_rows`` rows (the reference's defaults: 2^22 rows or
1 GiB by a static row-width estimate); a prefetch thread decodes batch
k+1 and encodes it into one pinned buffer (``ColumnBatch.stage_arrow``:
the wire codec, as the reference's scans run it) while the consumer works
on batch k, and the consumer copies each buffer to the device in one copy
and decodes it there (K8) as it takes it.  Each scan node keeps the split
of its host time in :class:`ScanStats`.  Files are spread over at most 8
partitions by size.
Predicate pushdown, ORC and the multi-file reader modes wait for a later
slice.
"""
from __future__ import annotations

import glob as _glob
import os
import queue
import threading
import time
from typing import Iterator, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.conf import BATCH_ROWS, MAX_READER_BATCH_SIZE_BYTES
from spark_rapids_tpu_torch.exec.core import ExecCtx, PlanNode

__all__ = ["FileScanExec", "ParquetScanExec", "CsvScanExec", "ScanStats"]


class ScanStats:
    """Where a scan's host time and bytes go, summed over its batches:
    pyarrow's decode of the files (``decode_s``) and the encode into
    packed buffers (``encode_s``, raw leaves and wire codec), both on the
    prefetch threads; the bytes sent to the device (``sent_bytes``)
    against the decoded leaves' (``raw_bytes``).  ``bench/profile_query.py``
    reads it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.batches = 0
        self.decode_s = 0.0
        self.encode_s = 0.0
        self.raw_bytes = 0
        self.sent_bytes = 0

    def add(self, decode_s: float, encode_s: float, packed) -> None:
        with self._lock:
            self.batches += 1
            self.decode_s += decode_s
            self.encode_s += encode_s
            self.raw_bytes += packed.raw_bytes
            self.sent_bytes += packed.nbytes

    def as_dict(self) -> dict:
        with self._lock:
            return {"batches": self.batches, "decode_s": self.decode_s,
                    "encode_s": self.encode_s, "raw_bytes": self.raw_bytes,
                    "sent_bytes": self.sent_bytes}


def _effective_batch_rows(schema: T.Schema, settings: dict) -> int:
    """Row cap honoring both reader.batchRows and reader.batchSizeBytes
    (bytes become rows through a static per-row width estimate)."""
    rows = BATCH_ROWS.get(settings)
    byte_cap = MAX_READER_BATCH_SIZE_BYTES.get(settings)
    width = 1  # validity
    for f in schema:
        # an array's np_dtype is its element's: arrays take the
        # variable-width estimate, as strings do (the reference's)
        if f.data_type.np_dtype is None or \
                isinstance(f.data_type, T.ArrayType):
            width += 32          # offset + data estimate
        else:
            width += max(1, f.data_type.np_dtype.itemsize)
    return min(rows, max(256, byte_cap // width))


def _expand_paths(paths) -> list[str]:
    """Files under the given paths; hidden components (``_x``, ``.x``)
    anywhere in the relative path are skipped."""
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for f in sorted(_glob.glob(os.path.join(p, "**", "*"),
                                       recursive=True)):
                if not os.path.isfile(f):
                    continue
                rel = os.path.relpath(f, p)
                if any(part.startswith(("_", "."))
                       for part in rel.split(os.sep)):
                    continue
                out.append(f)
        else:
            out.append(p)
    return out


class FileScanExec(PlanNode):
    """Base scan: files spread over partitions, host decode per file
    (``_read_file``) on a prefetch thread, H2D as the consumer takes
    each batch."""

    format_name = "file"

    def __init__(self, paths, columns: Sequence[str] | None = None):
        super().__init__([])
        self._files = _expand_paths(paths)
        if not self._files:
            raise FileNotFoundError(f"no input files in {paths}")
        full = self._read_schema()
        self._schema = T.Schema([full.field(c) for c in columns]) \
            if columns else full
        self.stats = ScanStats()

    def _read_schema(self) -> T.Schema:
        raise NotImplementedError

    def _read_file(self, path: str, batch_rows: int):
        """pyarrow RecordBatches of one file, at most ``batch_rows``
        rows each, holding the scan's columns."""
        raise NotImplementedError

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def num_partitions(self, ctx: ExecCtx) -> int:
        return min(len(self._files), 8)

    def _partition_files(self, ctx: ExecCtx, pid: int) -> list[str]:
        """Greedy size-balanced assignment of files to partitions."""
        nparts = self.num_partitions(ctx)
        sizes = sorted(((os.path.getsize(f), f) for f in self._files),
                       reverse=True)
        buckets: list[list[str]] = [[] for _ in range(nparts)]
        loads = [0] * nparts
        for sz, f in sizes:
            i = loads.index(min(loads))
            buckets[i].append(f)
            loads[i] += sz
        return buckets[pid]

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        files = self._partition_files(ctx, pid)
        batch_rows = _effective_batch_rows(self._schema, ctx.conf.settings)

        def record_batches():
            for p in files:
                yield from self._read_file(p, batch_rows)

        yield from self._device_batches(record_batches(), ctx.device)

    def _device_batches(self, rbs, device) -> Iterator:
        """Decode and encode into pinned host buffers on a worker thread,
        two batches ahead; each is copied to the device and decoded when
        the consumer takes it, so the card holds only the consumer's
        batches (and a query's peak device memory does not depend on the
        worker's timing)."""
        q: queue.Queue = queue.Queue(maxsize=2)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                it = iter(rbs)
                while not stop.is_set():
                    t0 = time.perf_counter()
                    rb = next(it, None)
                    if rb is None:
                        put(done)
                        return
                    if rb.num_rows == 0:
                        continue
                    t1 = time.perf_counter()
                    packed = ColumnBatch.stage_arrow(rb, device)
                    self.stats.add(t1 - t0, time.perf_counter() - t1, packed)
                    if not put(packed):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised below
                put(e)

        t = threading.Thread(target=worker, daemon=True,
                             name="scan-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item.to(device)
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()

    def node_desc(self) -> str:
        return (f"{type(self).__name__}[{self.format_name}, "
                f"{len(self._files)} files, cols={self._schema.names}]")


class ParquetScanExec(FileScanExec):
    """Parquet scan: footer schema, column pruning, host decode, H2D."""

    format_name = "parquet"

    def _read_schema(self) -> T.Schema:
        import pyarrow.parquet as pq
        return T.Schema.from_arrow(pq.read_schema(self._files[0]))

    def _read_file(self, path: str, batch_rows: int):
        import pyarrow.dataset as ds
        scanner = ds.dataset(path, format="parquet").scanner(
            columns=self._schema.names, batch_size=batch_rows)
        yield from scanner.to_batches()


class CsvScanExec(FileScanExec):
    """CSV scan: pyarrow.csv parses each file on the host with the given
    schema (reference :611).  Without a header the schema's names are the
    columns'; an empty field is null in a numeric column and ``""`` in a
    string column (pyarrow's defaults, as in the reference)."""

    format_name = "csv"

    def __init__(self, paths, schema: T.Schema | None, header: bool = True,
                 delimiter: str = ",",
                 columns: Sequence[str] | None = None):
        if schema is None:
            raise NotImplementedError(
                "CSV schema inference is not ported (ROADMAP.md Queue 1 "
                "item 9): pass schema=")
        # load pyarrow's CSV module on the caller's thread: first imported
        # on the short-lived prefetch thread, a later read_csv can crash
        import pyarrow.csv  # noqa: F401
        self._explicit_schema = schema
        self._header = header
        self._delim = delimiter
        super().__init__(paths, columns)

    def _read_schema(self) -> T.Schema:
        return self._explicit_schema

    def _read_file(self, path: str, batch_rows: int):
        import pyarrow.csv as pc
        at = self._explicit_schema.to_arrow()
        ropts = pc.ReadOptions() if self._header else \
            pc.ReadOptions(column_names=[f.name for f in at])
        # only the scan's columns are converted (every field is still
        # tokenized)
        tbl = pc.read_csv(
            path, read_options=ropts,
            parse_options=pc.ParseOptions(delimiter=self._delim),
            convert_options=pc.ConvertOptions(
                column_types={f.name: f.type for f in at},
                include_columns=self._schema.names))
        # the parser's chunks are its ~1 MB blocks: re-cut the table into
        # whole batches of batch_rows rows
        for off in range(0, tbl.num_rows, batch_rows):
            yield from tbl.slice(off, batch_rows).combine_chunks() \
                .to_batches()
