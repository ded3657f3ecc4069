"""Device columnar batch and Arrow host interop (port of ``columnar/batch.py``).

A batch is a tuple of :class:`DeviceColumn` of exactly ``num_rows`` rows,
its schema and its device.  ``num_rows`` is a host int: the reference kept a
traced device scalar and padded every batch to a power-of-two capacity
(``round_capacity``, batch.py:293) so that XLA saw static shapes.  PyTorch
runs eagerly, so the port drops the padding and pays instead one
device-to-host sync where a row count depends on the data (a filter's
output count, a group-by's group count) to size the output tensors.

Host -> device: :meth:`ColumnBatch.from_arrow` decodes each Arrow column to
its raw numpy leaves (data, validity, lengths), stages them in pinned host
memory and copies them to the card asynchronously.  The reference's wire
codec (``_PackBuilder``, batch.py:63; kernel family K8) packs and bit-packs
leaves to save transfers over a TPU tunnel; the port uploads raw leaves
until a later slice ports the codec.
"""
from __future__ import annotations

import datetime as _dt
from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    round_string_width,
                                                    torch_dtype)

__all__ = ["ColumnBatch", "strings_to_matrix", "stage", "upload"]


def stage(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host numpy leaf as a host tensor ready for ``device``: a pinned
    copy for CUDA (so the copy to the card can be asynchronous), an owned
    copy otherwise."""
    arr = np.ascontiguousarray(arr)
    if device.type != "cuda":
        return torch.from_numpy(arr.copy())
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).pin_memory()


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host numpy leaf on ``device``: through pinned memory and an
    asynchronous copy on the current stream for CUDA, as an owned CPU
    tensor otherwise."""
    return stage(arr, device).to(device, non_blocking=True)


class ColumnBatch:
    """A device batch: columns of exactly ``num_rows`` rows on ``device``."""

    __slots__ = ("columns", "num_rows", "schema", "device")

    def __init__(self, columns: Sequence[DeviceColumn], num_rows: int,
                 schema: T.Schema, device: torch.device):
        self.columns = tuple(columns)
        self.num_rows = int(num_rows)
        self.schema = schema
        self.device = torch.device(device)

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def device_size_bytes(self) -> int:
        """Device bytes held by the batch's leaves."""
        return sum(c.nbytes() for c in self.columns)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_arrow(rb, device) -> "ColumnBatch":
        """Build a device batch from a pyarrow RecordBatch (H2D copy)."""
        device = torch.device(device)
        return ColumnBatch.stage_arrow(rb, device).to(device)

    @staticmethod
    def stage_arrow(rb, device) -> "ColumnBatch":
        """The host half of :meth:`from_arrow`: a pyarrow RecordBatch
        decoded into a batch of host tensors ready for ``device`` (pinned
        for CUDA); ``.to(device)`` finishes it.  The scan decodes on its
        prefetch thread and copies on the consumer's, so the card holds
        only the batches the consumer does."""
        import pyarrow as pa
        device = torch.device(device)
        n = rb.num_rows
        schema = T.Schema.from_arrow(rb.schema)
        cols = []
        for i, field in enumerate(schema):
            arr = rb.column(i)
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.combine_chunks()
            if pa.types.is_dictionary(arr.type):
                arr = arr.cast(arr.type.value_type)
            validity = T.arrow_validity_numpy(arr)
            dt = field.data_type
            if isinstance(dt, T.StringType):
                bm, lens = strings_to_matrix(arr)
                cols.append(DeviceColumn(stage(bm, device),
                                         stage(validity, device), dt,
                                         stage(lens, device)))
            elif isinstance(dt, (T.ArrayType, T.MapType)):
                raise NotImplementedError(
                    f"{dt} columns are not ported yet (ROADMAP.md Queue 1 "
                    "item 8)")
            else:
                data = T.arrow_fixed_to_numpy(arr, dt)
                cols.append(DeviceColumn(stage(data, device),
                                         stage(validity, device), dt))
        return ColumnBatch(cols, n, schema, torch.device("cpu"))

    def to(self, device) -> "ColumnBatch":
        """The batch on ``device`` (itself when it is there already):
        asynchronous copies on the current stream from pinned leaves."""
        device = torch.device(device)
        if device == self.device:
            return self

        def move(t):
            return None if t is None else t.to(device, non_blocking=True)

        cols = [DeviceColumn(move(c.data), move(c.validity), c.dtype,
                             move(c.lengths)) for c in self.columns]
        return ColumnBatch(cols, self.num_rows, self.schema, device)

    @staticmethod
    def nulls(schema: T.Schema, num_rows: int, device) -> "ColumnBatch":
        """``num_rows`` all-null rows with ``schema`` (zero rows: an
        empty batch)."""
        device = torch.device(device)
        cols = []
        for f in schema:
            v = torch.zeros(num_rows, dtype=torch.bool, device=device)
            if isinstance(f.data_type, T.StringType):
                cols.append(DeviceColumn(
                    torch.zeros((num_rows, 4), dtype=torch.uint8,
                                device=device), v, f.data_type,
                    torch.zeros(num_rows, dtype=torch.int32, device=device)))
            else:
                cols.append(DeviceColumn(
                    torch.zeros(num_rows, dtype=torch_dtype(f.data_type),
                                device=device), v, f.data_type))
        return ColumnBatch(cols, num_rows, schema, device)

    @staticmethod
    def from_leaves(arrow_schema, leaves, num_rows: int,
                    device) -> "ColumnBatch":
        """Build a batch from another engine's host leaves.

        ``leaves`` holds one ``(data, validity, lengths)`` tuple of numpy
        arrays per column (``lengths`` None for fixed-width columns), as
        ``jax.device_get`` returns them for a reference ``ColumnBatch``;
        rows past ``num_rows`` (the reference's capacity padding) are
        dropped.  Tests use it to hand both packages bit-identical input.
        """
        device = torch.device(device)
        schema = T.Schema.from_arrow(arrow_schema)
        n = int(num_rows)
        cols = []
        for f, (data, validity, lengths) in zip(schema, leaves):
            d = np.ascontiguousarray(np.asarray(data)[:n])
            want = torch_dtype(f.data_type)
            t = upload(d, device)
            if t.dtype != want:
                raise TypeError(f"column {f.name}: leaf dtype {t.dtype}, "
                                f"expected {want}")
            v = upload(np.ascontiguousarray(
                np.asarray(validity, dtype=np.bool_)[:n]), device)
            ln = None
            if lengths is not None:
                ln = upload(np.ascontiguousarray(
                    np.asarray(lengths, dtype=np.int32)[:n]), device)
            cols.append(DeviceColumn(t, v, f.data_type, ln))
        return ColumnBatch(cols, n, schema, device)

    # ------------------------------------------------------------------
    # device -> host
    # ------------------------------------------------------------------
    def host_leaves(self) -> list[tuple]:
        """(data, validity, lengths) numpy copies of every column."""
        out = []
        for c in self.columns:
            out.append((c.data.cpu().numpy(), c.validity.cpu().numpy(),
                        None if c.lengths is None
                        else c.lengths.cpu().numpy()))
        return out

    def to_arrow(self):
        """Copy the batch back to host as a pyarrow.RecordBatch."""
        import pyarrow as pa
        n = self.num_rows
        arrays = []
        for field, (data, validity, lengths) in zip(self.schema,
                                                    self.host_leaves()):
            dt = field.data_type
            vbits = pa.py_buffer(np.packbits(validity, bitorder="little"))
            nulls = int(n - validity.sum())
            if isinstance(dt, T.StringType):
                offsets = np.zeros(n + 1, dtype=np.int32)
                np.cumsum(lengths, out=offsets[1:])
                w = data.shape[1] if data.ndim == 2 else 0
                mask = np.arange(w, dtype=np.int32)[None, :] < lengths[:, None]
                chars = np.ascontiguousarray(data[mask])
                arrays.append(pa.StringArray.from_buffers(
                    n, pa.py_buffer(offsets), pa.py_buffer(chars), vbits,
                    nulls))
            elif isinstance(dt, T.BooleanType):
                bits = np.packbits(data.astype(np.bool_), bitorder="little")
                arrays.append(pa.Array.from_buffers(
                    pa.bool_(), n, [vbits, pa.py_buffer(bits)], nulls))
            else:
                arrays.append(pa.Array.from_buffers(
                    T.to_arrow(dt), n,
                    [vbits, pa.py_buffer(np.ascontiguousarray(data))], nulls))
        return pa.RecordBatch.from_arrays(arrays,
                                          schema=self.schema.to_arrow())

    def to_rows(self) -> list[tuple]:
        """Rows as python tuples, with the reference's collect surface:
        None for nulls, dates as datetime.date, timestamps as
        datetime.datetime, numbers as python int/float."""
        cols = []
        for field, (data, validity, lengths) in zip(self.schema,
                                                    self.host_leaves()):
            dt = field.data_type
            vals = []
            for i in range(self.num_rows):
                if not validity[i]:
                    vals.append(None)
                elif isinstance(dt, T.StringType):
                    vals.append(bytes(data[i, :lengths[i]]).decode(
                        "utf-8", "replace"))
                elif isinstance(dt, T.DateType):
                    vals.append(_dt.date(1970, 1, 1)
                                + _dt.timedelta(days=int(data[i])))
                elif isinstance(dt, T.TimestampType):
                    vals.append(_dt.datetime(1970, 1, 1)
                                + _dt.timedelta(microseconds=int(data[i])))
                else:
                    vals.append(data[i].item())
            cols.append(vals)
        return list(zip(*cols)) if cols else [()] * self.num_rows


def strings_to_matrix(arr):
    """Arrow string array -> (uint8[n, W] padded bytes, int32[n] lengths);
    null rows get zero bytes and length 0 (reference batch.py:508)."""
    import pyarrow as pa
    arr = arr.cast(pa.large_string())
    n = len(arr)
    buffers = arr.buffers()
    offsets = np.frombuffer(buffers[1], dtype=np.int64, count=n + 1,
                            offset=arr.offset * 8)
    databuf = np.frombuffer(buffers[2], dtype=np.uint8) \
        if buffers[2] is not None else np.zeros(0, np.uint8)
    lens = (offsets[1:] - offsets[:-1]).astype(np.int32)
    if arr.null_count:
        lens = np.where(T.arrow_validity_numpy(arr), lens, 0).astype(np.int32)
    maxw = int(lens.max()) if n else 0
    w = round_string_width(max(maxw, 1))
    out = np.zeros((n, w), dtype=np.uint8)
    if n and databuf.size:
        has = lens > 0
        packed = int(offsets[-1] - offsets[0]) == int(lens.sum())
        if maxw == 1:
            # one-byte strings (flags, codes): a single strided copy
            out[has, 0] = databuf[offsets[:-1][has]]
        elif maxw > 1 and packed and int(lens[has].min()) == maxw:
            # fixed-width strings (dates, codes) stored back to back:
            # one reshape of the data buffer
            rows = databuf[offsets[0]:offsets[-1]].reshape(-1, maxw)
            if rows.shape[0] == n:
                out[:, :maxw] = rows
            else:
                out[has, :maxw] = rows
        elif maxw > 1:
            pos = offsets[:-1, None] + np.arange(w, dtype=np.int64)[None, :]
            mask = np.arange(w, dtype=np.int32)[None, :] < lens[:, None]
            out[mask] = databuf[pos[mask]]
    return out, lens
