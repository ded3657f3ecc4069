"""Device columnar batch and Arrow host interop (port of ``columnar/batch.py``).

A batch is a tuple of :class:`DeviceColumn` of exactly ``num_rows`` rows,
its schema and its device.  ``num_rows`` is a host int: the reference kept a
traced device scalar and padded every batch to a power-of-two capacity
(``round_capacity``, batch.py:293) so that XLA saw static shapes.  PyTorch
runs eagerly, so the port drops the padding and pays instead one
device-to-host sync where a row count depends on the data (a filter's
output count, a group-by's group count) to size the output tensors.

Host -> device: :meth:`ColumnBatch.stage_arrow` turns an Arrow record
batch into one host buffer (:class:`_PackBuilder`, the reference's
``_PackBuilder``, batch.py:63-209): every leaf of the batch -- wire-codec
encoded words (``columnar/wirecodec.py``), raw leaves, dictionary rows and
lengths, the int64 FOR bases -- at 16-byte aligned offsets, pinned for
CUDA.  :meth:`PackedBatch.to` sends it in one asynchronous copy and
decodes it: raw leaves become views into the device buffer, encoded ones
go through the K8 kernels.  The codec is on by default for batches of
more than 1024 rows, as in the reference (its capacity of at least 2048,
batch.py:36-44); ``SRT_WIRE_CODEC=0`` turns it off (the reference's own
switch) and ``codec=`` overrides both per call.  The row count stays a
host int and is not shipped.
"""
from __future__ import annotations

import datetime as _dt
import os
from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import wirecodec as wc
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    round_string_width,
                                                    torch_dtype)

__all__ = ["ColumnBatch", "PackedBatch", "lists_to_matrix",
           "strings_to_matrix", "upload"]

#: wire-codec default (overridable per call; SRT_WIRE_CODEC=0 turns it off
#: for every batch, as in the reference, batch.py:34)
_CODEC_DEFAULT = os.environ.get("SRT_WIRE_CODEC", "1") != "0"
#: the codec runs for batches of more than this many rows: the reference's
#: ``round_capacity(n) >= 2048`` (batch.py:36-44)
_CODEC_MIN_ROWS = 1024
#: byte alignment of every leaf in a packed buffer (16-byte vector loads)
_ALIGN = 16

_NP_TO_TORCH = {"|b1": torch.bool, "|i1": torch.int8, "|u1": torch.uint8,
                "<i2": torch.int16, "<i4": torch.int32, "<u4": torch.int32,
                "<i8": torch.int64, "<f4": torch.float32,
                "<f8": torch.float64}


def _codec_auto(n: int, codec: bool | None) -> bool:
    if codec is not None:
        return codec
    return _CODEC_DEFAULT and n > _CODEC_MIN_ROWS


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host numpy leaf on ``device``: through pinned memory and an
    asynchronous copy on the current stream for CUDA, as an owned CPU
    tensor otherwise."""
    arr = np.ascontiguousarray(arr)
    if device.type != "cuda":
        return torch.from_numpy(arr.copy())
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).pin_memory().to(device, non_blocking=True)


class _PackBuilder:
    """The leaves of one batch of ``n`` rows, raw or wire-codec encoded,
    laid out in one host buffer (reference batch.py:63-209).

    Column specs follow the reference's: ``("fixed", data_desc,
    validity_desc)``, ``("var", matrix_desc, validity_desc,
    lengths_desc)`` and ``("dict", index_desc, validity_desc,
    matrix_leaf, lengths_leaf)``; a validity desc is ``("av",)`` (all
    valid: nothing ships) or ``("vbits", leaf)`` (1 bit a row), with the
    codec on or off, as in the reference."""

    def __init__(self, n: int, codec: bool):
        self.n = n
        self.codec = codec
        self.leaves: list[np.ndarray] = []
        self.i64_params: list[int] = []
        self.col_specs: list[tuple] = []

    def _add_leaf(self, arr: np.ndarray) -> int:
        self.leaves.append(np.ascontiguousarray(arr))
        return len(self.leaves) - 1

    def _add_i64(self, v: int) -> int:
        self.i64_params.append(int(v))
        return len(self.i64_params) - 1

    def _val_desc(self, validity: np.ndarray | None) -> tuple:
        if validity is None or bool(validity.all()):
            return ("av",)
        return ("vbits", self._add_leaf(wc.pack_bits_host(
            validity.astype(np.uint8), 1)))

    def add_fixed(self, data: np.ndarray, validity: np.ndarray | None):
        """A fixed-width column (null slots already zero)."""
        if self.codec:
            desc = wc.encode_fixed(data, validity, self._add_leaf,
                                   self._add_i64)
        else:
            desc = ("raw", self._add_leaf(data))
        self.col_specs.append(("fixed", desc, self._val_desc(validity)))

    def add_var(self, matrix: np.ndarray, lengths: np.ndarray,
                validity: np.ndarray | None):
        """A string or array column as its [n, W] byte or element matrix
        and lengths (null rows already zero).  The matrix ships raw, the
        lengths encoded when the codec is on (reference batch.py:138-159)."""
        mdesc = ("raw", self._add_leaf(matrix))
        if self.codec:
            ldesc = wc.encode_lengths(lengths, matrix.shape[1],
                                      self._add_leaf, self._add_i64)
        else:
            ldesc = ("raw", self._add_leaf(lengths))
        self.col_specs.append(("var", mdesc, self._val_desc(validity),
                               ldesc))

    def add_dict_string(self, indices: np.ndarray, dict_matrix: np.ndarray,
                        dict_lengths: np.ndarray,
                        validity: np.ndarray | None):
        """A dictionary-encoded string column: bit-packed indices plus the
        dictionary's byte matrix and lengths."""
        if validity is not None and not validity.all():
            indices = np.where(validity, indices, 0)
        idesc = wc.encode_fixed(indices, validity, self._add_leaf,
                                self._add_i64)
        self.col_specs.append(("dict", idesc, self._val_desc(validity),
                               self._add_leaf(dict_matrix),
                               self._add_leaf(dict_lengths)))

    def build(self, schema: T.Schema, device: torch.device,
              raw_bytes: int) -> "PackedBatch":
        """Lay every leaf and the FOR bases out in one host buffer, pinned
        when ``device`` is a CUDA device."""
        params = self._add_leaf(np.asarray(self.i64_params, np.int64))
        layout, off = [], 0
        for a in self.leaves:
            layout.append((off, a.nbytes, a.dtype.str, a.shape))
            off += -(-a.nbytes // _ALIGN) * _ALIGN
        buf = torch.empty(max(off, _ALIGN), dtype=torch.uint8,
                          pin_memory=device.type == "cuda")
        host = buf.numpy()
        for (o, nb, _d, _s), a in zip(layout, self.leaves):
            host[o:o + nb] = a.reshape(-1).view(np.uint8)
        return PackedBatch(buf, layout, tuple(self.col_specs), params,
                           self.n, schema, raw_bytes)


class PackedBatch:
    """A batch staged on the host as one buffer (see :class:`_PackBuilder`);
    :meth:`to` copies it to a device and decodes it there.

    ``nbytes`` is the size of the buffer sent; ``raw_bytes`` the bytes of
    the decoded leaves (what the batch would send raw, unpadded)."""

    __slots__ = ("buf", "layout", "col_specs", "params", "num_rows",
                 "schema", "raw_bytes")

    def __init__(self, buf, layout, col_specs, params, num_rows, schema,
                 raw_bytes):
        self.buf = buf
        self.layout = layout
        self.col_specs = col_specs
        self.params = params
        self.num_rows = num_rows
        self.schema = schema
        self.raw_bytes = raw_bytes

    @property
    def nbytes(self) -> int:
        return self.buf.numel()

    def to(self, device) -> "ColumnBatch":
        """One copy of the buffer to ``device`` (none for the CPU), then
        the decode: views for raw leaves, K8 for encoded ones."""
        device = torch.device(device)
        buf = self.buf.to(device, non_blocking=True)
        return ColumnBatch(self.decode(buf), self.num_rows, self.schema,
                           device)

    def leaf(self, buf: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i`` as a view into ``buf`` (uint32 words as int32)."""
        off, nb, dt, shape = self.layout[i]
        return buf[off:off + nb].view(_NP_TO_TORCH[dt]).view(shape)

    def decode(self, buf: torch.Tensor, plain: bool = False) -> list:
        """The batch's columns from its buffer on a device; ``plain`` runs
        the K8 kernels' plain versions on any device (to compare them).  On
        CUDA every K8a stream of the batch decodes in one launch
        (:meth:`decode_cuda`)."""
        if buf.device.type == "cuda" and not plain:
            return self.decode_cuda(buf)
        return [self.decode_column(buf, i, plain)
                for i in range(len(self.col_specs))]

    def k8a_jobs(self, buf: torch.Tensor) -> list:
        """(column, job) of every K8a job of the batch on ``buf``
        (``wirecodec.k8a_job``, by device address): a bit-packed data or
        lengths stream with its validity, and for a raw leaf its validity
        stream (ones where the column is all valid).  Dictionary columns
        (K8b) have none."""
        base = buf.data_ptr()
        lay = self.layout
        params = base + lay[self.params][0]
        out = []
        for i, spec in enumerate(self.col_specs):
            if spec[0] == "dict":
                continue
            vdesc = spec[2]
            vw = 0 if vdesc[0] == "av" else base + lay[vdesc[1]][0]
            desc = spec[1] if spec[0] == "fixed" else spec[3]
            if desc[0] == "raw":
                out.append((i, wc.k8a_job(0, vw, 0)))
                continue
            _kind, li, bits, dt, p, factor = desc
            out.append((i, wc.k8a_job(base + lay[li][0], vw, params + 8 * p,
                                      bits, factor, _NP_TO_TORCH[dt])))
        return out

    def decode_cuda(self, buf: torch.Tensor) -> list:
        """The batch's columns on CUDA: one K8a launch over every job
        (``wirecodec.decode_jobs``, every output carved from one
        allocation), one K8b launch a dictionary column, views of raw
        leaves."""
        jobs = self.k8a_jobs(buf)
        outs = dict(zip((i for i, _j in jobs), wc.decode_jobs(
            [j for _i, j in jobs], self.num_rows, buf.device)))
        cols = []
        for i, spec in enumerate(self.col_specs):
            if spec[0] == "dict":
                cols.append(self.decode_column(buf, i))
                continue
            dtype = self.schema.fields[i].data_type
            data, valid = outs[i]
            desc = spec[1] if spec[0] == "fixed" else spec[3]
            if desc[0] == "raw":
                data = self.leaf(buf, desc[1])
            if spec[0] == "fixed":
                cols.append(DeviceColumn(data, valid, dtype))
            else:
                cols.append(DeviceColumn(self.leaf(buf, spec[1][1]), valid,
                                         dtype, data))
        return cols

    def decode_column(self, buf: torch.Tensor, i: int,
                      plain: bool = False) -> DeviceColumn:
        """Column ``i`` from the buffer: K8a for a bit-packed data,
        lengths or validity stream, K8b for a dictionary string column,
        views of raw leaves; an all-valid raw column decodes nothing."""
        n = self.num_rows
        params = self.leaf(buf, self.params)
        dfix = wc.decode_fixed_plain if plain else wc.decode_fixed
        ddict = wc.decode_dict_plain if plain else wc.decode_dict
        spec, dtype = self.col_specs[i], self.schema.fields[i].data_type
        kind, vdesc = spec[0], spec[2]
        vwords = None if vdesc[0] == "av" else self.leaf(buf, vdesc[1])

        def fixed(desc):
            """(data, validity) of a data or lengths desc."""
            if desc[0] == "raw":
                data = self.leaf(buf, desc[1])
                if vwords is None:
                    return data, torch.ones(n, dtype=torch.bool,
                                            device=buf.device)
                return data, dfix(None, vwords, n)[1]
            _kind, li, bits, dt, p, factor = desc
            return dfix(self.leaf(buf, li), vwords, n, bits,
                        params[p:p + 1], factor, _NP_TO_TORCH[dt])

        if kind == "fixed":
            return DeviceColumn(*fixed(spec[1]), dtype)
        if kind == "var":
            lengths, valid = fixed(spec[3])
            return DeviceColumn(self.leaf(buf, spec[1][1]), valid, dtype,
                                lengths)
        idesc = spec[1]
        if idesc[0] == "raw":  # int32 indices: a 32-bit stream, base 0
            words, bits, b = self.leaf(buf, idesc[1]), 32, None
        else:
            words, bits, b = (self.leaf(buf, idesc[1]), idesc[2],
                              params[idesc[4]:idesc[4] + 1])
        data, lengths, valid = ddict(words, vwords, n, bits, b,
                                     self.leaf(buf, spec[3]),
                                     self.leaf(buf, spec[4]))
        return DeviceColumn(data, valid, dtype, lengths)


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
    def from_arrow(rb, device, codec: bool | None = None) -> "ColumnBatch":
        """Build a device batch from a pyarrow RecordBatch (H2D copy)."""
        device = torch.device(device)
        return ColumnBatch.stage_arrow(rb, device, codec).to(device)

    @staticmethod
    def stage_arrow(rb, device, codec: bool | None = None) -> "PackedBatch":
        """The host half of :meth:`from_arrow`: a pyarrow RecordBatch
        encoded into one host buffer ready for ``device`` (pinned for
        CUDA); ``.to(device)`` copies and decodes it.  The scan encodes on
        its prefetch thread and copies on the consumer's, so the card
        holds only the batches the consumer does.  ``codec`` None: on for
        more than 1024 rows unless ``SRT_WIRE_CODEC=0``."""
        import pyarrow as pa
        device = torch.device(device)
        n = rb.num_rows
        schema = T.Schema.from_arrow(rb.schema)
        pack = _PackBuilder(n, _codec_auto(n, codec))
        raw_bytes = 0
        for i, field in enumerate(schema):
            arr = rb.column(i)
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.combine_chunks()
            if pa.types.is_dictionary(arr.type):
                arr = arr.cast(arr.type.value_type)
            validity = T.arrow_validity_numpy(arr)
            dt = field.data_type
            if isinstance(dt, T.StringType):
                dic = wc.maybe_dict_arrow(arr, n) if pack.codec else None
                if dic is not None:
                    idx, dictionary = dic
                    dm, dlens = strings_to_matrix(dictionary)
                    pack.add_dict_string(idx, dm, dlens, validity)
                    w = dm.shape[1]
                else:
                    bm, lens = strings_to_matrix(arr)
                    pack.add_var(bm, lens, validity)
                    w = bm.shape[1]
                raw_bytes += n * (w + 5)
            elif isinstance(dt, T.ArrayType):
                m, lens = lists_to_matrix(arr, dt)
                pack.add_var(m, lens, validity)
                raw_bytes += m.nbytes + n * 5
            elif isinstance(dt, T.MapType):
                raise NotImplementedError(
                    f"{dt} columns have no device representation: the "
                    "reference keeps maps on its host, and the port has no "
                    "host oracle yet (ROADMAP.md Queue 1 item 4)")
            else:
                data = T.arrow_fixed_to_numpy(arr, dt)
                pack.add_fixed(data, validity)
                raw_bytes += data.nbytes + n
        return pack.build(schema, device, raw_bytes)

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
            if isinstance(f.data_type, (T.StringType, T.ArrayType)):
                cols.append(DeviceColumn(
                    torch.zeros((num_rows, 4),
                                dtype=torch_dtype(f.data_type),
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
            if isinstance(dt, T.ArrayType):
                offsets = np.zeros(n + 1, dtype=np.int32)
                np.cumsum(lengths, out=offsets[1:])
                w = data.shape[1]
                mask = np.arange(w, dtype=np.int32)[None, :] < lengths[:, None]
                values = _fixed_arrow(dt.element_type,
                                      np.ascontiguousarray(data[mask]))
                arrays.append(pa.Array.from_buffers(
                    T.to_arrow(dt), n, [vbits, pa.py_buffer(offsets)], nulls,
                    children=[values]))
            elif isinstance(dt, T.StringType):
                offsets = np.zeros(n + 1, dtype=np.int32)
                np.cumsum(lengths, out=offsets[1:])
                w = data.shape[1] if data.ndim == 2 else 0
                mask = np.arange(w, dtype=np.int32)[None, :] < lengths[:, None]
                chars = np.ascontiguousarray(data[mask])
                arrays.append(pa.StringArray.from_buffers(
                    n, pa.py_buffer(offsets), pa.py_buffer(chars), vbits,
                    nulls))
            else:
                arrays.append(_fixed_arrow(dt, data, vbits, nulls))
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
                elif isinstance(dt, T.ArrayType):
                    # storage values, as the reference's device collect
                    vals.append(data[i, :lengths[i]].tolist())
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


def _fixed_arrow(dt: T.DataType, data: np.ndarray, vbits=None,
                 nulls: int = 0):
    """A fixed-width Arrow array of ``dt`` over numpy ``data``."""
    import pyarrow as pa
    n = data.shape[0]
    if isinstance(dt, T.BooleanType):
        bits = np.packbits(data.astype(np.bool_), bitorder="little")
        return pa.Array.from_buffers(pa.bool_(), n,
                                     [vbits, pa.py_buffer(bits)], nulls)
    return pa.Array.from_buffers(
        T.to_arrow(dt), n, [vbits, pa.py_buffer(np.ascontiguousarray(data))],
        nulls)


def lists_to_matrix(arr, dtype: T.ArrayType):
    """Arrow list array -> (element matrix [n, W] of the element's dtype,
    int32 [n] lengths); W is ``round_string_width`` of the longest list
    and null rows get no elements (reference batch.py:472-505).  Element
    nulls are refused: they have no device representation."""
    import pyarrow as pa
    arr = arr.cast(pa.large_list(T.to_arrow(dtype.element_type)))
    n = len(arr)
    offsets = np.frombuffer(arr.buffers()[1], dtype=np.int64, count=n + 1,
                            offset=arr.offset * 8)
    # this slice's window of the child values (``.values`` spans the
    # whole child buffer)
    values = arr.values.slice(int(offsets[0]),
                              int(offsets[-1] - offsets[0]))
    if values.null_count:
        raise ValueError("arrays with null elements have no device "
                         "representation")
    offsets = offsets - offsets[0]
    flat = T.arrow_fixed_to_numpy(values, dtype.element_type)
    lens = (offsets[1:] - offsets[:-1]).astype(np.int32)
    if arr.null_count:
        lens = np.where(T.arrow_validity_numpy(arr), lens, 0).astype(
            np.int32)
    maxw = int(lens.max()) if n else 0
    w = round_string_width(max(maxw, 1))
    out = np.zeros((n, w), dtype=dtype.element_type.np_dtype)
    if n and flat.size:
        mask = np.arange(w, dtype=np.int32)[None, :] < lens[:, None]
        if arr.null_count:
            # a null row may span values: take each row's own window
            pos = offsets[:-1, None] + np.arange(w, dtype=np.int64)[None, :]
            out[mask] = flat[np.minimum(pos[mask], flat.size - 1)]
        else:
            out[mask] = flat
    return out, lens


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
