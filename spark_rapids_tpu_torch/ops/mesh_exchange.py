"""The mesh shuffle's kernels: K15a pack and K15b unpack.

Port of ``spark_rapids_tpu/parallel/mesh_shuffle.py:70`` ``_bucketize``
(with the send half of ``exchange_local_checked`` :148-171) and :114
``_repack`` (with the gathers of ``exec/mesh_exec.py:164``
``all_gather_batch`` and ``exec/mesh_region.py:125-141``).  The reference
scatters each column into ``[P, C]`` send buffers, sized for the worst
case, and front-packs the ``[P, C]`` receive buffers through an argsort.
The port sizes everything exactly, since the count matrix crosses to the
host once per exchange (``parallel/mesh_shuffle.py``):

* K15a :func:`mesh_pack`, ``csrc/mesh_exchange.cu`` ``srt_mesh_pack``:
  from K10's stable permutation and counts (``ops/partition.py``
  :func:`~spark_rapids_tpu_torch.ops.partition.partition_order`), every
  column of a shard into ONE uint8 send buffer of P sections.  Section d
  holds each column's rows for d, 16-byte aligned: the data, the int32
  lengths (strings and arrays) and the validity bytes (:func:`pack_layout`);
  the pad bytes are zero.
* K15b :func:`mesh_unpack`, ``srt_mesh_unpack``: P segments (sections of
  send buffers, :func:`section_columns`, or a shard's own columns for an
  all-gather) front-packed in source-major order, string rows zero-padded
  to the widest W of the sources.

Each has its plain PyTorch version beside it (:func:`mesh_pack_plain`,
:func:`mesh_unpack_plain`).  A wrapper takes it only for tensors on the
CPU; on CUDA tensors it launches its kernel or raises.  Each counts its
launches in ``.launches``.  The wrapper hands the kernel a device-side
int64 table of the columns' pointers and widths, copied from pinned host
memory on the launch's stream.
"""
from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import ptr

__all__ = ["pack_layout", "mesh_pack", "mesh_pack_plain", "section_columns",
           "mesh_unpack", "mesh_unpack_plain", "MAX_MESH"]

#: most sections K15a writes (and sources K15b reads): the row prefix
#: lives in shared memory, (P + 1) int64
MAX_MESH = 4096
#: byte alignment of every block of a section
_ALIGN = 16


def _a16(x: int) -> int:
    return (x + _ALIGN - 1) // _ALIGN * _ALIGN


def _vec_bytes(*vals: int) -> int:
    """Largest power-of-two chunk (<= 16 bytes) dividing every value
    (addresses and row widths), as csrc/common.cuh ``pick_vec_bytes``."""
    bits = 0
    for v in vals:
        bits |= int(v)
    v = 16
    while v > 1 and bits & (v - 1):
        v >>= 1
    return v


def pack_layout(cols: Sequence[DeviceColumn], counts: Sequence[int]):
    """Byte layout of a K15a send buffer for ``counts[d]`` rows to each
    destination d: ``(sections, blocks)`` with ``sections[d]`` the start
    of section d (``sections[P]`` the buffer's size) and ``blocks[d][j]``
    the ``(data, lengths, validity)`` byte offsets of column j in it
    (lengths -1 for fixed-width columns)."""
    sections, blocks = [0], []
    off = 0
    for c in counts:
        c = int(c)
        row = []
        for col in cols:
            data = off
            off += _a16(c * col.row_bytes)
            lens = -1
            if col.lengths is not None:
                lens = off
                off += _a16(4 * c)
            row.append((data, lens, off))
            off += _a16(c)
        blocks.append(row)
        sections.append(off)
    return sections, blocks


def _cumsum(counts) -> list[int]:
    out = [0]
    for c in counts:
        out.append(out[-1] + int(c))
    return out


# ---------------------------------------------------------------------------
# K15a: pack
# ---------------------------------------------------------------------------

def mesh_pack(cols: Sequence[DeviceColumn], perm: torch.Tensor,
              counts: Sequence[int]) -> tuple:
    """One send buffer of ``len(counts)`` sections: section d holds rows
    ``perm[prefix[d]:prefix[d] + counts[d]]`` of every column (``perm``
    int32, grouped by destination, as K10 orders it; ``counts`` host
    ints).  Returns ``(buffer, (sections, blocks))``."""
    layout = pack_layout(cols, counts)
    if perm.device.type == "cpu" or perm.numel() == 0:
        # no row to move launches nothing: the buffer is empty
        return mesh_pack_plain(cols, perm, counts), layout
    return _pack_cuda(cols, perm, counts, layout), layout


mesh_pack.launches = 0


def mesh_pack_plain(cols: Sequence[DeviceColumn], perm: torch.Tensor,
                    counts: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of :func:`mesh_pack` (any device): the same
    bytes, pad bytes zero."""
    sections, blocks = pack_layout(cols, counts)
    out = torch.zeros(sections[-1], dtype=torch.uint8, device=perm.device)
    prefix = _cumsum(counts)
    for d, c in enumerate(counts):
        c = int(c)
        if c == 0:
            continue
        rows = perm[prefix[d]:prefix[d] + c].long()
        for col, (data, lens, valid) in zip(cols, blocks[d]):
            rb = col.row_bytes
            out[data:data + c * rb] = \
                col.data[rows].contiguous().view(torch.uint8).reshape(-1)
            if lens >= 0:
                out[lens:lens + 4 * c] = col.lengths[rows].to(
                    torch.int32).contiguous().view(torch.uint8)
            out[valid:valid + c] = col.validity[rows].to(torch.uint8)
    return out


def _upload_table(words: list[int], dev) -> torch.Tensor:
    host = torch.tensor(words, dtype=torch.int64).pin_memory()
    return host.to(dev, non_blocking=True)


def _pack_cuda(cols, perm, counts, layout) -> torch.Tensor:
    lib = native.lib("mesh_exchange")
    sections, blocks = layout
    P, ncols = len(counts), len(cols)
    n = perm.numel()
    if not 1 <= P <= MAX_MESH:
        raise ValueError(f"mesh of {P} sections: must be in [1, {MAX_MESH}]")
    if ncols < 1:
        raise ValueError("a send buffer needs at least one column")
    if perm.dtype != torch.int32 or perm.dim() != 1:
        raise ValueError(f"perm must be int32[n], got {perm.dtype}"
                         f"{tuple(perm.shape)}")
    if sum(int(c) for c in counts) != n:
        raise ValueError(f"counts sum to {sum(counts)}, perm has {n} rows")
    dev = perm.device
    perm = perm.contiguous()
    out = torch.empty(sections[-1], dtype=torch.uint8, device=dev)
    keep, words = [], _cumsum(counts)
    max_chunks = 1
    for col in cols:
        if col.data.device != dev:
            raise ValueError(f"column on {col.data.device}, perm on {dev}")
        d, v = col.data.contiguous(), col.validity.contiguous()
        if d.shape[0] != n or v.shape != (n,) or v.dtype != torch.bool:
            raise ValueError(f"column of {n} rows expected, got data "
                             f"{tuple(d.shape)}, validity {v.dtype}"
                             f"{tuple(v.shape)}")
        ln = None if col.lengths is None else \
            col.lengths.to(torch.int32).contiguous()
        rb = col.row_bytes
        vec = _vec_bytes(ptr(d), rb)
        max_chunks = max(max_chunks, rb // vec)
        words += [ptr(d), ptr(v), 0 if ln is None else ptr(ln), rb, vec]
        keep += [d, v, ln]
    for row in blocks:
        for data, lens, valid in row:
            words += [data, max(lens, 0), valid]
    tab = _upload_table(words, dev)
    native.check(lib.srt_mesh_pack(ptr(tab), P, ncols, ptr(perm), n,
                                   ptr(out), max_chunks,
                                   native.stream_ptr(dev)), "srt_mesh_pack")
    mesh_pack.launches += 1
    return out


def section_columns(buf: torch.Tensor, like: Sequence[DeviceColumn],
                    count: int, blocks_d, base: int = 0
                    ) -> list[DeviceColumn]:
    """The columns of one section of a send buffer, as views of ``buf``:
    ``like`` gives each column's dtype and row width, ``blocks_d`` the
    section's block offsets (:func:`pack_layout`), ``base`` the section's
    own offset where ``buf`` holds only that section."""
    out = []
    for col, (data, lens, valid) in zip(like, blocks_d):
        data -= base
        valid -= base
        tail = tuple(col.data.shape[1:])
        rb = col.row_bytes
        d = buf[data:data + count * rb].view(col.data.dtype) \
            .view((count,) + tail)
        v = buf[valid:valid + count].view(torch.bool)
        ln = None
        if lens >= 0:
            lens -= base
            ln = buf[lens:lens + 4 * count].view(torch.int32)
        out.append(DeviceColumn(d, v, col.dtype, ln))
    return out


# ---------------------------------------------------------------------------
# K15b: unpack
# ---------------------------------------------------------------------------

def mesh_unpack(segments: Sequence[Sequence[DeviceColumn]],
                counts: Sequence[int]) -> list[DeviceColumn]:
    """Front-pack P segments (each a list of columns of ``counts[s]``
    rows, all on one device) into columns of ``sum(counts)`` rows, in
    source-major order; string and array rows are zero-padded to the
    widest W of the segments."""
    dev = segments[0][0].data.device
    if dev.type == "cpu" or sum(int(c) for c in counts) == 0:
        # no row to move launches nothing: the columns are empty
        return mesh_unpack_plain(segments, counts)
    return _unpack_cuda(segments, counts, dev)


mesh_unpack.launches = 0


def mesh_unpack_plain(segments: Sequence[Sequence[DeviceColumn]],
                      counts: Sequence[int]) -> list[DeviceColumn]:
    """Plain PyTorch version of :func:`mesh_unpack` (any device)."""
    out = []
    for j in range(len(segments[0])):
        parts = [seg[j] for seg in segments]
        first = parts[0]
        validity = torch.cat([p.validity for p in parts]).to(torch.bool)
        if first.lengths is not None:
            w = max(p.data.shape[1] for p in parts)
            data = torch.cat([torch.nn.functional.pad(
                p.data, (0, w - p.data.shape[1])) for p in parts])
            lengths = torch.cat([p.lengths for p in parts]).to(torch.int32)
            out.append(DeviceColumn(data, validity, first.dtype, lengths))
        else:
            out.append(DeviceColumn(torch.cat([p.data for p in parts]),
                                    validity, first.dtype))
    return out


def _unpack_cuda(segments, counts, dev) -> list[DeviceColumn]:
    lib = native.lib("mesh_exchange")
    P, ncols = len(segments), len(segments[0])
    if not 1 <= P <= MAX_MESH:
        raise ValueError(f"{P} segments: must be in [1, {MAX_MESH}]")
    if len(counts) != P:
        raise ValueError(f"{len(counts)} counts for {P} segments")
    prefix = _cumsum(counts)
    total = prefix[-1]
    out, keep = [], []
    head, segs = [], []
    max_chunks = 1
    for j in range(ncols):
        parts = [seg[j] for seg in segments]
        first = parts[0]
        var = first.lengths is not None
        w = max(p.data.shape[1] for p in parts) if var else None
        shape = (total, w) if var else (total,)
        od = torch.empty(shape, dtype=first.data.dtype, device=dev)
        ov = torch.empty(total, dtype=torch.bool, device=dev)
        ol = torch.empty(total, dtype=torch.int32, device=dev) if var \
            else None
        out.append(DeviceColumn(od, ov, first.dtype, ol))
        rb = od.element_size() * (w if var else 1)
        vals = [ptr(od), rb]
        for p, c in zip(parts, counts):
            if p.data.device != dev:
                raise ValueError(f"segment on {p.data.device}, expected "
                                 f"{dev}")
            d, v = p.data.contiguous(), p.validity.contiguous()
            if d.shape[0] != c or v.shape != (c,) or d.dtype != od.dtype \
                    or (p.lengths is None) == var:
                raise ValueError(f"segment column {j}: data {d.dtype}"
                                 f"{tuple(d.shape)}, validity "
                                 f"{tuple(v.shape)}, {c} rows of "
                                 f"{od.dtype} expected")
            ln = None if not var else p.lengths.to(torch.int32).contiguous()
            src_rb = d.element_size() * (d.shape[1] if var else 1)
            vals += [ptr(d), src_rb]
            segs += [ptr(d), ptr(v), 0 if ln is None else ptr(ln), src_rb]
            keep += [d, v, ln]
        vec = _vec_bytes(*vals)
        max_chunks = max(max_chunks, rb // vec)
        head += [ptr(od), ptr(ov), 0 if ol is None else ptr(ol), rb, vec]
    tab = _upload_table(prefix + head + segs, dev)
    native.check(lib.srt_mesh_unpack(ptr(tab), P, ncols, total, max_chunks,
                                     native.stream_ptr(dev)),
                 "srt_mesh_unpack")
    mesh_unpack.launches += 1
    return out
