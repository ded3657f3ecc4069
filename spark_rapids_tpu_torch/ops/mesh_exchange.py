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
  the pad bytes are zero.  The kernel works in tiles of up to
  :data:`PACK_TILE_ROWS` rows of one (destination, column) block
  (:func:`pack_plan`) and writes 16-byte chunks.
* K15b :func:`mesh_unpack`, ``srt_mesh_unpack``: P segments (sections of
  send buffers, :func:`section_columns`, or a shard's own columns for an
  all-gather) front-packed in source-major order, string rows zero-padded
  to the widest W of the sources.  Each (column, source) block whose row
  width equals the output's is one contiguous byte range, so the kernel
  is a batched copy of spans (:func:`unpack_plan`), tiled.

Each has its plain PyTorch version beside it (:func:`mesh_pack_plain`,
:func:`mesh_unpack_plain`).  A wrapper takes it only for tensors on the
CPU; on CUDA tensors it launches its kernel or raises.  Each counts its
launches in ``.launches``.  Both pass their tables by value in the
kernel's parameters, or as a device copy where they are longer than the
parameters hold: K15a's (:func:`pack_plan`) names each column's pointers
and row width, the destinations' row prefix and each (destination,
column) block's offset; K15b's (:func:`unpack_plan`) lists byte spans.
"""
from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import ptr

__all__ = ["pack_layout", "mesh_pack", "mesh_pack_plain", "section_columns",
           "mesh_unpack", "mesh_unpack_plain", "unpack_outputs",
           "unpack_plan", "pack_plan", "MAX_MESH"]

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


#: int64 words of one column in K15a's table (csrc/mesh_exchange.cu
#: ``kPackColWords``): data, validity, lengths, row bytes | vec << 32
PACK_COL_WORDS = 4
#: rows of one K15a tile (``kPackTileRows``): a tile lies inside one
#: (destination, column) block
PACK_TILE_ROWS = 2048


def pack_plan(cols: Sequence[DeviceColumn], counts: Sequence[int], layout,
              tile_rows: int = PACK_TILE_ROWS) -> tuple[list[int], int]:
    """K15a's table for one send buffer: ``(words, ntiles)``.  ``words``
    holds :data:`PACK_COL_WORDS` words a column (data, validity and
    lengths addresses, the lengths 0 for a fixed-width column, and the row
    bytes | vec << 32, vec the widest power-of-two load of at most 16 bytes
    dividing the row bytes and the data's address), the destinations' row
    prefix (``P + 1`` words), then the data offset of each (destination,
    column) block in the buffer (``layout``'s, destination-major).  Tile
    t is chunk ``t // (P * ncols)`` (``tile_rows`` rows) of destination
    ``t // ncols % P``, column ``t % ncols``; ``ntiles`` covers the
    largest destination, and a tile past its destination's rows does
    nothing.  Reads only shapes and addresses, so it runs on any
    device."""
    _sections, blocks = layout
    words = []
    for col in cols:
        d = col.data
        rb = col.row_bytes
        words += (d.data_ptr(), col.validity.data_ptr(),
                  0 if col.lengths is None else col.lengths.data_ptr(),
                  rb | _vec_bytes(d.data_ptr(), rb) << 32)
    words += _cumsum(counts)
    for row in blocks:
        words += (data for data, _lens, _valid in row)
    chunks = max(-(-int(c) // tile_rows) for c in counts)
    return words, chunks * len(counts) * len(cols)


def _pack_cuda(cols, perm, counts, layout) -> torch.Tensor:
    lib = native.lib("mesh_exchange")
    sections, _blocks = layout
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
    ready = []
    for col in cols:
        d, v = col.data.contiguous(), col.validity.contiguous()
        if d.device != dev or d.shape[0] != n or v.shape != (n,) \
                or v.dtype != torch.bool:
            raise ValueError(f"column of {n} rows on {dev} expected, got "
                             f"data {tuple(d.shape)} on {d.device}, "
                             f"validity {v.dtype}{tuple(v.shape)}")
        ln = None if col.lengths is None else \
            col.lengths.to(torch.int32).contiguous()
        ready.append(DeviceColumn(d, v, col.dtype, ln))
    words, ntiles = pack_plan(ready, counts, layout)
    host, tab = native.param_table(words, len(words) > UNPACK_PARAM_WORDS,
                                   dev)
    out = torch.empty(sections[-1], dtype=torch.uint8, device=dev)
    native.check(lib.srt_mesh_pack(host.buffer_info()[0], len(words), P,
                                   ncols, ntiles, ptr(tab), ptr(perm),
                                   ptr(out), native.stream_ptr(dev)),
                 "srt_mesh_pack")
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
    if dev.type == "cpu" or sum(counts) == 0:
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


#: output bytes of one K15b tile (csrc/mesh_exchange.cu ``kTileBytes``):
#: one block copies one tile at a time
UNPACK_TILE = 32 * 1024
#: int64 words of one K15b span: source, destination, rows, source row
#: bytes, destination row bytes
SPAN_WORDS = 5
#: most table words K15b's small parameter struct holds
#: (csrc/mesh_exchange.cu ``kUnpackSmallWords``)
UNPACK_SMALL_WORDS = 480
#: most table words K15b's kernel parameters hold (csrc/mesh_exchange.cu
#: ``kUnpackLargeWords``); a longer table is read from a device copy
UNPACK_PARAM_WORDS = 4000
# the kernel library must report the same constants when it is loaded
native.share_limits("mesh_exchange", (SPAN_WORDS, UNPACK_TILE,
                                      UNPACK_SMALL_WORDS, UNPACK_PARAM_WORDS,
                                      PACK_COL_WORDS, PACK_TILE_ROWS))


def unpack_outputs(segments: Sequence[Sequence[DeviceColumn]],
                   counts: Sequence[int], dev) -> list[DeviceColumn]:
    """Uninitialised output columns of :func:`mesh_unpack` on ``dev``:
    ``sum(counts)`` rows each, string and array matrices at the widest W
    of the segments."""
    total = sum(counts)
    out = []
    for j, first in enumerate(segments[0]):
        if first.lengths is not None:
            w = max(seg[j].data.shape[1] for seg in segments)
            out.append(DeviceColumn(
                torch.empty((total, w), dtype=first.data.dtype, device=dev),
                torch.empty(total, dtype=torch.bool, device=dev),
                first.dtype,
                torch.empty(total, dtype=torch.int32, device=dev)))
        else:
            out.append(DeviceColumn(
                torch.empty(total, dtype=first.data.dtype, device=dev),
                torch.empty(total, dtype=torch.bool, device=dev),
                first.dtype))
    return out


def unpack_plan(segments: Sequence[Sequence[DeviceColumn]],
                counts: Sequence[int], out: Sequence[DeviceColumn],
                tile: int = UNPACK_TILE) -> tuple[list[int], int, int]:
    """K15b's byte copies for one destination: ``(words, nspans,
    ntiles)``.  ``words`` holds :data:`SPAN_WORDS` words a span, then the
    first tile of each span and the tile count (``nspans + 1`` words).

    A span is one block (data, lengths or validity) of one (column,
    source) pair with rows: ``(src, dst, rows, src_w, dst_w)`` by
    address.  Where ``src_w == dst_w`` it is one contiguous range of
    ``rows * dst_w`` bytes, cut into tiles of ``tile`` bytes; else (a
    string or array source narrower than the output) each row's ``src_w``
    bytes are copied and the rest of its ``dst_w`` zeroed, in tiles of
    ``max(1, tile // dst_w)`` rows.  Sources of 0 rows give no span.
    Validity bytes are copied as they are: every source's are 0/1 (bool
    shard columns, or K15a's sections, which write 0/1).  Reads only
    shapes and addresses, so it runs on any device."""
    spans, starts = [], [0]
    ntiles = 0
    i32, boolean = torch.int32, torch.bool
    for j, oc in enumerate(out):
        od, ov, ol = oc.data, oc.validity, oc.lengths
        dt, gdev = od.dtype, od.get_device()
        var = ol is not None
        rb = od.element_size() * (od.shape[1] if var else 1)
        d0, v0 = od.data_ptr(), ov.data_ptr()
        l0 = ol.data_ptr() if var else 0
        rows_per_tile = max(1, tile // rb) if rb else 1
        at = 0
        for seg, c in zip(segments, counts):
            if not c:
                continue
            p = seg[j]
            d, v, ln = p.data, p.validity, p.lengths
            if d.dtype is not dt or v.dtype is not boolean \
                    or d.shape[0] != c or v.shape[0] != c \
                    or (ln is None) == var or not d.is_contiguous() \
                    or not v.is_contiguous() or d.get_device() != gdev:
                raise ValueError(f"segment column {j}: data {d.dtype}"
                                 f"{tuple(d.shape)} on {d.device}, "
                                 f"validity {v.dtype}{tuple(v.shape)}; "
                                 f"{c} contiguous rows of {dt} on "
                                 f"{od.device} expected")
            if var:
                if ln.dtype is not i32 or not ln.is_contiguous():
                    raise ValueError(f"segment column {j}: lengths must "
                                     "be contiguous int32")
                if rb:
                    sw = d.element_size() * d.shape[1]
                    spans += (d.data_ptr(), d0 + at * rb, c, sw, rb)
                    ntiles += -(-c * rb // tile) if sw == rb \
                        else -(-c // rows_per_tile)
                    starts.append(ntiles)
                spans += (ln.data_ptr(), l0 + 4 * at, c, 4, 4)
                ntiles += -(-4 * c // tile)
                starts.append(ntiles)
            elif rb:
                spans += (d.data_ptr(), d0 + at * rb, c, rb, rb)
                ntiles += -(-c * rb // tile)
                starts.append(ntiles)
            spans += (v.data_ptr(), v0 + at, c, 1, 1)
            ntiles += -(-c // tile)
            starts.append(ntiles)
            at += c
    return spans + starts, len(starts) - 1, ntiles


def _unpack_cuda(segments, counts, dev) -> list[DeviceColumn]:
    lib = native.lib("mesh_exchange")
    P = len(segments)
    if not 1 <= P <= MAX_MESH:
        raise ValueError(f"{P} segments: must be in [1, {MAX_MESH}]")
    if len(counts) != P:
        raise ValueError(f"{len(counts)} counts for {P} segments")
    out = unpack_outputs(segments, counts, dev)
    words, nspans, ntiles = unpack_plan(segments, counts, out)
    host, tab = native.param_table(words, len(words) > UNPACK_PARAM_WORDS,
                                   dev)
    native.check(lib.srt_mesh_unpack(host.buffer_info()[0], len(words),
                                     nspans, ntiles, ptr(tab),
                                     native.stream_ptr(dev)),
                 "srt_mesh_unpack")
    mesh_unpack.launches += 1
    return out
