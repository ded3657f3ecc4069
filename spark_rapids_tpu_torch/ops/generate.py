"""Generate kernels: explode of split strings (K14a, K14b) and of arrays
(K14c).

Port of ``spark_rapids_tpu/exec/generate.py``: ``_jit_counts`` (:138),
``_jit_generate`` (:149) with ``_first_ge`` (:210), and
``_jit_generate_array`` (:90).  Strings are the column contract's byte
matrices (uint8 ``[n, W]``, int32 lengths, bool validity); arrays are
element matrices ``[n, W]`` of the element's dtype with the same lengths
and validity (null rows have no elements).

* K14a, :func:`split_counts`: the pieces of every row of
  ``split(str, d)`` -- the delimiter bytes before the row's length plus
  one; 0 for a null row, 1 under ``outer`` -- with their total and the
  widest piece of the batch, both read by the host in one copy.
* K14b, :func:`split_emit`: output row ``offsets[row] + r`` holds piece
  ``r`` of source row ``row``: its bytes (zero past its length up to the
  output width), length, validity 1, ``src = row`` and ``pos = r``; under
  ``outer`` a null row gives one null row.
* K14c, :func:`array_emit`: output row ``offsets[row] + k`` holds element
  ``k`` of source row ``row``; under ``outer`` a null or empty array
  gives one null row.

All three run source-row-major in ``csrc/generate.cu`` (no output slot
searches its row).  The offsets are K7's exclusive scan
(``ops/join.py`` ``_offsets_cuda``, ``csrc/join_expand.cu``), and the
exec gathers the child columns by ``src`` with K3.  The delimiter is one
ASCII byte, so it never matches inside a multi-byte UTF-8 character.

Beside each kernel is its plain PyTorch version, which follows the
reference's method: ``repeat_interleave`` for the source rows, a
cumulative delimiter count and a first-at-least search for the piece
edges, a gather for the bytes and the elements.  A wrapper takes it only
for a tensor on the CPU; on a CUDA tensor it launches its kernel or
raises.  Each wrapper counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.join import I32MAX, _offsets_cuda
from spark_rapids_tpu_torch.ops.kernels import ptr
from spark_rapids_tpu_torch.ops.strings import _aligned

__all__ = ["split_counts", "split_counts_plain", "split_emit",
           "split_emit_plain", "array_counts", "array_emit",
           "array_emit_plain"]


def _check_matrix(data, lengths, validity, what: str) -> None:
    if data.dim() != 2:
        raise ValueError(f"{what}: data must be [n, W], got "
                         f"{tuple(data.shape)}")
    n = data.shape[0]
    if lengths.shape != (n,) or validity.shape != (n,):
        raise ValueError(f"{what}: lengths and validity must be [{n}]")


def _check_strings(data, lengths, validity, delim: int, what: str) -> None:
    _check_matrix(data, lengths, validity, what)
    if data.dtype != torch.uint8 or data.shape[1] % 4:
        raise ValueError(f"{what}: strings must be uint8 [n, W] with W a "
                         f"multiple of 4, got {data.dtype}"
                         f"{tuple(data.shape)}")
    if not 0 <= delim < 0x80:
        raise ValueError(f"{what}: the delimiter must be one ASCII byte, "
                         f"got {delim}")


def _check_total(total: int) -> None:
    if total > I32MAX:
        raise ValueError(
            f"one batch of the generate would produce {total} rows, more "
            f"than the int32 row indices hold ({I32MAX}); lower "
            "spark.rapids.sql.reader.batchRows")


def _emit_plan(emit: torch.Tensor, total: int):
    """(src, k): the source row and the index within it of every output
    row, as the reference's plan gives them (int64 [total])."""
    n = emit.numel()
    dev = emit.device
    e = emit.to(torch.int64)
    offsets = torch.cumsum(e, 0) - e
    src = torch.repeat_interleave(torch.arange(n, device=dev), e,
                                  output_size=total)
    k = torch.arange(total, dtype=torch.int64, device=dev) - offsets[src]
    return src, k


# ---------------------------------------------------------------------------
# K14a: pieces per row
# ---------------------------------------------------------------------------

def split_counts(data: torch.Tensor, lengths: torch.Tensor,
                 validity: torch.Tensor, delim: int, outer: bool):
    """Pieces of ``split(str, delim)`` per row.  Returns (emit int32 [n],
    total, widest): ``emit`` the output rows of every row (delimiters + 1
    for a valid row; for a null row 0, or 1 under ``outer``), ``total``
    their sum and ``widest`` the longest piece of a valid row in bytes,
    the last two host ints (one device-to-host copy)."""
    _check_strings(data, lengths, validity, delim, "split_counts")
    if data.device.type == "cpu":
        return split_counts_plain(data, lengths, validity, delim, outer)
    return _split_counts_cuda(data, lengths, validity, delim, outer)


split_counts.launches = 0


def _delims(data, lengths, delim):
    """(bool [n, W] delimiter bytes inside the lengths, bool [n, W] bytes
    inside the lengths)."""
    w = data.shape[1]
    inside = torch.arange(w, device=data.device)[None, :] < \
        lengths.to(torch.int64)[:, None]
    return (data == delim) & inside, inside


def split_counts_plain(data, lengths, validity, delim: int, outer: bool):
    """Plain PyTorch version of :func:`split_counts` (any device)."""
    n, w = data.shape
    is_d, inside = _delims(data, lengths, delim)
    counts = is_d.sum(1, dtype=torch.int32) + 1
    emit = torch.where(validity, counts,
                       torch.full_like(counts, 1 if outer else 0))
    # piece p of a row holds its bytes with p delimiters before them
    before = torch.cumsum(is_d, 1) - is_d.to(torch.int64)
    sizes = torch.zeros((n, w + 1), dtype=torch.int32, device=data.device)
    sizes.scatter_add_(1, before, (inside & ~is_d).to(torch.int32))
    widest = sizes[validity].max() if bool(validity.any()) else 0
    return emit, int(emit.sum(dtype=torch.int64)), int(widest)


def _split_counts_cuda(data, lengths, validity, delim, outer):
    n, w = data.shape
    dev = data.device
    emit = torch.empty(n, dtype=torch.int32, device=dev)
    stats = torch.empty(2, dtype=torch.int64, device=dev)
    data = _aligned(data)
    lengths = lengths.to(torch.int32).contiguous()
    validity = validity.contiguous()
    native.check(native.lib("generate").srt_split_counts(
        ptr(data), w, ptr(lengths), ptr(validity), n, delim, int(outer),
        ptr(emit), ptr(stats), native.stream_ptr(dev)), "srt_split_counts")
    split_counts.launches += 1
    total, widest = stats.tolist()
    return emit, total, widest


# ---------------------------------------------------------------------------
# K14b: the pieces
# ---------------------------------------------------------------------------

def split_emit(data: torch.Tensor, lengths: torch.Tensor,
               validity: torch.Tensor, delim: int, outer: bool,
               emit: torch.Tensor, total: int, out_w: int):
    """The pieces of every row, in row order, as ``total`` output rows of
    width ``out_w`` (a multiple of 4, at least the widest piece).
    ``emit`` and ``total`` are :func:`split_counts`'.  Returns (uint8
    [total, out_w] piece bytes with zeros past each piece, int32 lengths,
    bool validity, int32 src, int32 pos); pos shares the pieces'
    validity."""
    _check_strings(data, lengths, validity, delim, "split_emit")
    _check_total(total)
    if out_w <= 0 or out_w % 4:
        raise ValueError(f"split_emit: out_w {out_w} is not a positive "
                         "multiple of 4")
    if data.device.type == "cpu":
        return split_emit_plain(data, lengths, validity, delim, outer, emit,
                                total, out_w)
    return _split_emit_cuda(data, lengths, validity, delim, outer, emit,
                            total, out_w)


split_emit.launches = 0


def _first_ge(cum: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per row: the first column where ``cum >= k`` (W if none)."""
    w = cum.shape[1]
    idx = torch.arange(w, device=cum.device)
    return torch.where(cum >= k[:, None], idx, w).amin(1)


def split_emit_plain(data, lengths, validity, delim: int, outer: bool,
                     emit, total: int, out_w: int):
    """Plain PyTorch version of :func:`split_emit` (any device): the
    reference's dense plan over every output row."""
    w = data.shape[1]
    dev = data.device
    is_d, _inside = _delims(data, lengths, delim)
    counts = torch.where(validity, is_d.sum(1) + 1, 0)
    src, k = _emit_plan(emit, total)
    has = k < counts[src]
    src_cum = torch.cumsum(is_d, 1)[src]
    start = torch.where(k > 0, _first_ge(src_cum, k) + 1, 0)
    end = torch.minimum(_first_ge(src_cum, k + 1),
                        lengths.to(torch.int64)[src])
    start = torch.minimum(start, end)
    plen = torch.where(has, end - start, 0)
    j = torch.arange(out_w, device=dev)
    take = (start[:, None] + j[None, :]).clamp(0, w - 1)
    piece = torch.gather(data[src], 1, take)
    piece = torch.where(j[None, :] < plen[:, None], piece,
                        torch.zeros((), dtype=torch.uint8, device=dev))
    return (piece, plen.to(torch.int32), has, src.to(torch.int32),
            torch.where(has, k, 0).to(torch.int32))


def _split_emit_cuda(data, lengths, validity, delim, outer, emit, total,
                     out_w):
    n, w = data.shape
    dev = data.device
    stream = native.stream_ptr(dev)
    out = torch.empty((total, out_w), dtype=torch.uint8, device=dev)
    out_len = torch.empty(total, dtype=torch.int32, device=dev)
    out_valid = torch.empty(total, dtype=torch.bool, device=dev)
    src = torch.empty(total, dtype=torch.int32, device=dev)
    pos = torch.empty(total, dtype=torch.int32, device=dev)
    if total == 0:
        return out, out_len, out_valid, src, pos
    offsets = _offsets_cuda(native.lib("join_expand"), emit, stream)
    data = _aligned(data)
    lengths = lengths.to(torch.int32).contiguous()
    validity = validity.contiguous()
    native.check(native.lib("generate").srt_split_emit(
        ptr(data), w, ptr(lengths), ptr(validity), n, delim, int(outer),
        ptr(offsets),
        ptr(out), out_w, ptr(out_len), ptr(out_valid), ptr(src), ptr(pos),
        stream), "srt_split_emit")
    split_emit.launches += 1
    return out, out_len, out_valid, src, pos


# ---------------------------------------------------------------------------
# K14c: array elements
# ---------------------------------------------------------------------------

def array_counts(lengths: torch.Tensor, validity: torch.Tensor,
                 outer: bool):
    """(emit int32 [n], total): the output rows of every array row -- its
    length when valid, else 0; at least 1 under ``outer`` -- and their sum
    (a host int: one device-to-host copy).  A length read, no kernel."""
    emit = torch.where(validity, lengths.to(torch.int32), 0)
    if outer:
        emit = emit.clamp_min(1)
    return emit.to(torch.int32), int(emit.sum(dtype=torch.int64))


def array_emit(data: torch.Tensor, lengths: torch.Tensor,
               validity: torch.Tensor, outer: bool, emit: torch.Tensor,
               total: int):
    """The elements of every array row, in row order, as ``total`` output
    rows; ``emit`` and ``total`` are :func:`array_counts`'.  Returns
    (elements [total] of the data's dtype, bool validity, int32 src,
    int32 pos); pos shares the elements' validity."""
    _check_matrix(data, lengths, validity, "array_emit")
    _check_total(total)
    if data.device.type == "cpu":
        return array_emit_plain(data, lengths, validity, outer, emit, total)
    return _array_emit_cuda(data, lengths, validity, outer, emit, total)


array_emit.launches = 0


def array_emit_plain(data, lengths, validity, outer: bool, emit,
                     total: int):
    """Plain PyTorch version of :func:`array_emit` (any device)."""
    w = data.shape[1]
    counts = torch.where(validity, lengths.to(torch.int64), 0)
    src, k = _emit_plan(emit, total)
    has = k < counts[src]
    elem = data[src, k.clamp(0, max(w - 1, 0))] if w else \
        torch.zeros(total, dtype=data.dtype, device=data.device)
    elem = torch.where(has, elem, torch.zeros((), dtype=data.dtype,
                                              device=data.device))
    return (elem, has, src.to(torch.int32),
            torch.where(has, k, 0).to(torch.int32))


def _array_emit_cuda(data, lengths, validity, outer, emit, total):
    n, w = data.shape
    dev = data.device
    stream = native.stream_ptr(dev)
    out = torch.empty(total, dtype=data.dtype, device=dev)
    out_valid = torch.empty(total, dtype=torch.bool, device=dev)
    src = torch.empty(total, dtype=torch.int32, device=dev)
    pos = torch.empty(total, dtype=torch.int32, device=dev)
    if total == 0:
        return out, out_valid, src, pos
    offsets = _offsets_cuda(native.lib("join_expand"), emit, stream)
    data = data.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    validity = validity.contiguous()
    native.check(native.lib("generate").srt_array_emit(
        ptr(data), data.element_size(), w, ptr(lengths), ptr(validity), n,
        int(outer), ptr(offsets), ptr(out),
        ptr(out_valid), ptr(src), ptr(pos), stream), "srt_array_emit")
    array_emit.launches += 1
    return out, out_valid, src, pos
