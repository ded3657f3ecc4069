"""Window function kernels (K12).

Port of ``spark_rapids_tpu/ops/window.py``.  After one sort by (partition
keys, order keys), every window shape is index arithmetic over the sorted
batch:

* :func:`sorted_segments` (K12a, ``csrc/window_segments.cu``): each row's
  partition extents ``seg_start``/``seg_end``, its peer-group extents
  (rows with equal order keys) and the running count of order-key changes,
  from the boundary flags of K4's flag pass;
* :func:`_frame_edges`: each row's inclusive frame ``[lo, hi]``; a RANGE
  frame differs from ROWS only in using the peer-group edges;
* :func:`running_or_bounded_agg` (K12b, ``csrc/window_agg.cu``):
  sum/count/avg over any frame and min/max over frames whose lower edge
  is the partition start, by a segmented running scan read at the frame's
  edges; min/max over a frame with a bounded lower edge go to
* :func:`frame_min_max` (K12c, ``csrc/window_range.cu``): a sparse table
  whose levels stop at the widest frame of the batch, read at two
  overlapping spans per row (the reference's ``_sparse_table`` :126 and
  ``_range_query`` :140 build every level over the whole batch);
* :func:`row_number`, :func:`rank`, :func:`dense_rank` from the segment
  arrays, and :func:`lead_lag`, index glue plus K3's gather.

Each wrapper takes its plain PyTorch version only for a CPU tensor; on a
CUDA tensor it launches its kernel or raises.  ``SegmentInfo`` holds
tensors exactly ``num_rows`` long (the reference pads to a power-of-two
capacity with a ``real`` mask and an ``idx == num_rows`` sentinel, for
XLA's static shapes).

Float sums over a frame count NaN, +inf and -inf apart from the finite
values (Spark's sum: NaN if any NaN or both infinities, else the
infinity, else the finite sum), so a non-finite value outside the frame
never enters its result.  The reference subtracts prefix sums over the
whole batch, where one NaN or infinity turns every later frame's
difference into NaN (ROADMAP.md Queue 3).

All results are in sorted order; Spark does not define window output
order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, torch_dtype
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import gather_columns, num_tiles, ptr
from spark_rapids_tpu_torch.ops.segmented import (AggSpec, _cols_differ,
                                                   _segment_flags)
from spark_rapids_tpu_torch.ops.sort import normalize_floats

__all__ = ["WindowFrame", "UNBOUNDED", "CURRENT_ROW", "SegmentInfo",
           "sorted_segments", "segment_extents_plain",
           "running_or_bounded_agg", "running_or_bounded_agg_plain",
           "frame_min_max", "frame_min_max_plain",
           "row_number", "rank", "dense_rank", "lead_lag"]

UNBOUNDED = None
CURRENT_ROW = 0

@dataclass(frozen=True)
class WindowFrame:
    """ROWS/RANGE frame: bounds are None (unbounded) or int row offsets
    (negative = preceding).  RANGE only supports UNBOUNDED/CURRENT_ROW
    bounds (Spark's value-RANGE with literal offsets is a planner
    rejection, as in the reference tagging)."""
    mode: str = "range"            # "rows" | "range"
    lower: int | None = UNBOUNDED  # None=unbounded preceding, k<=0 offset
    upper: int | None = CURRENT_ROW  # None=unbounded following, k>=0

    def __post_init__(self):
        if self.mode == "range":
            assert self.lower in (UNBOUNDED, CURRENT_ROW)
            assert self.upper in (UNBOUNDED, CURRENT_ROW)


@dataclass
class SegmentInfo:
    """Per-row partition and peer-group extents over the sorted batch
    (int32[num_rows] each; ends inclusive)."""
    seg_start: torch.Tensor
    seg_end: torch.Tensor
    peer_start: torch.Tensor
    peer_end: torch.Tensor
    seg_id: torch.Tensor
    order_rank: torch.Tensor  # inclusive count of order-key changes


# ---------------------------------------------------------------------------
# K12a: segment extents
# ---------------------------------------------------------------------------

def _boundary_flags(sb: ColumnBatch, part_idx, order_idx):
    """uint8 partition-start and order-change flags of the sorted rows
    (K4's boundary pass on CUDA); ``part[0]`` is 1 and ``order[0]`` 0."""
    n = sb.num_rows
    dev = sb.device
    if dev.type != "cpu" and n:
        # one boundary pass each, row 0's flag set by the kernel
        part = _segment_flags([sb.columns[k] for k in part_idx], n, dev,
                              first=1)[0] if part_idx else None
        order = _segment_flags([sb.columns[k] for k in order_idx], n, dev,
                               first=0)[0] if order_idx else None
        if part is None:
            part = torch.zeros(n, dtype=torch.uint8, device=dev)
            part[0] = 1
        if order is None:
            order = torch.zeros(n, dtype=torch.uint8, device=dev)
        return part, order
    part = torch.zeros(n, dtype=torch.uint8, device=dev)
    order = torch.zeros(n, dtype=torch.uint8, device=dev)
    for ki in part_idx:
        part |= _cols_differ(sb.columns[ki]).to(torch.uint8)
    for ki in order_idx:
        order |= _cols_differ(sb.columns[ki]).to(torch.uint8)
    if n:
        part[0] = 1
        order[0] = 0
    return part, order


def sorted_segments(sb: ColumnBatch, part_idx, order_idx) -> SegmentInfo:
    """Partition and peer extents of a batch sorted by (partition keys,
    order keys); rows compare equal with null == null and NaN == NaN."""
    part, order = _boundary_flags(sb, part_idx, order_idx)
    if part.device.type == "cpu":
        return segment_extents_plain(part, order)
    return _segment_extents_cuda(part, order)


sorted_segments.launches = 0


def segment_extents_plain(part: torch.Tensor,
                          order: torch.Tensor) -> SegmentInfo:
    """Plain PyTorch version of K12a over the flags (any device)."""
    n = part.numel()
    dev = part.device
    p = part.bool()
    q = p | order.bool()
    seg_id = torch.cumsum(p.to(torch.int64), 0) - 1
    peer_id = torch.cumsum(q.to(torch.int64), 0) - 1
    end = torch.full((1,), n, dtype=torch.int64, device=dev)
    starts = torch.nonzero(p).squeeze(1)
    peers = torch.nonzero(q).squeeze(1)
    i32 = torch.int32
    return SegmentInfo(
        starts[seg_id].to(i32),
        (torch.cat([starts[1:], end])[seg_id] - 1).to(i32),
        peers[peer_id].to(i32),
        (torch.cat([peers[1:], end])[peer_id] - 1).to(i32),
        seg_id.to(i32),
        torch.cumsum(order.to(torch.int64), 0).to(i32))


def _segment_extents_cuda(part: torch.Tensor,
                          order: torch.Tensor) -> SegmentInfo:
    n = part.numel()
    dev = part.device
    out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(6)]
    if n == 0:
        return SegmentInfo(*out)
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed the int32 row index")
    lib = native.lib("window_segments")
    nt = num_tiles(n)
    counts = torch.empty(3 * nt, dtype=torch.int32, device=dev)
    offsets = torch.empty(3 * (nt + 1), dtype=torch.int32, device=dev)
    seg_list = torch.empty(n, dtype=torch.int32, device=dev)
    peer_list = torch.empty(n, dtype=torch.int32, device=dev)
    seg_start, seg_end, peer_start, peer_end, seg_id, order_rank = out
    native.check(lib.srt_window_segments(
        ptr(part.contiguous()), ptr(order.contiguous()), n, ptr(counts),
        ptr(offsets), ptr(seg_list), ptr(peer_list), ptr(seg_start),
        ptr(seg_end), ptr(peer_start), ptr(peer_end), ptr(seg_id),
        ptr(order_rank), native.stream_ptr(dev)), "srt_window_segments")
    sorted_segments.launches += 1
    return SegmentInfo(*out)


# ---------------------------------------------------------------------------
# frame edges
# ---------------------------------------------------------------------------

def _frame_edges(seg: SegmentInfo, frame: WindowFrame):
    """(lo, hi) int32 inclusive row-index bounds per row."""
    if frame.mode == "rows":
        idx = torch.arange(seg.seg_start.numel(), dtype=torch.int32,
                           device=seg.seg_start.device)
        lo = seg.seg_start if frame.lower is UNBOUNDED else \
            torch.maximum(idx + frame.lower, seg.seg_start)
        hi = seg.seg_end if frame.upper is UNBOUNDED else \
            torch.minimum(idx + frame.upper, seg.seg_end)
    else:  # range: CURRENT_ROW means the whole peer group
        lo = seg.seg_start if frame.lower is UNBOUNDED else seg.peer_start
        hi = seg.seg_end if frame.upper is UNBOUNDED else seg.peer_end
    return lo, hi


# ---------------------------------------------------------------------------
# K12b: frame aggregates
# ---------------------------------------------------------------------------

def _check_op(op: str, col: DeviceColumn) -> None:
    if op not in ("sum", "count", "avg", "min", "max"):
        raise ValueError(f"window agg op {op}")
    if op in ("min", "max") and col.is_var_width:
        raise NotImplementedError("windowed min/max over strings/arrays")


def running_or_bounded_agg(op: str, col: DeviceColumn, seg: SegmentInfo,
                           frame: WindowFrame):
    """sum|count|avg|min|max of ``col`` over each row's frame.  Returns
    (data, validity, result_type); null slots hold zeros."""
    _check_op(op, col)
    if col.data.device.type == "cpu":
        return running_or_bounded_agg_plain(op, col, seg, frame)
    if op in ("min", "max") and frame.lower is not UNBOUNDED:
        data, valid = frame_min_max(op, col, *_frame_edges(seg, frame))
        return data, valid, AggSpec(op, 0).result_type(col.dtype)
    return _window_agg_cuda(op, col, seg, frame)


running_or_bounded_agg.launches = 0


def _frame_totals(x: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over each row's frame ``[lo, hi]`` (0 when empty), by
    differences of prefix sums over the whole batch."""
    n = x.numel()
    # an empty frame (lo > hi, e.g. ROWS 2 FOLLOWING..5 FOLLOWING at the
    # partition's tail) totals 0, never a negative cross-partition diff
    hi1 = torch.maximum(hi + 1, lo).clamp(0, n)
    ps = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                    torch.cumsum(x, 0)])
    return ps[hi1] - ps[lo.clamp(0, n)]


def running_or_bounded_agg_plain(op: str, col: DeviceColumn,
                                 seg: SegmentInfo, frame: WindowFrame):
    """Plain PyTorch version of :func:`running_or_bounded_agg` (any
    device): differences of prefix sums over the whole batch with the
    non-finite values counted apart, and the reference's sparse table for
    min/max (:func:`frame_min_max_plain`)."""
    _check_op(op, col)
    n = col.validity.numel()
    dev = col.validity.device
    lo, hi = _frame_edges(seg, frame)
    lo, hi = lo.long(), hi.long()
    contributes = col.validity
    rtype = AggSpec(op, 0).result_type(col.dtype)
    if op in ("min", "max"):
        return (*frame_min_max_plain(op, col, lo, hi), rtype)

    def frame_total(x):
        return _frame_totals(x, lo, hi)

    cnt = frame_total(contributes.to(torch.int64))
    has = cnt > 0
    if op == "count":
        return cnt, torch.ones(n, dtype=torch.bool, device=dev), rtype
    if col.dtype.integral:
        total = frame_total(torch.where(contributes, col.data.long(), 0))
        data = total if op == "sum" else \
            total.double() / cnt.clamp(min=1).double()
    else:
        x = col.data.double()
        fin = contributes & torch.isfinite(x)
        total = frame_total(torch.where(fin, x, 0.0))
        if op == "avg":
            total = total / cnt.clamp(min=1).double()
        nan = frame_total((contributes & torch.isnan(x)).long())
        pinf = frame_total((contributes & (x == float("inf"))).long())
        ninf = frame_total((contributes & (x == float("-inf"))).long())
        data = torch.where(ninf > 0, float("-inf"), total)
        data = torch.where(pinf > 0, float("inf"), data)
        data = torch.where((nan > 0) | ((pinf > 0) & (ninf > 0)),
                           float("nan"), data)
    return torch.where(has, data, torch.zeros((), dtype=data.dtype,
                                              device=dev)), has, rtype


# ---------------------------------------------------------------------------
# K12c: min/max over frames with a bounded lower edge
# ---------------------------------------------------------------------------

def frame_min_max(op: str, col: DeviceColumn, lo: torch.Tensor,
                  hi: torch.Tensor):
    """``op`` ("min" or "max") of ``col`` over each row's inclusive frame
    ``[lo, hi]`` (int32 row indices into the sorted batch, clamped to the
    row's partition; lo > hi is an empty frame), with Spark's float order
    (NaN largest, -0.0 == 0.0).  Returns (data of the column's dtype,
    validity); a frame without a contributing row is null."""
    _check_op(op, col)
    if op not in ("min", "max"):
        raise ValueError(f"frame_min_max op {op}")
    if col.data.device.type == "cpu":
        return frame_min_max_plain(op, col, lo, hi)
    return _frame_min_max_cuda(op, col, lo, hi)


frame_min_max.launches = 0


def frame_min_max_plain(op: str, col: DeviceColumn, lo: torch.Tensor,
                        hi: torch.Tensor):
    """Plain PyTorch version of :func:`frame_min_max` (any device): the
    reference's sparse table over the whole batch, with NaN and the
    result's validity from prefix-sum counts."""
    lo, hi = lo.long(), hi.long()
    dev = col.validity.device
    contributes = col.validity
    cnt = _frame_totals(contributes.to(torch.int64), lo, hi)
    has = cnt > 0
    fop = torch.minimum if op == "min" else torch.maximum
    if col.dtype.fractional:
        x = normalize_floats(col.data)
        isnan = torch.isnan(x)
        ident = float("inf") if op == "min" else float("-inf")
        base = torch.where(contributes & ~isnan, x,
                           torch.full((), ident, dtype=x.dtype, device=dev))
        res = _range_query(_sparse_table(base, fop), lo, hi, fop, ident)
        nan_cnt = _frame_totals((contributes & isnan).long(), lo, hi)
        nan = torch.full((), float("nan"), dtype=x.dtype, device=dev)
        if op == "min":
            res = torch.where(has & (cnt == nan_cnt), nan, res)
        else:
            res = torch.where(nan_cnt > 0, nan, res)
    else:
        d = col.data.long() if col.data.dtype == torch.bool else col.data
        info = torch.iinfo(d.dtype)
        ident = info.max if op == "min" else info.min
        base = torch.where(contributes, d,
                           torch.full((), ident, dtype=d.dtype, device=dev))
        res = _range_query(_sparse_table(base, fop), lo, hi, fop, ident)
        res = res.to(col.data.dtype)
    return torch.where(has, res, torch.zeros((), dtype=res.dtype,
                                             device=dev)), has


_KIND_INT, _KIND_FLOAT, _KIND_BOOL = 0, 1, 2


def _frame_min_max_cuda(op: str, col: DeviceColumn, lo: torch.Tensor,
                        hi: torch.Tensor):
    n = col.validity.numel()
    dev = col.validity.device
    out = torch.zeros(n, dtype=col.data.dtype, device=dev)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, valid
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed the int32 row index")
    lib = native.lib("window_range")
    stream = native.stream_ptr(dev)
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    width = torch.zeros(1, dtype=torch.int32, device=dev)
    native.check(lib.srt_window_range_width(ptr(lo), ptr(hi), n, ptr(width),
                                            stream), "srt_window_range_width")
    levels = max(int(width.item()), 1).bit_length() - 1  # the one sync
    item = col.data.element_size()
    kind = _KIND_BOOL if col.data.dtype == torch.bool else \
        _KIND_FLOAT if col.dtype.fractional else _KIND_INT
    keys = torch.empty((levels + 1) * n, device=dev,
                       dtype=torch.int32 if item <= 4 else torch.int64)
    has = torch.empty((levels + 1) * n, dtype=torch.uint8, device=dev)
    native.check(lib.srt_window_range(
        int(op == "max"), kind, item, ptr(col.data.contiguous()),
        ptr(col.validity.contiguous()), ptr(lo), ptr(hi), n, levels,
        ptr(keys), ptr(has), ptr(out), ptr(valid), stream),
        "srt_window_range")
    frame_min_max.launches += 1
    return out, valid


def _sparse_table(x: torch.Tensor, op) -> list[torch.Tensor]:
    """st[k][i] = op over x[i : i + 2^k), clamped at the end."""
    levels = [x]
    k = 1
    while (1 << k) <= x.numel():
        prev = levels[-1]
        half = 1 << (k - 1)
        shifted = torch.cat([prev[half:], prev[-1:].expand(half)])
        levels.append(op(prev, shifted))
        k += 1
    return levels


def _range_query(levels, lo, hi, op, identity):
    """Per-row op over x[lo..hi] from two overlapping power-of-two spans."""
    x = levels[0]
    n = x.numel()
    res = torch.full_like(x, identity)
    if n == 0:
        return res
    length = (hi - lo + 1).clamp(min=1)
    k = torch.zeros_like(length)
    for kk in range(1, len(levels)):
        k += (length >= (1 << kk)).long()
    for kk, lev in enumerate(levels):
        a = lev[lo.clamp(0, n - 1)]
        b = lev[(hi - (1 << kk) + 1).clamp(0, n - 1)]
        res = torch.where(k == kk, op(a, b), res)
    return torch.where(hi >= lo, res, torch.full_like(res, identity))


_OP_CODES = {("sum", False): 0, ("sum", True): 1, ("avg", False): 2,
             ("avg", True): 3, ("count", False): 4, ("count", True): 4,
             ("min", False): 5, ("max", False): 6, ("min", True): 7,
             ("max", True): 8}


def _window_agg_cuda(op: str, col: DeviceColumn, seg: SegmentInfo,
                     frame: WindowFrame):
    n = col.validity.numel()
    dev = col.validity.device
    rtype = AggSpec(op, 0).result_type(col.dtype)
    fractional = col.dtype.fractional
    out_dtype = col.data.dtype if op in ("min", "max") else torch_dtype(rtype)
    out = torch.zeros(n, dtype=out_dtype, device=dev)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, valid, rtype
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed the int32 row index")
    lib = native.lib("window_agg")
    lo, hi = _frame_edges(seg, frame)
    nt = num_tiles(n)
    piece = lib.srt_window_agg_piece_bytes()
    tiles = torch.empty(nt * piece, dtype=torch.uint8, device=dev)
    carry = torch.empty(nt * piece, dtype=torch.uint8, device=dev)

    def scratch(dtype, keep):
        return torch.empty(n, dtype=dtype, device=dev) if keep else None

    floats = fractional and op != "count"
    run_f = scratch(torch.float64, floats)
    run_i = scratch(torch.int64, not floats and op != "count")
    run_cnt = scratch(torch.int32, True)
    specials = floats and op in ("sum", "avg")
    run_nan, run_pinf, run_ninf = (scratch(torch.int32, specials)
                                   for _ in range(3))
    native.check(lib.srt_window_agg(
        _OP_CODES[(op, fractional)], ptr(col.data.contiguous()),
        ptr(col.validity.contiguous()), int(fractional),
        col.data.element_size(),
        ptr(seg.seg_start.contiguous()), ptr(lo.contiguous()),
        ptr(hi.contiguous()), n, ptr(tiles), ptr(carry), ptr(run_f),
        ptr(run_i), ptr(run_cnt), ptr(run_nan), ptr(run_pinf),
        ptr(run_ninf), ptr(out), ptr(valid), out.element_size(),
        native.stream_ptr(dev)), "srt_window_agg")
    running_or_bounded_agg.launches += 1
    return out, valid, rtype


# ---------------------------------------------------------------------------
# ranking / offset functions (glue over K12a's arrays and K3)
# ---------------------------------------------------------------------------

def row_number(seg: SegmentInfo) -> torch.Tensor:
    idx = torch.arange(seg.seg_start.numel(), dtype=torch.int32,
                       device=seg.seg_start.device)
    return idx - seg.seg_start + 1


def rank(seg: SegmentInfo) -> torch.Tensor:
    return seg.peer_start - seg.seg_start + 1


def dense_rank(seg: SegmentInfo) -> torch.Tensor:
    return seg.order_rank - seg.order_rank[seg.seg_start.long()] + 1


def lead_lag(col: DeviceColumn, seg: SegmentInfo, offset: int,
             default_data=None, default_valid=None, default_len=None):
    """lead (offset > 0) / lag (offset < 0) within the partition: K3's
    gather of row ``i + offset``, a null row outside the partition.

    ``default_*``: optional out-of-partition fill -- data broadcast to the
    rows (a [n, w] byte matrix plus ``default_len`` for strings) and its
    validity.  Returns (data, validity, lengths)."""
    n = seg.seg_start.numel()
    idx = torch.arange(n, dtype=torch.int32, device=seg.seg_start.device)
    src = idx + offset
    in_seg = (src >= seg.seg_start) & (src <= seg.seg_end)
    perm = torch.where(in_seg, src, torch.full_like(src, -1))
    g = gather_columns([col], perm)[0]
    data, validity, lengths = g.data, g.validity, g.lengths
    if default_data is None:
        return data, validity, lengths
    use_def = ~in_seg & default_valid
    if col.is_var_width:
        w = max(data.shape[1], default_data.shape[1])
        pad = torch.nn.functional.pad
        data = pad(data, (0, w - data.shape[1]))
        dd = pad(default_data, (0, w - default_data.shape[1]))
        data = torch.where(use_def[:, None], dd, data)
        lengths = torch.where(use_def, default_len, lengths)
    else:
        data = torch.where(use_def, default_data, data)
    return data, validity | use_def, lengths
