"""Sort-based group-by aggregation (K4).

Port of ``spark_rapids_tpu/ops/segmented.py``: sort rows by the grouping
keys (K1 + K3), flag key changes between neighbouring rows (null == null,
NaN == NaN, -0.0 == 0.0), and reduce each contiguous segment.  Null keys
form their own group.  A grand aggregate (no keys) yields exactly one row,
even on empty input.

:func:`segment_aggregate` is the K4 wrapper: on CUDA it runs
``csrc/segmented.cu``; on the CPU its plain version mirrors the reference's
segment_sum formulation with ``index_add_``, and takes min/max/first/last
rows by sorting and indexing.

A percentile sorts the rows by (keys, value ascending, value nulls last)
with K1, so each segment's valid values lie at its front in order (NaN
last, -0.0 tied with 0.0); K4 counts them, and :func:`segment_percentile`
(K4p, ``srt_seg_percentile`` in ``csrc/segmented.cu``) picks
``v[lo] + (v[hi] - v[lo]) * frac`` at ``pos = (count - 1) * q`` for every
q over the column in one launch.

String min/max (K4s, :func:`segment_string_min_max`,
``srt_seg_string_minmax``) reduces each segment of the key-sorted rows to
the row of its least (greatest) valid string, ordered as the sort orders
strings (bytes as big-endian words, then the length), and K3 gathers
those rows; the plain version sorts (segment, null last, the string's
sort operands) and takes each segment's first row, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, torch_dtype
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import (gather_columns, gather_plain,
                                                num_tiles, ptr)
from spark_rapids_tpu_torch.ops.sort import (SortOrder, chain_sort,
                                             encode_key_operands,
                                             normalize_floats, sort_batch)

__all__ = ["AggSpec", "sorted_group_by", "segment_aggregate",
           "segment_aggregate_plain", "segment_percentile",
           "segment_percentile_plain", "segment_string_min_max",
           "segment_string_min_max_plain"]

_AGG_OPS = ("sum", "count", "count_star", "min", "max", "avg", "first", "last",
            "first_non_null", "last_non_null", "percentile")


@dataclass(frozen=True)
class AggSpec:
    op: str           # one of _AGG_OPS
    child_index: int  # input column (ignored for count_star)
    param: float | None = None  # percentile fraction q in [0, 1]

    def result_type(self, input_type: T.DataType) -> T.DataType:
        if self.op in ("count", "count_star"):
            return T.LongType()
        if self.op == "sum":
            return T.LongType() if input_type.integral else T.DoubleType()
        if self.op in ("avg", "percentile"):
            return T.DoubleType()
        return input_type


def sorted_group_by(batch: ColumnBatch, key_indices: list[int],
                    aggs: list[AggSpec],
                    presorted: bool = False) -> ColumnBatch:
    """Group ``batch`` by key columns, computing ``aggs``.

    Output schema: key columns (original names/types) then one column per
    agg; one row per group.  ``presorted``: rows equal on the keys are
    already contiguous, so the sort is skipped."""
    pct_cols = sorted({s.child_index for s in aggs if s.op == "percentile"})
    if len(pct_cols) > 1:
        raise NotImplementedError(
            "percentile aggregates over multiple distinct columns in one "
            "group-by are not supported (one value-sort per group-by)")
    sb = batch
    if (key_indices and not presorted) or pct_cols:
        orders = [SortOrder(i, True, True) for i in key_indices]
        orders += [SortOrder(i, True, False) for i in pct_cols]
        sb = sort_batch(batch, orders)
    key_cols, agg_cols, num_groups = segment_aggregate(sb, key_indices, aggs)
    fields = [batch.schema.fields[ki] for ki in key_indices]
    for spec, col in zip(aggs, agg_cols):
        arg = "1" if spec.op == "count_star" else \
            batch.schema.names[spec.child_index]
        name = f"count({arg})" if spec.op == "count_star" \
            else f"{spec.op}({arg})"
        fields.append(T.StructField(name, col.dtype))
    return ColumnBatch(key_cols + agg_cols, num_groups, T.Schema(fields),
                       batch.device)


def segment_aggregate(sb: ColumnBatch, key_indices: list[int],
                      aggs: list[AggSpec]):
    """(key columns, aggregate columns, group count) of rows already
    sorted by the keys."""
    if sb.device.type == "cpu":
        return segment_aggregate_plain(sb, key_indices, aggs)
    return _segment_aggregate_cuda(sb, key_indices, aggs)


segment_aggregate.launches = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _cols_differ(col: DeviceColumn) -> torch.Tensor:
    """bool[n]: row i's key differs from row i-1's (null == null)."""
    v = col.validity
    v_prev = torch.roll(v, 1)
    if col.is_string:
        data_diff = (col.data != torch.roll(col.data, 1, 0)).any(1) | \
            (col.lengths != torch.roll(col.lengths, 1))
    elif col.dtype.fractional:
        d = normalize_floats(col.data)
        d_prev = torch.roll(d, 1)
        data_diff = (d != d_prev) & ~(torch.isnan(d) & torch.isnan(d_prev))
    else:
        data_diff = col.data != torch.roll(col.data, 1)
    return (v != v_prev) | (v & v_prev & data_diff)


def segment_aggregate_plain(sb: ColumnBatch, key_indices: list[int],
                            aggs: list[AggSpec]):
    """Plain PyTorch version of :func:`segment_aggregate` (any device)."""
    n = sb.num_rows
    dev = sb.device
    idx = torch.arange(n, device=dev)
    if key_indices:
        flag = idx == 0
        for ki in key_indices:
            flag = flag | _cols_differ(sb.columns[ki])
        seg_id = torch.cumsum(flag.to(torch.int64), 0) - 1
        num_groups = int(seg_id[-1].item()) + 1 if n else 0
        starts = torch.nonzero(flag, as_tuple=False).squeeze(1)
        key_cols = gather_plain([sb.columns[k] for k in key_indices],
                                starts.to(torch.int32))
    else:
        seg_id = torch.zeros(n, dtype=torch.int64, device=dev)
        num_groups = 1
        key_cols = []
    g = num_groups
    seg_real_cnt = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
        0, seg_id, torch.ones(n, dtype=torch.int64, device=dev))
    out = []
    for spec in aggs:
        col = sb.columns[spec.child_index] if spec.op != "count_star" \
            else None
        out.append(_compute_agg_plain(spec, col, seg_id, g, n,
                                      seg_real_cnt))
    return key_cols, out, num_groups


def _zero(dtype, dev):
    return torch.zeros((), dtype=dtype, device=dev)


def _compute_agg_plain(spec: AggSpec, col: DeviceColumn | None, seg_id,
                       g: int, n: int, seg_real_cnt) -> DeviceColumn:
    op = spec.op
    dev = seg_id.device
    i64 = torch.int64
    if op == "count_star":
        return DeviceColumn(seg_real_cnt, torch.ones(g, dtype=torch.bool,
                                                     device=dev), T.LongType())
    contributes = col.validity
    cnt_valid = torch.zeros(g, dtype=i64, device=dev).index_add_(
        0, seg_id, contributes.to(i64))
    has = cnt_valid > 0
    if op == "count":
        return DeviceColumn(cnt_valid, torch.ones(g, dtype=torch.bool,
                                                  device=dev), T.LongType())
    if op in ("sum", "avg"):
        acc = i64 if (col.dtype.integral and op == "sum") else torch.float64
        contrib = torch.where(contributes, col.data.to(acc), _zero(acc, dev))
        s = torch.zeros(g, dtype=acc, device=dev).index_add_(0, seg_id,
                                                              contrib)
        if op == "avg":
            data = s / cnt_valid.clamp(min=1).to(torch.float64)
            rtype = T.DoubleType()
        else:
            data = s
            rtype = T.LongType() if col.dtype.integral else T.DoubleType()
        return DeviceColumn(torch.where(has, data, _zero(data.dtype, dev)),
                            has, rtype)
    if op in ("min", "max"):
        return _min_max_plain(op, col, contributes, seg_id, g, n, has)
    if op == "percentile":
        if spec.param is None:
            raise ValueError("percentile AggSpec needs param=q")
        all_rows = torch.ones(n, dtype=torch.bool, device=dev)
        starts = _first_last_index(all_rows, seg_id, g, last=False)
        data, valid = segment_percentile_plain(col.data.to(torch.float64),
                                               starts, cnt_valid,
                                               [spec.param])
        return DeviceColumn(data[0], valid[0], T.DoubleType())
    if op in ("first", "last", "first_non_null", "last_non_null"):
        eligible = contributes if op.endswith("non_null") else \
            torch.ones(n, dtype=torch.bool, device=dev)
        pick = _first_last_index(eligible, seg_id, g,
                                 last=op.startswith("last"))
        return gather_plain([col], pick.to(torch.int32))[0]
    raise NotImplementedError(f"aggregate op {op}")


def _first_last_index(eligible, seg_id, g: int, last: bool):
    """Per segment, the first (or last) row index where ``eligible``, -1
    when there is none.  Segments are contiguous, so this is indexing
    alone (scatter_reduce's 64-bit min/max is a compare-and-swap loop on
    CUDA, which serialises when millions of rows share a few groups)."""
    e = torch.nonzero(eligible, as_tuple=False).squeeze(1)
    pick = torch.full((g,), -1, dtype=torch.int64, device=seg_id.device)
    if e.numel():
        es = seg_id[e]
        edge = torch.ones(e.numel(), dtype=torch.bool, device=e.device)
        if last:
            edge[:-1] = es[1:] != es[:-1]
        else:
            edge[1:] = es[1:] != es[:-1]
        pick[es[edge]] = e[edge]
    return pick


def _min_max_plain(op, col, contributes, seg_id, g, n, has):
    """Min/max by a per-segment sort: order rows by (segment,
    non-contributing last, the column's sort operands) and take each
    segment's first row -- the reference's string min/max
    (segmented.py:216), here for every type.  The sort operands put NaN
    above every number, so min is NaN only when all values are, and max
    whenever one is (Spark); -0.0 comes out as 0.0."""
    words = encode_key_operands(col, ascending=(op == "min"))
    order = chain_sort([seg_id, (~contributes).to(torch.int64), *words], n,
                       seg_id.device)
    s_seg = seg_id[order]
    firsts = torch.ones(n, dtype=torch.bool, device=seg_id.device)
    if n:
        firsts[1:] = s_seg[1:] != s_seg[:-1]
    take = firsts & contributes[order]
    pick = torch.full((g,), -1, dtype=torch.int64, device=seg_id.device)
    pick[s_seg[take]] = order[take]
    out = gather_plain([col], pick.to(torch.int32))[0]
    data = normalize_floats(out.data) if col.dtype.fractional else out.data
    return DeviceColumn(data, out.validity & has, col.dtype, out.lengths)


# ---------------------------------------------------------------------------
# K4p: the percentile pick
# ---------------------------------------------------------------------------

def segment_percentile(values: torch.Tensor, starts: torch.Tensor,
                       counts: torch.Tensor, qs):
    """Per segment g and fraction q, the linear interpolation at
    ``pos = (counts[g] - 1) * q`` of the segment's sorted valid values
    ``values[starts[g] : starts[g] + counts[g]]`` (float64): ``v[lo] +
    (v[hi] - v[lo]) * (pos - lo)``, ``lo``/``hi`` the floor and ceiling
    of ``pos``.  Returns (float64 [len(qs), G], bool [len(qs), G]); a
    segment without values is null (0.0)."""
    qs = [float(q) for q in qs]
    if any(not 0.0 <= q <= 1.0 for q in qs):
        raise ValueError(f"percentile fractions must be in [0, 1]: {qs}")
    if values.dtype != torch.float64 or starts.shape != counts.shape:
        raise ValueError("segment_percentile: float64 values and starts "
                         "and counts of one shape expected")
    if values.device.type == "cpu":
        return segment_percentile_plain(values, starts, counts, qs)
    return _segment_percentile_cuda(values, starts, counts, qs)


segment_percentile.launches = 0


def segment_percentile_plain(values: torch.Tensor, starts: torch.Tensor,
                             counts: torch.Tensor, qs):
    """Plain PyTorch version of :func:`segment_percentile` (any device):
    the reference's formula (``ops/segmented.py:262-281``), one separately
    rounded operation at a time."""
    dev = values.device
    n = values.shape[0]
    q = torch.tensor([float(x) for x in qs], dtype=torch.float64,
                     device=dev)[:, None]
    counts = counts.to(torch.int64)
    has = (counts > 0)[None, :].expand(q.shape[0], -1)
    if n == 0:
        return (torch.zeros(has.shape, dtype=torch.float64, device=dev),
                has.clone())
    pos = (counts - 1).to(torch.float64)[None, :] * q
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(torch.float64)
    base = starts.to(torch.int64).clamp(0, n - 1)[None, :]
    vlo = values[(base + lo).clamp(0, n - 1)]
    vhi = values[(base + hi).clamp(0, n - 1)]
    data = vlo + (vhi - vlo) * frac
    return torch.where(has, data, _zero(torch.float64, dev)), has.clone()


def _segment_percentile_cuda(values, starts, counts, qs):
    g = starts.shape[0]
    dev = values.device
    out = torch.empty((len(qs), g), dtype=torch.float64, device=dev)
    out_valid = torch.empty((len(qs), g), dtype=torch.bool, device=dev)
    if g == 0 or not qs:
        return out, out_valid
    q = torch.tensor(qs, dtype=torch.float64).to(dev)
    native.check(native.lib("segmented").srt_seg_percentile(
        ptr(values.contiguous()), values.shape[0],
        ptr(starts.to(torch.int32).contiguous()),
        ptr(counts.to(torch.int64).contiguous()), g, ptr(q), len(qs),
        ptr(out), ptr(out_valid), native.stream_ptr(dev)),
        "srt_seg_percentile")
    segment_percentile.launches += 1
    return out, out_valid


# ---------------------------------------------------------------------------
# K4s: string min/max
# ---------------------------------------------------------------------------

def segment_string_min_max(col: DeviceColumn, flags: torch.Tensor,
                           starts: torch.Tensor, is_max: bool,
                           tile_offsets: torch.Tensor | None = None,
                           slots: torch.Tensor | None = None
                           ) -> DeviceColumn:
    """Per segment of rows sorted by the group keys, the least (``is_max``:
    the greatest) valid string of ``col``; a segment without one is null.
    ``flags`` (uint8 [n], 1 at each segment's first row) and ``starts``
    (int32 [G], those rows) are K4's boundary pass; on CUDA its tile
    offsets and its aggregate scratch ``slots`` are reused when given."""
    if not col.is_string:
        raise ValueError(f"segment_string_min_max over {col.dtype}")
    if col.data.device.type == "cpu":
        return segment_string_min_max_plain(col, flags, starts, is_max)
    return _string_min_max_cuda(col, flags, starts, is_max, tile_offsets,
                                slots)


segment_string_min_max.launches = 0


def segment_string_min_max_plain(col: DeviceColumn, flags: torch.Tensor,
                                 starts: torch.Tensor,
                                 is_max: bool) -> DeviceColumn:
    """Plain PyTorch version of :func:`segment_string_min_max` (any
    device): the reference's per-segment sort."""
    n = col.data.shape[0]
    g = starts.shape[0]
    seg_id = torch.cumsum(flags.to(torch.int64), 0) - 1
    has = torch.zeros(g, dtype=torch.int64, device=seg_id.device).index_add_(
        0, seg_id, col.validity.to(torch.int64)) > 0
    return _min_max_plain("max" if is_max else "min", col, col.validity,
                          seg_id, g, n, has)


def _string_min_max_cuda(col, flags, starts, is_max, tile_offsets, slots):
    n = col.data.shape[0]
    g = starts.shape[0]
    dev = col.data.device
    lib = native.lib("segmented")
    stream = native.stream_ptr(dev)
    nt = num_tiles(n)
    if tile_offsets is None:
        tile_offsets = torch.empty(nt + 1, dtype=torch.int32, device=dev)
        native.check(lib.srt_seg_prepare(
            ptr(flags), n, ptr(torch.empty(nt, dtype=torch.int32,
                                           device=dev)),
            ptr(tile_offsets), stream), "srt_seg_prepare")
    if slots is None:
        slots = torch.empty(2 * (g + nt), dtype=torch.int64, device=dev)
    data = col.data.contiguous()
    if data.data_ptr() % 16:
        data = data.clone()  # rows are compared as aligned words
    pick = torch.empty(g, dtype=torch.int32, device=dev)
    native.check(lib.srt_seg_string_minmax(
        int(is_max), ptr(data), ptr(col.lengths.to(torch.int32).contiguous()),
        ptr(col.validity.contiguous()), col.max_len, ptr(flags), n,
        ptr(tile_offsets), ptr(starts), g, ptr(slots), ptr(pick), stream),
        "srt_seg_string_minmax")
    segment_string_min_max.launches += 1
    return gather_columns([col], pick)[0]


# ---------------------------------------------------------------------------
# CUDA (csrc/segmented.cu)
# ---------------------------------------------------------------------------

_OP_CODES = {"count": 3, "count_star": 4, "avg": 2, "first": 9, "last": 10,
             "first_non_null": 11, "last_non_null": 12}
_KIND_INT, _KIND_FLOAT, _KIND_BOOL, _KIND_STRING = 0, 1, 2, 3


def _kind(col: DeviceColumn) -> tuple[int, int]:
    if col.is_string:
        return _KIND_STRING, col.max_len
    if isinstance(col.dtype, T.BooleanType):
        return _KIND_BOOL, 1
    if col.dtype.fractional:
        return _KIND_FLOAT, col.data.element_size()
    return _KIND_INT, col.data.element_size()


def _op_code(spec: AggSpec, col: DeviceColumn | None) -> int:
    if spec.op in _OP_CODES:
        return _OP_CODES[spec.op]
    if spec.op == "sum":
        return 0 if col.dtype.integral else 1
    if spec.op in ("min", "max"):
        base = 7 if col.dtype.fractional else 5
        return base + (spec.op == "max")
    raise NotImplementedError(f"aggregate op {spec.op}")


def _check_cuda_covered(sb: ColumnBatch, aggs: list[AggSpec]) -> None:
    for spec in aggs:
        if spec.op not in _AGG_OPS:
            raise NotImplementedError(f"aggregate op {spec.op}")


def _empty_grand(spec: AggSpec, col: DeviceColumn | None, dev):
    """One output row of a grand aggregate over zero rows: counts are 0,
    every other aggregate is null."""
    rtype = spec.result_type(col.dtype if col is not None else T.LongType())
    valid = torch.tensor([spec.op in ("count", "count_star")], device=dev)
    if col is not None and col.is_var_width and spec.op not in ("count",):
        return DeviceColumn(torch.zeros((1, col.max_len), dtype=torch.uint8,
                                        device=dev), valid, rtype,
                            torch.zeros(1, dtype=torch.int32, device=dev))
    return DeviceColumn(torch.zeros(1, dtype=torch_dtype(rtype), device=dev),
                        valid, rtype)


def _segment_flags(cols: list[DeviceColumn], flags: torch.Tensor) -> None:
    """Set ``flags[i]`` (uint8, CUDA) where row i's key differs from row
    i-1's in any of ``cols`` (null == null, NaN == NaN, -0.0 == 0.0): one
    launch of ``srt_seg_flags`` per column, each counted.  The boundary
    pass of the aggregate and of the join's key ids (ops/join.py)."""
    lib = native.lib("segmented")
    stream = native.stream_ptr(flags.device)
    for c in cols:
        kind, item = _kind(c)
        data = c.data.contiguous()
        if kind == _KIND_STRING and data.data_ptr() % 4:
            data = data.clone()
        native.check(lib.srt_seg_flags(
            ptr(data), ptr(c.validity.contiguous()),
            ptr(None if c.lengths is None else c.lengths.contiguous()),
            kind, item, ptr(flags), flags.numel(), stream), "srt_seg_flags")
        _segment_flags.launches += 1


_segment_flags.launches = 0


def _segment_aggregate_cuda(sb: ColumnBatch, key_indices: list[int],
                            aggs: list[AggSpec]):
    _check_cuda_covered(sb, aggs)
    n = sb.num_rows
    dev = sb.device
    if n == 0:
        if key_indices:
            empty = [DeviceColumn(torch.empty((0,) + tuple(c.data.shape[1:]),
                                              dtype=c.data.dtype, device=dev),
                                  torch.empty(0, dtype=torch.bool,
                                              device=dev), c.dtype,
                                  None if c.lengths is None else
                                  torch.empty(0, dtype=torch.int32,
                                              device=dev))
                     for c in sb.columns]
            keys = [empty[k] for k in key_indices]
            outs = []
            for spec in aggs:
                src = empty[spec.child_index] if spec.op != "count_star" \
                    else None
                rtype = spec.result_type(src.dtype if src is not None
                                         else T.LongType())
                if src is not None and src.is_var_width:
                    outs.append(src)
                else:
                    outs.append(DeviceColumn(
                        torch.empty(0, dtype=torch_dtype(rtype), device=dev),
                        torch.empty(0, dtype=torch.bool, device=dev), rtype))
            return keys, outs, 0
        return [], [_empty_grand(s, None if s.op == "count_star"
                                 else sb.columns[s.child_index], dev)
                    for s in aggs], 1
    lib = native.lib("segmented")
    stream = native.stream_ptr(dev)
    flags = torch.zeros(n, dtype=torch.uint8, device=dev)
    if key_indices:
        _segment_flags([sb.columns[ki] for ki in key_indices], flags)
    else:
        flags[0] = 1
    nt = num_tiles(n)
    counts = torch.empty(nt, dtype=torch.int32, device=dev)
    offsets = torch.empty(nt + 1, dtype=torch.int32, device=dev)
    native.check(lib.srt_seg_prepare(ptr(flags), n, ptr(counts),
                                     ptr(offsets), stream), "srt_seg_prepare")
    g = int(offsets[nt].item())
    starts = torch.empty(g, dtype=torch.int32, device=dev)
    native.check(lib.srt_seg_starts(ptr(flags), n, ptr(offsets), ptr(starts),
                                    stream), "srt_seg_starts")
    key_cols = gather_columns([sb.columns[k] for k in key_indices], starts) \
        if key_indices else []
    slots = torch.empty(2 * (g + nt), dtype=torch.int64, device=dev)

    def run(code, col, out_data, out_valid):
        if col is None:
            data, valid, kind, item = flags, flags, _KIND_INT, 1
        else:
            data, valid = col.data.contiguous(), col.validity.contiguous()
            kind, item = _kind(col)
        out_kind = _KIND_FLOAT if out_data.dtype.is_floating_point \
            else _KIND_INT
        native.check(lib.srt_seg_agg(
            code, ptr(data), ptr(valid), kind, item, ptr(flags), n,
            ptr(offsets), ptr(starts), g, ptr(slots), ptr(out_data),
            ptr(out_valid), out_kind, out_data.element_size(), stream),
            "srt_seg_agg")

    # percentiles: one valid count and one K4p launch per value column,
    # serving every q over it
    pct: dict[tuple, DeviceColumn] = {}
    by_col: dict[int, list[float]] = {}
    for spec in aggs:
        if spec.op == "percentile":
            by_col.setdefault(spec.child_index, []).append(spec.param)
    for ci, qs in by_col.items():
        col = sb.columns[ci]
        valid_counts = torch.empty(g, dtype=torch.int64, device=dev)
        run(_OP_CODES["count"], col, valid_counts,
            torch.empty(g, dtype=torch.bool, device=dev))
        data, valid = segment_percentile(col.data.to(torch.float64),
                                         starts, valid_counts, qs)
        for j, q in enumerate(qs):
            pct[(ci, q)] = DeviceColumn(data[j], valid[j], T.DoubleType())
    outs = []
    for spec in aggs:
        if spec.op == "percentile":
            outs.append(pct[(spec.child_index, spec.param)])
            continue
        col = sb.columns[spec.child_index] if spec.op != "count_star" \
            else None
        if spec.op in ("min", "max") and col.is_string:
            outs.append(segment_string_min_max(col, flags, starts,
                                               spec.op == "max", offsets,
                                               slots))
            continue
        code = _op_code(spec, col)
        picks = spec.op in ("first", "last", "first_non_null",
                            "last_non_null")
        rtype = spec.result_type(col.dtype if col is not None
                                 else T.LongType())
        out_dtype = torch.int32 if picks else torch_dtype(rtype)
        out_data = torch.empty(g, dtype=out_dtype, device=dev)
        out_valid = torch.empty(g, dtype=torch.bool, device=dev)
        run(code, col, out_data, out_valid)
        if picks:
            outs.append(gather_columns([col], out_data)[0])
        else:
            outs.append(DeviceColumn(out_data, out_valid, rtype))
    segment_aggregate.launches += 1
    return key_cols, outs, g
