"""Sort-based group-by aggregation (K4).

Port of ``spark_rapids_tpu/ops/segmented.py``: sort rows by the grouping
keys (K1 + K3), flag key changes between neighbouring rows (null == null,
NaN == NaN, -0.0 == 0.0), and reduce each contiguous segment.  Null keys
form their own group.  A grand aggregate (no keys) yields exactly one row,
even on empty input.

:func:`segment_aggregate` is the K4 wrapper: on CUDA it makes three
launches of ``csrc/segmented.cu`` a call -- the boundary pass over every
key column (:func:`_segment_flags`), then one tile launch and one combine
launch over every aggregate, the specs deduplicated into jobs
(:func:`agg_plan`) and passed as one table (:func:`agg_table`) -- with
one host read of the group count between the first two; on the CPU its
plain version mirrors the reference's segment_sum formulation with
``index_add_``, and takes min/max/first/last rows by sorting and
indexing.

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
                           tile_offsets: torch.Tensor | None = None
                           ) -> DeviceColumn:
    """Per segment of rows sorted by the group keys, the least (``is_max``:
    the greatest) valid string of ``col``; a segment without one is null.
    ``flags`` (uint8 [n], 1 at each segment's first row) and ``starts``
    (int32 [G], those rows) are K4's; on CUDA its tile offsets are reused
    when given, else one boundary pass over the flags makes them."""
    if not col.is_string:
        raise ValueError(f"segment_string_min_max over {col.dtype}")
    if col.data.device.type == "cpu":
        return segment_string_min_max_plain(col, flags, starts, is_max)
    return _string_min_max_cuda(col, flags, starts, is_max, tile_offsets)


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


def _string_min_max_cuda(col, flags, starts, is_max, tile_offsets):
    n = col.data.shape[0]
    g = starts.shape[0]
    dev = col.data.device
    if tile_offsets is None:
        _f, tile_offsets, _s = _segment_flags([flags], n, dev, offsets=True)
    slots = torch.empty(2 * (g + num_tiles(n)), dtype=torch.int64,
                        device=dev)
    data = col.data.contiguous()
    if data.data_ptr() % 16:
        data = data.clone()  # rows are compared as aligned words
    pick = torch.empty(g, dtype=torch.int32, device=dev)
    native.check(native.lib("segmented").srt_seg_string_minmax(
        int(is_max), ptr(data), ptr(col.lengths.to(torch.int32).contiguous()),
        ptr(col.validity.contiguous()), col.max_len, ptr(flags), n,
        ptr(tile_offsets), ptr(starts), g, ptr(slots), ptr(pick),
        native.stream_ptr(dev)), "srt_seg_string_minmax")
    segment_string_min_max.launches += 1
    return gather_columns([col], pick)[0]


# ---------------------------------------------------------------------------
# CUDA (csrc/segmented.cu): three launches a call
# ---------------------------------------------------------------------------

#: rows a tile and a thread of the K4 launches (``kTile``, ``kItems``)
SEG_TILE, SEG_ITEMS = 4096, 16
#: table words of a key column, an input column, a job and an output
KEY_WORDS, COL_WORDS, JOB_WORDS, OUT_WORDS = 4, 4, 2, 3
#: the longest key table the boundary pass takes in its parameters; past
#: it the wrapper hands over a device copy
KEY_PARAM_WORDS = 128
#: the aggregate's small and large parameter tables (``kAggSmallWords``,
#: ``kAggLargeWords``); past the large one, a device copy
AGG_SMALL_WORDS, AGG_PARAM_WORDS = 480, 4000
native.share_limits("segmented", (SEG_TILE, SEG_ITEMS, KEY_WORDS, COL_WORDS,
                                  JOB_WORDS, OUT_WORDS, KEY_PARAM_WORDS,
                                  AGG_SMALL_WORDS, AGG_PARAM_WORDS))

#: value kinds of csrc/segmented.cu (``ValKind``); a flag column (uint8,
#: nonzero where a segment starts) is the kind of K4s's given flags
_KIND_INT, _KIND_FLOAT, _KIND_BOOL, _KIND_STRING, _KIND_FLAG = 0, 1, 2, 3, 4
#: the jobs' accumulators (``AggOp``)
OP_SUM_I, OP_SUM_F, OP_COUNT, OP_COUNT_STAR = 0, 1, 3, 4
OP_MIN_I, OP_MAX_I, OP_MIN_F, OP_MAX_F = 5, 6, 7, 8
OP_FIRST, OP_LAST, OP_FIRST_NN, OP_LAST_NN = 9, 10, 11, 12
_PICK_OPS = {"first": OP_FIRST, "last": OP_LAST,
             "first_non_null": OP_FIRST_NN, "last_non_null": OP_LAST_NN}
#: accumulators that read the column's values (staged by the tile launch)
STAGED_OPS = frozenset({OP_SUM_I, OP_SUM_F, OP_MIN_I, OP_MAX_I, OP_MIN_F,
                        OP_MAX_F})
#: accumulators whose count is that of the column's valid rows, so that a
#: count over the column rides on them
VALID_COUNTED_OPS = STAGED_OPS | {OP_COUNT, OP_FIRST_NN, OP_LAST_NN}
#: what an output takes of its job's state (``OutMode``)
OUT_VALUE, OUT_AVG, OUT_COUNT, OUT_PICK = 0, 1, 2, 3


def _kind(col: DeviceColumn) -> tuple[int, int]:
    if col.is_string:
        return _KIND_STRING, col.max_len
    if isinstance(col.dtype, T.BooleanType):
        return _KIND_BOOL, 1
    if col.dtype.fractional:
        return _KIND_FLOAT, col.data.element_size()
    return _KIND_INT, col.data.element_size()


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


def key_table(cols) -> list[int]:
    """The boundary pass's table (:data:`KEY_WORDS` int64 words a key):
    each key's data, validity and lengths (0: fixed width) addresses and
    its kind and row bytes; a uint8 tensor stands for a flag column (a
    segment starts where it is nonzero).  Keys must be contiguous."""
    words = []
    for c in cols:
        if isinstance(c, torch.Tensor):
            words += [c.data_ptr(), 0, 0, _KIND_FLAG | 1 << 8]
            continue
        kind, item = _kind(c)
        words += [c.data.data_ptr(), c.validity.data_ptr(),
                  0 if c.lengths is None else c.lengths.data_ptr(),
                  kind | item << 8]
    return words


#: the boundary pass's look-back state by (device, stream): zero between
#: launches (the last tile of each launch clears it), grown as needed
_STATUS: dict = {}


def _status(dev, stream: int, ntiles: int) -> torch.Tensor:
    return native.lookback_status(_STATUS, dev, stream, ntiles)


def _segment_flags(cols, n: int, dev, first: int = 1,
                   offsets: bool = False):
    """K4's boundary pass, one launch of ``srt_seg_bounds`` over every key
    column (counted once): uint8 flags [n], 1 where row i's key differs
    from row i-1's in any of ``cols`` (null == null, NaN == NaN, -0.0 ==
    0.0), ``first`` at row 0.  With ``offsets``, also the int32 tile
    offsets [ntiles + 2] (the groups started before each tile, then G and
    S) and the tiles that hold a flag (the first S of int32 [ntiles]);
    else those two are None.  The aggregate's boundary pass and the
    window's partition and order flags (ops/window.py)."""
    nt = num_tiles(n)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    tile_offsets = torch.empty(nt + 2, dtype=torch.int32, device=dev) \
        if offsets else None
    spans = torch.empty(nt, dtype=torch.int32, device=dev) \
        if offsets else None
    if n == 0:
        if offsets:
            tile_offsets.zero_()
        return flags, tile_offsets, spans
    keys = [c.contiguous() if isinstance(c, torch.Tensor) else _contig_col(c)
            for c in cols]
    words = key_table(keys)
    stream = native.stream_ptr(dev)
    host, tab = native.param_table(words, len(words) > KEY_PARAM_WORDS, dev)
    native.check(native.lib("segmented").srt_seg_bounds(
        host.buffer_info()[0], len(words), len(keys), ptr(tab), first,
        ptr(flags), ptr(tile_offsets), ptr(spans),
        ptr(_status(dev, stream, nt)) if offsets else None, n, stream),
        "srt_seg_bounds")
    _segment_flags.launches += 1
    return flags, tile_offsets, spans


_segment_flags.launches = 0


@dataclass
class AggPlan:
    """The jobs of one aggregate call.  ``cols``: each input column's child
    index (None: count_star's rows), ``jobs``: (column position, op),
    grouped by column, ``outs``: (job, mode, torch dtype), grouped by job;
    ``spec_out``: each spec's output (None for string min/max, K4s);
    ``col_jobs``, ``job_outs``: the jobs of each column, the outputs of
    each job."""
    cols: list
    jobs: list
    outs: list
    spec_out: list
    col_jobs: list
    job_outs: list


def _job_of(op: str, col):
    """(accumulator op, output mode, output dtype) of a spec that is not a
    count, a percentile or a string min/max; ``col``: its column's
    (is_string, integral, fractional, torch dtype)."""
    if op == "count_star":
        return OP_COUNT_STAR, OUT_COUNT, torch.int64
    if op == "sum":
        if col[1]:
            return OP_SUM_I, OUT_VALUE, torch.int64
        return OP_SUM_F, OUT_VALUE, torch.float64
    if op == "avg":
        return OP_SUM_F, OUT_AVG, torch.float64
    if op in ("min", "max"):
        base = OP_MIN_F if col[2] else OP_MIN_I
        return base + (op == "max"), OUT_VALUE, col[3]
    if op in _PICK_OPS:
        return _PICK_OPS[op], OUT_PICK, torch.int32
    raise NotImplementedError(f"aggregate op {op}")


#: plans by (specs, the signature of their columns): a group-by makes the
#: same plan for every batch
_PLANS: dict = {}


def agg_plan(sb: ColumnBatch, aggs: list[AggSpec]) -> AggPlan:
    """Deduplicate ``aggs`` into jobs and outputs: identical specs share an
    output, a sum and an average of a double column share a job (over an
    integer column sum folds in wrapping int64, avg in doubles: two jobs),
    a count (and a percentile's count of valid values) rides on the first
    job over its column whose count is that of the valid rows, else gets a
    count job of its own.  Plans are kept by the specs and their columns'
    types."""
    specs = tuple((a.op, None if a.op == "count_star" else a.child_index)
                  for a in aggs)
    sig = {ci: (c.is_string, c.dtype.integral, c.dtype.fractional,
                c.data.dtype)
           for ci, c in ((ci, sb.columns[ci]) for _op, ci in specs
                         if ci is not None)}
    key = (specs, tuple(sorted(sig.items())))
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) > 1024:
            _PLANS.clear()
        plan = _PLANS[key] = _build_plan(specs, sig)
    return plan


def _build_plan(specs, sig) -> AggPlan:
    cols, jobs, outs = [], [], []
    col_pos, job_pos, out_pos = {}, {}, {}

    def job(ci, op):
        if ci not in col_pos:
            col_pos[ci] = len(cols)
            cols.append(ci)
        key = (col_pos[ci], op)
        if key not in job_pos:
            job_pos[key] = len(jobs)
            jobs.append(key)
        return job_pos[key]

    def out(j, mode, dtype):
        key = (j, mode, dtype)
        if key not in out_pos:
            out_pos[key] = len(outs)
            outs.append(key)
        return out_pos[key]

    spec_out, counts = [], []
    for i, (op, ci) in enumerate(specs):
        col = None if ci is None else sig[ci]
        if op in ("count", "percentile"):
            counts.append(i)
        elif op in ("min", "max") and col[0]:
            pass
        else:
            jop, mode, dtype = _job_of(op, col)
            spec_out.append((i, out(job(ci, jop), mode, dtype)))
            continue
        spec_out.append((i, None))
    spec_out = dict(spec_out)
    for i in counts:
        ci = specs[i][1]
        cp = col_pos.get(ci)
        j = next((k for k, (c, op) in enumerate(jobs)
                  if c == cp and op in VALID_COUNTED_OPS), None)
        if j is None:
            j = job(ci, OP_COUNT)
        spec_out[i] = out(j, OUT_COUNT, torch.int64)
    # jobs grouped by column, outputs by job (stable), indices remapped
    jorder = sorted(range(len(jobs)), key=lambda k: jobs[k][0])
    jnew = {old: new for new, old in enumerate(jorder)}
    oorder = sorted(range(len(outs)), key=lambda k: jnew[outs[k][0]])
    onew = {old: new for new, old in enumerate(oorder)}
    jobs = [jobs[k] for k in jorder]
    outs = [(jnew[outs[k][0]],) + outs[k][1:] for k in oorder]
    col_jobs, job_outs = [0] * len(cols), [0] * len(jobs)
    for c, _op in jobs:
        col_jobs[c] += 1
    for j, *_rest in outs:
        job_outs[j] += 1
    return AggPlan(cols, jobs, outs,
                   [None if spec_out[i] is None else onew[spec_out[i]]
                    for i in range(len(specs))], col_jobs, job_outs)


def agg_outputs(plan: AggPlan, g: int, dev) -> list:
    """(data, validity or None) views of every output of ``plan`` over
    ``g`` groups, carved from one allocation (16-byte aligned views)."""
    rnd = lambda x: -(-x // 16) * 16  # noqa: E731
    vb = rnd(g)
    total = sum(rnd(dtype.itemsize * g) + (0 if mode == OUT_PICK else vb)
                for _j, mode, dtype in plan.outs)
    buf = torch.empty(max(total, 16), dtype=torch.uint8, device=dev)
    views, off = [], 0
    for _j, mode, dtype in plan.outs:
        a = dtype.itemsize * g
        data = buf[off:off + a].view(dtype)
        off += rnd(a)
        valid = None
        if mode != OUT_PICK:
            valid = buf[off:off + g].view(torch.bool)
            off += vb
        views.append((data, valid))
    return views


def agg_table(sb: ColumnBatch, plan: AggPlan, views) -> list[int]:
    """The aggregate's table: each input column (:data:`COL_WORDS` words:
    data and validity addresses, 0 for count_star's rows; kind | staged <<
    8 | item << 16; first job | jobs << 32), each job (:data:`JOB_WORDS`:
    op; first output | outputs << 32), each output (:data:`OUT_WORDS`:
    data and validity addresses, mode | kind << 8 | item << 16).  Input
    columns must be contiguous."""
    words = []
    j0 = 0
    for pos, ci in enumerate(plan.cols):
        nj = plan.col_jobs[pos]
        staged = int(any(op in STAGED_OPS
                         for _c, op in plan.jobs[j0:j0 + nj]))
        if ci is None:
            words += [0, 0, 0, j0 | nj << 32]
        else:
            col = sb.columns[ci]
            kind, item = _kind(col)
            words += [col.data.data_ptr(), col.validity.data_ptr(),
                      kind | staged << 8 | item << 16, j0 | nj << 32]
        j0 += nj
    o0 = 0
    for j, (_c, op) in enumerate(plan.jobs):
        no = plan.job_outs[j]
        words += [op, o0 | no << 32]
        o0 += no
    for (data, valid), (_j, mode, dtype) in zip(views, plan.outs):
        kind = _KIND_FLOAT if dtype.is_floating_point else _KIND_INT
        words += [data.data_ptr(), 0 if valid is None else valid.data_ptr(),
                  mode | kind << 8 | data.element_size() << 16]
    return words


def combine_threads(ntiles: int, nspans: int) -> int:
    """Threads a combine block: a block of 256 where a spanning group has
    many pieces on average (two a tile), one warp where they are few."""
    return 256 if 2 * ntiles >= 64 * max(nspans, 1) else 32


def _contig_col(c: DeviceColumn) -> DeviceColumn:
    if all(t is None or t.is_contiguous()
           for t in (c.data, c.validity, c.lengths)):
        return c
    return DeviceColumn(c.data.contiguous(), c.validity.contiguous(),
                        c.dtype, None if c.lengths is None
                        else c.lengths.contiguous())


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
    nt = num_tiles(n)
    cols = list(sb.columns)
    for i in set(key_indices) | {s.child_index for s in aggs
                                 if s.op != "count_star"}:
        cols[i] = _contig_col(cols[i])
    sb = ColumnBatch(cols, n, sb.schema, dev)
    plan = agg_plan(sb, aggs)
    strings = [i for i, o in enumerate(plan.spec_out) if o is None
               and aggs[i].op in ("min", "max")]
    keys = [sb.columns[k] for k in key_indices]
    flags = offsets = spans = None
    g, nspans = 1, 1
    if keys or strings:
        # the one host read: the group count and the tiles with a flag
        flags, offsets, spans = _segment_flags(keys, n, dev, offsets=True)
        if keys:
            g, nspans = offsets[nt:].tolist()
    starts = torch.empty(g, dtype=torch.int32, device=dev)
    views = agg_outputs(plan, g, dev)
    words = agg_table(sb, plan, views)
    njobs = len(plan.jobs)
    slots = torch.empty(max(njobs, 1) * 4 * nt, dtype=torch.int64,
                        device=dev)
    host, tab = native.param_table(words, len(words) > AGG_PARAM_WORDS, dev)
    args = (host.buffer_info()[0], len(words), len(plan.cols), njobs,
            len(plan.outs), ptr(tab))
    native.check(lib.srt_seg_agg_tiles(
        *args, ptr(flags), ptr(offsets), ptr(starts), ptr(slots), n, g,
        stream), "srt_seg_agg_tiles")
    if njobs:
        native.check(lib.srt_seg_agg_combine(
            *args, ptr(offsets if keys else None),
            ptr(spans if keys else None), nspans, ptr(starts), ptr(slots),
            n, g, combine_threads(nt, nspans), stream),
            "srt_seg_agg_combine")
    segment_aggregate.launches += 1
    key_cols = gather_columns(keys, starts) if keys else []
    # percentiles: one K4p launch per value column, serving every q over it
    pct: dict[tuple, DeviceColumn] = {}
    by_col: dict[int, list[float]] = {}
    for spec in aggs:
        if spec.op == "percentile":
            by_col.setdefault(spec.child_index, []).append(spec.param)
    for ci, qs in by_col.items():
        i = next(k for k, s in enumerate(aggs)
                 if s.op == "percentile" and s.child_index == ci)
        col = sb.columns[ci]
        data, valid = segment_percentile(col.data.to(torch.float64), starts,
                                         views[plan.spec_out[i]][0], qs)
        for j, q in enumerate(qs):
            pct[(ci, q)] = DeviceColumn(data[j], valid[j], T.DoubleType())
    outs = []
    for i, spec in enumerate(aggs):
        if spec.op == "percentile":
            outs.append(pct[(spec.child_index, spec.param)])
            continue
        col = sb.columns[spec.child_index] if spec.op != "count_star" \
            else None
        o = plan.spec_out[i]
        if o is None:  # string min/max: K4s
            outs.append(segment_string_min_max(col, flags, starts,
                                               spec.op == "max", offsets))
            continue
        data, valid = views[o]
        if plan.outs[o][1] == OUT_PICK:
            outs.append(gather_columns([col], data)[0])
            continue
        rtype = spec.result_type(col.dtype if col is not None
                                 else T.LongType())
        outs.append(DeviceColumn(data, valid, rtype))
    return key_cols, outs, g
