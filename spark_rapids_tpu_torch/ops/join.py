"""Equi-join kernels K5-K7 (port of ``spark_rapids_tpu/ops/join.py``).

The reference joins sort-merge style, from XLA primitives:

1. **key ids** (K6, ``_key_ids``): both sides' key columns concatenated,
   one stable sort, segment boundaries -> a dense int32 rank per row that
   is comparable across sides (NaN == NaN, -0.0 == 0.0, null keys never
   match);
2. **probe**: the match range ``[start, end)`` of every stream row in
   the sorted build -- over the rank ids (K6, ``_probe``) or, for one
   integral key, over the build keys sorted once per query (K5,
   ``build_prepare_fast`` + ``probe_fast``); per-row output counts by
   join type;
3. **expansion** (K7, ``join_indices_from_probe``): output slot j ->
   (stream row, build row); full outer appends the unmatched build rows;
   ``gather_join_output`` gathers both sides (K3).

On CUDA the sorts are K1 (``sort_permutation``), the gathers K3 and the
boundary flags K4's ``srt_seg_flags``; the new kernels are
``csrc/join_probe.cu`` (K5: build-key rewrite, the binary-search probe
with per-join-type counts and the batch total), ``csrc/join_ids.cu``
(K6: flags -> dense ids, scattered back to the rows) and
``csrc/join_expand.cu`` (K7: exclusive scan of the counts, one binary
search per output slot, the full-outer tail, the matched-build bitmap).
Beside each is its plain PyTorch version; a wrapper takes it only for a
tensor on the CPU and counts its kernel launches in ``.launches``.

Differences from the reference, all from the port's unpadded batches:
arrays are exactly ``num_rows`` long, ``_out_cnt`` needs no row mask, a
probe returns its output total beside the arrays (summed by the kernel),
and ``join_indices_from_probe`` sizes its output to that exact total and
returns ``(li, ri)`` with ``-1`` where that side of a slot is null (the
reference's ``l_take``/``r_take`` are ``li >= 0``/``ri >= 0``).  Offsets
and indices stay int32 as in the reference; a stream batch whose output
would pass 2^31 - 1 rows raises instead of wrapping.

Right outer join is the exec layer's job (swap sides, reorder columns,
``exec/joins.py``), as in the reference.
"""
from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import (gather_columns, gather_plain,
                                                num_tiles, ptr)
from spark_rapids_tpu_torch.ops.segmented import (_cols_differ,
                                                  _segment_flags)
from spark_rapids_tpu_torch.ops.sort import (SortOrder, chain_sort,
                                             encode_key_operands,
                                             sort_permutation,
                                             sort_permutation_plain)

__all__ = ["JOIN_TYPES", "I32MAX", "build_prepare_fast",
           "build_prepare_fast_plain", "probe_fast", "probe_fast_plain",
           "join_search", "key_ids_plain", "join_probe", "join_probe_plain",
           "join_total",
           "join_indices_from_probe", "join_indices_plain",
           "gather_join_output", "matched_build_rows",
           "matched_build_rows_plain"]

JOIN_TYPES = ("inner", "left", "semi", "anti", "full", "cross")

I32MAX = 2 ** 31 - 1

#: join type -> out_cnt rule of the search kernel (csrc/join_probe.cu)
_JT_CODES = {"inner": 0, "left": 1, "full": 1, "semi": 2, "anti": 3}
_SEARCH_TYPES = (torch.int8, torch.int16, torch.int32, torch.int64)
#: the fast path's build sort: [null flag, key], nulls last
_NULLS_LAST = [SortOrder(0, True, False)]


def _one_col_batch(col: DeviceColumn) -> ColumnBatch:
    return ColumnBatch([col], col.capacity,
                       T.Schema([T.StructField("k", col.dtype)]),
                       col.data.device)


def _ids_col(ids: torch.Tensor) -> DeviceColumn:
    return DeviceColumn(ids, torch.ones(ids.numel(), dtype=torch.bool,
                                        device=ids.device), T.IntegerType())


def _combined_key_column(lc: DeviceColumn, rc: DeviceColumn) -> DeviceColumn:
    """Concatenate one key column from both sides (string widths padded
    to the max of the two)."""
    assert type(lc.dtype) is type(rc.dtype), (lc.dtype, rc.dtype)
    validity = torch.cat([lc.validity, rc.validity])
    if lc.is_var_width:
        w = max(lc.max_len, rc.max_len)
        ld = torch.nn.functional.pad(lc.data, (0, w - lc.max_len))
        rd = torch.nn.functional.pad(rc.data, (0, w - rc.max_len))
        return DeviceColumn(torch.cat([ld, rd]), validity, lc.dtype,
                            torch.cat([lc.lengths, rc.lengths]))
    return DeviceColumn(torch.cat([lc.data, rc.data]), validity, lc.dtype)


def _out_cnt(cnt: torch.Tensor, join_type: str) -> torch.Tensor:
    """Output rows per stream row (every port row is real)."""
    if join_type == "inner":
        return cnt
    if join_type in ("left", "full"):
        return torch.clamp(cnt, min=1)
    if join_type == "semi":
        return (cnt > 0).to(torch.int32)
    if join_type == "anti":
        return (cnt == 0).to(torch.int32)
    raise ValueError(f"join_type {join_type}")


def _ranges_plain(lkey, skey, nv, lvalid, join_type: str):
    """Plain version of the search kernel: (start, cnt, out_cnt)."""
    start = torch.searchsorted(skey, lkey, right=False)
    end = torch.searchsorted(skey, lkey, right=True)
    if nv is not None:
        end = torch.minimum(end, nv.to(end.dtype))
        start = torch.minimum(start, end)
    cnt = (end - start).to(torch.int32)
    if lvalid is not None:
        cnt = torch.where(lvalid, cnt, torch.zeros((), dtype=torch.int32,
                                                   device=cnt.device))
    return start.to(torch.int32), cnt, _out_cnt(cnt, join_type)


# ---------------------------------------------------------------------------
# the search kernel shared by K5 and K6 (csrc/join_probe.cu)
# ---------------------------------------------------------------------------

def join_search(lkey: torch.Tensor, lvalid: torch.Tensor | None,
                skey: torch.Tensor, nv: torch.Tensor | None, jt: str,
                total: torch.Tensor, want_ranges: bool = True):
    """Per row of ``lkey``: its match range in the sorted ``skey``
    (clipped to ``nv`` when given), the count (0 where ``lvalid`` is
    False) and the join type's output count; the output counts are added
    to ``total`` (int64[1]).  Returns (start, cnt, out_cnt)."""
    if lkey.dtype not in _SEARCH_TYPES or skey.dtype != lkey.dtype:
        raise ValueError(f"search keys must share one integral dtype, got "
                         f"{lkey.dtype} and {skey.dtype}")
    if lkey.device.type == "cpu":
        start, cnt, out_cnt = _ranges_plain(lkey, skey, nv, lvalid, jt)
        total += out_cnt.sum(dtype=torch.int64)
        return start, cnt, out_cnt
    lib = native.lib("join_probe")
    # bound to names: each buffer must outlive the asynchronous launch
    lkey, skey = lkey.contiguous(), skey.contiguous()
    lvalid = None if lvalid is None else lvalid.contiguous()
    n, dev = lkey.numel(), lkey.device
    start = torch.empty(n, dtype=torch.int32, device=dev) \
        if want_ranges else None
    cnt = torch.empty(n, dtype=torch.int32, device=dev) \
        if want_ranges else None
    out_cnt = torch.empty(n, dtype=torch.int32, device=dev)
    native.check(lib.srt_join_search(
        ptr(lkey), ptr(lvalid), n, ptr(skey), skey.numel(), ptr(nv),
        lkey.element_size(), _JT_CODES[jt], ptr(start), ptr(cnt),
        ptr(out_cnt), ptr(total), native.stream_ptr(dev)),
        "srt_join_search")
    join_search.launches += 1
    return start, cnt, out_cnt


join_search.launches = 0


# ---------------------------------------------------------------------------
# K5: the prepared build side and its probe
# ---------------------------------------------------------------------------

def build_prepare_fast(rbatch: ColumnBatch, rkey: int):
    """Sort the build side once by its single integral key.

    Returns ``(sorted_key, perm, nv)``: the build keys sorted ascending
    with the ``nv`` valid ones first and every null slot rewritten to the
    dtype max, so the array stays globally sorted; probe ranges are
    clipped to ``nv``, which keeps genuine max-valued keys (they sit at
    positions < nv).  ``nv`` is an int32[1] tensor on the batch's device.
    The sort is K1; on CUDA the rewrite is a kernel."""
    col = rbatch.columns[rkey]
    if col.data.dtype not in _SEARCH_TYPES:
        raise ValueError(f"fast-path build key dtype {col.data.dtype}")
    if col.data.device.type == "cpu":
        return build_prepare_fast_plain(rbatch, rkey)
    perm = sort_permutation(_one_col_batch(col), _NULLS_LAST)         # K1
    lib = native.lib("join_probe")
    data, valid = col.data.contiguous(), col.validity.contiguous()
    skey = torch.empty_like(data)
    nv = torch.zeros(1, dtype=torch.int32, device=data.device)
    native.check(lib.srt_join_build_keys(
        ptr(data), ptr(valid), ptr(perm), col.capacity, data.element_size(),
        ptr(skey), ptr(nv), native.stream_ptr(data.device)),
        "srt_join_build_keys")
    build_prepare_fast.launches += 1
    return skey, perm, nv


build_prepare_fast.launches = 0


def build_prepare_fast_plain(rbatch: ColumnBatch, rkey: int):
    """Plain PyTorch version of :func:`build_prepare_fast` (any device)."""
    col = rbatch.columns[rkey]
    perm = sort_permutation_plain(_one_col_batch(col), _NULLS_LAST)
    nv = col.validity.sum().to(torch.int32).reshape(1)
    maxv = torch.full((), torch.iinfo(col.data.dtype).max,
                      dtype=col.data.dtype, device=col.data.device)
    pos = torch.arange(col.capacity, device=col.data.device)
    return torch.where(pos < nv, col.data[perm.long()], maxv), perm, nv


def probe_fast(lbatch: ColumnBatch, lkey: int, sorted_key, perm, nv,
               join_type: str):
    """Per-stream-batch probe against a prepared build side: two binary
    searches per row, no sort.  Returns ``((start, cnt, perm, out_cnt,
    None), total)`` with ``total`` an int64[1] tensor (full outer's
    unmatched build rows are tracked by the exec, as in the reference)."""
    col = lbatch.columns[lkey]
    dev = col.data.device
    if dev.type == "cpu":
        return probe_fast_plain(lbatch, lkey, sorted_key, perm, nv,
                                join_type)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    start, cnt, out_cnt = join_search(col.data, col.validity, sorted_key,
                                      nv, join_type, total)
    return (start, cnt, perm, out_cnt, None), total


def probe_fast_plain(lbatch: ColumnBatch, lkey: int, sorted_key, perm, nv,
                     join_type: str):
    """Plain PyTorch version of :func:`probe_fast` (any device)."""
    col = lbatch.columns[lkey]
    start, cnt, out_cnt = _ranges_plain(col.data, sorted_key, nv,
                                        col.validity, join_type)
    total = out_cnt.sum(dtype=torch.int64).reshape(1)
    return (start, cnt, perm, out_cnt, None), total


# ---------------------------------------------------------------------------
# K6: dense cross-side key ids and the rank-path probe
# ---------------------------------------------------------------------------

def _key_ids(lbatch: ColumnBatch, rbatch: ColumnBatch,
             lkeys: Sequence[int], rkeys: Sequence[int]):
    """Dense cross-side key ranks.

    Returns (lid[CL], rid[CR]): the int32 rank of each row's key tuple;
    rows with any null key get I32MAX on the left and I32MAX - 1 on the
    right, so they never match anything."""
    if lbatch.device.type == "cpu":
        return key_ids_plain(lbatch, rbatch, lkeys, rkeys)
    cols, valid = _combined(lbatch, rbatch, lkeys, rkeys)
    if valid.numel() == 0:
        return valid.to(torch.int32), valid.to(torch.int32)
    return _ids_cuda(cols, valid, lbatch.num_rows)


_key_ids.launches = 0


def _combined(lbatch, rbatch, lkeys, rkeys):
    """Both sides' key columns, concatenated, and per row whether every
    key is non-null."""
    cols = [_combined_key_column(lbatch.columns[a], rbatch.columns[b])
            for a, b in zip(lkeys, rkeys)]
    valid = torch.ones(lbatch.num_rows + rbatch.num_rows, dtype=torch.bool,
                       device=lbatch.device)
    for c in cols:
        valid = valid & c.validity
    return cols, valid


def key_ids_plain(lbatch: ColumnBatch, rbatch: ColumnBatch,
                  lkeys: Sequence[int], rkeys: Sequence[int]):
    """Plain PyTorch version of :func:`_key_ids` (any device)."""
    cols, valid = _combined(lbatch, rbatch, lkeys, rkeys)
    cl = lbatch.num_rows
    cc = valid.numel()
    operands = [(~valid).to(torch.int64)]  # invalid rows last
    for c in cols:
        operands.extend(encode_key_operands(c, True))
    order = chain_sort(operands, cc, valid.device)
    sorted_cols = gather_plain(cols, order.to(torch.int32))
    differ = torch.zeros(cc, dtype=torch.bool, device=valid.device)
    for sc in sorted_cols:
        differ = differ | _cols_differ(sc)
    pos = torch.arange(cc, device=valid.device)
    seg = torch.cumsum(((pos > 0) & differ).to(torch.int64), 0)
    ids = torch.zeros(cc, dtype=torch.int64, device=valid.device)
    ids[order] = seg
    lid = torch.where(valid[:cl], ids[:cl], I32MAX)
    rid = torch.where(valid[cl:], ids[cl:], I32MAX - 1)
    return lid.to(torch.int32), rid.to(torch.int32)


def _ids_cuda(cols, valid, cl: int):
    dev = valid.device
    cc = valid.numel()
    inv = DeviceColumn(~valid, torch.ones_like(valid), T.BooleanType())
    batch = ColumnBatch([inv] + cols, cc, T.Schema(
        [T.StructField(f"k{i}", c.dtype) for i, c in
         enumerate([inv] + cols)]), dev)
    order = sort_permutation(batch, [SortOrder(i, True, True)
                                     for i in range(len(cols) + 1)])  # K1
    sorted_cols = gather_columns(cols, order)                          # K3
    stream = native.stream_ptr(dev)
    flags = torch.zeros(cc, dtype=torch.uint8, device=dev)
    _segment_flags(sorted_cols, flags)                                 # K4
    nt = num_tiles(cc)
    counts = torch.empty(nt, dtype=torch.int32, device=dev)
    offsets = torch.empty(nt + 1, dtype=torch.int32, device=dev)
    ids = torch.empty(cc, dtype=torch.int32, device=dev)
    native.check(native.lib("join_ids").srt_join_key_ids(
        ptr(flags), ptr(order), ptr(valid), cc, cl,
        ptr(counts), ptr(offsets), ptr(ids), stream), "srt_join_key_ids")
    _key_ids.launches += 1
    return ids[:cl], ids[cl:]


def _probe(lbatch: ColumnBatch, rbatch: ColumnBatch,
           lkeys: Sequence[int], rkeys: Sequence[int], join_type: str,
           plain: bool = False):
    """Per-left-row match ranges and output counts over the rank ids;
    for full outer also the unmatched build rows (int32 0/1).  Returns
    ``((start, cnt, rsort_perm, out_cnt, unmatched_r), total)``."""
    cl, cr = lbatch.num_rows, rbatch.num_rows
    dev = lbatch.device
    if join_type == "cross":
        start = torch.zeros(cl, dtype=torch.int32, device=dev)
        cnt = torch.full((cl,), cr, dtype=torch.int32, device=dev)
        rsort_perm = torch.arange(cr, dtype=torch.int32, device=dev)
        total = torch.full((1,), cl * cr, dtype=torch.int64, device=dev)
        return (start, cnt, rsort_perm, cnt, None), total
    if plain:
        lid, rid = key_ids_plain(lbatch, rbatch, lkeys, rkeys)
        rsort_perm = sort_permutation_plain(_one_col_batch(_ids_col(rid)),
                                            [SortOrder(0)])
        # lid == I32MAX never matches: every rid is < I32MAX
        start, cnt, out_cnt = _ranges_plain(lid, rid[rsort_perm.long()],
                                            None, None, join_type)
        total = out_cnt.sum(dtype=torch.int64).reshape(1)
        unmatched_r = None
        if join_type == "full":
            _s, _c, unmatched_r = _ranges_plain(rid, torch.sort(lid).values,
                                                None, None, "anti")
            total = total + unmatched_r.sum(dtype=torch.int64)
        return (start, cnt, rsort_perm, out_cnt, unmatched_r), total
    lid, rid = _key_ids(lbatch, rbatch, lkeys, rkeys)                  # K6
    rsort_perm = sort_permutation(_one_col_batch(_ids_col(rid)),
                                  [SortOrder(0)])                      # K1
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    sorted_rid = gather_columns([_ids_col(rid)], rsort_perm)[0].data   # K3
    start, cnt, out_cnt = join_search(lid, None, sorted_rid, None,
                                      join_type, total)               # K5
    unmatched_r = None
    if join_type == "full":
        lperm = sort_permutation(_one_col_batch(_ids_col(lid)),
                                 [SortOrder(0)])
        sorted_lid = gather_columns([_ids_col(lid)], lperm)[0].data
        _s, _c, unmatched_r = join_search(rid, None, sorted_lid, None,
                                          "anti", total, want_ranges=False)
    return (start, cnt, rsort_perm, out_cnt, unmatched_r), total


def join_probe(lbatch: ColumnBatch, rbatch: ColumnBatch,
               lkeys: Sequence[int], rkeys: Sequence[int], join_type: str):
    """The rank-path probe: ``(probe_arrays, total)``, where
    ``probe_arrays`` feeds :func:`join_indices_from_probe` and ``total``
    (int64[1] on the device) is the output row count."""
    return _probe(lbatch, rbatch, lkeys, rkeys, join_type,
                  plain=lbatch.device.type == "cpu")


def join_probe_plain(lbatch: ColumnBatch, rbatch: ColumnBatch,
                     lkeys: Sequence[int], rkeys: Sequence[int],
                     join_type: str):
    """Plain PyTorch version of :func:`join_probe` (any device)."""
    return _probe(lbatch, rbatch, lkeys, rkeys, join_type, plain=True)


def join_total(lbatch: ColumnBatch, rbatch: ColumnBatch,
               lkeys: Sequence[int], rkeys: Sequence[int],
               join_type: str) -> int:
    """Total output rows.  The reference's API, held against it by the
    parity tests; the execs read the total from :func:`join_probe`."""
    return int(join_probe(lbatch, rbatch, lkeys, rkeys, join_type)[1]
               .item())


# ---------------------------------------------------------------------------
# K7: index expansion, full-outer tail, matched-build bitmap
# ---------------------------------------------------------------------------

def join_indices_from_probe(cl: int, probe_arrays, join_type: str,
                            total: int):
    """Gather plan of ``total`` output slots (the probe's total, read on
    the host).  Returns (li, ri): int32[total] stream and build row per
    slot, -1 where that side is null (outer non-matches, semi/anti right
    sides, the full-outer tail's left side)."""
    if total > I32MAX:
        raise ValueError(
            f"one stream batch of the join would produce {total} rows, "
            f"more than the int32 row indices hold ({I32MAX}); lower "
            "spark.rapids.sql.reader.batchRows")
    start, cnt, rsort_perm, out_cnt, unmatched_r = probe_arrays
    dev = out_cnt.device
    take_right = join_type not in ("semi", "anti")
    if dev.type == "cpu":
        return join_indices_plain(cl, probe_arrays, join_type, total)
    lib = native.lib("join_expand")
    stream = native.stream_ptr(dev)
    li = torch.empty(total, dtype=torch.int32, device=dev)
    ri = torch.empty(total, dtype=torch.int32, device=dev)
    offsets = _offsets_cuda(lib, out_cnt, stream)  # [cl + 1]
    native.check(lib.srt_join_expand(
        ptr(offsets), cl, ptr(cnt), ptr(start), ptr(rsort_perm), total,
        int(take_right), ptr(li), ptr(ri), stream), "srt_join_expand")
    if unmatched_r is not None:
        uoff = _offsets_cuda(lib, unmatched_r, stream)
        native.check(lib.srt_join_tail(
            ptr(unmatched_r), ptr(uoff), unmatched_r.numel(),
            ptr(offsets[cl:]), ptr(li), ptr(ri), stream), "srt_join_tail")
    join_indices_from_probe.launches += 1
    return li, ri


join_indices_from_probe.launches = 0


def _offsets_cuda(lib, counts: torch.Tensor, stream) -> torch.Tensor:
    """int32[n + 1]: exclusive scan of ``counts``, the total last."""
    counts = counts.contiguous()
    n = counts.numel()
    dev = counts.device
    nt = num_tiles(n)
    sums = torch.empty(max(nt, 1), dtype=torch.int32, device=dev)
    toff = torch.empty(nt + 1, dtype=torch.int32, device=dev)
    out = torch.empty(n + 1, dtype=torch.int32, device=dev)
    native.check(lib.srt_join_offsets(ptr(counts), n, ptr(sums),
                                      ptr(toff), ptr(out), stream),
                 "srt_join_offsets")
    return out


def join_indices_plain(cl: int, probe_arrays, join_type: str, total: int):
    """Plain PyTorch version of :func:`join_indices_from_probe` (the
    reference's cumsum + searchsorted arithmetic; any device)."""
    start, cnt, rsort_perm, out_cnt, unmatched_r = probe_arrays
    take_right = join_type not in ("semi", "anti")
    dev = out_cnt.device
    i32 = torch.int32
    oc = out_cnt.to(torch.int64)
    offsets = torch.cumsum(oc, 0) - oc
    total_left = int(oc.sum())
    j = torch.arange(total, dtype=torch.int64, device=dev)
    in_left = j < total_left
    li = torch.full((total,), -1, dtype=torch.int64, device=dev)
    ri = torch.full((total,), -1, dtype=torch.int64, device=dev)
    if cl > 0 and total_left > 0:
        jl = j[:total_left]
        row = torch.searchsorted(offsets, jl, right=True) - 1
        k = jl - offsets[row]
        li[:total_left] = row
        if take_right:
            matched = k < cnt.long()[row]
            pos = (start.long()[row] + k).clamp(0, max(rsort_perm.numel()
                                                       - 1, 0))
            if rsort_perm.numel():
                ri[:total_left] = torch.where(matched,
                                              rsort_perm.long()[pos], -1)
    li = torch.where(in_left, li, -1)
    if unmatched_r is not None:
        u = unmatched_r.to(torch.bool)
        slots = total_left + torch.cumsum(u.to(torch.int64), 0) - 1
        ri[slots[u]] = torch.nonzero(u, as_tuple=False).squeeze(1)
    return li.to(i32), ri.to(i32)


def matched_build_rows(ri: torch.Tensor, cr: int,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """bool[cr]: build rows referenced by an output slot (``ri >= 0``),
    OR-ed into ``out`` when given (full outer's bookkeeping across stream
    batches)."""
    if out is None:
        out = torch.zeros(cr, dtype=torch.bool, device=ri.device)
    if ri.device.type == "cpu":
        return matched_build_rows_plain(ri, out)
    ri = ri.contiguous()
    native.check(native.lib("join_expand").srt_join_mark(
        ptr(ri), ri.numel(), ptr(out),
        native.stream_ptr(ri.device)), "srt_join_mark")
    matched_build_rows.launches += 1
    return out


matched_build_rows.launches = 0


def matched_build_rows_plain(ri: torch.Tensor,
                             out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`matched_build_rows` (any device)."""
    out[ri[ri >= 0].long()] = True
    return out


def gather_join_output(lbatch: ColumnBatch, rbatch: ColumnBatch,
                       li: torch.Tensor, ri: torch.Tensor,
                       schema: T.Schema, include_right: bool) -> ColumnBatch:
    """The output batch of a gather plan (K3 on both sides; index -1
    gives a null row)."""
    cols = list(gather_columns(lbatch.columns, li))
    if include_right:
        cols += gather_columns(rbatch.columns, ri)
    return ColumnBatch(cols, li.numel(), schema, lbatch.device)
