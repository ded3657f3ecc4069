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

On CUDA the sorts are K1 (``sort_permutation``; K6's through
``sort_words``, which keeps K1's packed key words) and the gathers K3; the
new kernels are ``csrc/join_probe.cu`` (K5: the build-key rewrite with
the search layout, the probe with per-join-type counts, their offsets
and the batch total),
``csrc/join_ids.cu`` (K6: flags between neighbouring sorted rows' words ->
dense ids, scattered back to the rows) and
``csrc/join_expand.cu`` (K7: a merge-path expansion over the offsets K5
wrote with the full-outer tail, one launch a call; the matched-build
bitmap; and the one-launch exclusive scan that K14's emit counts take).
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

from typing import NamedTuple, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import (gather_columns, gather_plain,
                                                num_tiles, ptr)
from spark_rapids_tpu_torch.ops.segmented import _cols_differ
from spark_rapids_tpu_torch.ops.sort import (SortOrder, chain_sort,
                                             encode_key_operands,
                                             sort_permutation,
                                             sort_permutation_plain,
                                             sort_words)

__all__ = ["JOIN_TYPES", "I32MAX", "PreparedBuild", "ProbeArrays",
           "SearchLayout", "search_levels", "rank_layout",
           "build_prepare_fast",
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
        ld, rd = (c.data if c.max_len == w else
                  torch.nn.functional.pad(c.data, (0, w - c.max_len))
                  for c in (lc, rc))
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

#: stream rows a tile of the search kernel, the bytes of a layout node
#: (one sector), the bytes of the level staged in shared memory and the
#: most levels (csrc/join_probe.cu ``kTile``, ``kNodeBytes``,
#: ``kStageBytes``, ``kMaxLevels``)
PROBE_TILE = 4096
NODE_BYTES = 32
STAGE_BYTES = 32768
MAX_LEVELS = 16
native.share_limits("join_probe", (PROBE_TILE, NODE_BYTES, STAGE_BYTES,
                                   MAX_LEVELS))

#: the search kernel's look-back status by (device, stream): zero between
#: launches (the last tile of each launch clears it), grown as needed
_STATUS: dict = {}


class SearchLayout(NamedTuple):
    """The search layout of a sorted build side (csrc/join_probe.cu): a
    static tree over the sorted keys, nodes of one 32-byte sector; level
    ``j`` (1..``k``) holds every ``F^j``-th key (``F = NODE_BYTES /
    item``), each level padded to whole nodes, in ``levels`` (None where
    ``k`` is 0); level ``k`` is the one the search stages in shared
    memory (0: the sorted keys themselves)."""
    levels: torch.Tensor | None
    k: int


class PreparedBuild(tuple):
    """The reference's prepared build, ``(sorted_key, perm, nv)``, with
    the card's search layout beside it in ``.layout``."""

    def __new__(cls, sorted_key, perm, nv, layout=None):
        self = super().__new__(cls, (sorted_key, perm, nv))
        self.layout = layout
        return self

    def to(self, device):
        lay = self.layout
        if lay is not None and lay.levels is not None:
            lay = SearchLayout(lay.levels.to(device, non_blocking=True),
                               lay.k)
        return PreparedBuild(*(t.to(device, non_blocking=True)
                               for t in self), lay)


class ProbeArrays(tuple):
    """The reference's probe arrays, ``(start, cnt, perm, out_cnt,
    unmatched_r)``, with the exclusive int32 offsets that K5's search
    wrote beside them (``.offsets`` of ``out_cnt``, ``.uoffsets`` of
    ``unmatched_r``, each with its total last), which K7's expansion
    takes in place of its own scan."""

    def __new__(cls, arrays, offsets=None, uoffsets=None):
        self = super().__new__(cls, arrays)
        self.offsets = offsets
        self.uoffsets = uoffsets
        return self


def search_levels(nb: int, item: int):
    """The search layout's geometry for ``nb`` sorted keys of ``item``
    bytes, as the kernel computes it: ``(k, sizes, offsets, length)`` --
    the level staged in shared memory (the first whose keys fit
    :data:`STAGE_BYTES`), each level's key count ``sizes[j] = ceil(nb /
    F^j)``, the first element of levels 1..k in the layout tensor
    (``offsets[0]`` unused) and that tensor's length."""
    f = NODE_BYTES // item
    sizes = [nb]
    while sizes[-1] * item > STAGE_BYTES:
        sizes.append(-(-sizes[-1] // f))
    offsets, at = [0], 0
    for size in sizes[1:]:
        offsets.append(at)
        at += -(-size // f) * f
    return len(sizes) - 1, sizes, offsets, at


def rank_layout(sorted_ids: torch.Tensor) -> SearchLayout:
    """The search layout of the rank path's sorted int32 ids, new each
    call: staged whole in shared memory where they fit
    :data:`STAGE_BYTES` (no launch), else its levels written by one
    levels-only launch of K5's build kernel (``srt_join_build_keys``),
    counted in ``.launches``.  On the card a layout pays against the
    binary search at q24's 2.88M ids too (PERF.md §6)."""
    n = sorted_ids.numel()
    k, _sizes, _offsets, length = search_levels(n, 4)
    if k == 0:
        return SearchLayout(None, 0)
    dev = sorted_ids.device
    levels = torch.empty(length, dtype=torch.int32, device=dev)
    native.check(native.lib("join_probe").srt_join_build_keys(
        ptr(sorted_ids), None, None, n, 4, None, None, ptr(levels), k,
        native.stream_ptr(dev)), "srt_join_build_keys")
    rank_layout.launches += 1
    return SearchLayout(levels, k)


rank_layout.launches = 0


def join_search(lkey: torch.Tensor, lvalid: torch.Tensor | None,
                skey: torch.Tensor, nv: torch.Tensor | None, jt: str,
                total: torch.Tensor | None = None, want_ranges: bool = True,
                layout: SearchLayout | None = None):
    """Per row of ``lkey``: its match range in the sorted ``skey``
    (clipped to ``nv`` when given), the count (0 where ``lvalid`` is
    False) and the join type's output count, and the exclusive int32
    offsets of the output counts with their total last.  The output
    counts' sum is added to ``total`` (int64[1]) when given, else written
    to a new one.  ``layout``: the search layout of ``skey``
    (:func:`build_prepare_fast`, :func:`rank_layout`), which the card
    requires.  Returns ``(start, cnt, out_cnt, offsets, total)``."""
    if lkey.dtype not in _SEARCH_TYPES or skey.dtype != lkey.dtype:
        raise ValueError(f"search keys must share one integral dtype, got "
                         f"{lkey.dtype} and {skey.dtype}")
    if lkey.device.type == "cpu":
        start, cnt, out_cnt = _ranges_plain(lkey, skey, nv, lvalid, jt)
        oc = out_cnt.to(torch.int64)
        offsets = torch.cat([oc.new_zeros(1), torch.cumsum(oc, 0)])
        if total is None:
            total = torch.zeros(1, dtype=torch.int64)
        total += offsets[-1]
        return start, cnt, out_cnt, offsets.to(torch.int32), total
    return _search_cuda(lkey, lvalid, skey, nv, jt, total, want_ranges,
                        layout)


join_search.launches = 0


def _search_cuda(lkey, lvalid, skey, nv, jt, total, want_ranges, layout):
    """K5's search on the card: one launch of ``srt_join_search``; its
    outputs and, where none is given, the total are views of one int32
    allocation."""
    lib = native.lib("join_probe")
    if layout is None:
        raise ValueError("K5's search on the card needs the search layout "
                         "of the sorted keys (PreparedBuild.layout, "
                         "rank_layout)")
    # bound to names: each buffer must outlive the asynchronous launch
    lkey, skey = lkey.contiguous(), skey.contiguous()
    lvalid = None if lvalid is None else lvalid.contiguous()
    n, dev = lkey.numel(), lkey.device
    add = total is not None
    ranges = 2 * n if want_ranges else 0
    buf = torch.empty(2 + ranges + 2 * n + 1, dtype=torch.int32, device=dev)
    if not add:
        total = buf[:2].view(torch.int64)
    start = buf[2:2 + n] if want_ranges else None
    cnt = buf[2 + n:2 + ranges] if want_ranges else None
    out_cnt = buf[2 + ranges:2 + ranges + n]
    offsets = buf[2 + ranges + n:]
    if n == 0:
        offsets.zero_()
        if not add:
            total.zero_()
        return start, cnt, out_cnt, offsets, total
    stream = native.stream_ptr(dev)
    status = native.lookback_status(_STATUS, dev, stream, num_tiles(n))
    native.check(lib.srt_join_search(
        ptr(lkey), ptr(lvalid), n, ptr(skey), skey.numel(), ptr(nv),
        ptr(layout.levels), layout.k, lkey.element_size(),
        _JT_CODES[jt], ptr(start), ptr(cnt), ptr(out_cnt), ptr(offsets),
        ptr(total), int(add), ptr(status), stream), "srt_join_search")
    join_search.launches += 1
    return start, cnt, out_cnt, offsets, total


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
    The sort is K1; on CUDA the rewrite is a kernel that also writes the
    search layout.  Returned as a :class:`PreparedBuild`, whose ``layout``
    (None on the CPU) :func:`probe_fast` takes."""
    col = rbatch.columns[rkey]
    if col.data.dtype not in _SEARCH_TYPES:
        raise ValueError(f"fast-path build key dtype {col.data.dtype}")
    if col.data.device.type == "cpu":
        return PreparedBuild(*build_prepare_fast_plain(rbatch, rkey))
    return _build_prepare_cuda(col)


build_prepare_fast.launches = 0


def _build_prepare_cuda(col: DeviceColumn) -> PreparedBuild:
    perm = sort_permutation(_one_col_batch(col), _NULLS_LAST)         # K1
    lib = native.lib("join_probe")
    data, valid = col.data.contiguous(), col.validity.contiguous()
    n, item, dev = col.capacity, data.element_size(), data.device
    k, _sizes, _offsets, length = search_levels(n, item)
    skey = torch.empty(n, dtype=data.dtype, device=dev)
    nv = torch.zeros(1, dtype=torch.int32, device=dev)
    levels = torch.empty(length, dtype=data.dtype, device=dev) if k \
        else None
    native.check(lib.srt_join_build_keys(
        ptr(data), ptr(valid), ptr(perm), n, item, ptr(skey), ptr(nv),
        ptr(levels), k, native.stream_ptr(dev)), "srt_join_build_keys")
    build_prepare_fast.launches += 1
    return PreparedBuild(skey, perm, nv, SearchLayout(levels, k))


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
               join_type: str, layout: SearchLayout | None = None):
    """Per-stream-batch probe against a prepared build side: one search
    per row, no sort.  Returns ``(arrays, total)``: ``arrays`` the
    reference's ``(start, cnt, perm, out_cnt, None)`` (a
    :class:`ProbeArrays` on the card, carrying the offsets K7 takes) and
    ``total`` an int64[1] tensor (full outer's unmatched build rows are
    tracked by the exec, as in the reference).  ``layout``: the build's
    search layout (``PreparedBuild.layout``), which the card requires."""
    col = lbatch.columns[lkey]
    dev = col.data.device
    if dev.type == "cpu":
        return probe_fast_plain(lbatch, lkey, sorted_key, perm, nv,
                                join_type)
    start, cnt, out_cnt, offsets, total = join_search(
        col.data, col.validity, sorted_key, nv, join_type, layout=layout)
    return ProbeArrays((start, cnt, perm, out_cnt, None), offsets), total


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
    if not cols:
        return cols, torch.ones(lbatch.num_rows + rbatch.num_rows,
                                dtype=torch.bool, device=lbatch.device)
    valid = cols[0].validity
    for c in cols[1:]:
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


#: sorted rows a tile of the ids kernel (csrc/join_ids.cu ``kIdsTile``)
IDS_TILE = 4096
native.share_limits("join_ids", (IDS_TILE,))


def ids_sort_keys(cols, valid):
    """K6's K1 sort: ``(keys, orders, drop)``.  The leading key is the
    rows' validity, nulls last, of which only the null indicator is kept
    (set where a key is null), so rows with a null key sort last; every
    key's own null indicator is dropped from the words, as it is the same
    in every valid row."""
    keys = [DeviceColumn(valid, valid, T.BooleanType())] + list(cols)
    orders = [SortOrder(0, True, False)] + \
        [SortOrder(i, True, True) for i in range(1, len(keys))]
    drop = [(0, 1)] + [(k, 0) for k in range(1, len(keys))]
    return keys, orders, drop


def ids_valid_bit(plan) -> int:
    """The bit of K1's top word that is set where a row has a null key
    (the validity key's null indicator, the highest kept bit), or -1
    where it does not vary."""
    return next((dst for k, f, _s, _n, _w, dst in plan.segments
                 if (k, f) == (0, 0)), -1)


def _ids_cuda(cols, valid, cl: int):
    """K6 on the card: K1 over :func:`ids_sort_keys` keeping its packed
    words, then one ids kernel over them (csrc/join_ids.cu)."""
    dev = valid.device
    cc = valid.numel()
    keys, orders, drop = ids_sort_keys(cols, valid)
    nt = -(-cc // IDS_TILE)
    sw = sort_words(keys, orders, drop=drop, extra=1 + nt,
                    keep_top=True)                                    # K1
    ids = torch.empty(cc, dtype=torch.int32, device=dev)
    words = sw.words
    native.check(native.lib("join_ids").srt_join_key_ids(
        ptr(sw.top), ptr(words),
        0 if words is None else words.element_size(),
        0 if words is None else words.shape[0], ptr(sw.perm),
        ids_valid_bit(sw.plan), int(sw.ors[0][0] == 0), cc, cl,
        ptr(sw.extra), ptr(ids), native.stream_ptr(dev)),
        "srt_join_key_ids")
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
        # every row's run is cr slots: its offsets need no scan (int32,
        # checked against the total before K7 reads them)
        offsets = (torch.arange(cl + 1, dtype=torch.int64, device=dev)
                   * cr).to(torch.int32)
        return ProbeArrays((start, cnt, rsort_perm, cnt, None),
                           offsets), total
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
    sorted_rid = gather_columns([_ids_col(rid)], rsort_perm)[0].data   # K3
    start, cnt, out_cnt, offsets, total = join_search(
        lid, None, sorted_rid, None, join_type,
        layout=rank_layout(sorted_rid))                                # K5
    unmatched_r = uoffsets = None
    if join_type == "full":
        lperm = sort_permutation(_one_col_batch(_ids_col(lid)),
                                 [SortOrder(0)])
        sorted_lid = gather_columns([_ids_col(lid)], lperm)[0].data
        _s, _c, unmatched_r, uoffsets, total = join_search(
            rid, None, sorted_lid, None, "anti", total, want_ranges=False,
            layout=rank_layout(sorted_lid))
    return ProbeArrays((start, cnt, rsort_perm, out_cnt, unmatched_r),
                       offsets, uoffsets), total


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
    sides, the full-outer tail's left side).  On the card the offsets are
    those K5's search wrote (:class:`ProbeArrays`; a cross join's are
    arithmetic), which the card requires."""
    if total > I32MAX:
        raise ValueError(
            f"one stream batch of the join would produce {total} rows, "
            f"more than the int32 row indices hold ({I32MAX}); lower "
            "spark.rapids.sql.reader.batchRows")
    if probe_arrays[3].device.type == "cpu":
        return join_indices_plain(cl, probe_arrays, join_type, total)
    return _indices_cuda(cl, probe_arrays, join_type, total)


join_indices_from_probe.launches = 0


def _indices_cuda(cl: int, probe_arrays, join_type: str, total: int):
    """K7 on the card: one launch of ``srt_join_expand`` over the offsets
    K5 wrote, the full-outer tail in the same launch; ``li`` and ``ri``
    are two views of one allocation."""
    lib = native.lib("join_expand")
    start, cnt, rsort_perm, out_cnt, unmatched_r = probe_arrays
    dev = out_cnt.device
    take_right = join_type not in ("semi", "anti")
    offsets = getattr(probe_arrays, "offsets", None)
    uoff = getattr(probe_arrays, "uoffsets", None)
    if offsets is None or (unmatched_r is not None and uoff is None):
        raise ValueError("K7 on the card takes the offsets K5's search "
                         "wrote (ProbeArrays from probe_fast or join_probe)")
    both = torch.empty((2, total), dtype=torch.int32, device=dev)
    li, ri = both[0], both[1]
    cr = 0 if unmatched_r is None else unmatched_r.numel()
    native.check(lib.srt_join_expand(
        ptr(offsets), cl, ptr(cnt), ptr(start), ptr(rsort_perm), total,
        int(take_right), ptr(unmatched_r), ptr(uoff), cr, ptr(li), ptr(ri),
        native.stream_ptr(dev)), "srt_join_expand")
    join_indices_from_probe.launches += 1
    return li, ri


#: threads and items of an expansion block, rows a tile of K7's own
#: offsets scan (csrc/join_expand.cu ``kExpThreads``, ``kExpItems``,
#: ``kTile``)
EXPAND_THREADS = 256
EXPAND_ITEMS = 8
OFFSETS_TILE = 4096
native.share_limits("join_expand", (EXPAND_THREADS, EXPAND_ITEMS,
                                    OFFSETS_TILE))

#: the look-back status of K7's own offsets scan by (device, stream)
_SCAN_STATUS: dict = {}


def _offsets_cuda(lib, counts: torch.Tensor, stream) -> torch.Tensor:
    """int32[n + 1]: exclusive scan of ``counts``, the total last (K7's
    ``srt_join_offsets``, one launch with a decoupled look-back, which
    K14's emit offsets take and no join path runs: K5's search writes
    its offsets)."""
    counts = counts.contiguous()
    n = counts.numel()
    dev = counts.device
    out = torch.empty(n + 1, dtype=torch.int32, device=dev)
    status = native.lookback_status(_SCAN_STATUS, dev, stream,
                                    max(-(-n // OFFSETS_TILE), 1))
    native.check(lib.srt_join_offsets(ptr(counts), n, ptr(status),
                                      ptr(out), stream),
                 "srt_join_offsets")
    _offsets_cuda.launches += 1
    return out


_offsets_cuda.launches = 0


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
