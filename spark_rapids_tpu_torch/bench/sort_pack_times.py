"""Time K2 (``compact``), K5 (``probe_fast`` with the offsets K7 needs),
K1 (``sort_permutation``), K3 (``gather_columns``), K4
(``segment_aggregate``), K6 (``join._key_ids``), K8a (the fixed-width
decode of ``PackedBatch.decode``) and K15a (``mesh_pack``) of whichever
``spark_rapids_tpu_torch`` is importable, at the shapes ``chip_smoke.py``
checks them: K2 over a 2^20-row q1 scan batch of its 7 columns under
q1's filter (~98% kept) and under a 3% keep (the wrapper, its C entry
points alone -- ``srt_compact_count`` and ``srt_compact_copy``, or an
older tree's ``srt_compact_prepare`` and one ``srt_compact_column`` a
column -- and its kernels' device time a call), K5 at q6's largest probe
(2^20 int32 stream rows against customer's 501,187 keys, an inner join)
with the offsets K7 needs (written by the search where the tree's search
writes them, else K7's ``_offsets_cuda`` after it; the C entry alone; the
search kernel's device time), q1's two one-letter keys at 2^24 rows, the mixed
int64/f64/int32/W16-string keys at 2^22 rows in two orders, q6's rank
join (K6 over 56,920 item rows of a W 16 category key, and K1 alone on
that key), K6 over 2^22 rows of one int64 key (3 x 2^20 left, 2^20
right), K3 at 2^24 rows x q1's six columns under q1's sort permutation
(q1's four key groups as its generator draws them, and six equally likely
ones) and at 14,524 of 2^20 rows x six int32 columns (a q6 join output),
K4 over those six sorted columns (q1's two keys, its 11 update aggregates)
and over 2^22 rows of one int64 key in ~2^20 groups (the same aggregates
over q1's doubles), K8a over a 2^20-row q1 lineitem batch of q1's
generator's quantity, price, discount, tax and ship date, staged with the
codec on (the price raw, four bit-packed streams: one launch where K8a
decodes a batch at once, a launch a stream where it decodes a column at
a time), and a
4,194,304-row shard of one and of three int32 columns packed into 8
sections in K10's order (top_customers_mesh's and q6_mesh_partitioned's
largest).  Each result is first held against the package's plain version.

Prints one JSON line: the card (``nvidia-smi`` name and power limit), the
package's directory and each time in ms (CUDA events, the mean of 20 calls
after a warm-up, the best of two rounds), beside torch.argsort(stable=True)
of q1's packed key, torch.unique for K6 and index_select of every leaf
for K3 and K15a, timed in the same rounds; for K3 also its C entry points
alone (the package's own: one ``srt_gather`` a call, or one
``srt_gather_column`` a column) and its kernels' device time a call
(torch.profiler, where it sees device work).  Needs a CUDA card.  Two
trees compare on one card, one process each, in turns (the parent
unpacked with ``git archive`` into a git-ignored directory):

    for t in PARENT . . PARENT; do
        PYTHONPATH=$t python3 spark_rapids_tpu_torch/bench/sort_pack_times.py
    done

``--only-k2-k5`` times K2 and K5 alone.  ``--only-k7-k10`` times K7
(q6's first join over the offsets K5 wrote, and a many-to-many join of
~8.66M slots) and K10 (a 2^20-row map batch at P = 8 and 200, the order
alone and with K3's gather) alone: the wrapper, the C entry points alone
(either tree's: one ``srt_join_expand`` with the full-outer tail's
arguments or without; ``srt_partition_upsweep`` and a scatter a pass, or
one ``srt_partition_group``) and the kernels' device time a call, beside
torch.repeat_interleave and argsort(stable) + bincount (+ index_select).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def _time_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _best(torch, fns: dict) -> dict:
    """{name: ms}: the best of two rounds, the functions in turns."""
    times = {k: [] for k in fns}
    for _ in range(2):
        for k, fn in fns.items():
            times[k].append(_time_ms(torch, fn))
    return {k: min(v) for k, v in times.items()}


def _q1_keys(torch, dev, n: int):
    """l_returnflag and l_linestatus as q1's scan gives them: W 4 byte
    matrices, one letter each, all valid."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    cols = []
    for letters in (b"RAN", b"FO"):
        lut = torch.tensor(list(letters), dtype=torch.uint8, device=dev)
        m = torch.zeros((n, 4), dtype=torch.uint8, device=dev)
        m[:, 0] = lut[torch.randint(0, len(letters), (n,), generator=g,
                                    device=dev)]
        cols.append(DeviceColumn(m, torch.ones(n, dtype=torch.bool,
                                               device=dev), T.StringType(),
                                 torch.ones(n, dtype=torch.int32,
                                            device=dev)))
    return ColumnBatch(cols, n, None, dev)


def _mixed_keys(torch, dev, n: int):
    """int64, f64 (NaN, -0.0, nulls), int32 and a W 16 string (nulls)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    g = torch.Generator(device=dev)
    g.manual_seed(2)

    def ints(lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=dtype)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    vals = torch.tensor([-1.5, -0.0, 0.0, 2.25, float("nan"), 7.0, -3e300],
                        dtype=torch.float64, device=dev)
    v_f = torch.rand(n, generator=g, device=dev) > 0.05
    v_s = torch.rand(n, generator=g, device=dev) > 0.05
    f64 = torch.where(v_f, vals[ints(0, len(vals))], 0.0)
    lens = torch.where(v_s, ints(0, 13, torch.int32), 0)
    mat = torch.randint(97, 100, (n, 16), generator=g, device=dev,
                        dtype=torch.uint8)
    mat[torch.arange(16, device=dev)[None, :] >= lens[:, None]] = 0
    cols = [DeviceColumn(ints(-50, 50) * (1 << 40), ones, T.LongType()),
            DeviceColumn(f64, v_f, T.DoubleType()),
            DeviceColumn(ints(-3, 3, torch.int32), ones, T.IntegerType()),
            DeviceColumn(mat, v_s, T.StringType(), lens)]
    return ColumnBatch(cols, n, None, dev)


def _q1_gather_cols(torch, dev, n: int):
    """q1's six gathered columns as its generator draws them (the return
    flag R or A where the receipt date is at most 1995-03-17, else N; the
    status F where the ship date is at most that day, else O; quantity,
    price, discount and tax as doubles), all valid, and q1's sort
    permutation of them (by flag, then status: four groups)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import sort as S
    g = torch.Generator(device=dev)
    g.manual_seed(5)

    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev)
    ship = ints(8036, 10591)
    receipt = ship + ints(1, 31)
    flag = torch.where(receipt <= 9204, ints(0, 2), 2)
    status = (ship > 9204).long()
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    cols = []
    for codes, letters in ((flag, b"RAN"), (status, b"FO")):
        m = torch.zeros((n, 4), dtype=torch.uint8, device=dev)
        m[:, 0] = torch.tensor(list(letters), dtype=torch.uint8,
                               device=dev)[codes]
        cols.append(DeviceColumn(m, ones, T.StringType(),
                                 torch.ones(n, dtype=torch.int32,
                                            device=dev)))
    qty = ints(1, 51).double()
    for x in (qty, torch.rand(n, generator=g, device=dev,
                              dtype=torch.float64) * 1200 * qty,
              ints(0, 11).double() * 0.01, ints(0, 9).double() * 0.01):
        cols.append(DeviceColumn(x, ones, T.DoubleType()))
    perm = S.sort_permutation(ColumnBatch(cols, n, None, dev),
                              [S.SortOrder(0), S.SortOrder(1)])
    return cols, perm


def _q6_join_output(torch, dev):
    """14,524 of 2^20 stream rows (sorted) x six nullable int32 columns."""
    import numpy as np
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    rng = np.random.default_rng(6)
    ns = 1 << 20
    cols = []
    for _ in range(6):
        v = rng.random(ns) >= 0.02
        x = np.where(v, rng.integers(0, ns, ns), 0).astype(np.int32)
        cols.append(DeviceColumn(torch.from_numpy(x).to(dev),
                                 torch.from_numpy(v).to(dev),
                                 T.IntegerType()))
    rows = np.sort(rng.choice(ns, 14_524, replace=False)).astype(np.int32)
    return cols, torch.from_numpy(rows).to(dev)


def _gather_entry(torch, cols, perm):
    """K3's C entry points alone, outputs allocated once: one
    ``srt_gather`` over every column, or (an older tree) one
    ``srt_gather_column`` a column."""
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.ops import native
    lib = native.lib("gather")
    m = perm.numel()
    stream = native.stream_ptr(perm.device)
    srcs = [K._contig(c) for c in cols]
    outs = [K._empty_like_rows(c, m) for c in cols]
    if "srt_gather" in native._SIGNATURES["gather"]:
        words = K.gather_table(srcs, outs)
        host, tab = native.param_table(
            words, len(words) > K.GATHER_PARAM_WORDS, perm.device)
        args = (host.buffer_info()[0], len(words), len(cols), K.ptr(tab),
                perm.data_ptr(), m, stream)

        # the table and the tensors it points to live as long as the call
        def one(_keep=(host, tab, srcs, outs)):
            lib.srt_gather(*args)
        return one
    calls = [(perm.data_ptr(), m, c.data.data_ptr(), o.data.data_ptr(),
              c.validity.data_ptr(), o.validity.data_ptr(),
              K.ptr(c.lengths), K.ptr(o.lengths), c.row_bytes, stream)
             for c, o in zip(srcs, outs)]

    def each(_keep=(srcs, outs)):
        for a in calls:
            lib.srt_gather_column(*a)
    return each


def _device_ms(torch, fn, reps: int = 10):
    """The device time of a call (ms): its kernels' and copies' mean
    times under torch.profiler over ``reps`` warm calls; None where the
    profiler saw no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / reps / 1e3 if total > 0 else None


def _time_gather(torch, out: dict, name: str, cols, perm) -> None:
    from spark_rapids_tpu_torch.ops import kernels as K
    got = K.gather_columns(cols, perm)
    for a, b in zip(got, K.gather_plain(cols, perm)):
        for x, y in ((a.data, b.data), (a.validity, b.validity),
                     (a.lengths, b.lengths)):
            if (x is None) != (y is None) or (x is not None and not
                                              torch.equal(x, y)):
                raise AssertionError(f"K3 differs from its plain version "
                                     f"({name})")
    idx = perm.long()
    leaves = [t for c in cols for t in (c.data, c.validity, c.lengths)
              if t is not None]
    entry = _gather_entry(torch, cols, perm)
    t = _best(torch, {
        "k3": lambda: K.gather_columns(cols, perm),
        "entry": entry,
        "index_select": lambda: [x.index_select(0, idx) for x in leaves]})
    out[f"k3_{name}_ms"] = t["k3"]
    out[f"k3_{name}_entry_ms"] = t["entry"]
    out[f"k3_{name}_index_select_ms"] = t["index_select"]
    out[f"k3_{name}_device_ms"] = _device_ms(
        torch, lambda: K.gather_columns(cols, perm))


#: q1's 11 update aggregates over (flag, status, qty, price, disc, tax)
_Q1_AGGS = [("sum", 2), ("sum", 3), ("sum", 4), ("sum", 5), ("sum", 2),
            ("count", 2), ("sum", 3), ("count", 3), ("sum", 4), ("count", 4),
            ("count_star", 0)]


def _time_k4(torch, out: dict, name: str, batch, keys, shift: int) -> None:
    """K4 at one shape, held to its plain version (doubles within rtol
    1e-9), through the wrapper and its device time a call."""
    from spark_rapids_tpu_torch.ops import segmented as G
    specs = [G.AggSpec(o, c - shift) for o, c in _Q1_AGGS]
    gk, ga, g = G.segment_aggregate(batch, keys, specs)
    wk, wa, wg = G.segment_aggregate_plain(batch, keys, specs)
    if g != wg or any(not torch.equal(a.validity, b.validity) or (
            not torch.allclose(a.data, b.data, rtol=1e-9, atol=0.0)
            if a.data.dtype == torch.float64 else
            not torch.equal(a.data, b.data)) for a, b in zip(ga, wa)):
        raise AssertionError(f"K4 differs from its plain version ({name})")
    t = _best(torch, {"k4": lambda: G.segment_aggregate(batch, keys, specs)})
    out[f"k4_{name}_ms"] = t["k4"]
    out[f"k4_{name}_groups"] = g
    out[f"k4_{name}_device_ms"] = _device_ms(
        torch, lambda: G.segment_aggregate(batch, keys, specs))


def _q1_decode_batch(torch, dev):
    """A 2^20-row q1 lineitem batch (no flags: its decode is K8a alone),
    staged with the codec on and copied to the card: (packed, buf)."""
    import numpy as np
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    rng = np.random.default_rng(8)
    n = 1 << 20
    ship = rng.integers(8036, 10591, n).astype(np.int32)
    qty = rng.integers(1, 51, n).astype(np.float64)
    rb = pa.RecordBatch.from_arrays([
        pa.array(qty),
        pa.array(np.round(rng.uniform(900.0, 2100.0, n) * qty, 2)),
        pa.array(np.round(rng.integers(0, 11, n) * 0.01, 2)),
        pa.array(np.round(rng.integers(0, 9, n) * 0.01, 2)),
        pa.array(ship).cast(pa.date32())],
        names=["l_quantity", "l_extendedprice", "l_discount", "l_tax",
               "l_shipdate"])
    packed = ColumnBatch.stage_arrow(rb, dev, codec=True)
    return packed, packed.buf.to(dev)


def _category_keys(torch, dev, n: int):
    """q6's rank join: n item rows of a nullable W 16 string key (10
    category names) against the 11 category groups (the first null)."""
    import numpy as np
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    names = [b"Books", b"Children", b"Electronics", b"Home", b"Jewelry",
             b"Men", b"Music", b"Shoes", b"Sports", b"Women"]
    rng = np.random.default_rng(4)

    def batch(words, valid):
        m = np.zeros((len(words), 16), np.uint8)
        for i, w in enumerate(words):
            m[i, :len(w)] = np.frombuffer(w, np.uint8)
        lens = np.array([len(w) for w in words], np.int32)
        col = DeviceColumn(torch.from_numpy(m).to(dev),
                           torch.from_numpy(valid).to(dev), T.StringType(),
                           torch.from_numpy(lens).to(dev))
        return ColumnBatch([col], len(words), None, dev)
    item = batch([names[i] for i in rng.integers(0, 10, n)],
                 rng.random(n) >= 0.005)
    cats = batch([b""] + names, np.arange(11) > 0)
    return item, cats


def _int64_sides(torch, dev, nl: int, nr: int):
    """Two join sides of one int64 key: 1,000 values 2^33 apart, 3%
    null."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    out = []
    for n in (nl, nr):
        v = torch.rand(n, generator=g, device=dev) >= 0.03
        x = torch.randint(-500, 500, (n,), generator=g, device=dev) << 33
        out.append(ColumnBatch([DeviceColumn(torch.where(v, x, 0), v,
                                             T.LongType())], n, None, dev))
    return out


def _q1_filter_batch(torch, dev, n: int):
    """q1's seven scanned lineitem columns as its generator draws them (a
    double's validity false every 97th row), and q1's filter's keep flags
    (ship date <= 1998-09-02: ~98% kept)."""
    import numpy as np
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    rng = np.random.default_rng(12)
    ship = rng.integers(8036, 10591, n).astype(np.int32)
    receipt = ship + rng.integers(1, 31, n)
    flag = np.where(receipt <= 9204, rng.integers(0, 2, n), 2)
    qty = rng.integers(1, 51, n).astype(np.float64)
    valid = np.ones(n, bool)
    valid[::97] = False
    ones = torch.ones(n, dtype=torch.bool, device=dev)

    def letters(codes, s):
        m = np.zeros((n, 4), np.uint8)
        m[:, 0] = np.frombuffer(s, np.uint8)[codes]
        return DeviceColumn(torch.from_numpy(m).to(dev), ones,
                            T.StringType(), torch.ones(n, dtype=torch.int32,
                                                       device=dev))

    def dbl(x):
        return DeviceColumn(torch.from_numpy(np.where(valid, x, 0.0)).to(dev),
                            torch.from_numpy(valid).to(dev), T.DoubleType())
    cols = [letters(flag, b"RAN"), letters((ship > 9204).astype(int), b"FO"),
            dbl(qty), dbl(np.round(rng.uniform(900.0, 2100.0, n) * qty, 2)),
            dbl(np.round(rng.integers(0, 11, n) * 0.01, 2)),
            dbl(np.round(rng.integers(0, 9, n) * 0.01, 2)),
            DeviceColumn(torch.from_numpy(ship).to(dev), ones, T.DateType())]
    return ColumnBatch(cols, n, None, dev), cols[6].data <= 10471


def _kernels_device_ms(torch, fn, needle: str = "", reps: int = 10):
    """The device time a call of the kernels whose names hold ``needle``
    (every kernel where it is empty; no copy, no memset), from
    torch.profiler over ``reps`` warm calls; None where it saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and needle in e.key
                and "Memcpy" not in e.key and "Memset" not in e.key)
    return total / reps / 1e3 if total > 0 else None


def _compact_entry(torch, batch, keep):
    """K2's C entry points alone, the outputs allocated once, with the
    host read of the kept rows between the count and the copies: the two
    launches of ``srt_compact_count``/``srt_compact_copy``, or (an older
    tree) ``srt_compact_prepare`` and one ``srt_compact_column`` a
    column."""
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.ops import native
    lib = native.lib("compact")
    dev, n = keep.device, batch.num_rows
    nt = K.num_tiles(n)
    stream = native.stream_ptr(dev)
    srcs = [K._contig(c) for c in batch.columns]
    outs = [K._empty_like_rows(c, int(keep.sum())) for c in srcs]
    offsets = torch.empty(nt + 1, dtype=torch.int32, device=dev)
    kp = keep.data_ptr()
    if "srt_compact_count" in native._SIGNATURES["compact"]:
        status = native.lookback_status(K._STATUS, dev, stream, nt)
        rows = torch.empty(nt * K.TILE, dtype=torch.int16, device=dev)
        words = K.gather_table(srcs, outs)
        host, tab = native.param_table(
            words, len(words) > K.COMPACT_PARAM_WORDS, dev)

        def two(_keep=(host, tab, srcs, outs, offsets, rows, status)):
            lib.srt_compact_count(kp, n, offsets.data_ptr(), rows.data_ptr(),
                                  status.data_ptr(), stream)
            int(offsets[nt].item())
            lib.srt_compact_copy(host.buffer_info()[0], len(words),
                                 len(srcs), K.ptr(tab), rows.data_ptr(), n,
                                 offsets.data_ptr(), stream)
        return two
    counts = torch.empty(max(nt, 1), dtype=torch.int32, device=dev)
    calls = [(kp, n, offsets.data_ptr(), c.data.data_ptr(),
              o.data.data_ptr(), c.validity.data_ptr(),
              o.validity.data_ptr(), K.ptr(c.lengths), K.ptr(o.lengths),
              c.row_bytes, stream) for c, o in zip(srcs, outs)]

    def each(_keep=(srcs, outs, offsets, counts)):
        lib.srt_compact_prepare(kp, n, counts.data_ptr(),
                                offsets.data_ptr(), stream)
        int(offsets[nt].item())
        for a in calls:
            lib.srt_compact_column(*a)
    return each


def _time_k2(torch, out: dict, dev) -> None:
    """K2 at a 2^20-row q1 scan batch x its 7 columns under q1's filter
    and under a selective keep (~3%, q6-like): the wrapper (checked
    against the plain version), the C entry points alone and the kernels'
    device time a call."""
    from spark_rapids_tpu_torch.ops import kernels as K
    n = 1 << 20
    batch, q1keep = _q1_filter_batch(torch, dev, n)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    sel = torch.rand(n, generator=g, device=dev) < 0.03
    for name, keep in (("q1", q1keep), ("sel", sel)):
        got, want = K.compact(batch, keep), K.compact_plain(batch, keep)
        for a, b in zip(got.columns, want.columns):
            for x, y in ((a.data, b.data), (a.validity, b.validity),
                         (a.lengths, b.lengths)):
                if (x is None) != (y is None) or (
                        x is not None and not torch.equal(x, y)):
                    raise AssertionError(f"K2 differs from its plain "
                                         f"version ({name})")
        entry = _compact_entry(torch, batch, keep)
        t = _best(torch, {"k2": lambda: K.compact(batch, keep),
                          "entry": entry})
        out[f"k2_{name}_ms"] = t["k2"]
        out[f"k2_{name}_entry_ms"] = t["entry"]
        out[f"k2_{name}_kernels_ms"] = _kernels_device_ms(
            torch, lambda: K.compact(batch, keep))
        out[f"k2_{name}_kept"] = got.num_rows


def _time_k5(torch, out: dict, dev) -> None:
    """K5 at q6's largest probe (2^20 int32 stream rows, ~4% null, against
    customer's 501,187 keys, ~1% null; an inner join) with the offsets K7
    needs: the probe through the wrapper (over the build's layout where
    the tree has one) and the probe plus K7's own offsets scan where the
    search writes none, both checked; the C entry alone; the search
    kernel's device time a call."""
    import numpy as np
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.ops import native
    rng = np.random.default_rng(14)
    nb, ns = 501_187, 1 << 20

    def side(keys, valid):
        keys = np.where(valid, keys, 0).astype(np.int32)
        return ColumnBatch([DeviceColumn(
            torch.from_numpy(keys).to(dev), torch.from_numpy(valid).to(dev),
            T.IntegerType())], len(keys), None, dev)
    build = side(np.arange(1, nb + 1), rng.random(nb) >= 0.01)
    stream = side(rng.integers(1, nb + 1, ns), rng.random(ns) >= 0.04)
    prep = J.build_prepare_fast(build, 0)
    lay = getattr(prep, "layout", None)
    sp = native.stream_ptr(dev)
    lib7 = native.lib("join_expand")
    if lay is not None:
        def probe():
            arrays, total = J.probe_fast(stream, 0, *prep, "inner",
                                         layout=lay)
            return arrays, total, arrays.offsets
    else:
        def probe():
            arrays, total = J.probe_fast(stream, 0, *prep, "inner")
            return arrays, total, J._offsets_cuda(lib7, arrays[3], sp)
    arrays, total, offsets = probe()
    want, wtotal = J.probe_fast_plain(stream, 0, *prep, "inner")
    oc = want[3].to(torch.int64)
    if int(total.item()) != int(wtotal.item()) or any(
            not torch.equal(a, b) for a, b in zip(arrays[:2], want[:2])) \
            or not torch.equal(offsets.to(torch.int64), torch.cat(
                [oc.new_zeros(1), torch.cumsum(oc, 0)])):
        raise AssertionError("K5 differs from its plain version")
    lib = native.lib("join_probe")
    key, valid = stream.columns[0].data, stream.columns[0].validity
    skey, _perm, nv = prep
    res = torch.empty(2 + 4 * ns + 1, dtype=torch.int32, device=dev)
    base = res.data_ptr()
    if lay is not None:
        status = native.lookback_status(J._STATUS, dev, sp,
                                        -(-ns // J.PROBE_TILE))
        args = (key.data_ptr(), valid.data_ptr(), ns, skey.data_ptr(), nb,
                nv.data_ptr(), J.ptr(lay.levels), lay.k, 4, 0, base + 8,
                base + 8 + 4 * ns, base + 8 + 8 * ns, base + 8 + 12 * ns,
                base, 0, status.data_ptr(), sp)
    else:
        status = None
        args = (key.data_ptr(), valid.data_ptr(), ns, skey.data_ptr(), nb,
                nv.data_ptr(), 4, 0, base + 8, base + 8 + 4 * ns,
                base + 8 + 8 * ns, base, sp)

    def entry(_keep=(res, status)):
        lib.srt_join_search(*args)
    t = _best(torch, {"probe": probe, "entry": entry})
    out["k5_probe_offsets_ms"] = t["probe"]
    out["k5_entry_ms"] = t["entry"]
    out["k5_search_kernel_ms"] = _kernels_device_ms(
        torch, probe, "search_kernel")
    out["k5_probe_offsets_device_ms"] = _kernels_device_ms(torch, probe)
    out["k5_matched"] = int(total.item())


def _int_side(torch, dev, keys, valid):
    """One nullable int32 key column as a batch."""
    import numpy as np
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    keys = np.where(valid, keys, 0).astype(np.int32)
    return ColumnBatch([DeviceColumn(
        torch.from_numpy(keys).to(dev), torch.from_numpy(valid).to(dev),
        T.IntegerType())], len(keys), None, dev)


def _expand_entry(torch, arrays, cl: int, total: int):
    """K7's C entry alone (an inner join), outputs allocated once: the one
    ``srt_join_expand`` launch with the tail's arguments, or (an older
    tree) its expansion entry, whose tail was a second entry."""
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops.kernels import ptr
    lib = native.lib("join_expand")
    start, cnt, rperm, out_cnt, _u = arrays
    dev = out_cnt.device
    both = torch.empty((2, total), dtype=torch.int32, device=dev)
    head = (ptr(arrays.offsets), cl, ptr(cnt), ptr(start), ptr(rperm),
            total, 1)
    if "srt_join_tail" in native._SIGNATURES["join_expand"]:
        args = head + (ptr(both[0]), ptr(both[1]), native.stream_ptr(dev))
    else:
        args = head + (None, None, 0, ptr(both[0]), ptr(both[1]),
                       native.stream_ptr(dev))

    def run(_keep=(arrays, both)):
        lib.srt_join_expand(*args)
    return run, both


def _time_k7(torch, out: dict, dev) -> None:
    """K7 at q6's first join (2^20 int32 stream rows, 2% null, against
    31 date keys: ~14.6K slots) over the offsets K5's search wrote, and at
    a many-to-many shape (2^20 stream rows against 10,000 keys matching
    0-16 build rows each and one key matching 2^16: ~8.66M slots) over
    offsets from a cumsum: the wrapper (checked against the plain
    version), its C entry alone and its kernel alone (torch.profiler),
    beside torch.repeat_interleave of the stream rows."""
    import numpy as np
    from spark_rapids_tpu_torch.ops import join as J
    rng = np.random.default_rng(20261018)
    ns = 1 << 20
    stream = _int_side(torch, dev, rng.integers(0, 2192, ns),
                       rng.random(ns) >= 0.02)
    dates = _int_side(torch, dev, np.arange(31), np.ones(31, bool))
    prep = J.build_prepare_fast(dates, 0)
    q6, total = J.probe_fast(stream, 0, *prep, "inner", layout=prep.layout)
    reps = rng.integers(0, 17, 10_000)
    bkeys = np.concatenate([np.repeat(np.arange(10_000), reps),
                            np.full(1 << 16, 10_000)])
    build = _int_side(torch, dev, rng.permutation(bkeys),
                      np.ones(bkeys.size, bool))
    skeys = rng.integers(0, 10_000, ns)
    skeys[rng.choice(ns, 4, replace=False)] = 10_000
    many = _int_side(torch, dev, skeys, np.ones(ns, bool))
    arrays, mtotal = J.join_probe_plain(many, build, [0], [0], "inner")
    oc = arrays[3].to(torch.int64)
    arrays = J.ProbeArrays(tuple(arrays), torch.cat(
        [oc.new_zeros(1), torch.cumsum(oc, 0)]).to(torch.int32))
    rows = torch.arange(ns, dtype=torch.int32, device=dev)
    for name, arr, n in (("q6", q6, int(total.item())),
                         ("many", arrays, int(mtotal.item()))):
        def wrapper(arr=arr, n=n):
            return J.join_indices_from_probe(ns, arr, "inner", n)
        got = wrapper()
        want = J.join_indices_plain(ns, arr, "inner", n)
        run, both = _expand_entry(torch, arr, ns, n)
        run()
        if not all(torch.equal(a, b) for a, b in zip(got, want)) or not (
                torch.equal(both[0], want[0])
                and torch.equal(both[1], want[1])):
            raise AssertionError(f"K7 differs from its plain version "
                                 f"({name})")
        t = _best(torch, {"k7": wrapper, "entry": run,
                          "lib": lambda arr=arr, n=n: torch.repeat_interleave(
                              rows, arr[3], output_size=n)})
        out[f"k7_{name}_ms"] = t["k7"]
        out[f"k7_{name}_entry_ms"] = t["entry"]
        out[f"k7_{name}_kernel_ms"] = _kernels_device_ms(
            torch, wrapper, "expand_kernel")
        out[f"k7_{name}_device_ms"] = _kernels_device_ms(torch, wrapper)
        out[f"k7_{name}_repeat_interleave_ms"] = t["lib"]
        out[f"k7_{name}_out"] = n


def _group_entry(torch, ids, parts: int):
    """K10's C entry points alone, outputs and scratch allocated once:
    ``srt_partition_upsweep`` and a scatter a pass, or (an older tree)
    the one ``srt_partition_group`` entry with its histogram and scan
    scratch."""
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops import partition as P
    from spark_rapids_tpu_torch.ops.kernels import ptr
    lib = native.lib("partition_group")
    n, dev = ids.numel(), ids.device
    sp = native.stream_ptr(dev)
    cs = torch.empty((2, parts), dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    if "srt_partition_group" in native._SIGNATURES["partition_group"]:
        nt = -(-n // 4096)
        m = (parts + 1) * nt
        hist = torch.empty(max(m, 1), dtype=torch.int32, device=dev)
        offsets = torch.empty(m + 1, dtype=torch.int32, device=dev)

        def one(_keep=(hist, offsets, cs, perm)):
            lib.srt_partition_group(ptr(ids), n, parts, ptr(hist),
                                    ptr(offsets), ptr(cs[0]), ptr(cs[1]),
                                    ptr(perm), sp)
        return one, perm
    scratch = native.lookback_status(
        P._STATUS, dev, sp, (P.scratch_words(n, parts) + 1) // 2)
    outs = [perm] if len(P.group_passes(parts)) == 1 else [
        torch.empty_like(perm), perm]

    def two(_keep=(scratch, cs, outs)):
        lib.srt_partition_upsweep(ptr(ids), n, parts, ptr(scratch),
                                  ptr(cs[0]), ptr(cs[1]), sp)
        src = None
        for p, o in enumerate(outs):
            lib.srt_partition_scatter(ptr(ids), n, parts, p, ptr(src),
                                      ptr(o), ptr(scratch), sp)
            src = o
    return two, perm


def _time_k10(torch, out: dict, dev) -> None:
    """K10 at a 2^20-row map batch of one nullable int32 column, P = 8 and
    200: the order alone (``partition_order``) and with K3's gather
    (``group_by_part``), both checked against the plain version, the C
    entry points alone, the kernels' device time a call (torch.profiler),
    beside argsort(stable) + bincount (+ index_select of the leaves)."""
    import numpy as np
    from spark_rapids_tpu_torch.ops import partition as P
    rng = np.random.default_rng(10)
    m = 1 << 20
    one = _int_side(torch, dev, rng.integers(0, 1 << 30, m),
                    rng.random(m) >= 0.05)
    leaves = [one.columns[0].data, one.columns[0].validity]
    for parts in (8, 200):
        ids = torch.from_numpy(rng.integers(0, parts, m).astype(
            np.int32)).to(dev)
        want = P._order_plain(ids, parts)
        got = P.partition_order(ids, parts)
        grouped = P.group_by_part(one, ids, parts)[0]
        run, perm = _group_entry(torch, ids, parts)
        run()
        same = (all(torch.equal(a, b) for a, b in zip(got, want))
                and torch.equal(perm, want[0])
                and torch.equal(grouped.columns[0].data,
                                one.columns[0].data[want[0].long()]))
        if not same:
            raise AssertionError(f"K10 differs from its plain version "
                                 f"(P={parts})")

        def library(ids=ids, parts=parts):
            order = torch.argsort(ids, stable=True)
            torch.bincount(ids, minlength=parts)
            return [x.index_select(0, order) for x in leaves]

        def order_library(ids=ids, parts=parts):
            return (torch.argsort(ids, stable=True),
                    torch.bincount(ids, minlength=parts))

        def order(ids=ids, parts=parts):
            return P.partition_order(ids, parts)

        def group(ids=ids, parts=parts):
            return P.group_by_part(one, ids, parts)
        t = _best(torch, {"order": order, "group": group, "entry": run,
                          "order_lib": order_library, "lib": library})
        key = f"k10_p{parts}"
        out[f"{key}_order_ms"] = t["order"]
        out[f"{key}_ms"] = t["group"]
        out[f"{key}_entry_ms"] = t["entry"]
        out[f"{key}_order_device_ms"] = _kernels_device_ms(torch, order)
        out[f"{key}_device_ms"] = _kernels_device_ms(torch, group)
        out[f"{key}_argsort_bincount_ms"] = t["order_lib"]
        out[f"{key}_argsort_bincount_index_select_ms"] = t["lib"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sort_pack_times: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    import spark_rapids_tpu_torch as pkg
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops import partition as PT
    from spark_rapids_tpu_torch.ops import sort as S
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    native.build(["sort", "mesh_exchange", "partition_group", "gather",
                  "join_ids", "segmented", "wirecodec"])
    dev = torch.device("cuda", 0)
    out = {"card": card, "package": os.path.dirname(pkg.__file__)}
    native.build(["compact", "join_probe", "join_expand"])
    if "--only-k7-k10" in sys.argv[1:]:
        _time_k7(torch, out, dev)
        _time_k10(torch, out, dev)
        print(json.dumps(out), flush=True)
        return 0
    _time_k2(torch, out, dev)
    _time_k5(torch, out, dev)
    if "--only-k2-k5" in sys.argv[1:]:
        print(json.dumps(out), flush=True)
        return 0
    q1 = _q1_keys(torch, dev, 1 << 24)
    orders = [S.SortOrder(0, True, True), S.SortOrder(1, True, True)]
    if not torch.equal(S.sort_permutation(q1, orders),
                       S.sort_permutation_plain(q1, orders)):
        raise AssertionError("K1 differs from its plain version (q1 keys)")
    packed = (q1.columns[0].data[:, 0].to(torch.int64) << 8) \
        | q1.columns[1].data[:, 0].to(torch.int64)
    t = _best(torch, {
        "k1_q1_ms": lambda: S.sort_permutation(q1, orders),
        "argsort_ms": lambda: torch.argsort(packed, stable=True)})
    out.update(t)
    # K3 under q1's six equally likely key pairs, then q1's own groups
    ones = torch.ones(q1.num_rows, dtype=torch.bool, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    _time_gather(torch, out, "q1even", list(q1.columns) + [
        DeviceColumn(torch.rand(q1.num_rows, generator=g, device=dev,
                                dtype=torch.float64), ones, T.DoubleType())
        for _ in range(4)], S.sort_permutation(q1, orders))
    del q1, packed, ones
    cols, perm = _q1_gather_cols(torch, dev, 1 << 24)
    _time_gather(torch, out, "q1", cols, perm)
    del cols, perm
    cols, perm = _q1_gather_cols(torch, dev, 1 << 24)
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.ops import kernels as K
    sorted_cols = K.gather_columns(cols, perm)
    del cols, perm
    _time_k4(torch, out, "q1", ColumnBatch(sorted_cols, 1 << 24, None, dev),
             [0, 1], 0)
    import numpy as np
    m = 1 << 22
    key = np.sort(np.random.default_rng(16).integers(0, 1 << 20, m))
    many = [DeviceColumn(torch.from_numpy(key).to(dev),
                         torch.ones(m, dtype=torch.bool, device=dev),
                         T.LongType())]
    many += [DeviceColumn(c.data[:m].contiguous(),
                          c.validity[:m].contiguous(), c.dtype)
             for c in sorted_cols[2:6]]
    _time_k4(torch, out, "many", ColumnBatch(many, m, None, dev), [0], 1)
    del sorted_cols, many
    packed, buf = _q1_decode_batch(torch, dev)
    from spark_rapids_tpu_torch.columnar import wirecodec as WC
    before = WC.decode_fixed.launches
    got = packed.decode(buf)
    out["k8a_q1_launches"] = WC.decode_fixed.launches - before
    for a, b in zip(got, packed.decode(buf, plain=True)):
        if not (torch.equal(a.validity, b.validity) and torch.equal(
                a.data.view(torch.int64) if a.data.dtype == torch.float64
                else a.data, b.data.view(torch.int64)
                if b.data.dtype == torch.float64 else b.data)):
            raise AssertionError("K8a differs from its plain version")
    out["k8a_q1_ms"] = _best(torch, {"k8a": lambda: packed.decode(buf)})[
        "k8a"]
    out["k8a_q1_device_ms"] = _device_ms(torch, lambda: packed.decode(buf))
    del packed, buf
    cols, rows = _q6_join_output(torch, dev)
    _time_gather(torch, out, "q6", cols, rows)
    del cols, rows
    mixed = _mixed_keys(torch, dev, 1 << 22)
    out["k1_mixed_ms"] = []
    for mo in ([S.SortOrder(1, True, None), S.SortOrder(3, False, None),
                S.SortOrder(0, True, False)],
               [S.SortOrder(3, True, False), S.SortOrder(2, False, True),
                S.SortOrder(1, False, True)]):
        if not torch.equal(S.sort_permutation(mixed, mo),
                           S.sort_permutation_plain(mixed, mo)):
            raise AssertionError("K1 differs from its plain version "
                                 "(mixed keys)")
        out["k1_mixed_ms"].append(_best(torch, {
            "k": lambda: S.sort_permutation(mixed, mo)})["k"])
    del mixed
    from spark_rapids_tpu_torch.ops import join as J
    item, cats = _category_keys(torch, dev, 56_920)
    one = [S.SortOrder(0, True, False)]
    if not torch.equal(S.sort_permutation(item, one),
                       S.sort_permutation_plain(item, one)):
        raise AssertionError("K1 differs from its plain version (q6's "
                             "category key)")
    mat = torch.cat([item.columns[0].data, cats.columns[0].data])
    t = _best(torch, {
        "k1_category_ms": lambda: S.sort_permutation(item, one),
        "k6_q6_ms": lambda: J._key_ids(item, cats, [0], [0]),
        "unique_q6_ms": lambda: torch.unique(mat, dim=0, sorted=True,
                                             return_inverse=True)})
    out.update(t)
    left, right = _int64_sides(torch, dev, 3 << 20, 1 << 20)
    if any(not torch.equal(a, b) for a, b in zip(
            J._key_ids(left, right, [0], [0]),
            J.key_ids_plain(left, right, [0], [0]))):
        raise AssertionError("K6 differs from its plain version (one "
                             "int64 key)")
    both = torch.cat([left.columns[0].data, right.columns[0].data])
    t = _best(torch, {
        "k6": lambda: J._key_ids(left, right, [0], [0]),
        "unique": lambda: torch.unique(both, sorted=True,
                                       return_inverse=True)})
    out["k6_int64_2p22_ms"] = t["k6"]
    out["unique_int64_2p22_ms"] = t["unique"]
    del left, right, both
    n = 4_194_304
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ids = torch.randint(0, 8, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    perm, counts = PT.partition_order(ids, 8)[:2]
    counts = [int(c) for c in counts.tolist()]
    idx = perm.long()
    for ncols in (1, 3):
        cols = [DeviceColumn(
            torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                          device=dev, dtype=torch.int32),
            torch.rand(n, generator=g, device=dev) < 0.9, T.IntegerType())
            for _ in range(ncols)]
        buf, _layout = ME.mesh_pack(cols, perm, counts)
        if not torch.equal(buf, ME.mesh_pack_plain(cols, perm, counts)):
            raise AssertionError("K15a differs from its plain version")
        leaves = [t for c in cols for t in (c.data, c.validity)]
        t = _best(torch, {
            "k15a": lambda: ME.mesh_pack(cols, perm, counts),
            "index_select": lambda: [torch.index_select(x, 0, idx)
                                     for x in leaves]})
        out[f"k15a_{ncols}col_ms"] = t["k15a"]
        out[f"index_select_{ncols}col_ms"] = t["index_select"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
