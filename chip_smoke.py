#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spark_rapids_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is caught):

1. print the card (nvidia-smi name and power limit, torch's device name);
2. build every CUDA kernel of the port from csrc/ (one nvcc per source,
   all started together) and print the build seconds and ptxas reports;
3. per kernel (K1 sort, K2 compact, K3 gather, K4 segmented aggregate;
   K5 prepared-build probe, K6 rank ids, K7 join expansion; K9, K10 in
   phase 6; K12a window segment extents, K12b window frame aggregates in
   phase 7; K13a, K13b in phase 8; K13c, K13d in phase 9): seeded inputs
   at the shapes the q1 and q6 main paths give it, the kernel held against
   its plain PyTorch version on the card, and its time beside the plain
   version's, one PyTorch library call's and the memory-bound floor;
4. generate TPC-H lineitem at SF10 into .bench_data/ (reused when there),
   run q1 through TorchSession() on cuda -- one cold run with every launch
   counter set to 0 just before it, then three warm runs -- and check the
   rows against an independent numpy/pyarrow evaluation of q1;
5. the same for TPC-DS q6 at SF10 (seed 42, one parquet file per table):
   every launch counter of K1-K7 (K4's boundary pass and K5's build-key
   rewrite included) is set to 0 just before its cold run, and each must
   be above 0 after it, but for K7's matched-build bitmap, which only a
   full outer join runs;
6. the shuffle exchange (K9 murmur3 partition ids, K10 partition
   grouping: both held against their plain versions at 2^24 rows), then
   three paths over the generator's default layout (2^20-row files, 28
   store_sales files, 8 scan partitions) in .bench_data/: q6 with the
   adaptive layer on (the map side is coalesced, so K9 and K10 must
   launch 0 times, as in the reference), q6 with
   spark.sql.adaptive.enabled=false (K9 and K10 above 0), and
   top_customers, an explicit repartition of all 28.8M store_sales rows
   (K9 and K10 once per map batch); each cold + warm, checked against
   numpy/pyarrow, with its peak device memory, which must not grow from
   the first warm run to the last;
7. the window kernels: K12a and K12b held against their plain versions
   at q51's final-window shape (5.1M rows: int32 items, date order keys,
   f64 cumulative sales with nulls) and on a 2^24-row stress batch (NaN,
   -0.0, +-inf, nulls, all-null partitions, one giant partition and many
   one-row partitions) over every frame K12b serves, ROWS and RANGE;
   row_number, rank, dense_rank and lead/lag on the card against the CPU;
   then TPC-DS q51 (per-channel running sums, a full outer join, two
   running maxima) and q63 (a whole-partition average) at SF10 over the
   default layout, each cold + warm, checked against numpy/pyarrow, with
   every exchange's map-side bytes;
8. the string kernels: K13a substring and K13b literal match held exactly
   against their plain versions on a 2^24-row stress batch (widths 4 to
   256; ASCII, 2-, 3- and 4-byte UTF-8, NULs, lone continuation bytes,
   empty and null rows; pos in [-W-2, W+2] and len in [-2, W+2] plus
   2^31-1, literal and as columns with nulls; every match mode with
   literal needles, the empty one and one wider than W, and needle
   columns) and at the paths' shapes (q22's SF10 c_phone column, q14's
   joined p_type rows); then TPC-DS q15 (SF10, default layout, AQE on:
   substr(ca_zip, 1, 5) after three joins), TPC-H q14 (p_type LIKE
   'PROMO%') and q22 (substring(c_phone, 1, 2), a scalar subquery, an
   anti join), each cold + warm, checked against numpy/pyarrow; K13a
   must launch on q15 and q22, K13b on q14;
9. K13c concat (both modes, 1 to 8 pieces, columns and literals, widths
   4 to 256) and K13d ASCII case map (both directions) held exactly
   against their plain versions on ~2^24 stress rows and at the paths'
   shapes (q84_all_cities' coalesced names, q24's ca_country); K1's
   packed-key limbs for q24's 10-key group-by and one K6 call at q24's
   (2^20 + 2.88M)-row shape; then TPC-DS q24, q84 and q84_all_cities
   (SF10, default layout, AQE on; store_returns and the demographics
   tables added) cold + warm against numpy/pyarrow: q84 must return 0
   rows and q24 at least 1; K13d must launch on q24, K13c on
   q84_all_cities;
10. print the kernel table as one JSON line (launches per path), the
   card line, and last the result line {"ok": true, "device": {...}}.

Without a CUDA device it exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import datetime as _dt
import json
import os
import subprocess
import sys
import time

import numpy as np

#: H100 SXM memory bandwidth (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: float64 tolerance of a kernel sum against its plain version: both sum
#: the same values in different orders (tile tree vs index_add_ atomics)
F64_RTOL = 1e-9

ROOT = os.path.dirname(os.path.abspath(__file__))


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int = 5) -> float:
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


def _leaves(cols):
    out = []
    for c in cols:
        out += [c.data, c.validity] + ([] if c.lengths is None
                                       else [c.lengths])
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _assert_equal_cols(torch, got, want, what: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} columns vs {len(want)}")
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: leaf {i} differs from the plain "
                                 "version")


# ---------------------------------------------------------------------------
# seeded inputs with q1's shapes
# ---------------------------------------------------------------------------

def _q1_host_columns(rng, n: int) -> dict:
    """numpy leaves shaped like q1's lineitem projection."""
    ship = rng.integers(8036, 10591, n).astype(np.int32)
    receipt = ship + rng.integers(1, 31, n)
    flag = np.where(receipt <= 9204, rng.integers(0, 2, n), 2)
    status = (ship > 9204).astype(np.int64)
    qty = rng.integers(1, 51, n).astype(np.float64)

    def strings(codes, letters):
        m = np.zeros((n, 4), dtype=np.uint8)
        m[:, 0] = np.frombuffer("".join(letters).encode(), np.uint8)[codes]
        return m, np.ones(n, dtype=np.int32)

    return {
        "l_returnflag": strings(flag, "RAN"),
        "l_linestatus": strings(status, "FO"),
        "l_quantity": qty,
        "l_extendedprice": np.round(rng.uniform(900.0, 2100.0, n) * qty, 2),
        "l_discount": np.round(rng.integers(0, 11, n) * 0.01, 2),
        "l_tax": np.round(rng.integers(0, 9, n) * 0.01, 2),
        "l_shipdate": ship,
    }


def _batch(torch, host: dict, dev, null_every: int = 0):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    cols, fields = [], []
    for name, leaf in host.items():
        if isinstance(leaf, tuple):
            m, ln = leaf
            n = m.shape[0]
            cols.append(DeviceColumn(torch.from_numpy(m).to(dev),
                                     torch.ones(n, dtype=torch.bool,
                                                device=dev), T.StringType(),
                                     torch.from_numpy(ln).to(dev)))
            fields.append(T.StructField(name, T.StringType()))
            continue
        n = leaf.shape[0]
        dt = T.DateType() if name == "l_shipdate" else \
            T.from_numpy_dtype(leaf.dtype)
        valid = np.ones(n, dtype=np.bool_)
        if null_every and dt == T.DoubleType():
            valid[::null_every] = False
            leaf = np.where(valid, leaf, 0.0)
        cols.append(DeviceColumn(torch.from_numpy(leaf).to(dev),
                                 torch.from_numpy(valid).to(dev), dt))
        fields.append(T.StructField(name, dt))
    return ColumnBatch(cols, cols[0].capacity, T.Schema(fields), dev)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def check_compact(torch, dev, rng) -> dict:
    """Checked at 2^22 rows and at the main path's scan batch (one parquet
    row group, 2^20 rows), timed at the latter."""
    from spark_rapids_tpu_torch.ops import kernels as K
    for n in (1 << 22, 1 << 20):
        batch = _batch(torch, _q1_host_columns(rng, n), dev, null_every=97)
        keep = batch.columns[6].data <= 10471  # 1998-09-02, q1's filter
        got = K.compact(batch, keep)
        want = K.compact_plain(batch, keep)
        if got.num_rows != want.num_rows:
            raise AssertionError("compact: row counts differ")
        _assert_equal_cols(torch, got.columns, want.columns, "compact")
    ms = _time_ms(torch, lambda: K.compact(batch, keep))
    plain_ms = _time_ms(torch, lambda: K.compact_plain(batch, keep))
    leaves = _leaves(batch.columns)
    lib_ms = _time_ms(torch, lambda: [t[keep] for t in leaves])
    nbytes = _nbytes(leaves) + keep.numel() + _nbytes(_leaves(got.columns))
    print(f"[K2 compact] rows={n} kept={got.num_rows} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={_bound_ms(nbytes):.4f}", flush=True)
    return dict(name="compact", route="cuda",
                source="spark_rapids_tpu_torch/csrc/compact.cu",
                replaces="spark_rapids_tpu/ops/kernels.py:62",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms)


def _mixed_batch(torch, rng, n: int, dev):
    """Wider key mix: int64, float64 with NaN/-0.0/nulls, int32 and a
    16-byte string column with nulls."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    i64 = rng.integers(-50, 50, n).astype(np.int64) * (1 << 40)
    f64 = rng.choice(np.array([-1.5, -0.0, 0.0, 2.25, np.nan, 7.0, -3e300]), n)
    i32 = rng.integers(-3, 3, n).astype(np.int32)
    lens = rng.integers(0, 13, n).astype(np.int32)
    mat = rng.integers(97, 100, (n, 16)).astype(np.uint8)
    mat[np.arange(16)[None, :] >= lens[:, None]] = 0
    v_f = rng.random(n) > 0.05
    v_s = rng.random(n) > 0.05
    f64 = np.where(v_f, f64, 0.0)
    mat[~v_s] = 0
    lens = np.where(v_s, lens, 0).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    cols = [DeviceColumn(t(i64), ones, T.LongType()),
            DeviceColumn(t(f64), t(v_f), T.DoubleType()),
            DeviceColumn(t(i32), ones, T.IntegerType()),
            DeviceColumn(t(mat), t(v_s), T.StringType(), t(lens))]
    schema = T.Schema([T.StructField(c, d.dtype) for c, d in
                       zip(["a", "b", "c", "s"], cols)])
    return ColumnBatch(cols, n, schema, dev)


def check_sort(torch, dev, rng, q1_batch) -> dict:
    from spark_rapids_tpu_torch.ops import sort as S
    orders = [S.SortOrder(0, True, True), S.SortOrder(1, True, True)]
    n = q1_batch.num_rows
    got = S.sort_permutation(q1_batch, orders)
    want = S.sort_permutation_plain(q1_batch, orders)
    if not torch.equal(got, want):
        raise AssertionError("sort: permutation differs (q1 keys)")
    mixed = _mixed_batch(torch, rng, 1 << 22, dev)
    for mo in ([S.SortOrder(1, True, None), S.SortOrder(3, False, None),
                S.SortOrder(0, True, False)],
               [S.SortOrder(3, True, False), S.SortOrder(2, False, True),
                S.SortOrder(1, False, True)]):
        if not torch.equal(S.sort_permutation(mixed, mo),
                           S.sort_permutation_plain(mixed, mo)):
            raise AssertionError(f"sort: permutation differs (mixed {mo})")
    ms = _time_ms(torch, lambda: S.sort_permutation(q1_batch, orders))
    plain_ms = _time_ms(torch,
                        lambda: S.sort_permutation_plain(q1_batch, orders))
    w1 = q1_batch.columns[0].data[:, 0].to(torch.int64)
    w2 = q1_batch.columns[1].data[:, 0].to(torch.int64)
    packed = (w1 << 8) | w2
    lib_ms = _time_ms(torch, lambda: torch.argsort(packed, stable=True))
    nbytes = _nbytes(_leaves(q1_batch.columns[:2])) + 4 * n
    print(f"[K1 sort] rows={n} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={_bound_ms(nbytes):.4f} "
          "(mixed int64/f64/int32/string keys at 2^22 rows: equal)",
          flush=True)
    return dict(name="sort_permutation", route="cuda",
                source="spark_rapids_tpu_torch/csrc/sort.cu",
                replaces="spark_rapids_tpu/ops/sort.py:105",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms), got


def check_gather(torch, dev, q1_batch, perm) -> dict:
    from spark_rapids_tpu_torch.ops import kernels as K
    cols = list(q1_batch.columns[:6])
    got = K.gather_columns(cols, perm)
    want = K.gather_plain(cols, perm)
    _assert_equal_cols(torch, got, want, "gather")
    ms = _time_ms(torch, lambda: K.gather_columns(cols, perm))
    plain_ms = _time_ms(torch, lambda: K.gather_plain(cols, perm))
    idx = perm.long()
    leaves = _leaves(cols)
    lib_ms = _time_ms(torch, lambda: [t.index_select(0, idx)
                                      for t in leaves])
    nbytes = 4 * perm.numel() + 2 * _nbytes(leaves)
    print(f"[K3 gather] rows={perm.numel()} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={_bound_ms(nbytes):.4f}", flush=True)
    return dict(name="gather_columns", route="cuda",
                source="spark_rapids_tpu_torch/csrc/gather.cu",
                replaces="spark_rapids_tpu/ops/kernels.py:42",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms), got


def check_segmented(torch, dev, q1_batch, sorted_cols) -> dict:
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.ops import segmented as G
    sb = ColumnBatch(sorted_cols, q1_batch.num_rows,
                     type(q1_batch.schema)(q1_batch.schema.fields[:6]), dev)
    # q1's update specs over (flag, status, qty, price, disc, tax)
    specs = [G.AggSpec("sum", 2), G.AggSpec("sum", 3), G.AggSpec("sum", 4),
             G.AggSpec("sum", 5), G.AggSpec("sum", 2), G.AggSpec("count", 2),
             G.AggSpec("sum", 3), G.AggSpec("count", 3), G.AggSpec("sum", 4),
             G.AggSpec("count", 4), G.AggSpec("count_star", 0),
             G.AggSpec("min", 5), G.AggSpec("max", 3),
             G.AggSpec("first", 4), G.AggSpec("last_non_null", 2)]
    gk, ga, g = G.segment_aggregate(sb, [0, 1], specs)
    wk, wa, wg = G.segment_aggregate_plain(sb, [0, 1], specs)
    if g != wg:
        raise AssertionError(f"segmented: {g} groups vs {wg}")
    _assert_equal_cols(torch, gk, wk, "segmented keys")
    err = 0.0
    for spec, a, b in zip(specs, ga, wa):
        if not torch.equal(a.validity, b.validity):
            raise AssertionError(f"segmented {spec}: validity differs")
        if a.data.dtype == torch.float64:
            diff = (a.data - b.data).abs()
            err = max(err, float(diff.max()))
            tol = F64_RTOL * b.data.abs() + 1e-300
            if bool((diff > tol).any()):
                raise AssertionError(f"segmented {spec}: beyond rtol "
                                     f"{F64_RTOL}")
        elif not torch.equal(a.data, b.data):
            raise AssertionError(f"segmented {spec}: differs")
    q1_specs = specs[:11]  # timed: the aggregates the q1 update runs
    ms = _time_ms(torch, lambda: G.segment_aggregate(sb, [0, 1], q1_specs))
    plain_ms = _time_ms(
        torch, lambda: G.segment_aggregate_plain(sb, [0, 1], q1_specs))
    # library yardstick: index_add_ per aggregate input by segment id
    flag = torch.ones(sb.num_rows, dtype=torch.bool, device=dev)
    for c in sb.columns[:2]:
        flag[1:] &= (c.data[1:] == c.data[:-1]).all(1)
    seg = torch.cumsum((~flag).to(torch.int64), 0)
    ones = torch.ones(sb.num_rows, dtype=torch.int64, device=dev)
    inputs = [ones if s.op == "count_star" else
              sb.columns[s.child_index].validity.to(torch.int64)
              if s.op == "count" else sb.columns[s.child_index].data
              for s in q1_specs]
    lib_ms = _time_ms(torch, lambda: [
        torch.zeros(g, dtype=x.dtype, device=dev).index_add_(0, seg, x)
        for x in inputs])
    distinct = _leaves(sb.columns)
    nbytes = _nbytes(distinct)
    print(f"[K4 segmented] rows={sb.num_rows} groups={g} checked_aggs="
          f"{len(specs)} timed_aggs={len(q1_specs)} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={_bound_ms(nbytes):.4f} max_abs_err={err:.3e}",
          flush=True)
    return dict(name="segment_aggregate", route="cuda",
                source="spark_rapids_tpu_torch/csrc/segmented.cu",
                replaces="spark_rapids_tpu/ops/segmented.py:68",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms)


# ---------------------------------------------------------------------------
# join kernels (K5-K7) at q6's shapes
# ---------------------------------------------------------------------------

def _int_batch(torch, keys: np.ndarray, valid: np.ndarray, dev):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    keys = np.where(valid, keys, 0).astype(keys.dtype)
    dt = T.from_numpy_dtype(keys.dtype)
    col = DeviceColumn(torch.from_numpy(keys).to(dev),
                       torch.from_numpy(valid).to(dev), dt)
    return ColumnBatch([col], len(keys), T.Schema([T.StructField("k", dt)]),
                       dev)


def _assert_same_tensors(torch, got, want, what: str) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            if a is not None or b is not None:
                raise AssertionError(f"{what}: item {i} None on one side")
            continue
        if a.shape != b.shape or not torch.equal(a.to(b.dtype), b):
            raise AssertionError(f"{what}: item {i} differs from the plain "
                                 "version")


_STREAM_JOIN_TYPES = ("inner", "left", "semi", "anti", "full")


def check_join_probe(torch, dev, rng) -> dict:
    """K5 at q6's largest probe: a 2^20-row int32 stream batch (~4% null)
    against customer's 501,187 build keys (~1% null), every join type."""
    from spark_rapids_tpu_torch.ops import join as J
    nb, ns = 501_187, 1 << 20
    build = _int_batch(torch, np.arange(1, nb + 1, dtype=np.int32),
                       rng.random(nb) >= 0.01, dev)
    stream = _int_batch(torch, rng.integers(1, nb + 1, ns).astype(np.int32),
                        rng.random(ns) >= 0.04, dev)
    prep = J.build_prepare_fast(build, 0)
    _assert_same_tensors(torch, prep, J.build_prepare_fast_plain(build, 0),
                         "build_prepare_fast")
    for jt in _STREAM_JOIN_TYPES:
        got, total = J.probe_fast(stream, 0, *prep, jt)
        want, wtotal = J.probe_fast_plain(stream, 0, *prep, jt)
        _assert_same_tensors(torch, got + (total,), want + (wtotal,),
                             f"probe_fast {jt}")
    total = J.probe_fast(stream, 0, *prep, "inner")[1]
    ms = _time_ms(torch, lambda: J.probe_fast(stream, 0, *prep, "inner"),
                  reps=20)
    plain_ms = _time_ms(torch, lambda: J.probe_fast_plain(
        stream, 0, *prep, "inner"), reps=20)
    skey, key = prep[0], stream.columns[0].data
    lib_ms = _time_ms(torch, lambda: (torch.searchsorted(skey, key),
                                      torch.searchsorted(skey, key,
                                                         right=True)),
                      reps=20)
    # stream key + validity read, start/cnt/out_cnt written, build keys
    # read once
    nbytes = ns * (4 + 1) + ns * 12 + nb * 4 + 4 + 8
    print(f"[K5 probe] stream={ns} build={nb} matched="
          f"{int(total.item())} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={_bound_ms(nbytes):.4f} "
          f"(join types {list(_STREAM_JOIN_TYPES)}: equal)", flush=True)
    return dict(name="join_probe_fast", route="cuda",
                source="spark_rapids_tpu_torch/csrc/join_probe.cu",
                replaces="spark_rapids_tpu/ops/join.py:152",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms)


_CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
               "Men", "Music", "Shoes", "Sports", "Women"]


def _string_col(torch, words, valid, dev):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import strings_to_matrix
    mat, lens = strings_to_matrix(pa.array(list(words), type=pa.string(),
                                           mask=~valid))
    return DeviceColumn(torch.from_numpy(mat).to(dev),
                        torch.from_numpy(valid).to(dev), T.StringType(),
                        torch.from_numpy(lens).to(dev))


def _batch_of(torch, cols, dev):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    return ColumnBatch(cols, cols[0].capacity, T.Schema(
        [T.StructField(f"c{i}", c.dtype) for i, c in enumerate(cols)]), dev)


def _fuzz_sides(torch, rng, dev, nl: int, nr: int):
    """(int64, string, float64) keys with duplicates on both sides, nulls
    in every key, NaN and -0.0 in the float key."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    words = np.array(["", "a", "ab", "zz", "a\x00", "a longer string key"],
                     dtype=object)
    out = []
    for n in (nl, nr):
        v = [rng.random(n) >= 0.03 for _ in range(3)]
        i64 = np.where(v[0], rng.integers(-500, 500, n) * (1 << 33), 0)
        f64 = np.where(v[2], rng.choice([-0.0, 0.0, 1.5, np.nan, -2.0], n),
                       0.0)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
        out.append(_batch_of(torch, [
            DeviceColumn(t(i64.astype(np.int64)), t(v[0]), T.LongType()),
            _string_col(torch, words[rng.integers(0, len(words), n)], v[1],
                        dev),
            DeviceColumn(t(f64), t(v[2]), T.DoubleType())], dev))
    return out


def check_key_ids(torch, dev, rng) -> dict:
    """K6 at q6's rank join (56,920 item rows against the 11 category
    groups on the nullable string key), and a 2^22-row three-key fuzz."""
    from spark_rapids_tpu_torch.ops import join as J
    ni = 56_920
    item = _batch_of(torch, [_string_col(
        torch, np.array(_CATEGORIES, dtype=object)[rng.integers(0, 10, ni)],
        rng.random(ni) >= 0.005, dev)], dev)
    cats = _batch_of(torch, [_string_col(
        torch, np.array([""] + _CATEGORIES, dtype=object),
        np.arange(11) > 0, dev)], dev)
    got = J._key_ids(item, cats, [0], [0])
    _assert_same_tensors(torch, got, J.key_ids_plain(item, cats, [0], [0]),
                         "key_ids q6")
    for jt in _STREAM_JOIN_TYPES:
        g, gt = J.join_probe(item, cats, [0], [0], jt)
        w, wt = J.join_probe_plain(item, cats, [0], [0], jt)
        _assert_same_tensors(torch, g + (gt,), w + (wt,), f"join_probe {jt}")
    left, right = _fuzz_sides(torch, rng, dev, 3 << 20, 1 << 20)
    keys = [0, 1, 2]
    _assert_same_tensors(torch, J._key_ids(left, right, keys, keys),
                         J.key_ids_plain(left, right, keys, keys),
                         "key_ids fuzz")
    for jt in ("inner", "full"):
        g, gt = J.join_probe(left, right, keys, keys, jt)
        w, wt = J.join_probe_plain(left, right, keys, keys, jt)
        _assert_same_tensors(torch, g + (gt,), w + (wt,),
                             f"join_probe fuzz {jt}")
    fuzz_ms = _time_ms(torch, lambda: J._key_ids(left, right, [0], [0]))
    both = torch.cat([left.columns[0].data, right.columns[0].data])
    fuzz_lib = _time_ms(torch, lambda: torch.unique(
        both, sorted=True, return_inverse=True))
    del left, right, both
    ms = _time_ms(torch, lambda: J._key_ids(item, cats, [0], [0]), reps=20)
    plain_ms = _time_ms(torch, lambda: J.key_ids_plain(item, cats, [0], [0]),
                        reps=20)
    mat = torch.cat([item.columns[0].data, cats.columns[0].data])
    lib_ms = _time_ms(torch, lambda: torch.unique(
        mat, dim=0, sorted=True, return_inverse=True), reps=20)
    rows = ni + 11
    # key bytes + validity + lengths read once, one int32 id written
    nbytes = rows * (mat.shape[1] + 1 + 4) + rows * 4
    print(f"[K6 key ids] q6 rows={rows} width={mat.shape[1]} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"(torch.unique over the byte rows) "
          f"bound_ms={_bound_ms(nbytes):.4f}; fuzz 2^22 rows, three keys "
          f"(int64, string, float64 with NaN/-0.0/nulls): equal; one int64 "
          f"key at 2^22 rows ms={fuzz_ms:.4f} torch.unique_ms="
          f"{fuzz_lib:.4f}", flush=True)
    return dict(name="join_key_ids", route="cuda",
                source="spark_rapids_tpu_torch/csrc/join_ids.cu",
                replaces="spark_rapids_tpu/ops/join.py:62",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms)


def _check_expand(torch, J, lb, rb, jts, what):
    for jt in jts:
        keys = [] if jt == "cross" else [0]
        arrays, total = J.join_probe_plain(lb, rb, keys, keys, jt)
        n = int(total.item())
        got = J.join_indices_from_probe(lb.num_rows, arrays, jt, n)
        want = J.join_indices_plain(lb.num_rows, arrays, jt, n)
        _assert_same_tensors(torch, got, want, f"expand {what} {jt}")
        m = J.matched_build_rows(got[1], rb.num_rows)
        mw = J.matched_build_rows_plain(got[1], torch.zeros_like(m))
        _assert_same_tensors(torch, (m,), (mw,), f"matched {what} {jt}")


def check_expand(torch, dev, rng) -> dict:
    """K7 at q6's first join (2^20 stream rows, ~1.4% matched once each)
    and a many-to-many shape (0-16 matches per row plus one key that
    matches 2^16 build rows), every join type."""
    from spark_rapids_tpu_torch.ops import join as J
    ns = 1 << 20
    stream = _int_batch(torch, rng.integers(0, 2192, ns).astype(np.int32),
                        rng.random(ns) >= 0.02, dev)
    dates = _int_batch(torch, np.arange(31, dtype=np.int32),
                       np.ones(31, dtype=np.bool_), dev)
    _check_expand(torch, J, stream, dates, _STREAM_JOIN_TYPES + ("cross",),
                  "q6")
    reps = rng.integers(0, 17, 10_000)
    bkeys = np.concatenate([np.repeat(np.arange(10_000), reps),
                            np.full(1 << 16, 10_000)]).astype(np.int32)
    build = _int_batch(torch, rng.permutation(bkeys),
                       np.ones(len(bkeys), dtype=np.bool_), dev)
    skeys = rng.integers(0, 10_000, ns).astype(np.int32)
    skeys[rng.choice(ns, 4, replace=False)] = 10_000
    many = _int_batch(torch, skeys, np.ones(ns, dtype=np.bool_), dev)
    _check_expand(torch, J, many, build, _STREAM_JOIN_TYPES, "many")
    arrays, total = J.join_probe_plain(many, build, [0], [0], "inner")
    n_many = int(total.item())
    many_ms = _time_ms(torch, lambda: J.join_indices_from_probe(
        ns, arrays, "inner", n_many))
    # q6's shape, timed
    prep = J.build_prepare_fast_plain(dates, 0)
    arrays, total = J.probe_fast_plain(stream, 0, *prep, "inner")
    n = int(total.item())
    ms = _time_ms(torch, lambda: J.join_indices_from_probe(
        ns, arrays, "inner", n), reps=20)
    plain_ms = _time_ms(torch, lambda: J.join_indices_plain(
        ns, arrays, "inner", n), reps=20)
    out_cnt = arrays[3]
    rows = torch.arange(ns, dtype=torch.int32, device=dev)
    lib_ms = _time_ms(torch, lambda: torch.repeat_interleave(
        rows, out_cnt, output_size=n), reps=20)
    # out_cnt read per stream row; cnt, start and the build permutation
    # read only for the rows with output; li and ri written per output row
    nbytes = ns * 4 + n * (4 + 4 + 4) + n * 8
    print(f"[K7 expand] q6 stream={ns} out={n} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"(torch.repeat_interleave, left indices only) "
          f"bound_ms={_bound_ms(nbytes):.4f}; many-to-many out={n_many} "
          f"ms={many_ms:.4f}; every join type equal", flush=True)
    return dict(name="join_expand", route="cuda",
                source="spark_rapids_tpu_torch/csrc/join_expand.cu",
                replaces="spark_rapids_tpu/ops/join.py:216",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms)


# ---------------------------------------------------------------------------
# q1 end to end
# ---------------------------------------------------------------------------

def reference_q1(path: str) -> list[tuple]:
    """q1 over the parquet with numpy/pyarrow alone (pairwise sums)."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    cols = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
            "l_discount", "l_tax", "l_shipdate"]
    t = pq.read_table(path, columns=cols)
    cutoff = (_dt.date(1998, 9, 2) - _dt.date(1970, 1, 1)).days
    ship = t.column("l_shipdate").combine_chunks().cast("int32") \
        .to_numpy(zero_copy_only=False)
    keep = ship <= cutoff
    codes, names = [], []
    for c in ("l_returnflag", "l_linestatus"):
        enc = pc.dictionary_encode(t.column(c).combine_chunks())
        codes.append(enc.indices.to_numpy(zero_copy_only=False)
                     .astype(np.int64))
        names.append(enc.dictionary.to_pylist())
    key = codes[0] * 64 + codes[1]
    num = {c: t.column(c).combine_chunks().to_numpy(zero_copy_only=False)
           for c in cols[2:6]}
    rows = []
    for k in np.unique(key[keep]):
        m = keep & (key == k)
        qty, price = num["l_quantity"][m], num["l_extendedprice"][m]
        disc, tax = num["l_discount"][m], num["l_tax"][m]
        dp = price * (1.0 - disc)
        cnt = int(m.sum())
        rows.append((names[0][k // 64], names[1][k % 64], float(qty.sum()),
                     float(price.sum()), float(dp.sum()),
                     float((dp * (1.0 + tax)).sum()), float(qty.sum()) / cnt,
                     float(price.sum()) / cnt, float(disc.sum()) / cnt, cnt))
    return sorted(rows, key=lambda r: (r[0], r[1]))


def _check_rows(got: list[tuple], want: list[tuple]) -> None:
    if len(got) != len(want):
        raise AssertionError(f"q1: {len(got)} rows, expected {len(want)}")
    for g, w in zip(got, want):
        if g[:2] != w[:2] or g[9] != w[9]:
            raise AssertionError(f"q1 row {g} != {w}")
        for a, b in zip(g[2:9], w[2:9]):
            if not abs(a - b) <= F64_RTOL * abs(b):
                raise AssertionError(f"q1 row {g} != {w} (rtol {F64_RTOL})")


def _counters() -> dict:
    """Every launch counter of the port, by kernel entry.  The first
    counter of an entry gives the entry's ``launches``; the others count
    the launches of its other kernels (each launch is counted once)."""
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.ops import partition as P
    from spark_rapids_tpu_torch.ops import segmented as G
    from spark_rapids_tpu_torch.ops import sort as S
    from spark_rapids_tpu_torch.ops import strings as STR
    from spark_rapids_tpu_torch.ops import window as W
    return {"sort_permutation": {"sort_permutation": S.sort_permutation},
            "compact": {"compact": K.compact},
            "gather_columns": {"gather_columns": K.gather_columns},
            "segment_aggregate": {"segment_aggregate": G.segment_aggregate,
                                  "segment_flags": G._segment_flags},
            "join_probe_fast": {"join_search": J.join_search,
                                "build_prepare_fast": J.build_prepare_fast},
            "join_key_ids": {"key_ids": J._key_ids},
            "join_expand": {"join_indices_from_probe":
                            J.join_indices_from_probe,
                            "matched_build_rows": J.matched_build_rows},
            "partition_ids_for_keys": {
                "partition_ids_for_keys": P.partition_ids_for_keys,
                "murmur3_columns": P.murmur3_columns},
            "group_by_part": {"group_by_part": P.group_by_part},
            "sorted_segments": {"sorted_segments": W.sorted_segments},
            "running_or_bounded_agg": {
                "running_or_bounded_agg": W.running_or_bounded_agg},
            "substring": {"substring": STR.substring},
            "string_match": {"string_match": STR.string_match},
            "concat": {"concat": STR.concat},
            "case_map": {"case_map": STR.case_map}}


_Q1_ENTRIES = ("sort_permutation", "compact", "gather_columns",
               "segment_aggregate")
_Q6_ENTRIES = _Q1_ENTRIES + ("join_probe_fast", "join_key_ids",
                             "join_expand")
_SHUFFLE_ENTRIES = ("partition_ids_for_keys", "group_by_part")
#: counters of kernels that q6 does not run: the matched-build bitmap
#: serves full outer joins only, and q6's joins are all inner; K9's hash
#: mode serves the Murmur3Hash expression, which no path here evaluates
_OFF_Q6_PATH = ("matched_build_rows", "murmur3_columns")


def _reset_counters(entries) -> None:
    for name in entries:
        for w in _counters()[name].values():
            w.launches = 0


def _read_counters(entries, query: str, off_path=()) -> dict:
    """{entry: {counter: launches}}; fails if a counter on the query's
    path stayed at 0."""
    got = {name: {k: w.launches for k, w in _counters()[name].items()}
           for name in entries}
    for group in got.values():
        for k, v in group.items():
            if v <= 0 and k not in off_path:
                raise AssertionError(f"{query} ran without launching {k}")
    return got


def run_q1(torch, sf: float, warm: int) -> dict:
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.bench import tpch_gen
    from spark_rapids_tpu_torch.bench.tpch_queries import q1
    data_dir = os.path.join(ROOT, ".bench_data", f"tpch_sf{sf:g}_seed7")
    t0 = time.perf_counter()
    made = tpch_gen.generate_tpch(data_dir, sf=sf, seed=7,
                                  tables=("lineitem",))
    print(f"[q1] TPC-H SF{sf:g} lineitem "
          f"{'generated' if made else 'reused'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    path = os.path.join(data_dir, "lineitem")
    t0 = time.perf_counter()
    want = reference_q1(path)
    print(f"[q1] numpy/pyarrow reference in {time.perf_counter() - t0:.1f} s",
          flush=True)
    session = TorchSession()
    if session.device.type != "cuda":
        raise AssertionError(f"session on {session.device}, not cuda")
    df = q1(session, data_dir)
    print(df.explain(), flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters(_Q1_ENTRIES)
    t0 = time.perf_counter()
    rows = df.collect()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = _read_counters(_Q1_ENTRIES, "q1")
    _check_rows(rows, want)
    warm_s = []
    for _ in range(warm):
        t0 = time.perf_counter()
        rows = df.collect()
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
        _check_rows(rows, want)
    n = int(tpch_gen.table_row_counts(sf)["lineitem"])
    peak = torch.cuda.max_memory_allocated()
    for r in rows:
        print(f"[q1] {r}")
    print(f"[q1] device budget {session.device_budget()} bytes "
          "(allocFraction and reserve of the conf)")
    print(f"[q1] SF{sf:g} lineitem_rows={n} cold_s={cold:.3f} "
          f"warm_s={[round(x, 3) for x in warm_s]} "
          f"rows_per_s_warm={n / min(warm_s) if warm_s else 0:.0f} "
          f"peak_bytes={peak} launches={launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# q6 end to end
# ---------------------------------------------------------------------------

def _arrow_col(table, name: str):
    """(values with nulls as 0, validity) of one column as numpy."""
    import pyarrow.compute as pc
    c = table.column(name).combine_chunks()
    valid = c.is_valid().to_numpy(zero_copy_only=False)
    return pc.fill_null(c, 0).to_numpy(zero_copy_only=False), valid


def _lookup(keys: np.ndarray, want: np.ndarray):
    """Row of each ``want`` in the unique surrogate keys (-1: absent)."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    if len(sk) > 1 and not (sk[1:] > sk[:-1]).all():
        raise AssertionError("surrogate keys are not unique")
    pos = np.clip(np.searchsorted(sk, want), 0, max(len(sk) - 1, 0))
    hit = (sk[pos] == want) if len(sk) else np.zeros(len(want), bool)
    return np.where(hit, order[pos], -1)


def reference_q6(data_dir: str) -> list[tuple]:
    """q6 over the parquet with numpy/pyarrow alone: the (ca_state, cnt)
    rows with cnt >= 10, ascending cnt."""
    import pyarrow.parquet as pq

    def read(t, cols):
        return pq.read_table(os.path.join(data_dir, t), columns=cols)

    dd = read("date_dim", ["d_date_sk", "d_year", "d_moy", "d_month_seq"])
    year, _ = _arrow_col(dd, "d_year")
    moy, _ = _arrow_col(dd, "d_moy")
    seq, _ = _arrow_col(dd, "d_month_seq")
    dsk, _ = _arrow_col(dd, "d_date_sk")
    month = seq[(year == 2001) & (moy == 1)][0]
    dates = dsk[seq == month]
    it = read("item", ["i_item_sk", "i_category", "i_current_price"])
    isk, _ = _arrow_col(it, "i_item_sk")
    cat = it.column("i_category").combine_chunks()
    cat_valid = cat.is_valid().to_numpy(zero_copy_only=False)
    cat_names = np.array(cat.fill_null("").to_pylist(), dtype=object)
    price, price_valid = _arrow_col(it, "i_current_price")
    keep_item = np.zeros(len(isk), dtype=np.bool_)
    for c in set(cat_names[cat_valid]):
        rows = cat_valid & (cat_names == c)
        p = rows & price_valid
        if not p.any():
            continue
        avg = price[p].sum() / p.sum()
        keep_item |= p & (price > 1.2 * avg)
    items = isk[keep_item]
    cu = read("customer", ["c_customer_sk", "c_current_addr_sk"])
    csk, _ = _arrow_col(cu, "c_customer_sk")
    caddr, caddr_valid = _arrow_col(cu, "c_current_addr_sk")
    ca = read("customer_address", ["ca_address_sk", "ca_state"])
    ask, _ = _arrow_col(ca, "ca_address_sk")
    state = ca.column("ca_state").combine_chunks()
    state_valid = state.is_valid().to_numpy(zero_copy_only=False)
    states = np.array(state.fill_null("").to_pylist(), dtype=object)
    ss = read("store_sales", ["ss_sold_date_sk", "ss_item_sk",
                              "ss_customer_sk"])
    sold, sold_valid = _arrow_col(ss, "ss_sold_date_sk")
    sitem, sitem_valid = _arrow_col(ss, "ss_item_sk")
    scust, scust_valid = _arrow_col(ss, "ss_customer_sk")
    m = sold_valid & np.isin(sold, dates) & sitem_valid \
        & np.isin(sitem, items) & scust_valid
    crow = _lookup(csk, scust[m])
    crow = crow[crow >= 0]
    crow = crow[caddr_valid[crow]]
    arow = _lookup(ask, caddr[crow])
    arow = arow[arow >= 0]
    counts: dict = {}
    for valid, name in zip(state_valid[arow], states[arow]):
        k = name if valid else None
        counts[k] = counts.get(k, 0) + 1
    rows = [(k, v) for k, v in counts.items() if v >= 10]
    return sorted(rows, key=lambda r: r[1])[:100]


def _check_q6(got: list[tuple], want: list[tuple]) -> None:
    key = lambda r: (r[0] is not None, r[0] or "", r[1])  # noqa: E731
    if sorted(got, key=key) != sorted(want, key=key):
        raise AssertionError(f"q6 rows differ from numpy/pyarrow: "
                             f"{got} vs {want}")
    cnts = [r[1] for r in got]
    if cnts != sorted(cnts) or len(got) > 100 or not got:
        raise AssertionError(f"q6 rows not ordered by cnt: {got}")


#: TPC-DS scale factor of the q6 path: the repo's main configuration
Q6_SF = 10.0
#: rows per parquet file of the generator's default layout
DEFAULT_ROWS_PER_FILE = 1 << 20
#: rows of the K9/K10 exactness checks, and of one map batch of the
#: repartition path (the shape they are timed at)
SHUFFLE_CHECK_ROWS = 1 << 24
MAP_BATCH_ROWS = 1 << 20


def run_q6(torch, warm: int) -> dict:
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.bench import tpcds_gen
    from spark_rapids_tpu_torch.bench.tpcds_queries import TPCDS_QUERIES
    q6, tables = TPCDS_QUERIES["q6"]
    sf = Q6_SF
    data_dir = os.path.join(ROOT, ".bench_data",
                            f"tpcds_sf{sf:g}_seed42_onefile")
    t0 = time.perf_counter()
    tpcds_gen.generate_tpcds(data_dir, sf=sf, seed=42, tables=tables,
                             rows_per_file=1 << 40)
    print(f"[q6] TPC-DS SF{sf:g} {list(tables)} ready in "
          f"{time.perf_counter() - t0:.1f} s (one file per table)",
          flush=True)
    t0 = time.perf_counter()
    want = reference_q6(data_dir)
    print(f"[q6] numpy/pyarrow reference in {time.perf_counter() - t0:.1f} s",
          flush=True)
    session = TorchSession()
    if session.device.type != "cuda":
        raise AssertionError(f"session on {session.device}, not cuda")
    print(q6(session, data_dir).explain(), flush=True)
    entries = _Q6_ENTRIES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters(entries)
    t0 = time.perf_counter()
    rows = q6(session, data_dir).collect()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = _read_counters(entries, "q6", _OFF_Q6_PATH)
    _check_q6(rows, want)
    warm_s = []
    for _ in range(warm):
        t0 = time.perf_counter()
        rows = q6(session, data_dir).collect()
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
        _check_q6(rows, want)
    n = int(tpcds_gen.table_row_counts(sf)["store_sales"])
    peak = torch.cuda.max_memory_allocated()
    print(f"[q6] {len(rows)} rows: {rows}")
    print(f"[q6] SF{sf:g} store_sales_rows={n} cold_s={cold:.3f} "
          f"warm_s={[round(x, 3) for x in warm_s]} "
          f"rows_per_s_warm={n / min(warm_s) if warm_s else 0:.0f} "
          f"peak_bytes={peak} launches={launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# shuffle kernels (K9, K10)
# ---------------------------------------------------------------------------

#: string keys with multi-byte UTF-8 in block and tail positions (tail
#: bytes >= 128 hash sign-extended), the empty string and q6's states
_KEY_WORDS = np.array(["", "a", "CA", "TX", "é", "aé", "abé", "abcé",
                       "日本語", "😀", "x😀y", "héllo wörld",
                       "a longer state name"], dtype=object)


def _word_col(torch, rng, n: int, valid: np.ndarray, dev):
    """A nullable string column of n rows drawn from _KEY_WORDS, built as
    the byte matrix directly (no per-row python objects)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                        round_string_width)
    enc = [w.encode() for w in _KEY_WORDS]
    w = round_string_width(max(len(e) for e in enc))
    table = np.zeros((len(enc), w), dtype=np.uint8)
    for i, e in enumerate(enc):
        table[i, :len(e)] = np.frombuffer(e, dtype=np.uint8)
    lens = np.array([len(e) for e in enc], dtype=np.int32)
    pick = rng.integers(0, len(enc), n)
    mat = np.where(valid[:, None], table[pick], 0).astype(np.uint8)
    ln = np.where(valid, lens[pick], 0).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return DeviceColumn(t(mat), t(valid), T.StringType(), t(ln))


def _shuffle_keys(torch, rng, n: int, dev):
    """int32 with ~4% nulls (ss_customer_sk's shape), int64, float64 with
    NaN/-0.0/+-inf, and a nullable multi-byte UTF-8 string."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    v32 = rng.random(n) >= 0.04
    i32 = np.where(v32, rng.integers(1, 501_188, n), 0).astype(np.int32)
    i64 = rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)
    vf = rng.random(n) >= 0.03
    f64 = np.where(vf, rng.choice(np.array(
        [0.0, -0.0, 1.5, np.nan, np.inf, -np.inf, -2.5e300, 7.25]), n), 0.0)
    cols = [DeviceColumn(t(i32), t(v32), T.IntegerType()),
            DeviceColumn(t(i64), ones, T.LongType()),
            DeviceColumn(t(f64), t(vf), T.DoubleType()),
            _word_col(torch, rng, n, rng.random(n) >= 0.05, dev)]
    return _batch_of(torch, cols, dev)


def check_partition_ids(torch, dev, rng) -> dict:
    """K9 at 2^24 rows over every key kind alone and composite, exact
    against its plain version; timed at the repartition path's map batch
    (2^20 int32 customer keys, ~4% null)."""
    from spark_rapids_tpu_torch.ops import partition as P
    n = SHUFFLE_CHECK_ROWS
    big = _shuffle_keys(torch, rng, n, dev)
    for keys in ([0], [1], [2], [3], [0, 3], [3, 2, 1, 0]):
        for parts in (8, 200):
            got = P.partition_ids_for_keys(big, keys, parts)
            want = P.partition_ids_plain([big.columns[k] for k in keys], n,
                                         parts)
            if not torch.equal(got, want):
                raise AssertionError(f"partition ids differ: keys {keys} "
                                     f"P={parts}")
    cols = [big.columns[k] for k in (3, 2, 1, 0)]
    if not torch.equal(P.murmur3_columns(cols, n, dev),
                       P.to_int32(P._hash_plain(cols, n, dev, 42))):
        raise AssertionError("murmur3 hash bits differ")
    str_ms = _time_ms(torch, lambda: P.partition_ids_for_keys(big, [3], 8))
    del big, cols
    m = MAP_BATCH_ROWS
    batch = _shuffle_keys(torch, rng, m, dev)
    ms = _time_ms(torch, lambda: P.partition_ids_for_keys(batch, [0], 8),
                  reps=20)
    plain_ms = _time_ms(torch, lambda: P.partition_ids_plain(
        [batch.columns[0]], m, 8), reps=20)
    nbytes = m * (4 + 1) + m * 4  # key + validity read, one id written
    print(f"[K9 partition ids] checked {n} rows, keys int32/int64/"
          f"float64/string alone and composite, P=8 and 200, and the hash "
          f"bits: equal; timed rows={m} int32 key ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms=none (no PyTorch call "
          f"computes murmur3) bound_ms={_bound_ms(nbytes):.4f}; string key "
          f"at {n} rows ms={str_ms:.4f}", flush=True)
    return dict(name="partition_ids_for_keys", route="cuda",
                source="spark_rapids_tpu_torch/csrc/hash_partition.cu",
                replaces="spark_rapids_tpu/expr/hashing.py:208",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=None)


def _check_grouping(torch, P, batch, ids, parts: int, what: str) -> None:
    got, counts, starts = P.group_by_part(batch, ids, parts)
    want, wcounts, wstarts = P.group_by_part_plain(batch, ids, parts)
    if not (torch.equal(counts, wcounts) and torch.equal(starts, wstarts)):
        raise AssertionError(f"group_by_part {what}: counts/starts differ")
    for i, (a, b) in enumerate(zip(_leaves(got.columns),
                                   _leaves(want.columns))):
        if a.dtype == torch.float64:  # NaN rows: compare the bits
            a, b = a.view(torch.int64), b.view(torch.int64)
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"group_by_part {what}: leaf {i} differs "
                                 "from the plain version")


def check_group_by_part(torch, dev, rng) -> dict:
    """K10 at 2^24 rows with P = 8 and 200 and with one skewed partition,
    exact against its plain version; timed at the repartition path's map
    batch (2^20 rows of one nullable int32 column, P = 8)."""
    from spark_rapids_tpu_torch.ops import partition as P
    n = SHUFFLE_CHECK_ROWS
    big = _shuffle_keys(torch, rng, n, dev)
    for parts in (8, 200):
        ids = P.partition_ids_for_keys(big, [0, 3], parts)
        _check_grouping(torch, P, big, ids, parts, f"P={parts}")
    ids = torch.from_numpy(np.where(rng.random(n) < 0.6, 3, rng.integers(
        0, 8, n)).astype(np.int32)).to(dev)
    _check_grouping(torch, P, big, ids, 8, "skewed")
    del big, ids
    m = MAP_BATCH_ROWS
    batch = _shuffle_keys(torch, rng, m, dev)
    one = _batch_of(torch, [batch.columns[0]], dev)
    ids = P.partition_ids_for_keys(one, [0], 8)
    ms = _time_ms(torch, lambda: P.group_by_part(one, ids, 8), reps=20)
    plain_ms = _time_ms(torch, lambda: P.group_by_part_plain(one, ids, 8),
                        reps=20)
    leaves = _leaves(one.columns)

    def library():
        order = torch.argsort(ids, stable=True)
        torch.bincount(ids, minlength=8)
        return [t.index_select(0, order) for t in leaves]

    lib_ms = _time_ms(torch, library, reps=20)
    # ids and the column read once, the grouped column written once, the
    # counts and starts written
    nbytes = m * 4 + 2 * _nbytes(leaves) + 2 * 8 * 4
    print(f"[K10 group by part] checked {n} rows at P=8, P=200 and one "
          f"skewed partition: equal; timed rows={m} P=8 (with the K3 "
          f"gather) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{lib_ms:.4f} (argsort(stable) + bincount + index_select) "
          f"bound_ms={_bound_ms(nbytes):.4f}", flush=True)
    return dict(name="group_by_part", route="cuda",
                source="spark_rapids_tpu_torch/csrc/partition_group.cu",
                replaces="spark_rapids_tpu/exec/exchange.py:62",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms)


# ---------------------------------------------------------------------------
# the exchange paths over the default multi-file layout
# ---------------------------------------------------------------------------

def reference_top_customers(data_dir: str) -> list[tuple]:
    """top_customers over the parquet with numpy/pyarrow alone: the 100
    (customer, purchases) pairs with the most purchases, count descending,
    then key ascending with the null customer first (Spark's default for
    an ascending key)."""
    import pyarrow.parquet as pq
    t = pq.read_table(os.path.join(data_dir, "store_sales"),
                      columns=["ss_customer_sk"])
    v, valid = _arrow_col(t, "ss_customer_sk")
    keys, counts = np.unique(v[valid], return_counts=True)
    rows = [(int(k), int(c)) for k, c in zip(keys, counts)]
    if (~valid).any():
        rows.append((None, int((~valid).sum())))
    rows.sort(key=lambda r: (-r[1], r[0] is not None, r[0] or 0))
    return rows[:100]


def _scan_batches(data_dir: str, table: str, columns) -> int:
    """Batches the port's scan makes of a table: each parquet row group
    split at the scan's batch-row cap."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.io.scan import (_effective_batch_rows,
                                                _expand_paths)
    files = _expand_paths(os.path.join(data_dir, table))
    schema = T.Schema.from_arrow(pq.read_schema(files[0]))
    cap = _effective_batch_rows(
        T.Schema([schema.field(c) for c in columns]), TorchConf().settings)
    total = 0
    for f in files:
        md = pq.ParquetFile(f).metadata
        for g in range(md.num_row_groups):
            total += -(-md.row_group(g).num_rows // cap)
    return total


def _map_side_bytes(torch, df) -> list:
    """[(exchange, {partition: bytes})] of one run of ``df``, top-down,
    read from the transports before the context releases them."""
    from spark_rapids_tpu_torch.exec.core import ExecCtx
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    root = df._prepared()
    ctx = ExecCtx(device=df._s.device, conf=df._s.conf)
    try:
        for _b in root.execute(ctx):
            pass
        out, stack = [], [root]
        while stack:
            node = stack.pop()
            stack.extend(reversed(node.children))
            if isinstance(node, ShuffleExchangeExec):
                t = ctx._cache[("shuffle", node.shuffle_id)]
                out.append((node.node_desc(),
                            t.partition_sizes(node.shuffle_id)))
        return out
    finally:
        ctx.close()
        torch.cuda.synchronize()


def _drive(torch, label: str, make_df, check, entries, warm: int,
           off_path=(), zero=()) -> dict:
    """One path: explain, then a cold run with every counter of
    ``entries`` set to 0 just before it and read just after it (each
    counter above 0, but ``off_path``; each of ``zero`` exactly 0), then
    the warm runs, each checked and its peak device memory recorded."""
    print(make_df().explain(), flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters(entries)
    t0 = time.perf_counter()
    rows = make_df().collect()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = _read_counters(entries, label, tuple(off_path) + tuple(zero))
    for group in launches.values():
        for k, v in group.items():
            if k in zero and v != 0:
                raise AssertionError(f"{label} launched {k} {v} times, "
                                     "expected 0")
    check(rows)
    cold_peak = torch.cuda.max_memory_allocated()
    warm_s, peaks, held = [], [], []
    for _ in range(warm):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows = make_df().collect()
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        held.append(torch.cuda.memory_allocated())
        check(rows)
    if peaks and peaks[-1] > peaks[0]:
        raise AssertionError(f"{label}: peak device memory grew over the "
                             f"warm runs: {peaks}")
    if held and held[-1] > held[0]:
        raise AssertionError(f"{label}: device memory held after a query "
                             f"grew over the warm runs: {held}")
    print(f"[{label}] {len(rows)} rows, first {rows[:3]}; cold_s={cold:.3f} "
          f"warm_s={[round(x, 3) for x in warm_s]} cold_peak_bytes="
          f"{cold_peak} warm_peak_bytes={peaks} held_after_bytes={held} "
          f"launches={launches}", flush=True)
    return launches


def _cuda_session(conf=None):
    from spark_rapids_tpu_torch import TorchSession
    s = TorchSession(conf)
    if s.device.type != "cuda":
        raise AssertionError(f"session on {s.device}, not cuda")
    return s


def run_exchange_paths(torch, warm: int) -> dict:
    """q6 with the adaptive layer on and off, and top_customers, over the
    generator's default layout at SF10; {path: launches}."""
    from spark_rapids_tpu_torch.bench import tpcds_gen
    from spark_rapids_tpu_torch.bench.tpcds_queries import (TPCDS_QUERIES,
                                                            top_customers)
    from spark_rapids_tpu_torch.conf import ADVISORY_PARTITION_BYTES
    q6, tables = TPCDS_QUERIES["q6"]
    data_dir = os.path.join(ROOT, ".bench_data",
                            f"tpcds_sf{Q6_SF:g}_seed42_default")
    t0 = time.perf_counter()
    tpcds_gen.generate_tpcds(data_dir, sf=Q6_SF, seed=42, tables=tables,
                             rows_per_file=DEFAULT_ROWS_PER_FILE)
    nfiles = len([f for f in os.listdir(os.path.join(data_dir,
                                                     "store_sales"))
                  if f.endswith(".parquet")])
    print(f"[exchange] TPC-DS SF{Q6_SF:g} {list(tables)} ready in "
          f"{time.perf_counter() - t0:.1f} s (2^20-row files: {nfiles} "
          "store_sales files)", flush=True)
    t0 = time.perf_counter()
    want_q6 = reference_q6(data_dir)
    want_top = reference_top_customers(data_dir)
    print(f"[exchange] numpy/pyarrow references in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def check_top(rows):
        if rows != want_top:
            raise AssertionError(f"top_customers rows differ from "
                                 f"numpy/pyarrow: {rows[:5]} vs "
                                 f"{want_top[:5]}")

    aqe_on = _cuda_session()
    aqe_off = _cuda_session({"spark.sql.adaptive.enabled": False})
    entries = _Q6_ENTRIES + _SHUFFLE_ENTRIES
    paths = {}
    explain = q6(aqe_on, data_dir).explain()
    if "AdaptiveShuffleReaderExec" not in explain or \
            "ShuffleExchangeExec[HashPartitioning(8)]" not in explain:
        raise AssertionError("q6 in the default layout planned no "
                             "adaptive reader over a hash exchange")
    paths["q6_default_aqe_on"] = _drive(
        torch, "q6 default layout, AQE on", lambda: q6(aqe_on, data_dir),
        lambda r: _check_q6(r, want_q6), entries, warm, _OFF_Q6_PATH,
        zero=("partition_ids_for_keys", "group_by_part"))
    sizes = _map_side_bytes(torch, q6(aqe_on, data_dir))
    advisory = ADVISORY_PARTITION_BYTES.get(aqe_on.conf.settings)
    print(f"[q6 default layout, AQE on] K9 and K10 launched 0 times, as in "
          f"the reference: the map side is {sizes} bytes by partition, at "
          f"or below advisoryPartitionSizeInBytes={advisory}, so every map "
          "batch went whole to partition 0 (exchange.py tiny-input "
          "coalescing)", flush=True)
    paths["q6_default_aqe_off"] = _drive(
        torch, "q6 default layout, AQE off", lambda: q6(aqe_off, data_dir),
        lambda r: _check_q6(r, want_q6), entries, warm, _OFF_Q6_PATH)
    top_entries = ("sort_permutation", "gather_columns",
                   "segment_aggregate") + _SHUFFLE_ENTRIES
    paths["top_customers"] = _drive(
        torch, "top_customers (repartition)",
        lambda: top_customers(aqe_on, data_dir), check_top, top_entries,
        warm, ("murmur3_columns",))
    maps = _scan_batches(data_dir, "store_sales", ["ss_customer_sk"])
    got = (paths["top_customers"]["partition_ids_for_keys"][
        "partition_ids_for_keys"],
        paths["top_customers"]["group_by_part"]["group_by_part"])
    if got != (maps, maps):
        raise AssertionError(f"top_customers launched K9/K10 {got} times, "
                             f"expected once per map batch ({maps})")
    print(f"[top_customers] K9 and K10 launched once per map batch of the "
          f"repartition ({maps} store_sales scan batches); the partial "
          f"aggregate's exchange (first) was coalesced, the repartition "
          f"(second) never is: "
          f"{_map_side_bytes(torch, top_customers(aqe_on, data_dir))}",
          flush=True)
    return paths


# ---------------------------------------------------------------------------
# window kernels (K12a segment extents, K12b frame aggregates)
# ---------------------------------------------------------------------------

#: rows of q51's final windows at SF10: the full outer join of ~1.15M web
#: and ~4.2M store (item, date) groups, measured by the q51 path
Q51_WINDOW_ROWS = 5_100_000
#: rows of the K12 stress batch
WINDOW_CHECK_ROWS = 1 << 24
#: frames K12b serves: (mode, lower, upper); min/max only those whose
#: lower edge is the partition start
_K12_FRAMES = [("rows", None, 0), ("rows", None, None), ("rows", -3, 2),
               ("rows", 2, 5), ("rows", None, 3), ("rows", -2, None),
               ("rows", None, -1), ("range", None, 0), ("range", 0, 0),
               ("range", 0, None), ("range", None, None)]


def _arrow_batch(torch, dev, arrays: dict):
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    rb = pa.RecordBatch.from_arrays(list(arrays.values()),
                                    names=list(arrays))
    return ColumnBatch.from_arrow(rb, dev)


def _q51_window_batch(torch, rng, dev, n: int):
    """q51's final window input, sorted by (item, date): int32 item keys
    (56,920 items), one row per (item, date) of 366 days of 2000, and the
    two channels' cumulative sales (f64, null where the channel sold
    nothing that day: ~78% of web, ~18% of store)."""
    import pyarrow as pa
    days = 366
    keys = np.sort(rng.choice(56_920 * days, n, replace=False))
    web = np.round(rng.random(n) * 5e4, 2)
    store = np.round(rng.random(n) * 2e5, 2)
    return _arrow_batch(torch, dev, {
        "item_sk": pa.array((keys // days + 1).astype(np.int32)),
        "d_date": pa.array((keys % days + 10957).astype(np.int32))
        .cast(pa.date32()),
        "web_sales": pa.array(web, mask=rng.random(n) < 0.78),
        "store_sales": pa.array(store, mask=rng.random(n) < 0.18)})


def _stress_window_batch(torch, rng, dev, n: int):
    """Sorted by (k nulls first, o): one partition of 40% of the rows,
    30% one-row partitions, the rest ~100-row partitions and a null
    partition; order keys with peers, NaN, -0.0 and nulls; f64 values
    with NaN, -0.0, +-inf and nulls, every value null in the partitions
    whose key is a multiple of 17; int64 values with nulls."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.ops.sort import SortOrder, sort_batch
    giant, ones = int(n * 0.4), int(n * 0.3)
    rest = n - giant - ones
    k = np.concatenate([np.zeros(giant, np.int64),
                        np.arange(1, ones + 1, dtype=np.int64),
                        ones + 1 + rng.integers(0, max(rest // 100, 1),
                                                rest)])
    k_null = rng.random(n) < 0.01
    o = rng.choice(np.array([-1.5, -0.0, 0.0, 2.0, np.nan, 7.0, 1e300]), n) \
        * rng.integers(1, 50, n)
    v = np.round(rng.normal(size=n) * 100, 2)
    special = rng.random(n) < 0.01
    v[special] = rng.choice([np.nan, np.inf, -np.inf, -0.0], special.sum())
    v_null = (rng.random(n) < 0.1) | ((k % 17) == 0)
    b = _arrow_batch(torch, dev, {
        "k": pa.array(k, mask=k_null),
        "o": pa.array(o, mask=rng.random(n) < 0.05),
        "v": pa.array(v, mask=v_null),
        "i": pa.array(rng.integers(-10**12, 10**12, n),
                      mask=rng.random(n) < 0.1)})
    return sort_batch(b, [SortOrder(0, True, True), SortOrder(1, True)])


def _segments_equal(torch, got, want, what: str) -> None:
    for f in ("seg_start", "seg_end", "peer_start", "peer_end", "seg_id",
              "order_rank"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"K12a {what}: {f} differs from the plain "
                                 "version")


def check_window_segments(torch, dev, rng) -> dict:
    """K12a against its plain version over the same K4 boundary flags, at
    q51's final-window shape and on the 2^24-row stress batch; timed at
    q51's shape (the flags apart: K4's pass makes them)."""
    from spark_rapids_tpu_torch.ops import window as W
    stress = _stress_window_batch(torch, rng, dev, WINDOW_CHECK_ROWS)
    for part, order in (((0,), (1,)), ((0,), ()), ((), (1,)), ((), ())):
        flags = W._boundary_flags(stress, part, order)
        _segments_equal(torch, W.sorted_segments(stress, part, order),
                        W.segment_extents_plain(*flags),
                        f"stress part={part} order={order}")
    del stress, flags
    n = Q51_WINDOW_ROWS
    b = _q51_window_batch(torch, rng, dev, n)
    part, order = W._boundary_flags(b, (0,), (1,))
    _segments_equal(torch, W.sorted_segments(b, (0,), (1,)),
                    W.segment_extents_plain(part, order), "q51 shape")
    ms = _time_ms(torch, lambda: W._segment_extents_cuda(part, order),
                  reps=20)
    plain_ms = _time_ms(torch, lambda: W.segment_extents_plain(part, order))
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    lib_ms = _time_ms(torch, lambda: torch.cummax(
        torch.where(part.bool(), idx, 0), 0), reps=20)
    nbytes = 2 * n + 6 * 4 * n  # two flag bytes in, six int32 out a row
    print(f"[K12a window segments] checked 2^24 stress rows (one 40% "
          f"partition, 30% one-row partitions, nulls, NaN/-0.0 order keys) "
          f"with and without partition and order keys, and q51's shape: "
          f"equal; timed rows={n} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} (torch.cummax over flag*idx: the "
          f"partition starts alone) bound_ms={_bound_ms(nbytes):.4f}",
          flush=True)
    return dict(name="sorted_segments", route="cuda",
                source="spark_rapids_tpu_torch/csrc/window_segments.cu",
                replaces="spark_rapids_tpu/ops/window.py:72",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms)


def _check_window_agg(torch, W, op, col, seg, frame, what: str) -> float:
    """K12b against its plain version on one column and frame; returns
    the largest |difference| over the valid finite rows."""
    got = W.running_or_bounded_agg(op, col, seg, frame)
    want = W.running_or_bounded_agg_plain(op, col, seg, frame)
    (gd, gv, gt), (wd, wv, wt) = got, want
    if gt != wt or not torch.equal(gv, wv):
        raise AssertionError(f"K12b {what}: validity or type differs")
    if not gd.dtype.is_floating_point:
        if not torch.equal(gd, wd):
            raise AssertionError(f"K12b {what}: differs")
        return 0.0
    same_nan = torch.isnan(gd) == torch.isnan(wd)
    fin = torch.isfinite(wd)
    if not bool(same_nan.all()) or not torch.equal(gd[~fin & ~torch.isnan(wd)],
                                                   wd[~fin & ~torch.isnan(wd)]):
        raise AssertionError(f"K12b {what}: NaN/inf differ")
    diff = (gd[fin] - wd[fin]).abs()
    # min/max pick an input; avg over integers divides the same exact
    # int64 sum by the same count on both sides
    if op in ("min", "max") or col.dtype.integral:
        if diff.numel() and float(diff.max()) != 0.0:
            raise AssertionError(f"K12b {what}: differs")
        return 0.0
    # float sum/avg: the kernel folds each partition on its own; the plain
    # version differences prefix sums over the whole batch, off by up to a
    # few ulps of the running total
    x = col.data.double()
    atol = 8 * torch.finfo(torch.float64).eps * float(
        torch.where(torch.isfinite(x) & col.validity, x.abs(), 0.0).sum())
    tol = F64_RTOL * wd[fin].abs() + atol
    if diff.numel() and bool((diff > tol).any()):
        raise AssertionError(f"K12b {what}: beyond rtol {F64_RTOL} + "
                             f"atol {atol:.3e}")
    return float(diff.max()) if diff.numel() else 0.0


def check_window_agg(torch, dev, rng) -> dict:
    """K12b against its plain version for every op and every frame it
    serves, ROWS and RANGE, on the 2^24-row stress batch; timed at q51's
    final-window shape (the running max of the web channel); min/max
    with a bounded lower edge must raise on the card."""
    from spark_rapids_tpu_torch.ops import window as W
    stress = _stress_window_batch(torch, rng, dev, WINDOW_CHECK_ROWS)
    seg = W.sorted_segments(stress, (0,), (1,))
    err = 0.0
    checked = 0
    for mode, lo, hi in _K12_FRAMES:
        fr = W.WindowFrame(mode, lo, hi)
        for op, cols in (("sum", (2, 3)), ("count", (2,)), ("avg", (2, 3)),
                         ("min", (1, 2, 3)), ("max", (1, 2, 3))):
            for ci in cols:
                what = f"{op} col {ci} {mode}({lo}, {hi})"
                if op in ("min", "max") and lo is not None:
                    try:
                        W.running_or_bounded_agg(op, stress.columns[ci], seg,
                                                 fr)
                    except NotImplementedError as e:
                        if "K12" not in str(e):
                            raise
                        continue
                    raise AssertionError(f"K12b {what}: did not raise")
                err = max(err, _check_window_agg(
                    torch, W, op, stress.columns[ci], seg, fr, what))
                checked += 1
    del stress, seg
    n = Q51_WINDOW_ROWS
    b = _q51_window_batch(torch, rng, dev, n)
    seg = W.sorted_segments(b, (0,), (1,))
    cum = W.WindowFrame("rows", None, 0)
    for op, ci in (("max", 2), ("max", 3), ("sum", 2), ("sum", 3)):
        err = max(err, _check_window_agg(torch, W, op, b.columns[ci], seg,
                                         cum, f"q51 {op} col {ci}"))
    web = b.columns[2]
    ms = _time_ms(torch, lambda: W.running_or_bounded_agg("max", web, seg,
                                                          cum), reps=20)
    plain_ms = _time_ms(torch, lambda: W.running_or_bounded_agg_plain(
        "max", web, seg, cum))
    sum_ms = _time_ms(torch, lambda: W.running_or_bounded_agg(
        "sum", web, seg, cum), reps=20)
    x = torch.where(web.validity, web.data, 0.0)
    lo = seg.seg_start.long()

    def cumsum_diff():
        ps = torch.cumsum(x, 0)
        return ps - torch.where(lo > 0, ps[(lo - 1).clamp(min=0)], 0.0)

    cumsum_ms = _time_ms(torch, cumsum_diff, reps=20)
    # the running frame needs value + validity + partition start read
    # (lo is the partition start, hi the row itself) and result +
    # validity written
    nbytes = n * (8 + 1 + 4) + n * (8 + 1)
    print(f"[K12b window agg] checked {checked} (op, column, frame) cases "
          f"on 2^24 stress rows over {len(_K12_FRAMES)} ROWS/RANGE frames "
          f"(bounded-lower min/max raise) and q51's running max/sum: equal "
          f"(float sums and avgs within rtol {F64_RTOL} plus 8 ulps of the "
          f"sum of magnitudes, the rest exactly), max_abs_err={err:.3e}; timed rows={n} running "
          f"max ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=none (no "
          f"PyTorch call computes a segmented running max) bound_ms="
          f"{_bound_ms(nbytes):.4f}; running sum ms={sum_ms:.4f} against "
          f"torch.cumsum plus index differences {cumsum_ms:.4f}", flush=True)
    return dict(name="running_or_bounded_agg", route="cuda",
                source="spark_rapids_tpu_torch/csrc/window_agg.cu",
                replaces="spark_rapids_tpu/ops/window.py:164",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=None)


def check_window_glue(torch, dev, rng) -> None:
    """row_number, rank, dense_rank and lead/lag (K3's gather, with and
    without a default, over a string and a double column) on the card
    against the same functions over CPU copies of the same rows."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import window as W
    from spark_rapids_tpu_torch.ops.sort import SortOrder, sort_batch
    n = 1 << 20
    words = np.array(["", "a", "CA", "héllo", "a longer word"], dtype=object)
    b = sort_batch(_arrow_batch(torch, dev, {
        "k": pa.array(rng.integers(0, 5000, n).astype(np.int32),
                      mask=rng.random(n) < 0.01),
        "o": pa.array(rng.integers(0, 40, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "s": pa.array(list(words[rng.integers(0, len(words), n)]),
                      type=pa.string(), mask=rng.random(n) < 0.1),
        "d": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1)}),
        [SortOrder(0, True, True), SortOrder(1, True)])
    seg = W.sorted_segments(b, (0,), (1,))
    cpu = W.SegmentInfo(*[t.cpu() for t in vars(seg).values()])
    for fn in (W.row_number, W.rank, W.dense_rank):
        if not torch.equal(fn(seg).cpu(), fn(cpu)):
            raise AssertionError(f"{fn.__name__} differs on the card")
    for ci, default in ((2, "a default longer than the rows"), (3, 7.5)):
        c = b.columns[ci]
        cc = DeviceColumn(c.data.cpu(), c.validity.cpu(), c.dtype,
                          None if c.lengths is None else c.lengths.cpu())
        for off in (-2, 1):
            for with_default in (False, True):
                args = []
                if with_default and c.is_string:
                    bs = np.frombuffer(default.encode(), np.uint8)
                    row = np.zeros(32, np.uint8)
                    row[:len(bs)] = bs
                    args = [torch.from_numpy(row).expand(n, 32),
                            torch.ones(n, dtype=torch.bool),
                            torch.full((n,), len(bs), dtype=torch.int32)]
                elif with_default:
                    args = [torch.full((n,), default, dtype=torch.float64),
                            torch.ones(n, dtype=torch.bool), None]
                want = W.lead_lag(cc, cpu, off, *args)
                got = W.lead_lag(c, seg, off, *[None if a is None else
                                                a.to(dev) for a in args])
                for g, w in zip(got, want):
                    if (g is None) != (w is None) or (
                            g is not None and not torch.equal(
                                g.cpu().view(torch.uint8)
                                if g.dtype == torch.float64 else g.cpu(),
                                w.view(torch.uint8)
                                if w.dtype == torch.float64 else w)):
                        raise AssertionError(f"lead_lag col {ci} offset "
                                             f"{off} differs on the card")
    print(f"[K12 ranking, lead/lag] rows={n}: row_number, rank, dense_rank "
          "and lead/lag (string and double, offsets -2 and 1, with and "
          "without defaults) equal their CPU results", flush=True)


# ---------------------------------------------------------------------------
# the window paths (q51, q63) over the default multi-file layout
# ---------------------------------------------------------------------------

def _dates_of_year_2000(data_dir: str):
    """(d_date_sk, d_date as days since 1970) of d_month_seq 1200..1211."""
    import pyarrow.parquet as pq
    dd = pq.read_table(os.path.join(data_dir, "date_dim"),
                       columns=["d_date_sk", "d_date", "d_month_seq",
                                "d_qoy"])
    seq, _ = _arrow_col(dd, "d_month_seq")
    keep = (seq >= 1200) & (seq <= 1211)
    sk, _ = _arrow_col(dd, "d_date_sk")
    date = dd.column("d_date").combine_chunks().cast("int32") \
        .to_numpy(zero_copy_only=False)
    qoy, _ = _arrow_col(dd, "d_qoy")
    return sk[keep], date[keep], qoy[keep]


def _day_sales(data_dir: str, table: str, pre: str, date_sk, date_day):
    """Per (item, date) sums of one channel's sales price in 2000, sorted
    by (item, date): (item, day, sum)."""
    import pyarrow.parquet as pq
    t = pq.read_table(os.path.join(data_dir, table),
                      columns=[f"{pre}_item_sk", f"{pre}_sold_date_sk",
                               f"{pre}_sales_price"])
    item, item_valid = _arrow_col(t, f"{pre}_item_sk")
    sold, sold_valid = _arrow_col(t, f"{pre}_sold_date_sk")
    price, price_valid = _arrow_col(t, f"{pre}_sales_price")
    row = _lookup(date_sk, sold)
    keep = item_valid & sold_valid & (row >= 0)
    key = item[keep].astype(np.int64) * 100_000 + date_day[row[keep]]
    uniq, inv = np.unique(key, return_inverse=True)
    p = np.where(price_valid[keep], price[keep], 0.0).astype(np.longdouble)
    sums = np.zeros(len(uniq), np.longdouble)
    np.add.at(sums, inv, p)
    return uniq // 100_000, uniq % 100_000, sums


def _cume(items, sums):
    """Running sum per item over rows sorted by (item, date), in extended
    precision."""
    c = np.cumsum(sums)
    start = np.r_[True, items[1:] != items[:-1]]
    first = np.maximum.accumulate(np.where(start, np.arange(len(c)), 0))
    return (c - (c - sums)[first]).astype(np.float64)


def _running_max(items, vals, valid):
    """Running max per item, nulls skipped (None until the first value)."""
    out = np.full(len(vals), -np.inf)
    start = np.flatnonzero(np.r_[True, items[1:] != items[:-1]])
    ends = np.r_[start[1:], len(vals)]
    x = np.where(valid, vals, -np.inf)
    for a, b in zip(start, ends):
        out[a:b] = np.maximum.accumulate(x[a:b])
    return out, out > -np.inf


def reference_q51(data_dir: str) -> tuple:
    """q51 over the parquet with numpy/pyarrow alone: (rows, {window:
    input rows}, closeness) where closeness counts, among the rows that
    decide the first 100 results, the comparisons web > store whose
    relative gap is below 10 * F64_RTOL but not 0 (the doubles' rounding
    could flip them) and the exact ties (never greater), and gives the
    smallest nonzero gap."""
    sk, day, _qoy = _dates_of_year_2000(data_dir)
    chans = []
    for table, pre in (("web_sales", "ws"), ("store_sales", "ss")):
        items, days, sums = _day_sales(data_dir, table, pre, sk, day)
        chans.append((items * 100_000 + days, _cume(items, sums)))
    (wk, wc), (sk_, sc) = chans
    keys = np.union1d(wk, sk_)
    web = np.zeros(len(keys))
    web_valid = np.isin(keys, wk)
    web[web_valid] = wc
    store = np.zeros(len(keys))
    store_valid = np.isin(keys, sk_)
    store[store_valid] = sc
    items = keys // 100_000
    wmax, wmax_valid = _running_max(items, web, web_valid)
    smax, smax_valid = _running_max(items, store, store_valid)
    both = wmax_valid & smax_valid
    hit = np.flatnonzero(both & (wmax > smax))[:100]
    decide = both & (np.arange(len(keys)) <= (hit[-1] if hit.size else -1))
    gap = np.abs(wmax - smax)[decide] / np.maximum(
        np.abs(wmax), np.abs(smax))[decide]
    close = {"near": int(((gap > 0) & (gap < 10 * F64_RTOL)).sum()),
             "ties": int((gap == 0).sum()),
             "min_gap": float(gap[gap > 0].min()) if (gap > 0).any()
             else None}
    epoch = _dt.date(1970, 1, 1)
    rows = [(int(items[i]), epoch + _dt.timedelta(days=int(keys[i] % 100_000)),
             float(web[i]) if web_valid[i] else None,
             float(store[i]) if store_valid[i] else None,
             float(wmax[i]), float(smax[i])) for i in hit]
    sizes = {"web window": len(wk), "store window": len(sk_),
             "final windows": len(keys)}
    return rows, sizes, close


def reference_q63(data_dir: str) -> tuple:
    """q63 over the parquet with numpy/pyarrow alone: (rows, the smallest
    distance of |sum - avg| / avg from the 0.1 line)."""
    import pyarrow.parquet as pq
    sk, _day, qoy = _dates_of_year_2000(data_dir)
    it = pq.read_table(os.path.join(data_dir, "item"),
                       columns=["i_item_sk", "i_manager_id", "i_class"])
    isk, _ = _arrow_col(it, "i_item_sk")
    mgr, _ = _arrow_col(it, "i_manager_id")
    cls = it.column("i_class").combine_chunks()
    cls_ok = np.isin(np.array(cls.fill_null("").to_pylist(), dtype=object),
                     ["accent", "dresses", "fiction", "shirts"]) & \
        cls.is_valid().to_numpy(zero_copy_only=False)
    st = pq.read_table(os.path.join(data_dir, "store"),
                       columns=["s_store_sk"])
    stores, _ = _arrow_col(st, "s_store_sk")
    ss = pq.read_table(os.path.join(data_dir, "store_sales"),
                       columns=["ss_sold_date_sk", "ss_item_sk",
                                "ss_store_sk", "ss_sales_price"])
    sold, sold_valid = _arrow_col(ss, "ss_sold_date_sk")
    item, item_valid = _arrow_col(ss, "ss_item_sk")
    store, store_valid = _arrow_col(ss, "ss_store_sk")
    price, price_valid = _arrow_col(ss, "ss_sales_price")
    drow = _lookup(sk, sold)
    irow = _lookup(isk, item)
    keep = sold_valid & (drow >= 0) & item_valid & (irow >= 0) & \
        store_valid & np.isin(store, stores)
    keep[keep] &= cls_ok[irow[keep]]
    key = mgr[irow[keep]].astype(np.int64) * 10 + qoy[drow[keep]]
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros(len(uniq), np.longdouble)
    np.add.at(sums, inv, np.where(price_valid[keep], price[keep],
                                  0.0).astype(np.longdouble))
    m = uniq // 10
    rows, gaps = [], []
    for g in np.unique(m):
        sel = np.flatnonzero(m == g)
        avg = float(np.sum(sums[sel]) / len(sel))
        for i in sel:
            s = float(sums[i])
            if avg > 0:
                rel = abs(s - avg) / avg
                gaps.append(abs(rel - 0.1))
                if rel > 0.1:
                    rows.append((int(g), int(uniq[i] % 10), s, avg))
    rows.sort(key=lambda r: (r[0], r[3], r[2]))
    return rows[:100], min(gaps) if gaps else 1.0


def _check_window_rows(label: str, got, want) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} rows, expected "
                             f"{len(want)}")
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                ok = abs(a - b) <= F64_RTOL * abs(b)
            else:
                ok = a == b
            if not ok:
                raise AssertionError(f"{label} row {g} != {w} (doubles "
                                     f"rtol {F64_RTOL})")


_WINDOW_ENTRIES = ("sorted_segments", "running_or_bounded_agg")


def run_window_paths(torch, warm: int) -> dict:
    """q51 and q63 over the generator's default layout at SF10;
    {path: launches}."""
    from spark_rapids_tpu_torch.bench import tpcds_gen
    from spark_rapids_tpu_torch.bench.tpcds_queries import TPCDS_QUERIES
    from spark_rapids_tpu_torch.conf import ADVISORY_PARTITION_BYTES
    data_dir = os.path.join(ROOT, ".bench_data",
                            f"tpcds_sf{Q6_SF:g}_seed42_default")
    tables = sorted(set(TPCDS_QUERIES["q51"][1]) | set(
        TPCDS_QUERIES["q63"][1]))
    t0 = time.perf_counter()
    tpcds_gen.generate_tpcds(data_dir, sf=Q6_SF, seed=42, tables=tables,
                             rows_per_file=DEFAULT_ROWS_PER_FILE)
    print(f"[window] TPC-DS SF{Q6_SF:g} {tables} ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    want51, sizes51, close51 = reference_q51(data_dir)
    want63, gap63 = reference_q63(data_dir)
    print(f"[window] numpy/pyarrow references in "
          f"{time.perf_counter() - t0:.1f} s: q51's window input rows "
          f"{sizes51}; among the rows deciding its 100 results, web > "
          f"store comparisons {close51}; q63's closest |sum - avg| / avg "
          f"is {gap63:.3e} from 0.1", flush=True)
    if close51["near"] or gap63 <= 10 * F64_RTOL:
        raise AssertionError("a q51 or q63 row lies within the comparison "
                             "tolerance of its filter")
    session = _cuda_session()
    q51, q63 = TPCDS_QUERIES["q51"][0], TPCDS_QUERIES["q63"][0]
    explain = q51(session, data_dir).explain()
    if explain.count("WindowExec") != 4 or "JoinExec[full" not in explain:
        raise AssertionError("q51 planned no full outer join between four "
                             "WindowExecs")
    paths = {}
    paths["q51"] = _drive(
        torch, "q51", lambda: q51(session, data_dir),
        lambda r: _check_window_rows("q51", r, want51),
        _Q6_ENTRIES + _SHUFFLE_ENTRIES + _WINDOW_ENTRIES, warm,
        ("murmur3_columns",))
    paths["q63"] = _drive(
        torch, "q63", lambda: q63(session, data_dir),
        lambda r: _check_window_rows("q63", r, want63),
        _Q6_ENTRIES + _SHUFFLE_ENTRIES + _WINDOW_ENTRIES, warm,
        ("matched_build_rows", "murmur3_columns", "key_ids"),
        zero=("partition_ids_for_keys", "group_by_part"))
    advisory = ADVISORY_PARTITION_BYTES.get(session.conf.settings)
    for label, q in (("q51", q51), ("q63", q63)):
        for desc, sizes in _map_side_bytes(torch, q(session, data_dir)):
            total = sum(sizes.values())
            how = "coalesced into partition 0, K9/K10 not run" \
                if total <= advisory else "hashed (K9) and grouped (K10)"
            print(f"[{label} exchange] {desc}: map side {total} bytes "
                  f"(advisory {advisory}), {how}; by partition {sizes}",
                  flush=True)
    return paths


# ---------------------------------------------------------------------------
# string kernels (K13a substring, K13b literal match) and the string paths
# ---------------------------------------------------------------------------

#: rows of each width of the K13 stress batches (2^24 rows in all)
STRING_STRESS_ROWS = {4: 1 << 22, 8: 1 << 22, 16: 1 << 22, 32: 1 << 21,
                      64: 1 << 20, 128: 1 << 19, 256: 1 << 19}
INT32_MAX = 2 ** 31 - 1
#: the 4-byte pieces stress rows are built from: ASCII, two 2-byte
#: characters, a 3-byte character and an ASCII byte, a 4-byte character,
#: NUL bytes, a lone continuation byte; one pick in seven is random bytes
_STRESS_SLOTS = [b"abcd", "éé".encode(), "€a".encode(), "😀".encode(),
                 b"\x00a\x00b", b"Z \x80Z"]
#: literal needles of the K13b stress checks (one wider than every W is
#: added per width)
_STRESS_NEEDLES = ["", "a", "é", "€a", "😀", "\x00a", "Z \x80Z", "abcdé"]
_TPCH_CODES = ("13", "31", "23", "29", "30", "18", "17")
_Q15_ZIPS = ("85669", "86197", "88274", "83405", "86475", "85392", "85460",
             "80348", "81792")


def _stress_strings(torch, gen, n: int, w: int, dev):
    """uint8 [n, w], int32 lengths, bool validity on the card: rows of
    4-byte pieces (whole UTF-8 characters, NULs, lone continuation bytes
    or random bytes) cut at a random length, so characters are cut too;
    ~10% null and ~10% empty rows, zeros past every length."""
    table = torch.tensor([int.from_bytes(s, "little") for s in
                          _STRESS_SLOTS], dtype=torch.int64, device=dev)
    nw = w // 4
    pick = torch.randint(0, len(_STRESS_SLOTS) + 1, (n, nw), device=dev,
                         generator=gen)
    rand = torch.randint(0, 1 << 32, (n, nw), dtype=torch.int64, device=dev,
                         generator=gen)
    words = torch.where(pick < len(_STRESS_SLOTS),
                        table[pick.clamp(max=len(_STRESS_SLOTS) - 1)], rand)
    data = torch.stack([(words >> (8 * k)) & 0xFF for k in range(4)],
                       dim=2).to(torch.uint8).reshape(n, w)
    u = torch.rand(n, device=dev, generator=gen)
    lengths = torch.randint(1, w + 1, (n,), device=dev, generator=gen)
    valid = u >= 0.1
    lengths = torch.where(valid & (u >= 0.2), lengths, 0).to(torch.int32)
    j = torch.arange(w, device=dev)
    data = torch.where(j[None, :] < lengths[:, None], data, 0)
    return data.contiguous(), lengths, valid


def _sector_bytes(torch, lengths, w: int) -> int:
    """Bytes of the 32-byte sectors of a row-major [n, w] matrix that hold
    a byte inside some row's length."""
    if w >= 32:
        return int(((lengths.long() + 31) // 32).sum()) * 32
    k = 32 // w
    pad = (-lengths.numel()) % k
    ln = torch.cat([lengths, lengths.new_zeros(pad)]).view(-1, k)
    return int((ln > 0).any(1).sum()) * 32


def _same_strings(torch, got, want, what: str) -> None:
    for g, w_, name in zip(got, want, ("data", "lengths", "validity")):
        if g.shape != w_.shape or not torch.equal(g, w_):
            raise AssertionError(f"{what}: {name} differs from the plain "
                                 "version")


def _column_operand(torch, gen, n: int, lo: int, hi: int, dev, extra=()):
    vals = torch.randint(lo, hi + 1, (n,), device=dev, generator=gen)
    for x in extra:
        vals = torch.where(torch.rand(n, device=dev, generator=gen) < 0.1,
                           x, vals)
    return vals, torch.rand(n, device=dev, generator=gen) >= 0.1


def check_substring(torch, dev, phones) -> dict:
    """K13a against its plain version on the 2^24-row stress batch (every
    width from 4 to 256; pos in [-W-2, W+2] and len in [-2, W+2] plus
    2^31-1, literal and as columns with nulls) and at q22's shape (the
    SF10 c_phone column, W 16, substring(c_phone, 1, 2)), exactly; timed
    at q22's shape."""
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops import strings as OS
    gen = torch.Generator(device=dev)
    gen.manual_seed(131)
    cases = 0
    for w, n in STRING_STRESS_ROWS.items():
        s = _stress_strings(torch, gen, n, w, dev)
        pos = _column_operand(torch, gen, n, -w - 2, w + 2, dev, (0,))
        ln = _column_operand(torch, gen, n, -2, w + 2, dev, (INT32_MAX,))
        literals = [(1, 2), (0, 3), (-1, 1), (-3, 2), (3, -1), (w // 2, w),
                    (w + 2, 1), (-w - 2, w + 2), (2, INT32_MAX),
                    (-2, INT32_MAX)]
        for p, l in literals + [(pos, ln), (pos, 5), (1, ln)]:
            _same_strings(torch, OS.substring(*s, p, l),
                          OS.substring_plain(*s, p, l),
                          f"K13a W={w} pos={p if isinstance(p, int) else 'col'}"
                          f" len={l if isinstance(l, int) else 'col'}")
            cases += 1
        del s, pos, ln
        torch.cuda.empty_cache()
    data, lengths, valid = phones
    n, w = data.shape
    _same_strings(torch, OS.substring(data, lengths, valid, 1, 2),
                  OS.substring_plain(data, lengths, valid, 1, 2), "K13a q22")
    ms = _time_ms(torch, lambda: OS.substring(data, lengths, valid, 1, 2),
                  reps=20)
    plain_ms = _time_ms(torch, lambda: OS.substring_plain(
        data, lengths, valid, 1, 2))
    # the kernel alone: its C entry point on preallocated outputs, apart
    # from the wrapper's allocations and checks
    out = [torch.empty_like(data), torch.empty_like(lengths),
           torch.empty_like(valid)]
    args = [data.data_ptr(), lengths.data_ptr(), valid.data_ptr(), n, w,
            None, None, 1, None, None, 2] + [t.data_ptr() for t in out] + [
        native.stream_ptr(dev)]
    lib = native.lib("string_substr")
    kernel_ms = _time_ms(torch, lambda: lib.srt_substring(*args), reps=50)
    # in: the sectors of the bytes inside the lengths, lengths, validity;
    # out: the whole W-wide rows, lengths, validity
    nbytes = _sector_bytes(torch, lengths, w) + 5 * n + n * w + 5 * n
    print(f"[K13a substring] checked {cases} (width, pos, len) cases on "
          f"2^24 stress rows over W 4..256 and q22's shape: equal; timed "
          f"rows={n} W={w} ms={ms:.4f} (the kernel alone {kernel_ms:.4f}) "
          f"plain_ms={plain_ms:.4f} "
          f"library_ms=none (no PyTorch call computes a UTF-8 substring) "
          f"bound_ms={_bound_ms(nbytes):.4f}", flush=True)
    return dict(name="substring", route="cuda",
                source="spark_rapids_tpu_torch/csrc/string_substr.cu",
                replaces="spark_rapids_tpu/expr/strings.py:174",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=None)


def _doubled(torch, data, lengths, valid):
    """Each row twice over, in a matrix twice as wide (a needle wider than
    the column's W once the row is longer than W / 2)."""
    n, w = data.shape
    j = torch.arange(2 * w, device=data.device)
    ln = lengths.long()[:, None]
    src = torch.where(j[None, :] < ln, j[None, :], j[None, :] - ln)
    out = torch.gather(data, 1, src.clamp(0, w - 1))
    out = torch.where(j[None, :] < 2 * ln, out, 0).contiguous()
    return out, (2 * lengths).to(torch.int32), valid


def check_string_match(torch, dev, ptypes) -> dict:
    """K13b against its plain version in every mode on the 2^24-row stress
    batch (literal needles, the empty one and one wider than W included,
    and needle columns: pieces of each row, and each row doubled) and at
    q14's shape (the joined p_type rows, W 32, prefix 'PROMO'), exactly;
    timed at q14's shape."""
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops import strings as OS
    gen = torch.Generator(device=dev)
    gen.manual_seed(132)
    cases, hits = 0, 0
    for w, n in STRING_STRESS_ROWS.items():
        s = _stress_strings(torch, gen, n, w, dev)
        pos = _column_operand(torch, gen, n, 1, w, dev)
        ln = _column_operand(torch, gen, n, 0, w // 2, dev)
        needles = [OS.literal_needle(t, dev) for t in
                   _STRESS_NEEDLES + ["x" * (w + 4)]]
        needles.append(OS.substring_plain(*s, pos, ln))
        needles.append(_doubled(torch, *s))
        for mode in OS.MATCH_MODES:
            for nd in needles:
                got = OS.string_match(mode, *s, *nd)
                want = OS.string_match_plain(mode, *s, *nd)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"K13b W={w} {mode} needle width "
                                         f"{nd[0].shape[1]} rows "
                                         f"{nd[0].shape[0]}: differs")
                hits += int(got[0].sum())
                cases += 1
        del s, pos, ln, needles
        torch.cuda.empty_cache()
    data, lengths, valid = ptypes
    n, w = data.shape
    nd = OS.literal_needle("PROMO", dev)
    got = OS.string_match("prefix", data, lengths, valid, *nd)
    want = OS.string_match_plain("prefix", data, lengths, valid, *nd)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("K13b q14 prefix: differs")
    ms = _time_ms(torch, lambda: OS.string_match("prefix", data, lengths,
                                                 valid, *nd), reps=20)
    plain_ms = _time_ms(torch, lambda: OS.string_match_plain(
        "prefix", data, lengths, valid, *nd))
    # the kernel alone, as for K13a
    out = [torch.empty_like(valid), torch.empty_like(valid)]
    args = [OS.MATCH_MODES["prefix"], data.data_ptr(), lengths.data_ptr(),
            valid.data_ptr(), n, w] + [t.data_ptr() for t in nd] + [
        0, nd[0].shape[1]] + [t.data_ptr() for t in out] + [
        native.stream_ptr(dev)]
    lib = native.lib("string_match")
    kernel_ms = _time_ms(torch, lambda: lib.srt_string_match(*args), reps=50)
    k = int(nd[1][0])

    def library():
        return (torch.eq(data[:, :k], nd[0][:, :k]).all(1)
                & (lengths >= k) & valid)

    if not torch.equal(library(), got[0]):
        raise AssertionError("K13b q14: the library call disagrees")
    lib_ms = _time_ms(torch, library, reps=20)
    # in: the first sector of every valid row at least k long, lengths,
    # validity; out: match and validity
    need = (valid & (lengths >= k)).to(torch.int32) * k
    nbytes = _sector_bytes(torch, need, w) + 5 * n + 2 * n
    print(f"[K13b string match] checked {cases} (width, mode, needle) cases "
          f"on 2^24 stress rows ({hits} matches) and q14's shape: equal; "
          f"timed rows={n} W={w} prefix 'PROMO' ms={ms:.4f} (the kernel "
          f"alone {kernel_ms:.4f}) "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (torch.eq over "
          f"the first {k} bytes .all(1) plus the length test) "
          f"bound_ms={_bound_ms(nbytes):.4f}", flush=True)
    return dict(name="string_match", route="cuda",
                source="spark_rapids_tpu_torch/csrc/string_match.cu",
                replaces="spark_rapids_tpu/expr/strings.py:294",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms)


def _strings_np(table, name: str):
    """(python strings with None, validity) of one string column."""
    c = table.column(name).combine_chunks()
    return (np.array(c.to_pylist(), dtype=object),
            c.is_valid().to_numpy(zero_copy_only=False))


def reference_q15(data_dir: str) -> tuple:
    """q15 over the parquet with numpy/pyarrow alone: (ca_zip, sum of
    cs_sales_price) of the sales in 2001Q1 whose address has one of nine
    zip prefixes or a state of CA/WA/GA, or whose price tops 500; first
    100 zips ascending (null first).  Also the rows of the three joins
    (the input of q15's filter, where the substring runs)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    def read(t, cols):
        return pq.read_table(os.path.join(data_dir, t), columns=cols)

    dd = read("date_dim", ["d_date_sk", "d_qoy", "d_year"])
    dsk, _ = _arrow_col(dd, "d_date_sk")
    qoy, _ = _arrow_col(dd, "d_qoy")
    year, _ = _arrow_col(dd, "d_year")
    dates = dsk[(qoy == 1) & (year == 2001)]
    cs = read("catalog_sales", ["cs_sold_date_sk", "cs_bill_customer_sk",
                                "cs_sales_price"])
    sold, sold_valid = _arrow_col(cs, "cs_sold_date_sk")
    cust, cust_valid = _arrow_col(cs, "cs_bill_customer_sk")
    price, price_valid = _arrow_col(cs, "cs_sales_price")
    cu = read("customer", ["c_customer_sk", "c_current_addr_sk"])
    csk, _ = _arrow_col(cu, "c_customer_sk")
    caddr, caddr_valid = _arrow_col(cu, "c_current_addr_sk")
    ca = read("customer_address", ["ca_address_sk", "ca_state", "ca_zip"])
    ask, _ = _arrow_col(ca, "ca_address_sk")
    states, state_valid = _strings_np(ca, "ca_state")
    zips, zip_valid = _strings_np(ca, "ca_zip")
    zip5 = pc.utf8_slice_codeunits(ca.column("ca_zip").combine_chunks(),
                                   0, 5)
    zip_hit = pc.fill_null(pc.is_in(zip5, value_set=pa.array(
        list(_Q15_ZIPS))), False).to_numpy(zero_copy_only=False)
    state_hit = state_valid & np.isin(states, ["CA", "WA", "GA"])
    idx = np.nonzero(sold_valid & np.isin(sold, dates) & cust_valid)[0]
    crow = _lookup(csk, cust[idx])
    idx, crow = idx[crow >= 0], crow[crow >= 0]
    k = caddr_valid[crow]
    idx, crow = idx[k], crow[k]
    arow = _lookup(ask, caddr[crow])
    idx, arow = idx[arow >= 0], arow[arow >= 0]
    joined = len(idx)
    keep = zip_hit[arow] | state_hit[arow] | (price_valid[idx]
                                               & (price[idx] > 500.0))
    idx, arow = idx[keep], arow[keep]
    sums: dict = {}
    for z, zv, p, pv in zip(zips[arow], zip_valid[arow], price[idx],
                            price_valid[idx]):
        key = z if zv else None
        tot = sums.setdefault(key, [0.0, False])
        if pv:
            tot[0] += float(p)
            tot[1] = True
    rows = [(k_, v[0] if v[1] else None) for k_, v in sums.items()]
    rows.sort(key=lambda r: (r[0] is not None, r[0] or ""))
    return rows[:100], joined


def _check_keyed_doubles(label: str, got, want, exact: int) -> None:
    """Rows equal in order: the first ``exact`` fields exactly, doubles
    after them within F64_RTOL."""
    if len(got) != len(want) or not got:
        raise AssertionError(f"{label}: {len(got)} rows, numpy/pyarrow "
                             f"{len(want)}")
    for g, w in zip(got, want):
        if g[:exact] != w[:exact] or len(g) != len(w):
            raise AssertionError(f"{label} row {g} != {w}")
        for a, b in zip(g[exact:], w[exact:]):
            if (a is None) != (b is None) or (
                    b is not None and not abs(a - b) <= F64_RTOL * abs(b)):
                raise AssertionError(f"{label} row {g} != {w} (doubles "
                                     f"rtol {F64_RTOL})")


def reference_q14(data_dir: str):
    """q14 over the parquet with numpy/pyarrow alone; also the part rows
    of the joined lineitem rows (q14's p_type input) and the part table's
    p_type column."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    li = pq.read_table(os.path.join(data_dir, "lineitem"),
                       columns=["l_partkey", "l_shipdate",
                                "l_extendedprice", "l_discount"])
    ship = li.column("l_shipdate").combine_chunks().cast("int32") \
        .to_numpy(zero_copy_only=False)
    lo = (_dt.date(1995, 9, 1) - _dt.date(1970, 1, 1)).days
    hi = (_dt.date(1995, 10, 1) - _dt.date(1970, 1, 1)).days
    keep = (ship >= lo) & (ship < hi)
    pk, _ = _arrow_col(li, "l_partkey")
    price, _ = _arrow_col(li, "l_extendedprice")
    disc, _ = _arrow_col(li, "l_discount")
    pt = pq.read_table(os.path.join(data_dir, "part"),
                       columns=["p_partkey", "p_type"])
    psk, _ = _arrow_col(pt, "p_partkey")
    ptype = pt.column("p_type").combine_chunks()
    promo = pc.fill_null(pc.starts_with(ptype, "PROMO"), False) \
        .to_numpy(zero_copy_only=False)
    prow = _lookup(psk, pk[keep])
    dp = (price[keep] * (1.0 - disc[keep]))[prow >= 0]
    prow = prow[prow >= 0]
    value = 100.0 * float(dp[promo[prow]].sum()) / float(dp.sum())
    return [(value,)], prow, ptype


def reference_q22(data_dir: str):
    """q22 over the parquet with numpy/pyarrow alone: (cntrycode, count,
    sum of c_acctbal) of customers whose phone starts with one of seven
    codes, whose balance is above the average positive balance of those,
    and who placed no order; by code.  Also the smallest relative gap
    between a balance and that average."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    cu = pq.read_table(os.path.join(data_dir, "customer"),
                       columns=["c_custkey", "c_phone", "c_acctbal"])
    ck, _ = _arrow_col(cu, "c_custkey")
    bal, _ = _arrow_col(cu, "c_acctbal")
    code = pc.utf8_slice_codeunits(cu.column("c_phone").combine_chunks(),
                                   0, 2)
    codes = np.array(pc.fill_null(code, "").to_pylist(), dtype=object)
    m = pc.fill_null(pc.is_in(code, value_set=pa.array(list(_TPCH_CODES))),
                     False).to_numpy(zero_copy_only=False)
    avg = float(bal[m & (bal > 0.0)].mean())
    gap = float(np.min(np.abs(bal[m] - avg)) / abs(avg))
    od = pq.read_table(os.path.join(data_dir, "orders"),
                       columns=["o_custkey"])
    ok, _ = _arrow_col(od, "o_custkey")
    sel = m & (bal > avg) & ~np.isin(ck, np.unique(ok))
    rows = []
    for c in sorted(set(codes[sel])):
        g = sel & (codes == c)
        rows.append((c, int(g.sum()), float(bal[g].sum())))
    return rows, gap


def _device_strings(torch, dev, arr):
    """(data, lengths, validity) of a pyarrow string array on the card,
    each in an allocation of its own (aligned for the kernels' word
    reads)."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    rb = pa.RecordBatch.from_arrays([arr], names=["s"])
    c = ColumnBatch.from_arrow(rb, dev).columns[0]
    return c.data.clone(), c.lengths.clone(), c.validity.clone()


_STRING_ENTRIES = ("substring", "string_match")


def run_string_phase(torch, dev, sf: float, warm: int):
    """K13a and K13b against their plain versions, then TPC-DS q15 (SF10,
    default layout, AQE on) and TPC-H q14 and q22 (``sf``, seed 7), each
    cold + warm and checked against numpy/pyarrow; returns ({kernel:
    entry}, {path: launches})."""
    from spark_rapids_tpu_torch.bench import tpcds_gen, tpch_gen
    from spark_rapids_tpu_torch.bench.profile_query import TPCH_OTHER
    from spark_rapids_tpu_torch.bench.tpcds_queries import TPCDS_QUERIES
    from spark_rapids_tpu_torch.bench.tpch_queries import q14, q22
    from spark_rapids_tpu_torch.conf import ADVISORY_PARTITION_BYTES
    tpch_dir = os.path.join(ROOT, ".bench_data", f"tpch_sf{sf:g}_seed7")
    tpcds_dir = os.path.join(ROOT, ".bench_data",
                             f"tpcds_sf{Q6_SF:g}_seed42_default")
    q15, tables = TPCDS_QUERIES["q15"]
    t0 = time.perf_counter()
    tpch_gen.generate_tpch(tpch_dir, sf=sf, seed=7, tables=("lineitem",))
    tpch_gen.generate_tpch(tpch_dir, sf=sf, seed=7, tables=TPCH_OTHER)
    tpcds_gen.generate_tpcds(tpcds_dir, sf=Q6_SF, seed=42, tables=tables,
                             rows_per_file=DEFAULT_ROWS_PER_FILE)
    print(f"[strings] TPC-H SF{sf:g} {list(TPCH_OTHER)} and TPC-DS "
          f"SF{Q6_SF:g} {list(tables)} ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    want15, joined15 = reference_q15(tpcds_dir)
    want14, prow, ptype = reference_q14(tpch_dir)
    want22, gap22 = reference_q22(tpch_dir)
    print(f"[strings] numpy/pyarrow references in "
          f"{time.perf_counter() - t0:.1f} s: q15 filters {joined15} "
          f"joined rows; q14 joins {len(prow)} "
          f"lineitem rows to part; q22's closest |c_acctbal - avg| / avg "
          f"is {gap22:.3e}", flush=True)
    if gap22 <= 10 * F64_RTOL:
        raise AssertionError("a q22 balance lies within the comparison "
                             "tolerance of the average")
    import pyarrow.parquet as pq
    phones = pq.read_table(os.path.join(tpch_dir, "customer"),
                           columns=["c_phone"]).column("c_phone") \
        .combine_chunks()
    entries = {
        "substring": check_substring(
            torch, dev, _device_strings(torch, dev, phones)),
        "string_match": check_string_match(
            torch, dev, _device_strings(torch, dev, ptype.take(prow)))}
    del phones, prow, ptype
    torch.cuda.empty_cache()
    session = _cuda_session()
    explain = q15(session, tpcds_dir).explain()
    if explain.index("FilterExec") > explain.index("JoinExec") or \
            explain.count("JoinExec") != 3:
        raise AssertionError("q15 does not filter above its three joins")
    paths = {}
    paths["q15"] = _drive(
        torch, "q15", lambda: q15(session, tpcds_dir),
        lambda r: _check_keyed_doubles("q15", r, want15, 1),
        _Q6_ENTRIES + _SHUFFLE_ENTRIES + _STRING_ENTRIES, warm,
        ("matched_build_rows", "murmur3_columns", "key_ids",
         "string_match"), zero=("partition_ids_for_keys", "group_by_part"))
    advisory = ADVISORY_PARTITION_BYTES.get(session.conf.settings)
    for desc, sizes in _map_side_bytes(torch, q15(session, tpcds_dir)):
        print(f"[q15 exchange] {desc}: map side {sum(sizes.values())} "
              f"bytes (advisory {advisory}), coalesced into partition 0, "
              f"K9/K10 not run; by partition {sizes}", flush=True)
    paths["q14"] = _drive(
        torch, "q14", lambda: q14(session, tpch_dir),
        lambda r: _check_keyed_doubles("q14", r, want14, 0),
        _Q6_ENTRIES + _STRING_ENTRIES, warm,
        ("segment_flags", "key_ids", "matched_build_rows", "substring"))
    paths["q22"] = _drive(
        torch, "q22", lambda: q22(session, tpch_dir),
        lambda r: _check_keyed_doubles("q22", r, want22, 2),
        _Q6_ENTRIES + _STRING_ENTRIES, warm,
        ("key_ids", "matched_build_rows", "string_match"))
    if "JoinExec[anti" not in q22(session, tpch_dir).explain():
        raise AssertionError("q22 planned no anti join")
    return entries, paths


# ---------------------------------------------------------------------------
# string kernels K13c (concat) and K13d (ASCII case map); q24 and q84
# ---------------------------------------------------------------------------

#: literal pieces of the K13c stress checks (a null one is added)
_CONCAT_LITERALS = [", ", "é-", "", "abcdefghijklmnopqrstu😀"]
#: the K13c stress cases: pieces as "s" (the width's stress column), "h"
#: (a column a quarter as wide) or an index into the literals, "n" a null
#: literal; 1 to 8 pieces
_CONCAT_STRESS = [["s"], ["s", 0], [1, "s", "h"], ["h", "n", "s"],
                  ["s", 3, "h", 2], ["s", 0, "h", "s", 1, "h", "s", "h"]]


def _concat_pieces(torch, OS, spec, s, h, dev):
    out = []
    for p in spec:
        if p == "s":
            out.append(s)
        elif p == "h":
            out.append(h)
        elif p == "n":
            d, ln, v = OS.literal_needle("x", dev)
            out.append((d, ln, ~v))
        else:
            out.append(OS.literal_needle(_CONCAT_LITERALS[p], dev))
    return out


def _concat_bytes(torch, pieces, out_w: int, n: int) -> int:
    """Bytes K13c must move: each column piece's sectors inside its
    lengths, its lengths and validity, a literal row once; the output
    rows, lengths and validity."""
    total = n * out_w + 5 * n
    for d, ln, _v in pieces:
        if d.shape[0] == 1:
            total += d.shape[1] + 5
        else:
            total += _sector_bytes(torch, ln, d.shape[1]) + 5 * n
    return total


def check_concat(torch, dev, names) -> dict:
    """K13c against its plain version in both modes on the 2^24-row stress
    batch (every width from 4 to 256; 1 to 8 pieces, columns of two widths,
    literal pieces, the empty and a null one) and at q84_all_cities' shape
    (the coalesced last and first names of the customers that reach the
    Concat, with ', ' between them), exactly; timed at that shape."""
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops import strings as OS
    gen = torch.Generator(device=dev)
    gen.manual_seed(133)
    cases = 0
    for w, n in STRING_STRESS_ROWS.items():
        n = n // 2 if w >= 128 else n  # 8 pieces of W 256 are 1 KiB rows
        s = _stress_strings(torch, gen, n, w, dev)
        h = _stress_strings(torch, gen, n, max(4, w // 4), dev)
        for spec in _CONCAT_STRESS:
            pieces = _concat_pieces(torch, OS, spec, s, h, dev)
            for sep in (None, ", "):
                _same_strings(torch, OS.concat(pieces, sep),
                              OS.concat_plain(pieces, sep),
                              f"K13c W={w} pieces={spec} sep={sep!r}")
                cases += 1
            del pieces
            torch.cuda.empty_cache()
        del s, h
        torch.cuda.empty_cache()
    last, first = names
    n = last[0].shape[0]
    pieces = [last, OS.literal_needle(", ", dev), first]
    got = OS.concat(pieces)
    _same_strings(torch, got, OS.concat_plain(pieces), "K13c q84")
    out_w = got[0].shape[1]
    ms = _time_ms(torch, lambda: OS.concat(pieces), reps=20)
    plain_ms = _time_ms(torch, lambda: OS.concat_plain(pieces))
    # the kernel alone: its C entry point on preallocated outputs
    import ctypes
    ptrs = ctypes.c_void_p * 3
    args = [3, ptrs(*[p[0].data_ptr() for p in pieces]),
            (ctypes.c_int * 3)(*[p[0].shape[1] for p in pieces]),
            ptrs(*[p[1].data_ptr() for p in pieces]),
            ptrs(*[p[2].data_ptr() for p in pieces]),
            (ctypes.c_int * 3)(1, 0, 1), n, None, 0, 0, 0, out_w] + [
        t.data_ptr() for t in got] + [native.stream_ptr(dev)]
    lib = native.lib("string_concat")
    kernel_ms = _time_ms(torch, lambda: lib.srt_concat(*args), reps=50)
    nbytes = _concat_bytes(torch, pieces, out_w, n)
    print(f"[K13c concat] checked {cases} (width, pieces, mode) cases on "
          f"~2^24 stress rows over W 4..256 and q84_all_cities' shape: "
          f"equal; timed rows={n} pieces W "
          f"{[p[0].shape[1] for p in pieces]} -> W {out_w} ms={ms:.4f} "
          f"(the kernel alone {kernel_ms:.4f}) plain_ms={plain_ms:.4f} "
          f"library_ms=none (no PyTorch call "
          f"concatenates variable-length rows) "
          f"bound_ms={_bound_ms(nbytes):.4f}", flush=True)
    return dict(name="concat", route="cuda",
                source="spark_rapids_tpu_torch/csrc/string_concat.cu",
                replaces="spark_rapids_tpu/expr/strings.py:252",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=None)


def check_case_map(torch, dev, countries) -> dict:
    """K13d against its plain version in both directions on the 2^24-row
    stress batch (every width from 4 to 256, letters of both cases
    planted, and row counts that leave a tail shorter than one 16-byte
    vector) and at q24's shape (the SF10 ca_country column, W 16, upper),
    exactly; timed at q24's shape."""
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops import strings as OS
    gen = torch.Generator(device=dev)
    gen.manual_seed(134)
    cases = 0
    for w, n in STRING_STRESS_ROWS.items():
        s = _stress_strings(torch, gen, n + 1, w, dev)
        # ASCII letters and their neighbours on a third of the bytes
        letters = torch.tensor(list(b"aAzZmM@[`{"), dtype=torch.uint8,
                               device=dev)
        pick = torch.randint(0, len(letters), s[0].shape, device=dev,
                             generator=gen)
        plant = (torch.rand(s[0].shape, device=dev, generator=gen) < 0.33) \
            & (torch.arange(w, device=dev)[None, :] < s[1][:, None])
        data = torch.where(plant, letters[pick], s[0]).contiguous()
        for upper in (True, False):
            for rows in (n + 1, n - 3):
                t = (data[:rows], s[1][:rows], s[2][:rows])
                _same_strings(torch, OS.case_map(*t, upper),
                              OS.case_map_plain(*t, upper),
                              f"K13d W={w} rows={rows} upper={upper}")
                cases += 1
        del s, data, pick, plant
        torch.cuda.empty_cache()
    data, lengths, valid = countries
    n, w = data.shape
    got = OS.case_map(data, lengths, valid, True)
    _same_strings(torch, got, OS.case_map_plain(data, lengths, valid, True),
                  "K13d q24")
    ms = _time_ms(torch, lambda: OS.case_map(data, lengths, valid, True),
                  reps=20)
    plain_ms = _time_ms(torch, lambda: OS.case_map_plain(data, lengths,
                                                         valid, True))
    out = torch.empty_like(data)
    lib = native.lib("string_case")
    args = [data.data_ptr(), out.data_ptr(), n * w, 1,
            native.stream_ptr(dev)]
    kernel_ms = _time_ms(torch, lambda: lib.srt_case_map(*args), reps=50)
    # in: the sectors inside the lengths; out: the whole rows (lengths and
    # validity are shared, not moved)
    nbytes = _sector_bytes(torch, lengths, w) + n * w
    print(f"[K13d case map] checked {cases} (width, rows, direction) cases "
          f"on 2^24 stress rows and q24's shape: equal; timed rows={n} "
          f"W={w} upper ms={ms:.4f} (the kernel alone {kernel_ms:.4f}) "
          f"plain_ms={plain_ms:.4f} library_ms=none (no PyTorch call maps "
          f"ASCII case) bound_ms={_bound_ms(nbytes):.4f}", flush=True)
    return dict(name="case_map", route="cuda",
                source="spark_rapids_tpu_torch/csrc/string_case.cu",
                replaces="spark_rapids_tpu/expr/strings.py:63",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=None)


def _key(v, ok):
    return v if ok else None


def reference_q24(data_dir: str):
    """q24 over the parquet with numpy/pyarrow alone: (c_last_name,
    c_first_name, s_store_name, paid) of the pale-item groups above 5% of
    the average net paid, ordered ascending with nulls first.  Also the
    smallest relative gap between a group's paid and the threshold."""
    import pyarrow.parquet as pq

    def read(t, cols):
        return pq.read_table(os.path.join(data_dir, t), columns=cols)

    st = read("store", ["s_store_sk", "s_store_name", "s_market_id",
                        "s_state", "s_zip"])
    ssk, _ = _arrow_col(st, "s_store_sk")
    market, _ = _arrow_col(st, "s_market_id")
    sname, sname_ok = _strings_np(st, "s_store_name")
    sstate, sstate_ok = _strings_np(st, "s_state")
    szip, szip_ok = _strings_np(st, "s_zip")
    ss = read("store_sales", ["ss_ticket_number", "ss_item_sk",
                              "ss_customer_sk", "ss_store_sk",
                              "ss_net_paid"])
    store, store_ok = _arrow_col(ss, "ss_store_sk")
    keep = np.nonzero(store_ok & np.isin(store, ssk[market == 8]))[0]
    ticket, _ = _arrow_col(ss, "ss_ticket_number")
    item, _ = _arrow_col(ss, "ss_item_sk")
    cust, cust_ok = _arrow_col(ss, "ss_customer_sk")
    paid, _ = _arrow_col(ss, "ss_net_paid")
    del ss
    sr = read("store_returns", ["sr_ticket_number", "sr_item_sk"])
    rt, _ = _arrow_col(sr, "sr_ticket_number")
    ri, _ = _arrow_col(sr, "sr_item_sk")
    # (ticket, item) as one int64; a pair may repeat on either side
    rkey = np.sort(rt.astype(np.int64) * (1 << 20) + ri)
    lkey = ticket[keep].astype(np.int64) * (1 << 20) + item[keep]
    mult = np.searchsorted(rkey, lkey, "right") - \
        np.searchsorted(rkey, lkey, "left")
    rows = np.repeat(keep, mult)
    it = read("item", ["i_item_sk", "i_color", "i_current_price",
                       "i_manager_id", "i_units", "i_size"])
    isk, _ = _arrow_col(it, "i_item_sk")
    icols = [_strings_np(it, "i_color"), _arrow_col(it, "i_current_price"),
             _arrow_col(it, "i_manager_id"), _strings_np(it, "i_units"),
             _strings_np(it, "i_size")]
    cu = read("customer", ["c_customer_sk", "c_first_name", "c_last_name",
                           "c_birth_country"])
    csk, _ = _arrow_col(cu, "c_customer_sk")
    first, first_ok = _strings_np(cu, "c_first_name")
    last, last_ok = _strings_np(cu, "c_last_name")
    born, born_ok = _strings_np(cu, "c_birth_country")
    ca = read("customer_address", ["ca_address_sk", "ca_state",
                                   "ca_country", "ca_zip"])
    astate, astate_ok = _strings_np(ca, "ca_state")
    country, country_ok = _strings_np(ca, "ca_country")
    azip, azip_ok = _strings_np(ca, "ca_zip")
    by_key: dict = {}
    zips = set(szip[(market == 8) & szip_ok])
    for a in np.nonzero(country_ok & azip_ok)[0]:
        if azip[a] in zips:
            by_key.setdefault((country[a].upper(), azip[a]), []).append(a)
    rows = rows[cust_ok[rows]]
    srow = _lookup(ssk, store[rows])
    irow = _lookup(isk, item[rows])
    crow = _lookup(csk, cust[rows])
    ok = (crow >= 0) & (irow >= 0)
    rows, srow, irow, crow = rows[ok], srow[ok], irow[ok], crow[ok]
    groups: dict = {}
    for r, s, i, c in zip(rows, srow, irow, crow):
        if not (born_ok[c] and szip_ok[s]):
            continue
        for a in by_key.get((born[c], szip[s]), ()):
            k = (_key(last[c], last_ok[c]), _key(first[c], first_ok[c]),
                 _key(sname[s], sname_ok[s]),
                 _key(astate[a], astate_ok[a]),
                 _key(sstate[s], sstate_ok[s])) + tuple(
                _key(v[i], m[i]) for v, m in icols)
            groups[k] = groups.get(k, 0.0) + float(paid[r])
    if not groups:
        return [], float("inf")
    threshold = 0.05 * (sum(groups.values()) / len(groups))
    pale: dict = {}
    for k, v in groups.items():
        if k[5] == "pale":
            pale[k[:3]] = pale.get(k[:3], 0.0) + v
    gap = min((abs(v - threshold) / abs(threshold) for v in pale.values()),
              default=float("inf"))
    out = [k + (v,) for k, v in pale.items() if v > threshold]
    out.sort(key=lambda r: tuple((x is not None, x if x is not None else "")
                                 for x in r[:3]) + (r[3],))
    return out, gap


def reference_q84(data_dir: str, city):
    """q84 (``city`` None: q84_all_cities) over the parquet with
    numpy/pyarrow alone: (customer_id, 'last, first') of the first 100
    customers by id.  Also the coalesced last and first names of every
    customer that reaches the Concat (the kernel's input on the path)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    def read(t, cols=None):
        return pq.read_table(os.path.join(data_dir, t), columns=cols)

    cu = read("customer", ["c_customer_id", "c_first_name", "c_last_name",
                           "c_current_addr_sk", "c_current_cdemo_sk",
                           "c_current_hdemo_sk"])
    ca = read("customer_address", ["ca_address_sk", "ca_city"])
    ask, _ = _arrow_col(ca, "ca_address_sk")
    if city is not None:
        cities, cities_ok = _strings_np(ca, "ca_city")
        ask = ask[cities_ok & (cities == city)]
    hd = read("household_demographics", ["hd_demo_sk", "hd_income_band_sk"])
    hsk, _ = _arrow_col(hd, "hd_demo_sk")
    band, band_ok = _arrow_col(hd, "hd_income_band_sk")
    ib = read("income_band")
    bsk, _ = _arrow_col(ib, "ib_income_band_sk")
    lo, _ = _arrow_col(ib, "ib_lower_bound")
    hi, _ = _arrow_col(ib, "ib_upper_bound")
    bands = bsk[(lo >= 38128) & (hi <= 38128 + 50000)]
    cdsk, _ = _arrow_col(read("customer_demographics", ["cd_demo_sk"]),
                         "cd_demo_sk")
    rcd, rcd_ok = _arrow_col(read("store_returns", ["sr_cdemo_sk"]),
                             "sr_cdemo_sk")
    addr, addr_ok = _arrow_col(cu, "c_current_addr_sk")
    cdemo, cdemo_ok = _arrow_col(cu, "c_current_cdemo_sk")
    hdemo, hdemo_ok = _arrow_col(cu, "c_current_hdemo_sk")
    hrow = _lookup(hsk, hdemo)
    hband = np.where(hrow >= 0, band[hrow], 0)
    hband_ok = (hrow >= 0) & band_ok[np.maximum(hrow, 0)]
    sel = (addr_ok & np.isin(addr, ask) & hdemo_ok & hband_ok
           & np.isin(hband, bands) & cdemo_ok & np.isin(cdemo, cdsk)
           & np.isin(cdemo, np.unique(rcd[rcd_ok])))
    idx = np.nonzero(sel)[0]
    cid = np.array(cu.column("c_customer_id").combine_chunks().to_pylist(),
                   dtype=object)
    lastc = pc.fill_null(cu.column("c_last_name").combine_chunks(), "")
    firstc = pc.fill_null(cu.column("c_first_name").combine_chunks(), "")
    lastn = np.array(lastc.to_pylist(), dtype=object)
    firstn = np.array(firstc.to_pylist(), dtype=object)
    out = sorted((cid[i], f"{lastn[i]}, {firstn[i]}") for i in idx)[:100]
    take = pa.array(idx, type=pa.int64())
    return out, (lastc.take(take), firstc.take(take))


def _packed_key_limbs(data_dir: str) -> tuple:
    """(bits, limbs) of K1's packed key over q24's 10 group-by keys, at
    the widths the scans give their columns."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.ops.sort import key_layout
    keys = [("customer", "c_last_name"), ("customer", "c_first_name"),
            ("store", "s_store_name"), ("customer_address", "ca_state"),
            ("store", "s_state"), ("item", "i_color"),
            ("item", "i_current_price"), ("item", "i_manager_id"),
            ("item", "i_units"), ("item", "i_size")]
    bits = 0
    for t, c in keys:
        arr = pq.read_table(os.path.join(data_dir, t), columns=[c]) \
            .column(c).combine_chunks()
        rb = pa.RecordBatch.from_arrays([arr], names=[c])
        import torch
        col = ColumnBatch.from_arrow(rb, torch.device("cpu")).columns[0]
        bits += key_layout(col)[2]
    return bits, (bits + 63) // 64


def time_q24_key_ids(torch, dev, data_dir: str) -> float:
    """ms of one K6 call (its K1 sort, K3 gather and K4 flags included) at
    q24's first join: one 2^20-row store_sales file against all of
    store_returns, keyed on (ticket, item)."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.ops import join as J
    f = sorted(x for x in os.listdir(os.path.join(data_dir, "store_sales"))
               if x.endswith(".parquet"))[0]
    lt = pq.read_table(os.path.join(data_dir, "store_sales", f),
                       columns=["ss_ticket_number", "ss_item_sk"])
    rt = pq.read_table(os.path.join(data_dir, "store_returns"),
                       columns=["sr_ticket_number", "sr_item_sk"])
    lb = ColumnBatch.from_arrow(lt.combine_chunks().to_batches()[0], dev)
    rb = ColumnBatch.from_arrow(rt.combine_chunks().to_batches()[0], dev)
    ms = _time_ms(torch, lambda: J._key_ids(lb, rb, [0, 1], [0, 1]))
    print(f"[q24 K6] one _key_ids call at {lb.num_rows} + {rb.num_rows} "
          f"rows (ticket, item): ms={ms:.3f}", flush=True)
    return ms


_CASE_ENTRIES = ("concat", "case_map")


def run_concat_case_phase(torch, dev, warm: int):
    """K13c and K13d against their plain versions, then TPC-DS q24, q84 and
    q84_all_cities (SF10, default layout, AQE on), each cold + warm and
    checked against numpy/pyarrow; returns ({kernel: entry}, {path:
    launches})."""
    from spark_rapids_tpu_torch.bench import tpcds_gen
    from spark_rapids_tpu_torch.bench.tpcds_queries import TPCDS_QUERIES
    tpcds_dir = os.path.join(ROOT, ".bench_data",
                             f"tpcds_sf{Q6_SF:g}_seed42_default")
    need = set(TPCDS_QUERIES["q24"][1]) | set(TPCDS_QUERIES["q84"][1])
    tables = [t for t in tpcds_gen.TABLES if t in need]
    t0 = time.perf_counter()
    tpcds_gen.generate_tpcds(tpcds_dir, sf=Q6_SF, seed=42, tables=tables,
                             rows_per_file=DEFAULT_ROWS_PER_FILE)
    print(f"[q24/q84] TPC-DS SF{Q6_SF:g} {tables} ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    want24, gap24 = reference_q24(tpcds_dir)
    want84, _names = reference_q84(tpcds_dir, "Edgewood")
    want84a, names = reference_q84(tpcds_dir, None)
    print(f"[q24/q84] numpy/pyarrow references in "
          f"{time.perf_counter() - t0:.1f} s: q24 {len(want24)} rows "
          f"(closest |paid - threshold| / threshold {gap24:.3e}); q84 "
          f"{len(want84)} rows; q84_all_cities concatenates "
          f"{len(names[0])} names", flush=True)
    if want84:
        raise AssertionError("q84 has rows: the generator wrote Edgewood")
    if not want24:
        raise AssertionError("q24 has no rows at SF10")
    if gap24 <= 10 * F64_RTOL:
        raise AssertionError("a q24 group lies within the comparison "
                             "tolerance of the threshold")
    import pyarrow.parquet as pq
    countries = pq.read_table(os.path.join(tpcds_dir, "customer_address"),
                              columns=["ca_country"]).column("ca_country") \
        .combine_chunks()
    entries = {
        "concat": check_concat(torch, dev, tuple(
            _device_strings(torch, dev, a) for a in names)),
        "case_map": check_case_map(
            torch, dev, _device_strings(torch, dev, countries))}
    del countries, names
    torch.cuda.empty_cache()
    bits, limbs = _packed_key_limbs(tpcds_dir)
    print(f"[q24 K1] the 10-key group-by packs {bits} bits: {limbs} "
          f"64-bit limbs", flush=True)
    time_q24_key_ids(torch, dev, tpcds_dir)
    torch.cuda.empty_cache()
    session = _cuda_session()
    q24 = TPCDS_QUERIES["q24"][0]
    q84 = TPCDS_QUERIES["q84"][0]
    q84a = TPCDS_QUERIES["q84_all_cities"][0]
    every = _Q6_ENTRIES + _SHUFFLE_ENTRIES + _STRING_ENTRIES + _CASE_ENTRIES
    # AQE coalesces every exchange's map side (K9/K10 0); no K13a/K13b
    not_run = ("partition_ids_for_keys", "murmur3_columns", "group_by_part",
               "substring", "string_match")
    paths = {}
    paths["q24"] = _drive(
        torch, "q24", lambda: q24(session, tpcds_dir),
        lambda r: _check_keyed_doubles("q24", r, want24, 3), every, warm,
        ("matched_build_rows",), zero=not_run + ("concat",))

    def check84(rows):
        if rows:
            raise AssertionError(f"q84 returned {len(rows)} rows")

    # q84: no customer survives the semi join against the empty Edgewood
    # side, so nothing is gathered, expanded, concatenated or aggregated
    paths["q84"] = _drive(
        torch, "q84", lambda: q84(session, tpcds_dir), check84, every, warm,
        ("gather_columns", "segment_aggregate", "segment_flags",
         "join_indices_from_probe", "matched_build_rows"),
        zero=not_run + ("key_ids", "concat", "case_map"))

    def check84a(rows):
        if rows != want84a:
            raise AssertionError(f"q84_all_cities rows differ: {rows[:3]} "
                                 f"vs {want84a[:3]}")

    paths["q84_all_cities"] = _drive(
        torch, "q84_all_cities", lambda: q84a(session, tpcds_dir), check84a,
        every, warm,
        ("segment_aggregate", "segment_flags", "matched_build_rows"),
        zero=not_run + ("key_ids", "case_map"))
    return entries, paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of q1, q14 and q22 (the "
                    "TPC-DS queries run at SF10 always)")
    ap.add_argument("--warm", type=int, default=3,
                    help="warm runs of each query")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.ops import native
    card = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    reports = native.build(verbose=True)
    print(f"[build] {len(native.SOURCES)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[ptxas {name}] {line.strip()}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261017)
    entries = {}
    entries["compact"] = check_compact(torch, dev, rng)
    q1_batch = _batch(torch, _q1_host_columns(rng, 1 << 24), dev)
    entries["sort_permutation"], perm = check_sort(torch, dev, rng, q1_batch)
    entries["gather_columns"], sorted_cols = check_gather(torch, dev,
                                                          q1_batch, perm)
    entries["segment_aggregate"] = check_segmented(torch, dev, q1_batch,
                                                   sorted_cols)
    del q1_batch, perm, sorted_cols
    entries["join_probe_fast"] = check_join_probe(torch, dev, rng)
    entries["join_key_ids"] = check_key_ids(torch, dev, rng)
    entries["join_expand"] = check_expand(torch, dev, rng)
    torch.cuda.empty_cache()
    entries["partition_ids_for_keys"] = check_partition_ids(torch, dev, rng)
    torch.cuda.empty_cache()
    entries["group_by_part"] = check_group_by_part(torch, dev, rng)
    torch.cuda.empty_cache()
    entries["sorted_segments"] = check_window_segments(torch, dev, rng)
    torch.cuda.empty_cache()
    entries["running_or_bounded_agg"] = check_window_agg(torch, dev, rng)
    torch.cuda.empty_cache()
    check_window_glue(torch, dev, rng)
    torch.cuda.empty_cache()
    paths = {"q1": run_q1(torch, args.sf, args.warm)}
    torch.cuda.empty_cache()
    paths["q6_onefile"] = run_q6(torch, args.warm)
    torch.cuda.empty_cache()
    paths.update(run_exchange_paths(torch, args.warm))
    torch.cuda.empty_cache()
    paths.update(run_window_paths(torch, args.warm))
    torch.cuda.empty_cache()
    string_entries, string_paths = run_string_phase(torch, dev, args.sf,
                                                    args.warm)
    entries.update(string_entries)
    paths.update(string_paths)
    torch.cuda.empty_cache()
    case_entries, case_paths = run_concat_case_phase(torch, dev, args.warm)
    entries.update(case_entries)
    paths.update(case_paths)
    kernels = []
    for name, e in entries.items():
        counters = list(_counters()[name])
        by_path = {p: c[name] for p, c in paths.items() if name in c}
        # every path's cold run, its counts set to 0 just before it
        e["launches"] = sum(c[counters[0]] for c in by_path.values())
        row = {k: e[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        row["launches_by_path"] = {p: c[counters[0]]
                                   for p, c in by_path.items()}
        row["launches_by_counter"] = {
            k: sum(c[k] for c in by_path.values()) for k in counters}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
