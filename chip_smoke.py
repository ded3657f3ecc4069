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
   phase 6): seeded inputs
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
7. print the kernel table as one JSON line (launches per path), the card
   line, and last the result line {"ok": true, "device": {...}}.

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
            "group_by_part": {"group_by_part": P.group_by_part}}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of the q1 phase (q6 runs "
                    "at SF10 always)")
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
    paths = {"q1": run_q1(torch, args.sf, args.warm)}
    torch.cuda.empty_cache()
    paths["q6_onefile"] = run_q6(torch, args.warm)
    torch.cuda.empty_cache()
    paths.update(run_exchange_paths(torch, args.warm))
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
