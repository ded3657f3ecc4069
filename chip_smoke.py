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
   phase 7; K13a, K13b in phase 8; K13c, K13d in phase 9; K13i, K4p in
   phase 10; K8a, K8b in phase 11; K11, K12c in phase 12; K14a-c in
   phase 13; K13e-h, K4s in phase 14; K15a, K15b in phase 15): seeded
   inputs
   at the shapes the q1 and q6 main paths give it, the kernel held against
   its plain PyTorch version on the card, and its time beside the plain
   version's, one PyTorch library call's and the memory-bound floor; K2
   at a 2^20-row scan batch of q1's 7 columns under q1's filter (~98%
   kept) and under a 3% keep, through the wrapper in turns with its plain
   version and mask indexing of every leaf, its two C entry points alone
   (with the host read between them) and its kernels alone
   (torch.profiler: one count_kernel and one copy_kernel a call, one copy
   to the host); K5 at q6's largest probe (2^20 stream rows against
   customer's 501,187 keys, every join type over the build's search
   layout), through the wrapper in turns with its plain version and two
   searchsorted calls, its C entry point alone and its search kernel
   alone (one search_kernel a call, nothing else), beside K7's own
   offsets scan of the same counts (which the search spares), and at
   q6's other build sides (item, date_dim, customer_address) through the
   wrapper and the kernel alone; the rank path's search (its sorted ids
   new each call, their layout built for the call) at q6's and q24's
   shapes; K7 under every join type at q6's first join and at a
   many-to-many shape (8.66M slots), timed at both through the wrapper in
   turns with its plain version and torch.repeat_interleave, its C entry
   alone and its kernel alone (one expand_kernel a call, the full-outer
   tail in the same launch: the library exports no tail entry), and its
   own one-launch offsets scan (offsets_kernel); K10 (in phase 6) at
   2^20 rows, P = 8 and 200, the order alone and with K3's gather, in
   turns with the plain versions and the library calls, its two C entry
   points alone and its kernels alone (one upsweep_kernel and one
   scatter_kernel a call, K3's gather_kernel; no scan, no memset); K1
   at q1's keys (2^24 rows) and at mixed int64/f64/int32/W16-string keys
   (2^22 rows, two orders) with the plan its wrapper derived (the varying
   bits, words and digit passes), timed in turns beside its plain version
   and torch.argsort(stable=True) of q1's packed key (the best of two
   rounds), its C entry points alone and its kernels alone
   (torch.profiler: one plan and one encode kernel, an upsweep and a scan
   a word, a scatter a digit pass, one copy to the host and nothing else,
   no memset), with the bytes the design moves; then the mesh kernels
   alone under torch.profiler (later in a run it sees no device work):
   K15b over 8 shard slices at top_customers_mesh's destination shape and
   K15a at a 4,194,304-row shard of one and of three int32 columns into 8
   sections, one kernel a call and no copy; K3 at q1's 2^24 rows x 6
   columns under q1's sort permutation and at a q6 join output (14,524 of
   2^20 rows x 6 int32 columns), each through the wrapper in turns with
   its plain version and index_select of every leaf (the best of two
   rounds), its C entry point alone and its kernel alone (torch.profiler:
   one gather_kernel a call, nothing else), with the 32-byte source
   sectors the permutation touches; K4 at q1's shape (2^24 rows under
   q1's two keys, the 11 aggregates of q1's update; 16 specs checked) and
   at 2^22 rows in ~2^20 groups of one int64 key (the same aggregates over
   q1's doubles), each checked (double sums with the same bits on two
   calls), through the wrapper in turns with its plain version, its three
   C entry points alone and its kernels alone (torch.profiler: one
   bounds_kernel, agg_tile_kernel and agg_combine_kernel and K3's key
   gather a call, one copy to the host), beside torch.segment_reduce once
   a distinct summed or counted input and index_add_ once a spec; K8a's
   kernel alone at a synthetic q1 lineitem batch (one decode_batch_kernel
   a call); K6 at q6's rank join and at 2^22 rows
   of one int64 key, in turns with torch.unique, its C entry points alone
   and its kernels alone (K1's, one key_ids_kernel, one copy to the host
   and nothing else);
4. generate TPC-H lineitem at the --sf scale (SF5 by default, a cut of
   depth that keeps the whole script within its time) into .bench_data/
   (reused when there),
   run q1 through TorchSession() on cuda -- one cold run with every launch
   counter set to 0 just before it, then two warm runs -- and check the
   rows against an independent numpy/pyarrow evaluation of q1;
5. the same for TPC-DS q6 at SF10 (seed 42, one parquet file per table):
   every launch counter of K1-K7 (K4's boundary pass and K5's build-key
   rewrite included) is set to 0 just before its cold run, and each must
   be above 0 after it, but for K7's matched-build bitmap, which only a
   full outer join runs; and K7's own offsets scan
   (``join._offsets_cuda``, which only K14 takes) must stay at 0 (K5's
   search writes the offsets K7 reads); from here on every C entry of
   K7's and K10's libraries is counted, and every path must make one
   ``srt_join_expand`` a K7 call (the full-outer tail inside it) and one
   ``srt_partition_upsweep`` and one ``srt_partition_scatter`` a K10
   call up to 255 partitions (no scan, no counts kernel);
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
   columns) and at the paths' shapes (q22's c_phone column, q14's
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
   (2^20 + 2.88M)-row shape, in turns with torch.unique(dim=0) of the
   stacked int64 (ticket, item) pairs; then TPC-DS q24, q84 and
   q84_all_cities
   (SF10, default layout, AQE on; store_returns and the demographics
   tables added) cold + warm against numpy/pyarrow: q84 must return 0
   rows and q24 at least 1; K13d must launch on q24, K13c on
   q84_all_cities; the plans of q24's 10-key K1 sorts (varying bits,
   words, digit passes) beside the packed key's bits;
10. the mortgage jobs: generate 1M loans (the generator's sf 1000, seed
   7; ~17.4M performance rows, ~1.7 GB of pipe-delimited text) into
   .bench_data/ (reused when there); K13i hex and K4p the percentile
   pick held exactly against their plain versions on 2^24 stress rows
   (every digit count, both signs, nulls; one giant segment, one-row
   and empty segments, NaN, +-inf, -0.0, q from 0 to 1) and at the
   path's shapes (one scan batch of loan-id hashes, after K9's hash mode
   is held against numpy's murmur3; every hash group's rates, ~17.4M rows
   in ~1M groups, 4 q's); one performance file's scan alone; then
   percentiles, agg_join and simple_agg through TorchSession(), each cold
   + warm against an independent numpy/pyarrow evaluation (its own
   murmur3 and hex, np.lexsort, the reference's Round): K13i, K4p and
   K9's hash mode must launch on percentiles, K13i, K9's hash mode and
   K6 on agg_join;
11. the scan's wire codec: K8a (fixed-width decode) and K8b (dictionary
   strings) held exactly against their plain versions on 2^24 stress rows
   a case (every bit bucket and output type, bases near the int64
   limits, both divisors and scales, nulls at validity word edges,
   all-null columns, dictionaries of widths 4 to 256), then on the first
   scan batch of q1's lineitem, of q6's store_sales (default layout) and
   of simple_agg's performance file as their scans encode them, against
   the plain versions and the raw upload; K8a timed as the batch's one
   launch (through decode_jobs, its C entry point alone and, where
   torch.profiler sees device work, its kernel alone), K8b a column;
   each beside its bound, its plain version's and (K8b) index_select's,
   and the copy to the card of the encoded against the raw buffer.  Every path above
   scans with the codec on (its default for batches of more than 1024
   rows): K8a must launch on every path, K8b on q1 and simple_agg;
12. range and round-robin exchanges and bounded-frame min/max: K11
   (range-partition ids) held exactly against its plain version on 2^24
   stress rows (int8, int16, int32, int64, doubles with NaN/+-0.0/+-inf,
   bools and strings at W 4 to 64, alone and in 2-3-key mixes, both
   directions and null orders, P of 2, 8, 200 and 1024; W 16 rows against
   W 64 bounds, three string keys too; ties on every key but the last; 40
   keys, whose descriptors leave the kernel's parameters; P 1024 with the
   bounds' fields in global memory; tied bounds; an empty batch) and at
   path 2's map batch, timed at two keys and one, through the wrapper and
   the kernel alone (torch.profiler: one kernel a call), beside
   torch.searchsorted over one packed limb; K12c (min/max over frames
   with a bounded lower edge) exactly against its plain version on the
   2^24-row window stress batch (min and max over int32, int64, f32, f64
   and bool, seven frames) and at moving_extrema's shape, timed beside
   max_pool1d; then, over the default layout at SF10, cold + warm against
   numpy/pyarrow: top_customers_rr (a keyless repartition(8) of all
   28.8M store_sales rows before a grouped count/max/sum: K10 once per
   map batch, round-robin partitions within one row of each other),
   range_sort_store_sales (a range exchange of all store_sales rows into
   8 partitions by date and net paid, each sorted; K11 once per map
   batch) and range_sort_customer_names (the 501,187 customers by three
   string keys into 200 partitions), both with
   spark.sql.adaptive.advisoryPartitionSizeInBytes pinned to 0 so that
   the map side is not coalesced, and moving_extrema (three moving
   min/max windows over ~4.2M (item, day) rows: K12c at least 3 times,
   K12b never);
13. the Generate exec: TPCx-BB's product_reviews at SF10 (85,380 reviews,
   .bench_data/tpcxbb_sf10_seed42) and store_baskets (one array row per
   store_sales ticket, ~9.1M, beside store_sales in the default layout),
   both reused when there; K14a (pieces per row) and K14b (the pieces of
   split strings) held exactly against their plain versions on 2^22-row
   stress batches (W 4 to 256; nulls, empty strings, rows of delimiters
   only, leading, trailing and consecutive delimiters, rows of length W,
   NULs and UTF-8 bytes; outer off and on; dense cases whose piece width
   W' is below W; an all-null batch, whose total is 0) and on
   review_words' scan batch, K14c (array elements) on 2^22-row arrays of
   int8, int32, int64, f32 and f64 (NaN, -0.0) and bool at W 1 to 64 and
   on one filtered basket batch, each timed at its path's batch beside
   its bound, its plain version and a library yardstick; GetArrayItem,
   ArrayContains and Size over a basket batch on the card against the
   CPU; then review_words (explode_split of the review text, grouped by
   word) and basket_items (the baskets of two or more items exploded,
   joined with item, grouped by category) cold + warm against Python's
   str.split and numpy: K14a and K14b once per review batch, K14c and K2
   once per basket batch, and K14 0 times over phases 3-12;
14. the last string kernels over the mortgage files of phase 10 (reused):
   K13e (trims), K13f (length), K13g (locate) and K13h (substring_index)
   held exactly against their plain versions on 2^22-row stress batches
   (W 4, 16, 64 and 256; spaces-only rows, commas, slashes, NULs, UTF-8
   bytes, lone continuation bytes, empty and null rows; all three trims,
   count in -3..2 over ',', space and NUL, literal needles (empty, wider
   than W) and needle columns with start in -1..W+2), at path A's first
   performance scan batch (4,194,304 reporting dates) and at path B's 1M
   seller names; K4s (string min/max) on 2^22-row stress batches (W 4, 16
   and 64; one segment, ~1000 and one-row segments) and at both paths'
   shapes (every performance row's period by loan, ~1M segments; the base
   names by state and form, ~66 segments); each timed beside its bound
   and its plain version; then loan_period_span (per loan the first and
   last reporting month as YYYY-MM, then per first month the loans and
   their last months) and seller_legal_forms (seller names cut at their
   commas, trimmed, measured and searched, per state and legal form)
   cold + warm against numpy and Python's str functions: K13h, K13c and
   K4s must launch on the first, K13e-h and K4s on the second, and K13e-h
   and K4s 0 times over phases 3-13;
15. the mesh shuffle over 8 virtual slots on the card
   (SRT_VIRTUAL_DEVICES=8, spark.rapids.tpu.mesh.deviceCount=8): K15a
   (pack a shard's columns into one send buffer of P sections) and K15b
   (front-pack P segments) held exactly against their plain versions on
   2^24-row exchanges (P 1, 2, 8 and 64; int8 to int64, dates, f32 and
   f64 with NaN, -0.0 and +-inf, bools, strings of W 4 to 256 differing
   between sources, nulls; empty sources, every row to one destination,
   a 0-row total; odd row counts a source, so unaligned heads and tails
   and spans under 16 bytes; a narrower string source beside equal ones)
   and K15b alone over all-gathers of shard slices (P 8 and 4096, whose
   span table leaves the kernel's parameters); then top_customers_mesh
   (MeshExchangeExec -> MeshAggregateExec -> MeshSortExec(limit 100)
   over all 28.8M
   store_sales rows), q6_mesh (replicated MeshJoinExecs, two
   MeshAggregateExecs, a TopN), q6_mesh_partitioned (every join
   partitioned: spark.rapids.tpu.mesh.join.buildThresholdBytes=0) and
   q22_mesh (a grand aggregate merged on slot 0, an anti MeshJoinExec, a
   MeshSortExec without a limit) cold + warm against the numpy/pyarrow
   evaluations of phases 6 and 8, each planning its Mesh nodes, with
   mesh_send_overflows 0; K15a and K15b exact and timed at
   top_customers_mesh's and q6_mesh_partitioned's largest shard and
   destination, in turns beside their plain versions and index_select /
   torch.cat (the best of two rounds), and their bounds, with each C
   entry point alone (K15b also the kernel alone where torch.profiler
   sees device work; phase 3 profiles one K15b call at
   top_customers_mesh's destination shape and K15a at both shard shapes:
   one kernel, no copy); K15a and K15b must launch on every mesh path
   and 0 times over phases 3-14;
16. print the kernel table as one JSON line (launches per path), the
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


def _device_ms(torch, fn, reps: int = 10):
    """The device time a call of ``fn`` (ms) for a call that runs each of
    its kernels and copies once: the sum of their mean times under
    torch.profiler over ``reps`` warm calls (a mean, so a launch the
    tracer misses at the window's start does not count); None where the
    profiler saw no device work (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total / e.count
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count)
    return total / 1e3 if total > 0 else None


def _profiled_rows(torch, fn, reps: int) -> list:
    """(kernel or copy name, launches, device us) of every device
    activity torch.profiler saw over ``reps`` + 1 warm calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps + 1):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


#: profiles of one call shape tried before the tracer is taken to have
#: lost launches (it has dropped records part way through a run: fewer
#: launches of the expected kernels than calls, and nothing else)
_PROFILE_TRIES = 3


def _lost_or_raise(label: str, shortfalls: list, missing: set) -> None:
    """After :data:`_PROFILE_TRIES` short profiles: raises where the
    shortfall is the wrapper's, not the tracer's: an expected kernel absent
    from every try (``missing``), or the same launch counts in every try
    (``shortfalls``); else says the kernels alone were not measured."""
    if missing:
        raise AssertionError(f"{label}: no {missing} launch in any of "
                             f"{_PROFILE_TRIES} profiles: {shortfalls}")
    if len(set(shortfalls)) == 1:
        raise AssertionError(f"{label}: the same launches short in every "
                             f"one of {_PROFILE_TRIES} profiles: "
                             f"{shortfalls[0]}")
    print(f"[{label}] the kernels alone not measured (the profiler lost "
          f"launches, differently in each try: {shortfalls})", flush=True)


def _one_kernel_ms(torch, label: str, fn, needle: str, reps: int = 10):
    """The device time of ``fn``'s one kernel a call (ms), from
    torch.profiler over ``reps`` warm calls; raises if a call ran any other
    device work (a copy, a memset, another kernel) or more than one launch
    of the kernel whose name holds ``needle``, or fewer launches than calls
    the same way in each of :data:`_PROFILE_TRIES` tries.  None where the
    profiler saw no device work at all, or fewer launches than calls,
    differently in each try (lost records: not measured)."""
    shortfalls = []
    for _ in range(_PROFILE_TRIES):
        # one call more than counted: the tracer may miss the window's
        # first launch, so it must see reps or reps + 1 launches
        rows = _profiled_rows(torch, fn, reps)
        if not rows:
            print(f"[{label}] torch.profiler saw no device work: the kernel "
                  "alone not measured", flush=True)
            return None
        if len(rows) != 1 or needle not in rows[0][0] \
                or rows[0][1] > reps + 1:
            raise AssertionError(f"{label}: {reps + 1} calls ran {rows}, "
                                 f"not one {needle} launch each")
        if rows[0][1] >= reps:
            return rows[0][2] / rows[0][1] / 1e3
        print(f"[{label}] torch.profiler saw {rows[0][1]} {needle} launches "
              f"of {reps + 1} calls: profiled again", flush=True)
        shortfalls.append(rows[0][1])
    _lost_or_raise(label, shortfalls, set())
    return None


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

#: K2's kernels a call (csrc/compact.cu), beside one host read of the
#: kept row count
_K2_KERNELS = {"count_kernel": 1, "copy_kernel": 1}


def _compact_entry(torch, batch, keep):
    """K2's two C entry points alone, with the host read between them, on
    outputs and a table prepared once: returns ``(run, outs)``."""
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.ops import native
    lib = native.lib("compact")
    dev, n = keep.device, batch.num_rows
    nt = K.num_tiles(n)
    stream = native.stream_ptr(dev)
    srcs = [K._contig(c) for c in batch.columns]
    outs = [K._empty_like_rows(c, int(keep.sum())) for c in srcs]
    offsets = torch.empty(nt + 1, dtype=torch.int32, device=dev)
    rows = torch.empty(nt * K.TILE, dtype=torch.int16, device=dev)
    status = native.lookback_status(K._STATUS, dev, stream, nt)
    words = K.gather_table(srcs, outs)
    host, tab = native.param_table(words, len(words) > K.COMPACT_PARAM_WORDS,
                                   dev)
    count = (keep.data_ptr(), n, offsets.data_ptr(), rows.data_ptr(),
             status.data_ptr(), stream)
    copy = (host.buffer_info()[0], len(words), len(srcs), K.ptr(tab),
            rows.data_ptr(), n, offsets.data_ptr(), stream)

    def run(_keep=(host, tab, srcs, outs, offsets, rows, status)):
        native.check(lib.srt_compact_count(*count), "srt_compact_count")
        int(offsets[nt].item())
        native.check(lib.srt_compact_copy(*copy), "srt_compact_copy")
    return run, outs


def _time_compact(torch, label: str, batch, keep) -> dict:
    """K2 at one shape: held to its plain version, then through the
    wrapper in turns with the plain version and mask indexing of every
    leaf (the best of two rounds), its C entry points alone (with the host
    read) and its kernels alone (torch.profiler: one count_kernel and one
    copy_kernel a call, one copy to the host, nothing else)."""
    from spark_rapids_tpu_torch.ops import kernels as K
    got = K.compact(batch, keep)
    want = K.compact_plain(batch, keep)
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{label}: row counts differ")
    _assert_equal_cols(torch, got.columns, want.columns, label)
    run, outs = _compact_entry(torch, batch, keep)
    run()
    _assert_equal_cols(torch, outs, got.columns, f"{label} C entry")
    leaves = _leaves(batch.columns)
    t = _in_turns(torch, {
        "ms": lambda: K.compact(batch, keep),
        "plain_ms": lambda: K.compact_plain(batch, keep),
        "library_ms": lambda: [x[keep] for x in leaves]})
    t["entry_ms"] = _time_ms(torch, run, reps=20)
    saved = K.compact.launches
    kern = _kernels_ms(torch, label, lambda: K.compact(batch, keep),
                       _K2_KERNELS)
    K.compact.launches = saved
    t["kernels"] = kern
    t["kernel_ms"] = None if kern is None else sum(
        kern[k] for k in _K2_KERNELS)
    t["bytes"] = _nbytes(leaves) + keep.numel() + _nbytes(
        _leaves(got.columns))
    t["kept"] = got.num_rows
    km = "not measured" if kern is None else (
        f"{t['kernel_ms']:.4f} ({_fmt_kernels(kern)})")
    print(f"[{label}] rows={batch.num_rows} x {batch.num_columns} columns "
          f"kept={got.num_rows}: ms={t['ms']:.4f} (the C entry points alone "
          f"{t['entry_ms']:.4f}, the kernels alone {km}) plain_ms="
          f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} (mask "
          f"indexing of every leaf) bound_ms={_bound_ms(t['bytes']):.4f} "
          f"({t['bytes']} bytes); in turns, the best of two rounds",
          flush=True)
    return t


def check_compact(torch, dev, rng) -> dict:
    """Checked at 2^22 rows and at the main path's scan batch (one parquet
    row group, 2^20 rows x q1's 7 columns), timed at the latter under q1's
    filter (~98% kept) and under a selective keep (~3%, q6-like)."""
    from spark_rapids_tpu_torch.ops import kernels as K
    for n in (1 << 22, 1 << 20):
        batch = _batch(torch, _q1_host_columns(rng, n), dev, null_every=97)
        keep = batch.columns[6].data <= 10471  # 1998-09-02, q1's filter
        got = K.compact(batch, keep)
        want = K.compact_plain(batch, keep)
        if got.num_rows != want.num_rows:
            raise AssertionError("compact: row counts differ")
        _assert_equal_cols(torch, got.columns, want.columns, "compact")
    q1 = _time_compact(torch, "K2 compact q1", batch, keep)
    sel = torch.from_numpy(rng.random(n) < 0.03).to(dev)
    few = _time_compact(torch, "K2 compact 3%", batch, sel)
    return dict(name="compact", route="cuda",
                source="spark_rapids_tpu_torch/csrc/compact.cu",
                replaces="spark_rapids_tpu/ops/kernels.py:62",
                max_abs_err=0.0, ms=q1["ms"], plain_ms=q1["plain_ms"],
                bound_ms=_bound_ms(q1["bytes"]), bound_by="bytes",
                library_ms=q1["library_ms"], kernel_ms=q1["kernel_ms"],
                entry_ms=q1["entry_ms"], k2_kernels=q1["kernels"],
                k2_kept=q1["kept"], k2_sel_ms=few["ms"],
                k2_sel_entry_ms=few["entry_ms"],
                k2_sel_kernel_ms=few["kernel_ms"],
                k2_sel_plain_ms=few["plain_ms"],
                k2_sel_library_ms=few["library_ms"],
                k2_sel_bound_ms=_bound_ms(few["bytes"]),
                k2_sel_kept=few["kept"])


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


class _K1Plans:
    """Records the plan of every K1 sort while it is open (the wrapper's
    ``sort_plan`` calls; ``pack_keys``' full plans are not recorded): a
    list of (keys, plan)."""

    def __enter__(self):
        from spark_rapids_tpu_torch.ops import sort as S
        self._mod, self._real = S, S.sort_plan
        self.plans = []

        def spy(field_bits, masks, wide=None):
            plan = self._real(field_bits, masks, wide)
            if wide is None:
                self.plans.append((len(field_bits), plan))
            return plan
        S.sort_plan = spy
        return self

    def __exit__(self, *exc):
        self._mod.sort_plan = self._real
        return False


def _kernels_ms(torch, label: str, fn, expect: dict, reps: int = 10):
    """The device time of a call of ``fn`` by kernel (ms), from
    torch.profiler over ``reps`` warm calls; raises unless each call ran
    exactly the kernels of ``expect`` ({name needle: launches a call}),
    at most one copy to the host (a wrapper's host read) and no other
    device work (a memset, another kernel).  Where an expected kernel is
    absent or short of its launches, profiles again, up to
    :data:`_PROFILE_TRIES` tries: raises if one is absent from every try
    or every try is short the same way, else gives None (lost records:
    not measured).  None too where the profiler saw no device work."""
    shortfalls, missing = [], set(expect)
    for _ in range(_PROFILE_TRIES):
        # one call more than counted: the tracer may miss the window's
        # first launches, so it must see reps or reps + 1 calls' worth
        rows = _profiled_rows(torch, fn, reps)
        if not rows:
            print(f"[{label}] torch.profiler saw no device work: the "
                  "kernels alone not measured", flush=True)
            return None
        out, counts = {}, dict.fromkeys(expect, 0)
        for key, count, us in rows:
            needle = next((k for k in expect if k in key), None)
            if needle is None and "Memcpy DtoH" in key \
                    and count <= reps + 1:
                out["host_read"] = us / count / 1e3
                continue
            if needle is None:
                raise AssertionError(f"{label}: {reps + 1} calls ran "
                                     f"{rows}, not {expect} a call")
            counts[needle] += count
            out[needle] = out.get(needle, 0.0) + us / 1e3
        if any(c > expect[k] * (reps + 1) for k, c in counts.items()):
            raise AssertionError(f"{label}: {reps + 1} calls ran {rows}, "
                                 f"not {expect} a call")
        missing &= {k for k, c in counts.items() if not c}
        if all(c >= expect[k] * reps for k, c in counts.items()):
            for k, c in counts.items():
                out[k] /= c / expect[k]
            return out
        print(f"[{label}] torch.profiler saw {rows}, short of {expect} a "
              f"call over {reps + 1} calls: profiled again", flush=True)
        shortfalls.append(tuple(sorted(counts.items())))
    _lost_or_raise(label, shortfalls, missing)
    return None


def _k1_leaves(batch, orders, plan) -> tuple:
    """(every key leaf's bytes, the bytes of the leaves the plan's
    segments read): the plan kernel reads every field, the encode only
    those that vary."""
    from spark_rapids_tpu_torch.ops import sort as S
    every = touched = 0
    for k, o in enumerate(orders):
        c = batch.columns[o.child_index]
        leaves = {"valid": c.validity, "data": c.data, "lens": c.lengths}
        kind = S.key_layout(c, S.packed_width(c) if c.is_string
                            else None)[0]
        nf = len(S.key_field_bits(kind, S.packed_width(c) if c.is_string
                                  else 1))
        used = set()
        for kk, f, *_r in plan.segments:
            if kk == k:
                used.add("valid" if f == 0 else
                         "lens" if c.is_string and f == nf - 1 else "data")
        for name, t in leaves.items():
            if t is not None:
                b = t.numel() * t.element_size()
                every += b
                touched += b if name in used else 0
    return every, touched


def _k1_design_bytes(batch, orders, plan) -> int:
    """The bytes K1's kernels move for one call with this plan: the key
    leaves read by the plan kernel and (those that vary) by the encode,
    the words written once and read by their upsweeps, the look-back
    state zeroed, and each pass's keys and row indices read and written
    (a later word's first pass reads its keys through the permutation)."""
    from spark_rapids_tpu_torch.ops import sort as S
    n = batch.num_rows
    every, touched = _k1_leaves(batch, orders, plan)
    kb = 8 if plan.wide else 4
    total = every + touched + 2 * kb * n * len(plan.words)
    ntiles = -(-n // S.SORT_TILE)
    for w, passes in enumerate(plan.passes):
        total += len(passes) * ntiles * 256 * 4
        for i in range(len(passes)):
            reads = kb * n + (4 * n if (w, i) != (0, 0) else 0)
            writes = 4 * n + (kb * n if i + 1 < len(passes) else 0)
            total += reads + writes
    return total


def _k1_entry(torch, cols, orders, drop=(), extra: int = 0):
    """K1's C entry points on arguments prepared once (the wrapper's
    Python apart), as ``sort.sort_words`` calls them: the plan kernel,
    the host read of its partials, the encode (which also zeroes
    ``extra`` int32 after the histograms) and each word's sort (with
    ``extra``, the last word's last pass also writes it in sorted order,
    as K6 asks).  Returns ``(run, plan, ors)``: ``run()`` makes those
    calls with the plan derived here (the fields of ``drop`` kept out)
    and returns ``(perm, words, top, extra address)``."""
    import ctypes
    from array import array
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops import sort as S
    lib = native.lib("sort")
    dev, n = cols[0].device, cols[0].capacity
    stream = native.stream_ptr(dev)
    words, field_bits, keep = S._key_descriptors(cols, orders)
    host, keys_dev = native.param_table(words, len(cols) > S.PARAM_KEYS,
                                        dev)
    nfields = sum(map(len, field_bits))
    ntiles = -(-n // S.SORT_TILE)
    grid = min(S.PLAN_BLOCKS, ntiles)
    partials = torch.empty((2 * nfields, grid), dtype=torch.int64,
                           device=dev)
    plan_args = (host.buffer_info()[0], S.ptr(keys_dev), len(cols),
                 nfields, n, partials.data_ptr(), grid, stream)
    native.check(lib.srt_sort_plan(*plan_args), "srt_sort_plan")
    part = partials.cpu().numpy().view(np.uint64)
    masks = S.varying_masks(part, field_bits)
    for k, f in drop:
        masks[k][f] = 0
    plan = S.sort_plan(field_bits, masks)
    ors = S.field_ors(part, field_bits)
    segs = S.segment_words(plan)
    seg_host = array("q", segs)
    if len(segs) > S.LARGE_SEGS or len(cols) > S.PARAM_KEYS or \
            not plan.bits:
        raise AssertionError("K1's timed tables do not fit the parameters")
    nw = len(plan.words)
    kdt = torch.int64 if plan.wide else torch.int32
    passes = max(len(p) for p in plan.passes)
    hw = S.MAX_PASSES * 256
    nzero = nw * hw + extra
    scratch = torch.empty(nzero + hw + S.MAX_PASSES
                          + passes * ntiles * 256, dtype=torch.int32,
                          device=dev)
    enc = torch.empty((nw, n), dtype=kdt, device=dev)
    top = torch.empty(n, dtype=kdt, device=dev) if extra else None
    keys_ab = torch.empty((2, n), dtype=kdt, device=dev)
    vals = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    base = scratch.data_ptr() + 4 * nzero
    tickets = base + 4 * hw
    status = tickets + 4 * S.MAX_PASSES
    encode_args = (host.buffer_info()[0], None, len(cols),
                   seg_host.buffer_info()[0], None, len(segs),
                   int(plan.wide), n, enc.data_ptr(), scratch.data_ptr(),
                   nzero, stream)
    where = ctypes.c_int(-1)

    # the tables and the tensors they point to live as long as run
    def run(_keep=(keep, host, keys_dev, seg_host)):
        lib.srt_sort_plan(*plan_args)
        partials.cpu()
        lib.srt_sort_encode(*encode_args)
        cur = None
        for w, bits in enumerate(plan.words):
            a, b = [i for i in range(3) if i != cur][:2]
            lib.srt_sort_word(
                enc[w].data_ptr(), enc.element_size(), bits,
                None if cur is None else vals[cur].data_ptr(), n,
                keys_ab[0].data_ptr(), keys_ab[1].data_ptr(),
                vals[a].data_ptr(), vals[b].data_ptr(),
                scratch.data_ptr() + 4 * w * hw, base, status, tickets,
                None if top is None or w + 1 < nw else top.data_ptr(),
                ctypes.byref(where), stream)
            cur = a if where.value == 0 else b
        return vals[cur], enc, top, scratch.data_ptr() + 4 * nw * hw

    return run, plan, ors


def _k1_entry_ms(torch, batch, orders) -> float:
    """K1's C entry points alone on a batch (:func:`_k1_entry`), held to
    the plain version first."""
    from spark_rapids_tpu_torch.ops import sort as S
    run, _plan, _ors = _k1_entry(torch, [batch.columns[o.child_index]
                                         for o in orders], orders)
    if not torch.equal(run()[0], S.sort_permutation_plain(batch, orders)):
        raise AssertionError("K1's C entry points alone differ from the "
                             "plain version")
    return _time_ms(torch, lambda: run(), reps=20)


def _k1_profile(torch, label: str, batch, orders, plan) -> dict:
    """K1's kernels alone on a batch: the kernels one call must run (one
    plan, one encode, an upsweep and a scan a word, a scatter a digit; no
    memset) and their device ms."""
    from spark_rapids_tpu_torch.ops import sort as S
    expect = {"plan_kernel": 1, "encode_kernel": 1,
              "upsweep_kernel": len(plan.words),
              "scan_kernel": len(plan.words),
              "scatter_kernel": sum(len(p) for p in plan.passes)}
    saved = S.sort_permutation.launches
    ms = _kernels_ms(torch, label, lambda: S.sort_permutation(batch, orders),
                     expect)
    S.sort_permutation.launches = saved
    return ms


def _fmt_kernels(ms) -> str:
    if ms is None:
        return "not measured by torch.profiler"
    return ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + \
        f"; kernels {sum(v for k, v in ms.items() if k != 'host_read'):.4f}"


def _fmt_plan(plan) -> str:
    return (f"{plan.bits} varying bits in {len(plan.words)} "
            f"{'64' if plan.wide else '32'}-bit word(s) {list(plan.words)}, "
            f"{sum(len(p) for p in plan.passes)} digit pass(es)")


def check_sort(torch, dev, rng, q1_batch) -> dict:
    """K1 exactly against its plain version at q1's keys (2^24 rows) and
    at mixed 2^22-row keys (two orders); timed in turns beside the plain
    version and torch.argsort of the packed key (best of two rounds),
    its C entry points alone and its kernels alone (torch.profiler: the
    kernels a call must run and nothing else), each with the plan the
    wrapper derived."""
    from spark_rapids_tpu_torch.ops import sort as S
    orders = [S.SortOrder(0, True, True), S.SortOrder(1, True, True)]
    n = q1_batch.num_rows
    with _K1Plans() as rec:
        got = S.sort_permutation(q1_batch, orders)
    (_k, plan), = rec.plans
    want = S.sort_permutation_plain(q1_batch, orders)
    if not torch.equal(got, want):
        raise AssertionError("sort: permutation differs (q1 keys)")
    mixed = _mixed_batch(torch, rng, 1 << 22, dev)
    mixed_orders = ([S.SortOrder(1, True, None), S.SortOrder(3, False, None),
                     S.SortOrder(0, True, False)],
                    [S.SortOrder(3, True, False), S.SortOrder(2, False, True),
                     S.SortOrder(1, False, True)])
    mixed_plans = []
    for mo in mixed_orders:
        with _K1Plans() as mrec:
            mgot = S.sort_permutation(mixed, mo)
        mixed_plans.append(mrec.plans[0][1])
        if not torch.equal(mgot, S.sort_permutation_plain(mixed, mo)):
            raise AssertionError(f"sort: permutation differs (mixed {mo})")
    del mgot
    w1 = q1_batch.columns[0].data[:, 0].to(torch.int64)
    w2 = q1_batch.columns[1].data[:, 0].to(torch.int64)
    packed = (w1 << 8) | w2

    def kernel():
        return S.sort_permutation(q1_batch, orders)

    def plain():
        return S.sort_permutation_plain(q1_batch, orders)

    def library():
        return torch.argsort(packed, stable=True)
    # in turns: kernel, plain, library, then again; the best of two
    times = {kernel: [], plain: [], library: []}
    for _ in range(2):
        for fn in times:
            times[fn].append(_time_ms(torch, fn))
    ms, plain_ms, lib_ms = (min(times[f]) for f in (kernel, plain, library))
    entry_ms = _k1_entry_ms(torch, q1_batch, orders)
    kern = _k1_profile(torch, "K1 q1 keys", q1_batch, orders, plan)
    mixed_ms, mixed_plain, mixed_entry, mixed_kern = [], [], [], []
    for mo, mp in zip(mixed_orders, mixed_plans):
        t = {"k": [], "p": []}
        for _ in range(2):
            t["k"].append(_time_ms(torch, lambda: S.sort_permutation(mixed,
                                                                     mo)))
            t["p"].append(_time_ms(torch, lambda: S.sort_permutation_plain(
                mixed, mo)))
        mixed_ms.append(min(t["k"]))
        mixed_plain.append(min(t["p"]))
        mixed_entry.append(_k1_entry_ms(torch, mixed, mo))
        mixed_kern.append(_k1_profile(torch, f"K1 mixed {len(mo)} keys",
                                      mixed, mo, mp))
    nbytes = _nbytes(_leaves(q1_batch.columns[:2])) + 4 * n
    design = _k1_design_bytes(q1_batch, orders, plan)
    kernels_ms = None if kern is None else \
        sum(v for k, v in kern.items() if k != "host_read")
    print(f"[K1 sort] rows={n} (q1's keys): {_fmt_plan(plan)}; ms={ms:.4f} "
          f"(the C entry points alone {entry_ms:.4f}; kernels alone: "
          f"{_fmt_kernels(kern)}) plain_ms={plain_ms:.4f} library_ms="
          f"{lib_ms:.4f} (argsort(stable=True) of the packed key) "
          f"bound_ms={_bound_ms(nbytes):.4f} ({nbytes} bytes: the two keys' "
          f"leaves and the permutation); the design moves {design} bytes "
          f"({_bound_ms(design):.4f} ms at the card's rate); the best of "
          f"two rounds in turns", flush=True)
    for mo, mp, a, b, c, k in zip(mixed_orders, mixed_plans, mixed_ms,
                                  mixed_plain, mixed_entry, mixed_kern):
        md = _k1_design_bytes(mixed, mo, mp)
        npass = sum(len(x) for x in mp.passes)
        per_pass = "not measured" if k is None else \
            f"{k['scatter_kernel'] / npass:.4f}"
        print(f"[K1 sort] mixed int64/f64/int32/W16-string keys, "
              f"{mixed.num_rows} rows, orders "
              f"{[(o.child_index, o.ascending, o.nulls_first) for o in mo]}:"
              f" {_fmt_plan(mp)}; ms={a:.4f} (C entry points {c:.4f}; "
              f"kernels alone: {_fmt_kernels(k)}; a scatter pass "
              f"{per_pass}) plain_ms={b:.4f}; the design moves {md} bytes "
              f"({_bound_ms(md):.4f} ms); equal to the plain version",
              flush=True)
    return dict(name="sort_permutation", route="cuda",
                source="spark_rapids_tpu_torch/csrc/sort.cu",
                replaces="spark_rapids_tpu/ops/sort.py:105",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms, kernel_ms=kernels_ms, entry_ms=entry_ms,
                k1_kernels_ms=kern, k1_varying_bits=plan.bits,
                k1_digit_passes=sum(len(p) for p in plan.passes),
                k1_design_bytes=design, k1_mixed_ms=mixed_ms,
                k1_mixed_plain_ms=mixed_plain,
                k1_mixed_entry_ms=mixed_entry,
                k1_mixed_varying_bits=[p.bits for p in mixed_plans],
                k1_mixed_digit_passes=[sum(len(x) for x in p.passes)
                                       for p in mixed_plans]), got


def _in_turns(torch, fns: dict, reps: int = 5) -> dict:
    """{name: ms}: each function timed in turns with the others, twice,
    the best of the two rounds."""
    times = {k: [] for k in fns}
    for _ in range(2):
        for k, fn in fns.items():
            times[k].append(_time_ms(torch, fn, reps=reps))
    return {k: min(v) for k, v in times.items()}


def _gather_sectors(torch, perm, cols) -> tuple:
    """The source bytes that ``perm`` touches: (the bytes of the distinct
    rows it reads, each once, which is what the function must read; the
    32-byte sectors of the source leaves holding them, each once, however
    often it is read; a sector once per run of output rows that read it in
    turn, which is what the gather reads from memory where no sector stays
    in L2 between runs)."""
    idx = perm.long()
    idx = idx[idx >= 0]
    rows = torch.unique(idx).numel()
    touched = rows * sum(c.row_bytes + c.validity.element_size() + (
        0 if c.lengths is None else c.lengths.element_size()) for c in cols)
    once = runs = 0
    for c in cols:
        for t, item in ((c.data, c.row_bytes), (c.validity, 1),
                        (c.lengths, 4)):
            if t is None:
                continue
            first = idx * item // 32
            last = (idx * item + item - 1) // 32
            span = int((last - first).max()) + 1 if idx.numel() else 0
            sectors = torch.cat([first + k for k in range(span)]) \
                if span > 1 else first
            once += 32 * torch.unique(sectors).numel()
            runs += 32 * span * (1 + int((first[1:] != first[:-1]).sum()))
    return touched, once, runs


def _gather_entry(torch, cols, perm):
    """K3's C entry point alone on a table prepared once (the outputs
    allocated once): returns ``(run, outs)``."""
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.ops import native
    lib = native.lib("gather")
    outs = [K._empty_like_rows(c, perm.numel()) for c in cols]
    words = K.gather_table(cols, outs)
    host, tab = native.param_table(
        words, len(words) > K.GATHER_PARAM_WORDS, perm.device)
    args = (host.buffer_info()[0], len(words), len(cols), K.ptr(tab),
            perm.data_ptr(), perm.numel(), native.stream_ptr(perm.device))

    def run(_keep=(host, tab)):
        native.check(lib.srt_gather(*args), "srt_gather")
    return run, outs


def _time_gather(torch, label: str, cols, perm, reps: int = 5) -> dict:
    """K3 at one shape: held to its plain version, then through the
    wrapper in turns with the plain version and ``index_select`` of every
    leaf (best of two rounds), its C entry point alone and its kernel
    alone (torch.profiler: one gather_kernel a call, nothing else)."""
    from spark_rapids_tpu_torch.ops import kernels as K
    got = K.gather_columns(cols, perm)
    _assert_equal_cols(torch, got, K.gather_plain(cols, perm), label)
    run, outs = _gather_entry(torch, cols, perm)
    run()
    _assert_equal_cols(torch, outs, got, f"{label} C entry")
    idx = perm.long()
    leaves = _leaves(cols)
    t = _in_turns(torch, {
        "ms": lambda: K.gather_columns(cols, perm),
        "plain_ms": lambda: K.gather_plain(cols, perm),
        "library_ms": lambda: [x.index_select(0, idx) for x in leaves]},
        reps=reps)
    t["entry_ms"] = _time_ms(torch, run, reps=20)
    saved = K.gather_columns.launches
    t["kernel_ms"] = _one_kernel_ms(
        torch, label, lambda: K.gather_columns(cols, perm), "gather_kernel")
    K.gather_columns.launches = saved
    # the bound's bytes: the index, each source row it reads once (every
    # leaf whole where the index reads every row, as a sort permutation
    # does), the outputs
    touched, t["sector_once"], t["sector_runs"] = _gather_sectors(
        torch, perm, cols)
    t["bytes"] = 4 * perm.numel() + touched + _nbytes(_leaves(got))
    t["design"] = 4 * perm.numel() + _nbytes(_leaves(got)) + t["sector_runs"]
    km = "not measured" if t["kernel_ms"] is None \
        else f"{t['kernel_ms']:.4f}"
    print(f"[{label}] rows={perm.numel()} x {len(cols)} columns: "
          f"ms={t['ms']:.4f} (the C entry alone {t['entry_ms']:.4f}, the "
          f"kernel alone {km}) plain_ms={t['plain_ms']:.4f} library_ms="
          f"{t['library_ms']:.4f} (index_select of every leaf) bound_ms="
          f"{_bound_ms(t['bytes']):.4f} ({t['bytes']} bytes: the index, "
          f"each source row it reads once, the outputs); source sectors "
          f"the permutation touches: {t['sector_once']} bytes once each, "
          f"{t['sector_runs']} bytes read a run at a time; the design "
          f"moves {t['design']} bytes ({_bound_ms(t['design']):.4f} ms); "
          f"in turns, the best of two rounds", flush=True)
    return t, got


def check_gather(torch, dev, q1_batch, perm) -> dict:
    """K3 at q1's shape (2^24 rows x its 6 columns under its sort
    permutation) and at a small call of q6's join-output shape (14,524 of
    2^20 rows x 6 int32 columns, in stream order, the shape most of K3's
    launches take)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    cols = list(q1_batch.columns[:6])
    t, got = _time_gather(torch, "K3 gather", cols, perm)
    rng = np.random.default_rng(6)
    ns = 1 << 20
    small = [DeviceColumn(torch.from_numpy(np.where(
        v, rng.integers(0, 1 << 20, ns), 0).astype(np.int32)).to(dev),
        torch.from_numpy(v).to(dev), T.IntegerType())
        for v in (rng.random(ns) >= 0.02 for _ in range(6))]
    rows = np.sort(rng.choice(ns, 14_524, replace=False)).astype(np.int32)
    q6, _small_got = _time_gather(torch, "K3 gather q6 join output", small,
                                  torch.from_numpy(rows).to(dev), reps=50)
    return dict(name="gather_columns", route="cuda",
                source="spark_rapids_tpu_torch/csrc/gather.cu",
                replaces="spark_rapids_tpu/ops/kernels.py:42",
                max_abs_err=0.0, ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=_bound_ms(t["bytes"]), bound_by="bytes",
                library_ms=t["library_ms"], kernel_ms=t["kernel_ms"],
                entry_ms=t["entry_ms"], k3_sector_once_bytes=t["sector_once"],
                k3_sector_run_bytes=t["sector_runs"],
                k3_design_bytes=t["design"],
                k3_q6_ms=q6["ms"], k3_q6_entry_ms=q6["entry_ms"],
                k3_q6_kernel_ms=q6["kernel_ms"],
                k3_q6_library_ms=q6["library_ms"],
                k3_q6_bound_ms=_bound_ms(q6["bytes"])), got


#: K4's kernels a call (three launches of csrc/segmented.cu and K3's gather
#: of the keys, beside one host read of the group count)
_K4_KERNELS = {"bounds_kernel": 1, "agg_tile_kernel": 1,
               "agg_combine_kernel": 1, "gather_kernel": 1}
#: q1's update specs over (flag, status, qty, price, disc, tax): the 11 the
#: q1 update runs, then the ones checked besides
_Q1_SPECS = [("sum", 2), ("sum", 3), ("sum", 4), ("sum", 5), ("sum", 2),
             ("count", 2), ("sum", 3), ("count", 3), ("sum", 4),
             ("count", 4), ("count_star", 0), ("min", 5), ("max", 3),
             ("first", 4), ("last_non_null", 2), ("avg", 3)]
_Q1_TIMED = 11
#: rows of K4's many-groups shape, in about a quarter as many groups
K4_MANY_ROWS = 1 << 22
#: rows of phase 3's synthetic q1 lineitem batch (K8a's profile)
K8A_PROFILE_ROWS = 1 << 20
#: K8a's kernel alone at phase 3's synthetic q1 batch (profile_decode), the
#: reading phase 11 reports where its own profile sees no device work
PHASE3_K8A: dict = {}


def _k4_entry(torch, sb, keys, specs):
    """K4's three C entry points alone, every table, scratch and output
    prepared once: the boundary pass, the host read of G and S, the tile
    and the combine launch.  Returns (run, the outputs' views, plan)."""
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops import segmented as G
    from spark_rapids_tpu_torch.ops.kernels import num_tiles, ptr
    lib = native.lib("segmented")
    dev, n = sb.device, sb.num_rows
    nt = num_tiles(n)
    stream = native.stream_ptr(dev)
    kwords = G.key_table([sb.columns[k] for k in keys])
    khost, ktab = native.param_table(kwords, len(kwords) > G.KEY_PARAM_WORDS,
                                     dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    offs = torch.empty(nt + 2, dtype=torch.int32, device=dev)
    spans = torch.empty(nt, dtype=torch.int32, device=dev)
    status = G._status(dev, stream, nt)
    bounds = (khost.buffer_info()[0], len(kwords), len(keys), ptr(ktab), 1,
              ptr(flags), ptr(offs), ptr(spans), ptr(status), n, stream)
    native.check(lib.srt_seg_bounds(*bounds), "srt_seg_bounds")
    g, nspans = offs[nt:].tolist()
    plan = G.agg_plan(sb, specs)
    views = G.agg_outputs(plan, g, dev)
    words = G.agg_table(sb, plan, views)
    host, tab = native.param_table(words, len(words) > G.AGG_PARAM_WORDS,
                                   dev)
    starts = torch.empty(g, dtype=torch.int32, device=dev)
    slots = torch.empty(len(plan.jobs) * 4 * nt, dtype=torch.int64,
                        device=dev)
    head = (host.buffer_info()[0], len(words), len(plan.cols),
            len(plan.jobs), len(plan.outs), ptr(tab))
    tiles = head + (ptr(flags), ptr(offs), ptr(starts), ptr(slots), n, g,
                    stream)
    combine = head + (ptr(offs), ptr(spans), nspans, ptr(starts), ptr(slots),
                      n, g, G.combine_threads(nt, nspans), stream)

    def run(_keep=(khost, ktab, host, tab, flags, spans, status, starts,
                   slots)):
        native.check(lib.srt_seg_bounds(*bounds), "srt_seg_bounds")
        offs[nt:].tolist()  # the wrapper's one host read
        native.check(lib.srt_seg_agg_tiles(*tiles), "srt_seg_agg_tiles")
        native.check(lib.srt_seg_agg_combine(*combine),
                     "srt_seg_agg_combine")
    return run, views, plan


def _k4_check(torch, label, sb, keys, specs) -> float:
    """K4 against its plain version: keys and integers exact, doubles
    within F64_RTOL, validity exact, double sums with the same bits on a
    second call; returns the largest double difference."""
    from spark_rapids_tpu_torch.ops import segmented as G
    gk, ga, g = G.segment_aggregate(sb, keys, specs)
    again = G.segment_aggregate(sb, keys, specs)[1]
    wk, wa, wg = G.segment_aggregate_plain(sb, keys, specs)
    if g != wg:
        raise AssertionError(f"{label}: {g} groups vs {wg}")
    _assert_equal_cols(torch, gk, wk, f"{label} keys")
    err = 0.0
    for spec, a, b, c in zip(specs, ga, wa, again):
        if not torch.equal(a.validity, b.validity):
            raise AssertionError(f"{label} {spec}: validity differs")
        if a.data.dtype == torch.float64:
            diff = (a.data - b.data).abs()
            err = max(err, float(diff.max()))
            tol = F64_RTOL * b.data.abs() + 1e-300
            if bool((diff > tol).any()):
                raise AssertionError(f"{label} {spec}: beyond rtol "
                                     f"{F64_RTOL}")
            if not torch.equal(a.data.view(torch.int64),
                               c.data.view(torch.int64)):
                raise AssertionError(f"{label} {spec}: another run gave "
                                     "other bits")
        elif not torch.equal(a.data, b.data):
            raise AssertionError(f"{label} {spec}: differs")
    return err


def _time_k4(torch, label: str, sb, keys, specs, lengths,
             reps: int = 5) -> dict:
    """K4 at one shape: checked, then through the wrapper in turns with
    its plain version, the C entry points alone, the kernels alone
    (torch.profiler: the three K4 kernels and K3's key gather a call, one
    host read, nothing else), and the yardsticks: torch.segment_reduce
    once a distinct summed or counted input (null slots are zero, so the
    data sum directly; count_star is the lengths themselves) and
    index_add_ once a spec by segment id."""
    from spark_rapids_tpu_torch.ops import segmented as G
    t = {"err": _k4_check(torch, label, sb, keys, specs)}
    timed = specs[:_Q1_TIMED]
    run, views, plan = _k4_entry(torch, sb, keys, timed)
    run()
    gk, ga, g = G.segment_aggregate(sb, keys, timed)
    for o, a in zip(plan.spec_out, ga):
        if o is not None and not torch.equal(views[o][0], a.data):
            raise AssertionError(f"{label}: the C entry points differ from "
                                 "the wrapper")
    t.update(_in_turns(torch, {
        "ms": lambda: G.segment_aggregate(sb, keys, timed),
        "plain_ms": lambda: G.segment_aggregate_plain(sb, keys, timed)},
        reps=reps))
    t["entry_ms"] = _time_ms(torch, run, reps=20)
    kern = _kernels_ms(torch, label, lambda: G.segment_aggregate(
        sb, keys, timed), _K4_KERNELS)
    t["kernels"] = kern
    t["kernel_ms"] = None if kern is None else sum(
        kern[k] for k in ("bounds_kernel", "agg_tile_kernel",
                          "agg_combine_kernel"))
    summed = sorted({s.child_index for s in timed if s.op == "sum"})
    counted = sorted({s.child_index for s in timed if s.op == "count"})
    inputs = [sb.columns[c].data for c in summed] + [
        sb.columns[c].validity.to(torch.float64) for c in counted]
    t["library_ms"] = _time_ms(torch, lambda: [
        torch.segment_reduce(x, "sum", lengths=lengths, unsafe=True)
        for x in inputs], reps=reps)
    seg = torch.repeat_interleave(
        torch.arange(lengths.numel(), device=sb.device), lengths)
    ones = torch.ones(sb.num_rows, dtype=torch.int64, device=sb.device)
    adds = [ones if s.op == "count_star" else
            sb.columns[s.child_index].validity.to(torch.int64)
            if s.op == "count" else sb.columns[s.child_index].data
            for s in timed]
    t["index_add_ms"] = _time_ms(torch, lambda: [
        torch.zeros(g, dtype=x.dtype, device=sb.device).index_add_(0, seg, x)
        for x in adds], reps=reps)
    # the bound: each key and distinct input leaf read once, each distinct
    # output (one row a group) and the keys' group rows written once
    used = set(keys) | {s.child_index for s in timed if s.op != "count_star"}
    leaves = _leaves([sb.columns[i] for i in sorted(used)])
    outs = [t for d, v in views for t in (d, v) if t is not None]
    t["bytes"] = _nbytes(leaves) + _nbytes(outs) + _nbytes(_leaves(gk))
    t["groups"], t["jobs"] = g, len(plan.jobs)
    km = "not measured" if kern is None else (
        f"{t['kernel_ms']:.4f} ({_fmt_kernels(kern)})")
    print(f"[{label}] rows={sb.num_rows} groups={g} specs checked="
          f"{len(specs)} timed={len(timed)} jobs={len(plan.jobs)} outputs="
          f"{len(plan.outs)}: ms={t['ms']:.4f} (the C entry points alone "
          f"{t['entry_ms']:.4f}, the kernels alone {km}) plain_ms="
          f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
          f"(segment_reduce, {len(inputs)} calls) index_add_ms="
          f"{t['index_add_ms']:.4f} ({len(adds)} calls) bound_ms="
          f"{_bound_ms(t['bytes']):.4f} ({t['bytes']} bytes) max_abs_err="
          f"{t['err']:.3e}; double sums the same bits on two runs; in "
          f"turns, the best of two rounds", flush=True)
    return t


def check_segmented(torch, dev, q1_batch, sorted_cols) -> dict:
    """K4 at q1's shape (2^24 rows sorted by its two W 4 keys, 11 timed
    aggregates) and at a many-groups shape (2^22 rows in ~2^20 groups of
    one int64 key, the same aggregates over q1's doubles)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import segmented as G
    sb = ColumnBatch(sorted_cols, q1_batch.num_rows,
                     type(q1_batch.schema)(q1_batch.schema.fields[:6]), dev)
    specs = [G.AggSpec(o, c) for o, c in _Q1_SPECS]
    code = sb.columns[0].data[:, 0].to(torch.int64) * 256 + \
        sb.columns[1].data[:, 0].to(torch.int64)
    lengths = torch.unique_consecutive(code, return_counts=True)[1]
    q1 = _time_k4(torch, "K4 segmented q1", sb, [0, 1], specs, lengths)
    rng = np.random.default_rng(16)
    n = K4_MANY_ROWS
    key = np.sort(rng.integers(0, K4_MANY_ROWS >> 2, n))
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    cols = [DeviceColumn(torch.from_numpy(key).to(dev), ones, T.LongType())]
    cols += [DeviceColumn(c.data[:n].contiguous(), c.validity[:n].contiguous(),
                          c.dtype) for c in sorted_cols[2:6]]
    many = ColumnBatch(cols, n, None, dev)
    mspecs = [G.AggSpec(o, c - 1) for o, c in _Q1_SPECS]
    mlen = torch.unique_consecutive(cols[0].data, return_counts=True)[1]
    mg = _time_k4(torch, "K4 segmented many groups", many, [0], mspecs, mlen)
    return dict(name="segment_aggregate", route="cuda",
                source="spark_rapids_tpu_torch/csrc/segmented.cu",
                replaces="spark_rapids_tpu/ops/segmented.py:68",
                max_abs_err=max(q1["err"], mg["err"]), ms=q1["ms"],
                plain_ms=q1["plain_ms"], bound_ms=_bound_ms(q1["bytes"]),
                bound_by="bytes", library_ms=q1["library_ms"],
                kernel_ms=q1["kernel_ms"], entry_ms=q1["entry_ms"],
                k4_kernels=q1["kernels"], k4_index_add_ms=q1["index_add_ms"],
                k4_jobs=q1["jobs"], k4_many_ms=mg["ms"],
                k4_many_entry_ms=mg["entry_ms"],
                k4_many_kernel_ms=mg["kernel_ms"],
                k4_many_kernels=mg["kernels"],
                k4_many_plain_ms=mg["plain_ms"],
                k4_many_library_ms=mg["library_ms"],
                k4_many_index_add_ms=mg["index_add_ms"],
                k4_many_bound_ms=_bound_ms(mg["bytes"]),
                k4_many_groups=mg["groups"])


def profile_decode(torch, dev) -> dict:
    """K8a's kernel alone under torch.profiler, in phase 3 (later in a run
    it has seen no device work): a synthetic q1 lineitem batch of 2^20
    rows (q1's generator's columns, the codec on: the doubles and the
    ship date bit-packed, the two flags dictionary strings), one
    decode_batch_kernel a call and nothing else.  K8a's count is put
    back."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar import wirecodec as WC
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    host = _q1_host_columns(np.random.default_rng(8), K8A_PROFILE_ROWS)
    arrays, names = [], []
    for name, leaf in host.items():
        if isinstance(leaf, tuple):
            arrays.append(pa.array([bytes(r[:1]).decode() for r in leaf[0]]))
        elif name == "l_shipdate":
            arrays.append(pa.array(leaf).cast(pa.date32()))
        else:
            arrays.append(pa.array(leaf))
        names.append(name)
    rb = pa.RecordBatch.from_arrays(arrays, names=names)
    packed = ColumnBatch.stage_arrow(rb, dev, codec=True)
    buf = packed.buf.to(dev)
    jobs = [j for _i, j in packed.k8a_jobs(buf)]
    n = packed.num_rows
    saved = WC.decode_fixed.launches
    _k8_same(torch, _leaves(packed.decode(buf)),
             _leaves(packed.decode(buf, plain=True)),
             "K8a at the synthetic q1 batch")
    ms = _one_kernel_ms(torch, "K8a decode_batch_kernel",
                        lambda: WC.decode_jobs(jobs, n, dev),
                        "decode_batch_kernel")
    WC.decode_fixed.launches = saved
    print(f"[K8a profile] a synthetic q1 lineitem batch of {n} rows, "
          f"{len(jobs)} jobs ({'; '.join(_describe(packed))}): the "
          f"kernel alone {'not measured' if ms is None else f'{ms:.4f}'} "
          "ms", flush=True)
    return {"kernel_ms": ms, "jobs": len(jobs)}


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


#: q6's other fast-path build sides at SF10 (their rows, int32 keys 1..n)
_Q6_BUILDS = {"item": 56_920, "date_dim": 73_049,
              "customer_address": 250_593}


def _search_entry(torch, col, prep, jt: str, layout):
    """K5's C entry point alone on outputs allocated once: ``(run, buf)``,
    ``buf`` the int32 outputs (the total, start, cnt, out_cnt, offsets)."""
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.ops import native
    lib = native.lib("join_probe")
    key, valid = col.data.contiguous(), col.validity.contiguous()
    n, dev = key.numel(), key.device
    buf = torch.empty(2 + 4 * n + 1, dtype=torch.int32, device=dev)
    stream = native.stream_ptr(dev)
    status = native.lookback_status(J._STATUS, dev, stream,
                                    -(-n // J.PROBE_TILE))
    skey, _perm, nv = prep
    base = buf.data_ptr()
    args = (key.data_ptr(), valid.data_ptr(), n, skey.data_ptr(),
            skey.numel(), nv.data_ptr(), J.ptr(layout.levels), layout.k,
            key.element_size(),
            J._JT_CODES[jt], base + 8, base + 8 + 4 * n, base + 8 + 8 * n,
            base + 8 + 12 * n, base, 0, status.data_ptr(), stream)

    def run(_keep=(key, valid, buf, status, prep, layout)):
        native.check(lib.srt_join_search(*args), "srt_join_search")
    return run, buf


def _time_probe(torch, label: str, stream, build, full: bool,
                reps: int = 20) -> dict:
    """K5 at one shape (an inner probe over the build's layout): checked
    against its plain version, then timed through the wrapper and its
    search kernel alone (torch.profiler: one search_kernel a call,
    nothing else).  ``full``: the wrapper in turns with the plain version
    and two searchsorted calls (the best of two rounds), the C entry point
    alone, and K7's own offsets scan of the same counts, which the search
    spares."""
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.ops import native
    prep = J.build_prepare_fast(build, 0)
    lay = prep.layout
    col = stream.columns[0]
    got, total = J.probe_fast(stream, 0, *prep, "inner", layout=lay)
    want, wtotal = J.probe_fast_plain(stream, 0, *prep, "inner")
    _assert_same_tensors(torch, got + (total,), want + (wtotal,), label)
    oc = got[3].to(torch.int64)
    if not torch.equal(got.offsets.to(torch.int64), torch.cat(
            [oc.new_zeros(1), torch.cumsum(oc, 0)])):
        raise AssertionError(f"{label}: offsets differ from out_cnt's sum")
    n = col.capacity
    skey, key = prep[0], col.data

    def wrapper():
        return J.probe_fast(stream, 0, *prep, "inner", layout=lay)
    if full:
        run, buf = _search_entry(torch, col, prep, "inner", lay)
        run()
        if not torch.equal(buf[2 + 2 * n:], torch.cat([got[3],
                                                       got.offsets])):
            raise AssertionError(f"{label}: the C entry differs")
        t = _in_turns(torch, {
            "ms": wrapper,
            "plain_ms": lambda: J.probe_fast_plain(stream, 0, *prep,
                                                   "inner"),
            "library_ms": lambda: (
                torch.searchsorted(skey, key),
                torch.searchsorted(skey, key, right=True))}, reps=reps)
        t["entry_ms"] = _time_ms(torch, run, reps=reps)
        lib7, sp = native.lib("join_expand"), native.stream_ptr(key.device)
        t["k7_scan_ms"] = _time_ms(torch, lambda: J._offsets_cuda(
            lib7, got[3], sp), reps=reps)
    else:
        t = {"ms": _time_ms(torch, wrapper, reps=reps)}
    saved = J.join_search.launches
    t["kernel_ms"] = _one_kernel_ms(torch, label, wrapper, "search_kernel")
    J.join_search.launches = saved
    nb, item = skey.numel(), key.element_size()
    # each stream key and validity read, start, cnt, out_cnt and the
    # offsets written, the sorted build keys read once
    t["bytes"] = n * (item + 1) + n * 16 + 4 + 8 + nb * item
    t["levels"], t["matched"] = lay.k, int(total.item())
    km = ("not measured" if t["kernel_ms"] is None
          else f"{t['kernel_ms']:.4f}")
    more = (f"; the C entry alone {t['entry_ms']:.4f}) plain_ms="
            f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
            f"(searchsorted x2) bound_ms={_bound_ms(t['bytes']):.4f} "
            f"({t['bytes']} bytes); K7's own offsets scan of these counts, "
            f"spared: {t['k7_scan_ms']:.4f}; in turns, the best of two "
            f"rounds" if full else
            f") bound_ms={_bound_ms(t['bytes']):.4f} ({t['bytes']} bytes)")
    print(f"[{label}] stream={n} build={nb} layout levels below the staged "
          f"one={lay.k} matched={t['matched']}: ms={t['ms']:.4f} (the "
          f"kernel alone {km}{more}", flush=True)
    return t


def _time_rank_search(torch, dev, rng, label: str, nl: int, nr: int):
    """The rank path's search, whose sorted build ids are new every call:
    the layout built for the call (``join.rank_layout``: staged whole, or
    past the shared memory one levels-only launch of srt_join_build_keys)
    and searched, checked against the plain ranges and timed, with its
    device time a call (torch.profiler)."""
    from spark_rapids_tpu_torch.ops import join as J
    rid = torch.from_numpy(np.sort(rng.integers(0, nr, nr)).astype(
        np.int32)).to(dev)
    lid_np = rng.integers(0, nr, nl).astype(np.int32)
    lid_np[rng.random(nl) < 0.03] = 2 ** 31 - 1
    lid = torch.from_numpy(lid_np).to(dev)
    k = J.search_levels(nr, 4)[0]

    def search():
        return J.join_search(lid, None, rid, None, "inner",
                             layout=J.rank_layout(rid))
    _assert_same_tensors(torch, search()[:3], J._ranges_plain(
        lid, rid, None, None, "inner"), label)
    t = {"ms": _time_ms(torch, search, reps=20),
         "device_ms": _device_ms(torch, search)}
    dms = ("not measured" if t["device_ms"] is None
           else f"{t['device_ms']:.4f}")
    print(f"[{label}] stream={nl} sorted ids={nr} (levels k={k}): the rank "
          f"path's layout built and searched {t['ms']:.4f} ms, device "
          f"{dms}", flush=True)
    return t


def check_join_probe(torch, dev, rng) -> dict:
    """K5 at q6's largest probe: a 2^20-row int32 stream batch (~4% null)
    against customer's 501,187 build keys (~1% null), every join type over
    the build's layout; timed there, at q6's other build sides and at the
    rank path's shapes."""
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
        want, wtotal = J.probe_fast_plain(stream, 0, *prep, jt)
        got, total = J.probe_fast(stream, 0, *prep, jt, layout=prep.layout)
        _assert_same_tensors(torch, got + (total,), want + (wtotal,),
                             f"probe_fast {jt}")
    t = _time_probe(torch, "K5 probe customer", stream, build, full=True)
    others = {}
    for name, rows in _Q6_BUILDS.items():
        b = _int_batch(torch, np.arange(1, rows + 1, dtype=np.int32),
                       rng.random(rows) >= 0.01, dev)
        s = _int_batch(torch, rng.integers(1, rows + 1, ns).astype(
            np.int32), rng.random(ns) >= 0.04, dev)
        others[name] = _time_probe(torch, f"K5 probe {name}", s, b,
                                   full=False)
    rank = {"q6": _time_rank_search(torch, dev, rng, "K5 rank search q6",
                                    56_920, 11),
            "q24": _time_rank_search(torch, dev, rng, "K5 rank search q24",
                                     ns, 2_880_000)}
    out = dict(name="join_probe_fast", route="cuda",
               source="spark_rapids_tpu_torch/csrc/join_probe.cu",
               replaces="spark_rapids_tpu/ops/join.py:152",
               max_abs_err=0.0, ms=t["ms"], plain_ms=t["plain_ms"],
               bound_ms=_bound_ms(t["bytes"]), bound_by="bytes",
               library_ms=t["library_ms"], kernel_ms=t["kernel_ms"],
               entry_ms=t["entry_ms"], k5_k7_scan_ms=t["k7_scan_ms"],
               k5_levels=t["levels"])
    for name, o in others.items():
        out.update({f"k5_{name}_ms": o["ms"],
                    f"k5_{name}_kernel_ms": o["kernel_ms"],
                    f"k5_{name}_bound_ms": _bound_ms(o["bytes"])})
    for name, r in rank.items():
        out.update({f"k5_rank_{name}_ms": r["ms"],
                    f"k5_rank_{name}_device_ms": r["device_ms"]})
    return out


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


def _k6_entry(torch, cols, valid, cl: int):
    """K6's C entry points alone (K1's through :func:`_k1_entry`, then the
    ids kernel's) on arguments prepared once, as ``join._ids_cuda`` calls
    them: returns ``(run, plan)``, ``run()`` giving the ids."""
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.ops import native
    n = valid.numel()
    sort, plan, ors = _k1_entry(torch, *J.ids_sort_keys(cols, valid),
                                1 + -(-n // J.IDS_TILE))
    valid_bit = J.ids_valid_bit(plan)
    ids = torch.empty(n, dtype=torch.int32, device=valid.device)
    lib = native.lib("join_ids")
    stream = native.stream_ptr(valid.device)

    def run():
        perm, words, top, extra = sort()
        native.check(lib.srt_join_key_ids(
            top.data_ptr(), words.data_ptr(), words.element_size(),
            words.shape[0], perm.data_ptr(), valid_bit, int(ors[0][0] == 0),
            n, cl, extra, ids.data_ptr(), stream), "srt_join_key_ids")
        return ids
    return run, plan


def _time_key_ids(torch, label: str, lb, rb, keys, library) -> dict:
    """K6 at one shape: through the wrapper in turns with ``library`` (one
    torch.unique call), the best of two rounds; its C entry points alone
    and its kernels alone (torch.profiler: K1's, one ids kernel, one copy
    to the host and nothing else)."""
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.ops import sort as S
    cols, valid = J._combined(lb, rb, keys, keys)
    run, plan = _k6_entry(torch, cols, valid, lb.num_rows)
    ids = run()
    _assert_same_tensors(torch, (ids[:lb.num_rows], ids[lb.num_rows:]),
                         J.key_ids_plain(lb, rb, keys, keys),
                         f"{label} C entry points")
    t = _in_turns(torch, {"ms": lambda: J._key_ids(lb, rb, keys, keys),
                          "library_ms": library}, reps=20)
    t["entry_ms"] = _time_ms(torch, run, reps=20)
    saved = (J._key_ids.launches, S.sort_permutation.launches)
    t["kernels"] = _kernels_ms(
        torch, label, lambda: J._ids_cuda(cols, valid, lb.num_rows),
        {"plan_kernel": 1, "encode_kernel": 1,
         "upsweep_kernel": len(plan.words), "scan_kernel": len(plan.words),
         "scatter_kernel": sum(len(p) for p in plan.passes),
         "key_ids_kernel": 1})
    J._key_ids.launches, S.sort_permutation.launches = saved
    t["plan"] = plan
    print(f"[{label}] {lb.num_rows} + {rb.num_rows} rows: {_fmt_plan(plan)};"
          f" ms={t['ms']:.4f} (the C entry points alone "
          f"{t['entry_ms']:.4f}; kernels alone: {_fmt_kernels(t['kernels'])})"
          f" library_ms={t['library_ms']:.4f}; in turns, the best of two "
          f"rounds", flush=True)
    return t


def check_key_ids(torch, dev, rng) -> dict:
    """K6 at q6's rank join (56,920 item rows against the 11 category
    groups on the nullable string key), and a 2^22-row three-key fuzz;
    timed in turns with torch.unique at q6's shape and at 2^22 rows of one
    int64 key."""
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
    _assert_same_tensors(torch, J._key_ids(left, right, [0], [0]),
                         J.key_ids_plain(left, right, [0], [0]),
                         "key_ids fuzz, one key")
    both = torch.cat([left.columns[0].data, right.columns[0].data])
    fuzz = _time_key_ids(torch, "K6 one int64 key, 2^22 rows", left, right,
                         [0], lambda: torch.unique(both, sorted=True,
                                                   return_inverse=True))
    del left, right, both
    mat = torch.cat([item.columns[0].data, cats.columns[0].data])
    q6 = _time_key_ids(torch, "K6 q6 rank join", item, cats, [0],
                       lambda: torch.unique(mat, dim=0, sorted=True,
                                            return_inverse=True))
    plain_ms = _time_ms(torch, lambda: J.key_ids_plain(item, cats, [0], [0]),
                        reps=20)
    rows = ni + 11
    # key bytes + validity + lengths read once, one int32 id written
    nbytes = rows * (mat.shape[1] + 1 + 4) + rows * 4
    print(f"[K6 key ids] q6 rows={rows} width={mat.shape[1]} "
          f"ms={q6['ms']:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{q6['library_ms']:.4f} (torch.unique over the byte rows) "
          f"bound_ms={_bound_ms(nbytes):.4f}; fuzz 2^22 rows, three keys "
          f"(int64, string, float64 with NaN/-0.0/nulls): equal; one int64 "
          f"key at 2^22 rows ms={fuzz['ms']:.4f} torch.unique_ms="
          f"{fuzz['library_ms']:.4f}", flush=True)
    return dict(name="join_key_ids", route="cuda",
                source="spark_rapids_tpu_torch/csrc/join_ids.cu",
                replaces="spark_rapids_tpu/ops/join.py:62",
                max_abs_err=0.0, ms=q6["ms"], plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=q6["library_ms"], entry_ms=q6["entry_ms"],
                kernel_ms=None if q6["kernels"] is None else sum(
                    v for k, v in q6["kernels"].items() if k != "host_read"),
                k6_kernels_ms=q6["kernels"],
                k6_fuzz_ms=fuzz["ms"], k6_fuzz_library_ms=fuzz["library_ms"],
                k6_fuzz_entry_ms=fuzz["entry_ms"],
                k6_fuzz_kernels_ms=fuzz["kernels"],
                k6_fuzz_varying_bits=fuzz["plan"].bits)


def _with_offsets(torch, J, arrays):
    """The plain probe's arrays with the offsets K7 reads on the card (of
    out_cnt and of full outer's unmatched build rows, each with its total
    last), from torch.cumsum: the plain probe writes none."""
    def offsets(counts):
        c = counts.to(torch.int64)
        return torch.cat([c.new_zeros(1), torch.cumsum(c, 0)]).to(
            torch.int32)
    u = arrays[4]
    return J.ProbeArrays(tuple(arrays), offsets(arrays[3]),
                         None if u is None else offsets(u))


def _check_expand(torch, J, lb, rb, jts, what):
    for jt in jts:
        keys = [] if jt == "cross" else [0]
        arrays, total = J.join_probe_plain(lb, rb, keys, keys, jt)
        n = int(total.item())
        got = J.join_indices_from_probe(lb.num_rows,
                                        _with_offsets(torch, J, arrays), jt,
                                        n)
        want = J.join_indices_plain(lb.num_rows, arrays, jt, n)
        _assert_same_tensors(torch, got, want, f"expand {what} {jt}")
        m = J.matched_build_rows(got[1], rb.num_rows)
        mw = J.matched_build_rows_plain(got[1], torch.zeros_like(m))
        _assert_same_tensors(torch, (m,), (mw,), f"matched {what} {jt}")


def _expand_entry(torch, arrays, cl: int, jt: str, total: int):
    """K7's C entry point alone on outputs allocated once: ``(run, both)``,
    ``both`` the int32 [2, total] li and ri."""
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops.kernels import ptr
    lib = native.lib("join_expand")
    start, cnt, rperm, out_cnt, unmatched = arrays
    dev = out_cnt.device
    both = torch.empty((2, total), dtype=torch.int32, device=dev)
    cr = 0 if unmatched is None else unmatched.numel()
    args = (ptr(arrays.offsets), cl, ptr(cnt), ptr(start), ptr(rperm),
            total, int(jt not in ("semi", "anti")), ptr(unmatched),
            ptr(arrays.uoffsets), cr, ptr(both[0]), ptr(both[1]),
            native.stream_ptr(dev))

    def run(_keep=(arrays, both)):
        native.check(lib.srt_join_expand(*args), "srt_join_expand")
    return run, both


def _expand_bytes(arrays, jt: str, total: int) -> int:
    """K7's bytes for this data: the offsets read once, cnt and start
    only for the rows with slots, one build-permutation entry a matched
    slot, li and ri written once (and the full-outer tail's flags and
    offsets)."""
    start, cnt, _perm, out_cnt, unmatched = arrays
    cl = out_cnt.numel()
    rows = int((out_cnt > 0).sum())
    matched = (int(cnt.long().minimum(out_cnt.long()).sum())
               if jt not in ("semi", "anti") else 0)
    tail = 0 if unmatched is None else 8 * unmatched.numel() + 4
    return 4 * (cl + 1) + 8 * rows + 4 * matched + 8 * total + tail


def _time_expand(torch, J, label: str, arrays, cl: int, total: int,
                 reps: int = 20) -> dict:
    """K7 at one shape of an inner join: the wrapper in turns with its
    plain version and torch.repeat_interleave (the best of two rounds),
    the C entry alone, and the kernel alone (torch.profiler: one
    expand_kernel a call, nothing else)."""
    rows = torch.arange(cl, dtype=torch.int32, device=arrays[3].device)

    def wrapper():
        return J.join_indices_from_probe(cl, arrays, "inner", total)
    run, both = _expand_entry(torch, arrays, cl, "inner", total)
    run()
    got = wrapper()
    if not (torch.equal(both[0], got[0]) and torch.equal(both[1], got[1])):
        raise AssertionError(f"{label}: the C entry differs")
    saved = J.join_indices_from_probe.launches
    t = _in_turns(torch, {
        "ms": wrapper,
        "plain_ms": lambda: J.join_indices_plain(cl, arrays, "inner",
                                                 total),
        "library_ms": lambda: torch.repeat_interleave(
            rows, arrays[3], output_size=total)}, reps=reps)
    t["entry_ms"] = _time_ms(torch, run, reps=reps)
    t["kernel_ms"] = _one_kernel_ms(torch, label, wrapper, "expand_kernel")
    J.join_indices_from_probe.launches = saved
    t["bytes"] = _expand_bytes(arrays, "inner", total)
    t["total"] = total
    t["bound_ms"] = _bound_ms(t["bytes"])
    km = ("not measured" if t["kernel_ms"] is None
          else f"{t['kernel_ms']:.4f}")
    print(f"[{label}] stream={cl} out={total}: ms={t['ms']:.4f} (the C "
          f"entry alone {t['entry_ms']:.4f}, the kernel alone {km}) "
          f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
          f"(torch.repeat_interleave, left indices only) bound_ms="
          f"{t['bound_ms']:.4f} ({t['bytes']} bytes); in turns, the best "
          f"of two rounds", flush=True)
    return t


def check_expand(torch, dev, rng) -> dict:
    """K7 at q6's first join (2^20 stream rows, ~1.4% matched once each)
    and a many-to-many shape (0-16 matches per row plus one key that
    matches 2^16 build rows), every join type; timed at both through the
    wrapper, its C entry and its kernel alone.  The library exports no
    tail entry: the full-outer tail is in the expansion's launch."""
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.ops import native
    if hasattr(native.lib("join_expand"), "srt_join_tail"):
        raise AssertionError("join_expand still exports srt_join_tail")
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
    many_t = _time_expand(torch, J, "K7 expand many-to-many",
                          _with_offsets(torch, J, arrays), ns,
                          int(total.item()))
    del arrays
    # q6's shape, over the offsets K5 wrote (as the paths run it), and
    # beside it K7's own one-launch scan of the same counts, which K5's
    # search spares
    prep = J.build_prepare_fast(dates, 0)
    arrays, total = J.probe_fast(stream, 0, *prep, "inner",
                                 layout=prep.layout)
    n = int(total.item())
    q6 = _time_expand(torch, J, "K7 expand q6", arrays, ns, n)
    lib7 = native.lib("join_expand")
    sp = native.stream_ptr(dev)

    def scan():
        return J._offsets_cuda(lib7, arrays[3], sp)
    got = scan()
    oc = arrays[3].to(torch.int64)
    if not torch.equal(got.to(torch.int64), torch.cat(
            [oc.new_zeros(1), torch.cumsum(oc, 0)])):
        raise AssertionError("K7's own offsets scan differs from cumsum")
    saved = J._offsets_cuda.launches
    scan_ms = _time_ms(torch, scan, reps=20)
    scan_kernel_ms = _one_kernel_ms(torch, "K7 offsets scan", scan,
                                    "offsets_kernel")
    J._offsets_cuda.launches = saved
    skm = ("not measured" if scan_kernel_ms is None
           else f"{scan_kernel_ms:.4f}")
    print(f"[K7 expand] q6 out={n}: every join type equal at both shapes; "
          f"K7's own offsets scan of q6's counts (one launch, spared on "
          f"the join paths): {scan_ms:.4f} ms, the kernel alone {skm}",
          flush=True)
    return dict(name="join_expand", route="cuda",
                source="spark_rapids_tpu_torch/csrc/join_expand.cu",
                replaces="spark_rapids_tpu/ops/join.py:216",
                max_abs_err=0.0, ms=q6["ms"], plain_ms=q6["plain_ms"],
                bound_ms=q6["bound_ms"], bound_by="bytes",
                library_ms=q6["library_ms"], entry_ms=q6["entry_ms"],
                kernel_ms=q6["kernel_ms"], k7_scan_ms=scan_ms,
                k7_scan_kernel_ms=scan_kernel_ms,
                k7_many_out=many_t["total"],
                k7_many_ms=many_t["ms"], k7_many_plain_ms=many_t["plain_ms"],
                k7_many_library_ms=many_t["library_ms"],
                k7_many_entry_ms=many_t["entry_ms"],
                k7_many_kernel_ms=many_t["kernel_ms"],
                k7_many_bound_ms=many_t["bound_ms"], k7_q6_out=n)


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
    from spark_rapids_tpu_torch.ops import range_partition as RP
    from spark_rapids_tpu_torch.ops import segmented as G
    from spark_rapids_tpu_torch.ops import sort as S
    from spark_rapids_tpu_torch.ops import strings as STR
    from spark_rapids_tpu_torch.ops import window as W
    from spark_rapids_tpu_torch.columnar import wirecodec as WC
    from spark_rapids_tpu_torch.ops import generate as GE
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    return {"sort_permutation": {"sort_permutation": S.sort_permutation},
            "compact": {"compact": K.compact},
            "gather_columns": {"gather_columns": K.gather_columns},
            "segment_aggregate": {"segment_aggregate": G.segment_aggregate,
                                  "segment_flags": G._segment_flags},
            "join_probe_fast": {"join_search": J.join_search,
                                "build_prepare_fast": J.build_prepare_fast,
                                "rank_layout": J.rank_layout},
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
            "case_map": {"case_map": STR.case_map},
            "hex_string": {"hex_string": STR.hex_string},
            "segment_percentile": {
                "segment_percentile": G.segment_percentile},
            "decode_fixed": {"decode_fixed": WC.decode_fixed},
            "decode_dict": {"decode_dict": WC.decode_dict},
            "range_partition_ids": {
                "range_partition_ids": RP.range_partition_ids},
            "frame_min_max": {"frame_min_max": W.frame_min_max},
            "split_counts": {"split_counts": GE.split_counts},
            "split_emit": {"split_emit": GE.split_emit},
            "array_emit": {"array_emit": GE.array_emit},
            "trim": {"trim": STR.trim},
            "char_length": {"char_length": STR.char_length},
            "locate": {"locate": STR.locate},
            "substring_index": {"substring_index": STR.substring_index},
            "segment_string_min_max": {
                "segment_string_min_max": G.segment_string_min_max},
            "mesh_pack": {"mesh_pack": ME.mesh_pack},
            "mesh_unpack": {"mesh_unpack": ME.mesh_unpack}}


#: K8a and K8b: every scan batch of more than 1024 rows goes through the
#: wire codec; K8b only where a string column dictionary-encodes
_SCAN_ENTRIES = ("decode_fixed", "decode_dict")
#: the dictionary decode, required only on q1 and simple_agg
_MAY_DICT = ("decode_dict",)
_Q1_ENTRIES = ("sort_permutation", "compact", "gather_columns",
               "segment_aggregate") + _SCAN_ENTRIES
_Q6_ENTRIES = _Q1_ENTRIES + ("join_probe_fast", "join_key_ids",
                             "join_expand")
_SHUFFLE_ENTRIES = ("partition_ids_for_keys", "group_by_part")
#: counters of kernels that q6 does not run: the matched-build bitmap
#: serves full outer joins only, and q6's joins are all inner; K9's hash
#: mode serves the Murmur3Hash expression, which only the mortgage jobs
#: evaluate
_OFF_Q6_PATH = ("matched_build_rows", "murmur3_columns")


class _CEntries:
    """The C-level launches of K7 and K10 on the paths: ``native.lib`` is
    wrapped so that every call of an ``srt_*`` entry point of
    ``join_expand`` and ``partition_group`` is counted by name (each such
    entry launches one kernel, none on an empty input).  A path must run
    one ``srt_join_expand`` a K7 call, the full-outer tail included (the
    library has no tail entry), and one ``srt_partition_upsweep`` and one
    ``srt_partition_scatter`` a K10 call up to 255 partitions (a scatter
    a byte of the bucket past it): no one-block scan, no counts kernel.
    Installed once the kernel checks are over, so no timed call pays the
    count."""
    LIBS = {"join_expand": "join_expand", "partition_group": "group_by_part"}

    def __init__(self):
        self.calls = {lib: {} for lib in self.LIBS}
        self.passes = 0

    def install(self) -> None:
        from spark_rapids_tpu_torch.ops import native
        from spark_rapids_tpu_torch.ops import partition as P
        if hasattr(native.lib("join_expand"), "srt_join_tail"):
            raise AssertionError("join_expand still exports srt_join_tail")
        real = native.lib
        rec = self

        class Counting:
            def __init__(self, dll, name):
                self._dll, self._calls = dll, rec.calls[name]

            def __getattr__(self, fn):
                f = getattr(self._dll, fn)
                if not fn.startswith("srt_") or fn.endswith("_limits"):
                    return f

                def call(*args):
                    self._calls[fn] = self._calls.get(fn, 0) + 1
                    if fn == "srt_partition_upsweep":
                        rec.passes += len(P.group_passes(args[2]))
                    return f(*args)
                return call

        def lib(name):
            dll = real(name)
            return Counting(dll, name) if name in self.LIBS else dll
        native.lib = lib

    def reset(self, entries) -> None:
        for lib, entry in self.LIBS.items():
            if entry in entries:
                self.calls[lib].clear()
                if lib == "partition_group":
                    self.passes = 0

    def check(self, got: dict, query: str) -> None:
        """Against the wrapper counts of one path's cold run."""
        if "join_expand" in got:
            c = self.calls["join_expand"]
            k7 = got["join_expand"]["join_indices_from_probe"]
            if c.get("srt_join_expand", 0) != k7:
                raise AssertionError(f"{query}: {k7} K7 calls made the C "
                                     f"launches {c}, not one each")
        if "group_by_part" in got:
            c = self.calls["partition_group"]
            k10 = got["group_by_part"]["group_by_part"]
            up = c.get("srt_partition_upsweep", 0)
            sc = c.get("srt_partition_scatter", 0)
            if up != k10 or sc != self.passes or set(c) - {
                    "srt_partition_upsweep", "srt_partition_scatter"}:
                raise AssertionError(f"{query}: {k10} K10 calls made the C "
                                     f"launches {c} ({self.passes} passes)")

    def summary(self, entries) -> str:
        return str({lib: dict(self.calls[lib]) for lib, e in
                    self.LIBS.items() if e in entries})


_C_ENTRIES = _CEntries()


def _reset_counters(entries) -> None:
    for name in entries:
        for w in _counters()[name].values():
            w.launches = 0
    _C_ENTRIES.reset(entries)


#: counters that may or may not be 0 on any path: the rank path's
#: levels-only layout build runs only where a rank join's sorted ids pass
#: the search's shared memory (q24's store_returns, agg_join's loans)
_WHERE_NEEDED = ("rank_layout",)


def _read_counters(entries, query: str, off_path=()) -> dict:
    """{entry: {counter: launches}}; fails if a counter on the query's
    path stayed at 0."""
    got = {name: {k: w.launches for k, w in _counters()[name].items()}
           for name in entries}
    for group in got.values():
        for k, v in group.items():
            if v <= 0 and k not in off_path and k not in _WHERE_NEEDED:
                raise AssertionError(f"{query} ran without launching {k}")
    _C_ENTRIES.check(got, query)
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
    peak = torch.cuda.max_memory_allocated()
    warm_s, peaks = _warm_runs(torch, "q1", df.collect, _check_rows, want,
                               warm)
    n = int(tpch_gen.table_row_counts(sf)["lineitem"])
    for r in rows:
        print(f"[q1] {r}")
    print(f"[q1] device budget {session.device_budget()} bytes "
          "(allocFraction and reserve of the conf)")
    print(f"[q1] SF{sf:g} lineitem_rows={n} cold_s={cold:.3f} "
          f"warm_s={[round(x, 3) for x in warm_s]} "
          f"rows_per_s_warm={n / min(warm_s) if warm_s else 0:.0f} "
          f"cold_peak_bytes={peak} warm_peak_bytes={peaks} "
          f"launches={launches}", flush=True)
    return launches


def _warm_runs(torch, label: str, collect, check, want, warm: int):
    """``warm`` timed runs, each checked; (seconds, peak device bytes)
    per run.  Fails if the peak grows from the first warm run to the
    last."""
    warm_s, peaks = [], []
    for _ in range(warm):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows = collect()
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        check(rows, want)
    if peaks and peaks[-1] > peaks[0]:
        raise AssertionError(f"{label}: peak device memory grew over the "
                             f"warm runs: {peaks}")
    return warm_s, peaks


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
    from spark_rapids_tpu_torch.ops import join as J
    q6, tables = TPCDS_QUERIES["q6"]
    sf = Q6_SF
    data_dir = os.path.join(ROOT, ".bench_data",
                            f"tpcds_sf{sf:g}_seed42_onefile")
    t0 = time.perf_counter()
    # drawn once in the default layout (phase 6 reads it), then written
    # again as one file per table
    default_dir = os.path.join(ROOT, ".bench_data",
                               f"tpcds_sf{sf:g}_seed42_default")
    tpcds_gen.generate_tpcds(default_dir, sf=sf, seed=42, tables=tables,
                             rows_per_file=DEFAULT_ROWS_PER_FILE)
    tpcds_gen.relayout_tpcds(default_dir, data_dir, sf, 42, tables,
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
    J._offsets_cuda.launches = 0
    t0 = time.perf_counter()
    rows = q6(session, data_dir).collect()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = _read_counters(entries, "q6", _OFF_Q6_PATH + _MAY_DICT)
    c_launches = _C_ENTRIES.summary(entries)
    # K5's search writes the offsets K7 reads: K7's own scan runs not once
    k7_scans = J._offsets_cuda.launches
    if k7_scans != 0:
        raise AssertionError(f"q6 ran K7's own offsets scan {k7_scans} "
                             "times")
    _check_q6(rows, want)
    peak = torch.cuda.max_memory_allocated()
    warm_s, peaks = _warm_runs(torch, "q6",
                               lambda: q6(session, data_dir).collect(),
                               _check_q6, want, warm)
    n = int(tpcds_gen.table_row_counts(sf)["store_sales"])
    print(f"[q6] {len(rows)} rows: {rows}")
    print(f"[q6] SF{sf:g} store_sales_rows={n} cold_s={cold:.3f} "
          f"warm_s={[round(x, 3) for x in warm_s]} "
          f"rows_per_s_warm={n / min(warm_s) if warm_s else 0:.0f} "
          f"cold_peak_bytes={peak} warm_peak_bytes={peaks} "
          f"launches={launches} k7_offsets_scans={k7_scans} "
          f"k7_c_launches={c_launches}", flush=True)
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


def _group_entry(torch, ids, parts: int):
    """K10's C entry points alone (the upsweep, then a scatter a pass) on
    outputs and a scratch allocated once: ``(run, perm, counts)``."""
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops import partition as P
    from spark_rapids_tpu_torch.ops.kernels import ptr
    lib = native.lib("partition_group")
    n, dev = ids.numel(), ids.device
    sp = native.stream_ptr(dev)
    scratch = native.lookback_status(
        P._STATUS, dev, sp, (P.scratch_words(n, parts) + 1) // 2)
    cs = torch.empty((2, parts), dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    outs = [perm] if len(P.group_passes(parts)) == 1 else [
        torch.empty_like(perm), perm]

    def run(_keep=(ids, scratch, cs, outs)):
        native.check(lib.srt_partition_upsweep(
            ptr(ids), n, parts, ptr(scratch), ptr(cs[0]), ptr(cs[1]), sp),
            "srt_partition_upsweep")
        src = None
        for p, out in enumerate(outs):
            native.check(lib.srt_partition_scatter(
                ptr(ids), n, parts, p, ptr(src), ptr(out), ptr(scratch),
                sp), "srt_partition_scatter")
            src = out
    return run, perm, cs[0]


def _time_group(torch, P, one, parts: int) -> dict:
    """K10 at one map batch (2^20 rows of one nullable int32 column): the
    order alone (``partition_order``) and with K3's gather
    (``group_by_part``), in turns with their plain versions and the
    library calls (the best of two rounds), the C entry points alone, and
    the kernels alone (torch.profiler: one upsweep_kernel and one
    scatter_kernel a call, and K3's gather_kernel; nothing else)."""
    m = one.num_rows
    ids = P.partition_ids_for_keys(one, [0], parts)
    leaves = _leaves(one.columns)
    run, perm, counts = _group_entry(torch, ids, parts)
    run()
    want = P._order_plain(ids, parts)
    if not (torch.equal(perm, want[0]) and torch.equal(counts, want[1])):
        raise AssertionError(f"K10 P={parts}: the C entries differ")

    def library():
        order = torch.argsort(ids, stable=True)
        torch.bincount(ids, minlength=parts)
        return [t.index_select(0, order) for t in leaves]

    def order_library():
        order = torch.argsort(ids, stable=True)
        return order, torch.bincount(ids, minlength=parts)
    saved = P.group_by_part.launches
    t = _in_turns(torch, {
        "ms": lambda: P.group_by_part(one, ids, parts),
        "plain_ms": lambda: P.group_by_part_plain(one, ids, parts),
        "library_ms": library,
        "order_ms": lambda: P.partition_order(ids, parts),
        "order_plain_ms": lambda: P._order_plain(ids, parts),
        "order_library_ms": order_library}, reps=20)
    t["entry_ms"] = _time_ms(torch, run, reps=20)
    k10 = {"upsweep_kernel": 1, "scatter_kernel": 1}
    t["kernels"] = _kernels_ms(torch, f"K10 P={parts}",
                               lambda: P.partition_order(ids, parts), k10)
    t["k3_kernels"] = _kernels_ms(
        torch, f"K10 P={parts} with K3",
        lambda: P.group_by_part(one, ids, parts),
        dict(k10, gather_kernel=1))
    P.group_by_part.launches = saved
    # the order alone: the ids read twice, the permutation written, the
    # counts and starts written; with K3 also the column read and written
    t["order_bytes"] = 3 * 4 * m + 2 * 4 * parts
    t["bytes"] = m * 4 + 2 * _nbytes(leaves) + 2 * 4 * parts
    fmt = ("not measured" if t["kernels"] is None else
           {k: round(v, 4) for k, v in t["kernels"].items()})
    fmt3 = ("not measured" if t["k3_kernels"] is None else
            {k: round(v, 4) for k, v in t["k3_kernels"].items()})
    print(f"[K10 group by part] rows={m} P={parts}: with K3's gather "
          f"ms={t['ms']:.4f} (kernels alone {fmt3}) plain_ms="
          f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
          f"(argsort(stable) + bincount + index_select) bound_ms="
          f"{_bound_ms(t['bytes']):.4f}; the order alone ms="
          f"{t['order_ms']:.4f} (the C entries alone {t['entry_ms']:.4f}, "
          f"the kernels alone {fmt}) plain_ms={t['order_plain_ms']:.4f} "
          f"library_ms={t['order_library_ms']:.4f} (argsort(stable) + "
          f"bincount) bound_ms={_bound_ms(t['order_bytes']):.4f}; in "
          f"turns, the best of two rounds", flush=True)
    return t


def check_group_by_part(torch, dev, rng) -> dict:
    """K10 at 2^24 rows with P = 8 and 200 and with one skewed partition,
    exact against its plain version; timed at the repartition path's map
    batch (2^20 rows of one nullable int32 column) at P = 8 and 200."""
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
    t8 = _time_group(torch, P, one, 8)
    t200 = _time_group(torch, P, one, 200)
    print(f"[K10 group by part] checked {n} rows at P=8, P=200 and one "
          f"skewed partition: equal", flush=True)
    extra = {}
    for parts, t in ((8, t8), (200, t200)):
        extra.update({
            f"k10_p{parts}_ms": t["ms"], f"k10_p{parts}_order_ms":
            t["order_ms"], f"k10_p{parts}_entry_ms": t["entry_ms"],
            f"k10_p{parts}_kernels_ms": t["kernels"],
            f"k10_p{parts}_k3_kernels_ms": t["k3_kernels"],
            f"k10_p{parts}_order_plain_ms": t["order_plain_ms"],
            f"k10_p{parts}_order_library_ms": t["order_library_ms"],
            f"k10_p{parts}_order_bound_ms": _bound_ms(t["order_bytes"]),
            f"k10_p{parts}_bound_ms": _bound_ms(t["bytes"])})
    extra["k10_p200_plain_ms"] = t200["plain_ms"]
    extra["k10_p200_library_ms"] = t200["library_ms"]
    return dict(name="group_by_part", route="cuda",
                source="spark_rapids_tpu_torch/csrc/partition_group.cu",
                replaces="spark_rapids_tpu/exec/exchange.py:62",
                max_abs_err=0.0, ms=t8["ms"], plain_ms=t8["plain_ms"],
                bound_ms=_bound_ms(t8["bytes"]), bound_by="bytes",
                library_ms=t8["library_ms"], entry_ms=t8["entry_ms"],
                **extra)


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
    return [(desc, sizes) for desc, sizes, _rows in
            _exchange_sides(torch, df._s, df._prepared())]


def _drive(torch, label: str, make_df, check, entries, warm: int,
           off_path=(), zero=(), run=None, describe=None) -> dict:
    """One path: explain, then a cold run with every counter of
    ``entries`` set to 0 just before it and read just after it (each
    counter above 0, but ``off_path``; each of ``zero`` exactly 0), then
    the warm runs, each checked and its peak device memory recorded.
    ``run`` replaces ``make_df().collect()`` (a physical plan's run; no
    explain), ``describe`` the summary of its result."""
    if run is None:
        print(make_df().explain(), flush=True)

        def run():
            return make_df().collect()
    if describe is None:
        def describe(r):
            return f"{len(r)} rows, first {r[:3]}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters(entries)
    t0 = time.perf_counter()
    rows = run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = _read_counters(entries, label, tuple(off_path) + tuple(zero))
    for group in launches.values():
        for k, v in group.items():
            if k in zero and v != 0 and k not in _WHERE_NEEDED:
                raise AssertionError(f"{label} launched {k} {v} times, "
                                     "expected 0")
    check(rows)
    cold_peak = torch.cuda.max_memory_allocated()
    warm_s, peaks, held = [], [], []
    for _ in range(warm):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows = run()
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
    print(f"[{label}] {describe(rows)}; cold_s={cold:.3f} "
          f"warm_s={[round(x, 3) for x in warm_s]} cold_peak_bytes="
          f"{cold_peak} warm_peak_bytes={peaks} held_after_bytes={held} "
          f"launches={launches} k7_k10_c_launches="
          f"{_C_ENTRIES.summary(entries)}", flush=True)
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
        lambda r: _check_q6(r, want_q6), entries, warm,
        _OFF_Q6_PATH + _MAY_DICT,
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
        lambda r: _check_q6(r, want_q6), entries, warm,
        _OFF_Q6_PATH + _MAY_DICT)
    top_entries = ("sort_permutation", "gather_columns",
                   "segment_aggregate") + _SHUFFLE_ENTRIES + _SCAN_ENTRIES
    paths["top_customers"] = _drive(
        torch, "top_customers (repartition)",
        lambda: top_customers(aqe_on, data_dir), check_top, top_entries,
        warm, ("murmur3_columns",) + _MAY_DICT)
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
#: frames of the K12 stress: (mode, lower, upper); K12b serves min/max
#: only where the lower edge is the partition start, K12c the others
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
    final-window shape (the running max of the web channel).  Min/max
    with a bounded lower edge go to K12c through the same entry (held
    here too; phase 12 checks and times K12c)."""
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
          f"(bounded-lower min/max through K12c) and q51's running max/sum: "
          f"equal "
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
        ("murmur3_columns",) + _MAY_DICT)
    paths["q63"] = _drive(
        torch, "q63", lambda: q63(session, data_dir),
        lambda r: _check_window_rows("q63", r, want63),
        _Q6_ENTRIES + _SHUFFLE_ENTRIES + _WINDOW_ENTRIES, warm,
        ("matched_build_rows", "murmur3_columns", "key_ids") + _MAY_DICT,
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
    c_phone column, W 16, substring(c_phone, 1, 2)), exactly; timed
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
         "string_match") + _MAY_DICT,
        zero=("partition_ids_for_keys", "group_by_part"))
    advisory = ADVISORY_PARTITION_BYTES.get(session.conf.settings)
    for desc, sizes in _map_side_bytes(torch, q15(session, tpcds_dir)):
        print(f"[q15 exchange] {desc}: map side {sum(sizes.values())} "
              f"bytes (advisory {advisory}), coalesced into partition 0, "
              f"K9/K10 not run; by partition {sizes}", flush=True)
    paths["q14"] = _drive(
        torch, "q14", lambda: q14(session, tpch_dir),
        lambda r: _check_keyed_doubles("q14", r, want14, 0),
        _Q6_ENTRIES + _STRING_ENTRIES, warm,
        ("segment_flags", "key_ids", "matched_build_rows", "substring")
        + _MAY_DICT)
    paths["q22"] = _drive(
        torch, "q22", lambda: q22(session, tpch_dir),
        lambda r: _check_keyed_doubles("q22", r, want22, 2),
        _Q6_ENTRIES + _STRING_ENTRIES, warm,
        ("key_ids", "matched_build_rows", "string_match") + _MAY_DICT)
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
    """ms of one K6 call (its K1 sort and its ids kernel) at q24's first
    join: one 2^20-row store_sales file against all of store_returns,
    keyed on (ticket, item), in turns with torch.unique(dim=0) of the
    stacked (ticket, item) pairs as int64, the best of two rounds."""
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
    _assert_same_tensors(torch, J._key_ids(lb, rb, [0, 1], [0, 1]),
                         J.key_ids_plain(lb, rb, [0, 1], [0, 1]),
                         "key_ids q24")
    pairs = torch.stack([torch.cat([lb.columns[i].data, rb.columns[i].data])
                         .to(torch.int64) for i in (0, 1)], 1)
    t = _in_turns(torch, {
        "ms": lambda: J._key_ids(lb, rb, [0, 1], [0, 1]),
        "unique": lambda: torch.unique(pairs, dim=0, sorted=True,
                                       return_inverse=True)})
    print(f"[q24 K6] one _key_ids call at {lb.num_rows} + {rb.num_rows} "
          f"rows (ticket, item): ms={t['ms']:.4f}; torch.unique(dim=0, "
          f"return_inverse=True) of the stacked int64 pairs "
          f"{t['unique']:.4f}; in turns, the best of two rounds", flush=True)
    return t["ms"]


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
    with _K1Plans() as k1rec:
        paths["q24"] = _drive(
            torch, "q24", lambda: q24(session, tpcds_dir),
            lambda r: _check_keyed_doubles("q24", r, want24, 3), every,
            warm, ("matched_build_rows",) + _MAY_DICT,
            zero=not_run + ("concat",))
    keys10 = [p for k, p in k1rec.plans if k == 10]
    if not keys10:
        raise AssertionError("q24 ran no 10-key K1 sort")
    print(f"[q24 K1] the 10-key group-by packs {bits} bits ({limbs} 64-bit "
          f"limbs, PR 13's packing); on the card its K1 sorts kept "
          f"{sorted(set(_fmt_plan(p) for p in keys10))} over "
          f"{len(keys10)} calls (cold and warm runs)", flush=True)

    def check84(rows):
        if rows:
            raise AssertionError(f"q84 returned {len(rows)} rows")

    # q84: no customer survives the semi join against the empty Edgewood
    # side, so nothing is gathered, expanded, concatenated or aggregated
    paths["q84"] = _drive(
        torch, "q84", lambda: q84(session, tpcds_dir), check84, every, warm,
        ("gather_columns", "segment_aggregate", "segment_flags",
         "join_indices_from_probe", "matched_build_rows") + _MAY_DICT,
        zero=not_run + ("key_ids", "concat", "case_map"))

    def check84a(rows):
        if rows != want84a:
            raise AssertionError(f"q84_all_cities rows differ: {rows[:3]} "
                                 f"vs {want84a[:3]}")

    paths["q84_all_cities"] = _drive(
        torch, "q84_all_cities", lambda: q84a(session, tpcds_dir), check84a,
        every, warm,
        ("segment_aggregate", "segment_flags", "matched_build_rows")
        + _MAY_DICT, zero=not_run + ("key_ids", "case_map"))
    return entries, paths


# ---------------------------------------------------------------------------
# the mortgage phase: K13i (hex of a long) and K4p (the percentile pick);
# simple_agg, percentiles and agg_join over 1M loans
# ---------------------------------------------------------------------------

#: the generator's scale: thousands of loans (1M loans, ~17.4M
#: performance rows over the four 2003 quarters)
MORTGAGE_SF = 1000
#: the fractions of the K4p stress checks (the path's are 0.5 .. 0.99)
_STRESS_QS = [0.0, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0]
_PATH_QS = [0.5, 0.75, 0.9, 0.99]
_M32 = np.uint64(0xFFFFFFFF)


def _murmur3_long(v: np.ndarray) -> np.ndarray:
    """Spark's hash(long) (murmur3 x86_32, seed 42) of an int64 array, as
    int32, in numpy uint64 arithmetic (every product of two 32-bit values
    fits, then is cut to 32 bits)."""
    u = np.ascontiguousarray(v, dtype=np.int64).view(np.uint64)

    def mul(a, c):
        return (a * np.uint64(c)) & _M32

    def rotl(x, r):
        return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _M32

    def mix_k1(k):
        return mul(rotl(mul(k, 0xCC9E2D51), 15), 0x1B873593)

    def mix_h1(h, k):
        return (rotl(h ^ k, 13) * np.uint64(5) + np.uint64(0xE6546B64)) & _M32

    h = np.full(u.shape, 42, np.uint64)
    h = mix_h1(h, mix_k1(u & _M32))
    h = mix_h1(h, mix_k1(u >> np.uint64(32)))
    h ^= np.uint64(8)
    h ^= h >> np.uint64(16)
    h = mul(h, 0x85EBCA6B)
    h ^= h >> np.uint64(13)
    h = mul(h, 0xC2B2AE35)
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32).view(np.int32)


def _hex(h: int) -> str:
    """Spark hex of an int hash cast to long."""
    return format(int(h) & (2 ** 64 - 1), "X")


def _round4(x: np.ndarray) -> np.ndarray:
    """The reference's Round(x, 4) as its device runs it (XLA folds the
    division by 10^4 into a product with 10^-4)."""
    mag = np.abs(x)
    r = np.floor(mag * 1e4 + 0.5) * (1.0 / 1e4)
    return np.where(x < 0, -r, r)


def _read_csvs(data_dir: str, sub: str, schema, columns) -> dict:
    """The named columns of every quarter's file, in quarter order, as
    pyarrow arrays."""
    import glob
    import pyarrow as pa
    import pyarrow.csv as pc
    at = schema.to_arrow()
    tables = []
    for p in sorted(glob.glob(os.path.join(data_dir, sub, "*.txt_0"))):
        tables.append(pc.read_csv(
            p, read_options=pc.ReadOptions(column_names=at.names),
            parse_options=pc.ParseOptions(delimiter="|"),
            convert_options=pc.ConvertOptions(
                column_types={f.name: f.type for f in at},
                include_columns=columns)))
    t = pa.concat_tables(tables)
    return {c: t.column(c).combine_chunks() for c in columns}


def reference_mortgage(data_dir: str) -> dict:
    """The three jobs over the CSV files with numpy/pyarrow alone: its own
    murmur3 of a long and Python's hex, np.lexsort for the percentiles,
    the reference's Round formula.  Also the path's K4p inputs (each
    hash group's rates in ascending order, the groups' starts and
    counts), a batch of loan ids and the data's counts."""
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch.bench.mortgage_gen import (acq_schema,
                                                           perf_schema)
    perf = _read_csvs(data_dir, "perf", perf_schema(),
                      ["loan_id", "monthly_reporting_period",
                       "interest_rate"])
    acq = _read_csvs(data_dir, "acq", acq_schema(),
                     ["loan_id", "orig_interest_rate", "dti", "zip"])
    p_id = perf["loan_id"].to_numpy()
    rate = perf["interest_rate"].to_numpy(zero_copy_only=False)
    month = pc.cast(pc.utf8_slice_codeunits(
        perf["monthly_reporting_period"], 0, 2), "int64").to_numpy()
    a_id = acq["loan_id"].to_numpy()
    if len(np.unique(a_id)) != len(a_id) or \
            not np.isin(p_id, a_id).all():
        raise AssertionError("mortgage data: loan ids not unique in the "
                             "acquisitions or missing there")
    order_a = np.argsort(a_id, kind="stable")
    loan = order_a[np.searchsorted(a_id, p_id, sorter=order_a)]
    a_hash = _murmur3_long(a_id)
    uniq = np.unique(a_hash)
    hexes = {int(h): _hex(h) for h in uniq}
    by_hex = sorted(uniq.tolist(), key=lambda h: hexes[h])
    rank = {h: i for i, h in enumerate(by_hex)}
    a_group = np.array([rank[int(h)] for h in a_hash], np.int64)
    p_group = a_group[loan]

    # percentiles: rows by (group, rate); every group's stats
    order = np.lexsort((rate, p_group))
    g_sorted, r_sorted = p_group[order], rate[order]
    starts = np.flatnonzero(np.r_[True, g_sorted[1:] != g_sorted[:-1]])
    counts = np.diff(np.r_[starts, len(g_sorted)])
    gid = g_sorted[starts]
    vmin = r_sorted[starts]
    vmax = r_sorted[starts + counts - 1]
    avg = np.add.reduceat(r_sorted, starts) / counts
    pct = []
    for q in _PATH_QS:
        pos = (counts - 1).astype(np.float64) * q
        lo, hi = np.floor(pos), np.ceil(pos)
        vlo = r_sorted[starts + lo.astype(np.int64)]
        vhi = r_sorted[starts + hi.astype(np.int64)]
        pct.append(vlo + (vhi - vlo) * (pos - lo))
    top = np.argsort(gid)[:1000]
    pct_rows = [(hexes[by_hex[gid[i]]], *(float(x) for x in (
        _round4(vmin[i]), _round4(vmax[i]), _round4(avg[i]),
        *(_round4(p[i]) for p in pct)))) for i in top]
    avg_top = avg[top]

    # agg_join: min rate per hash; per hash over the acquisitions in
    # quarter order, the first non-null original rate and the max dti
    a_rate = acq["orig_interest_rate"].to_numpy(zero_copy_only=False)
    a_dti = acq["dti"].to_numpy(zero_copy_only=False)
    order_g = np.argsort(a_group, kind="stable")
    ga = a_group[order_g]
    a_starts = np.flatnonzero(np.r_[True, ga[1:] != ga[:-1]])
    a_ends = np.r_[a_starts[1:], len(ga)]
    have = np.flatnonzero(~np.isnan(a_rate[order_g]))
    at = np.minimum(np.searchsorted(have, a_starts), max(len(have) - 1, 0))
    first_rate = np.where((len(have) > 0) & (have[at] < a_ends),
                          a_rate[order_g][have[at]], np.nan)
    max_dti = np.fmax.reduceat(a_dti[order_g], a_starts)
    at_group = np.searchsorted(ga[a_starts], gid[top])
    join_rows = []
    for i, k in zip(top, at_group):
        h = hexes[by_hex[gid[i]]]
        fr, dti = first_rate[k], max_dti[k]
        join_rows.append((h, float(vmin[i]), h,
                          None if np.isnan(fr) else float(fr),
                          0.0 if np.isnan(dti) else float(dti)))

    # simple_agg: max rate per (month, loan); min of those per (zip, month)
    k1 = loan.astype(np.int64) * 13 + month
    o1 = np.argsort(k1, kind="stable")
    k1s = k1[o1]
    s1 = np.flatnonzero(np.r_[True, k1s[1:] != k1s[:-1]])
    max_rate = np.maximum.reduceat(rate[o1], s1)
    zips = acq["zip"].to_numpy()[k1s[s1] // 13]
    k2 = zips.astype(np.int64) * 13 + k1s[s1] % 13
    o2 = np.argsort(k2, kind="stable")
    k2s = k2[o2]
    s2 = np.flatnonzero(np.r_[True, k2s[1:] != k2s[:-1]])
    min_rate = np.minimum.reduceat(max_rate[o2], s2)
    simple_rows = list(zip((k2s[s2] // 13).tolist(), (k2s[s2] % 13).tolist(),
                           min_rate.tolist()))
    return {"simple_agg": simple_rows, "percentiles": pct_rows,
            "avg": avg_top, "agg_join": join_rows,
            "perf_rows": len(p_id), "loans": len(a_id),
            "collided": len(a_id) - len(uniq),
            "k4p": (r_sorted, starts, counts), "loan_ids": p_id}


def _check_percentiles(rows, want, avg) -> int:
    """Rows in order, doubles within F64_RTOL; the average, a sum taken in
    another order, may round to either side of a tie it lies within 1e-12
    of.  Returns the number of such near ties."""
    if len(rows) != len(want):
        raise AssertionError(f"percentiles: {len(rows)} rows, numpy "
                             f"{len(want)}")
    near = 0
    for g, w, a in zip(rows, want, avg):
        if g[0] != w[0] or len(g) != len(w):
            raise AssertionError(f"percentiles row {g} != {w}")
        sides = {float(_round4(np.float64(a) * (1 - 1e-12))),
                 float(_round4(np.float64(a) * (1 + 1e-12)))}
        near += len(sides) > 1
        for j, (x, y) in enumerate(zip(g[1:], w[1:])):
            ok = abs(x - y) <= F64_RTOL * abs(y)
            if j == 2 and not ok:
                ok = any(abs(x - s) <= F64_RTOL * abs(s) for s in sides)
            if not ok:
                raise AssertionError(f"percentiles row {g} != {w} (rtol "
                                     f"{F64_RTOL})")
    return near


def check_hex(torch, dev, rng, loan_ids) -> dict:
    """K13i against its plain version on 2^24 stress rows (random longs
    shifted to every digit count, 0, +-1, the extremes, int32 values of
    both signs cast to long, nulls) and at the path's shape (the hashes of
    one scan batch of loan_id, after K9's hash mode is held against numpy's
    murmur3), exactly; timed at the path's shape."""
    from spark_rapids_tpu_torch.ops import partition as P
    from spark_rapids_tpu_torch.ops import strings as OS
    n = 1 << 24
    v = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64) \
        >> rng.integers(0, 64, n)
    i32 = rng.random(n) < 0.25
    v[i32] = rng.integers(-2 ** 31, 2 ** 31, int(i32.sum()))
    v[:6] = [0, 1, -1, 2 ** 63 - 1, -2 ** 63, -2 ** 31]
    valid = rng.random(n) >= 0.1
    valid[:6] = True
    data = torch.from_numpy(np.where(valid, v, 0)).to(dev)
    ok = torch.from_numpy(valid).to(dev)
    got = OS.hex_string(data, ok)
    _same_strings(torch, got, OS.hex_string_plain(data, ok), "K13i stress")
    lens = set(torch.unique(got[1]).tolist())
    if lens != set(range(17)):
        raise AssertionError(f"K13i stress: digit counts {sorted(lens)}")
    del data, ok, got
    torch.cuda.empty_cache()
    # the path: one scan batch of loan_id, hashed by K9's hash mode
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.bench.mortgage_gen import perf_schema
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.expr.core import Val
    from spark_rapids_tpu_torch.io.scan import _effective_batch_rows
    rows = _effective_batch_rows(T.Schema(
        [perf_schema().field("loan_id"),
         perf_schema().field("interest_rate")]), TorchConf().settings)
    ids = np.array(loan_ids[:rows])
    col = Val(torch.from_numpy(ids).to(dev),
              torch.ones(len(ids), dtype=torch.bool, device=dev), None,
              T.LongType())
    h = P.murmur3_columns([col], len(ids), dev)
    if not np.array_equal(h.cpu().numpy(), _murmur3_long(ids)):
        raise AssertionError("K9's hash mode differs from numpy's murmur3 "
                             "of the loan ids")
    h64 = h.to(torch.int64)
    valid = torch.ones(len(ids), dtype=torch.bool, device=dev)
    got = OS.hex_string(h64, valid)
    _same_strings(torch, got, OS.hex_string_plain(h64, valid), "K13i path")
    neg = int((h64 < 0).sum())
    ms = _time_ms(torch, lambda: OS.hex_string(h64, valid), reps=20)
    plain_ms = _time_ms(torch, lambda: OS.hex_string_plain(h64, valid))
    nbytes = len(ids) * (8 + 1 + 16 + 4)
    print(f"[K13i hex] 2^24 stress rows (every digit count 0..16) and one "
          f"scan batch of {len(ids)} loan-id hashes ({neg} negative: 16 "
          f"digits): equal; K9's hash mode equals numpy's murmur3; "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=none (no PyTorch "
          f"call formats hex) bound_ms={_bound_ms(nbytes):.4f}", flush=True)
    return dict(name="hex_string", route="cuda",
                source="spark_rapids_tpu_torch/csrc/string_hex.cu",
                replaces="spark_rapids_tpu/expr/strings.py:781",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=None)


def _same_pick(torch, got, want, what: str) -> None:
    if not torch.equal(got[1], want[1]) or not torch.equal(
            torch.signbit(got[0]), torch.signbit(want[0])) or \
            not torch.equal(torch.isnan(got[0]), torch.isnan(want[0])):
        raise AssertionError(f"{what}: validity or signs differ from the "
                             "plain version")
    both = ~torch.isnan(want[0])
    if not torch.equal(got[0][both], want[0][both]):
        raise AssertionError(f"{what}: values differ from the plain version")


def check_percentile(torch, dev, rng, path) -> dict:
    """K4p against its plain version on a 2^24-row stress batch (one giant
    segment, many one-row segments, segments without values, NaN, +-inf,
    -0.0, ties; q from 0 to 1) and at the path's shape (every hash group's
    rates in order, ~17.4M rows in ~1M groups, 4 q's), exactly; timed at
    the path's shape."""
    from spark_rapids_tpu_torch.ops import segmented as G
    n = 1 << 24
    giant = 1 << 22
    singles = 1 << 21
    # segments of 2..20 rows (11 on average) fill ~11/12 of the rest; the
    # last one takes what is left
    rest = rng.integers(2, 21, (n - giant - singles) // 12)
    sizes = np.r_[[giant], np.ones(singles, np.int64), rest]
    sizes[-1] += n - int(sizes.sum())
    counts = torch.from_numpy(sizes).to(dev)
    starts = torch.cumsum(counts, 0) - counts
    seg = torch.repeat_interleave(torch.arange(len(sizes), device=dev),
                                  counts)[torch.randperm(n, device=dev)]
    pick = torch.tensor([-2.5, -0.0, 0.0, 1.0, float("nan"), float("inf"),
                         -float("inf"), 3.0], dtype=torch.float64,
                        device=dev)
    vals = pick[torch.randint(0, 8, (n,), device=dev)] + torch.where(
        torch.rand(n, device=dev) < 0.5, torch.rand(n, device=dev,
                                                    dtype=torch.float64), 0.0)
    # each segment ascending, NaN last (torch sorts NaN above every
    # number): sorted values, then a stable sort by the shuffled segments
    vals, _ = torch.sort(vals, stable=True)
    _, order = torch.sort(seg, stable=True)
    vals = vals[order]
    # some segments have fewer valid values than rows, some none
    cut = torch.where(torch.rand(len(sizes), device=dev) < 0.2,
                      counts // 2, counts)
    cut = torch.where(torch.rand(len(sizes), device=dev) < 0.05, 0, cut)
    args = (vals.contiguous(), starts.to(torch.int32), cut, _STRESS_QS)
    _same_pick(torch, G.segment_percentile(*args),
               G.segment_percentile_plain(*args), "K4p stress")
    del vals, seg, order, args
    torch.cuda.empty_cache()
    r_sorted, p_starts, p_counts = path
    args = (torch.from_numpy(r_sorted).to(dev),
            torch.from_numpy(p_starts.astype(np.int32)).to(dev),
            torch.from_numpy(p_counts.astype(np.int64)).to(dev), _PATH_QS)
    _same_pick(torch, G.segment_percentile(*args),
               G.segment_percentile_plain(*args), "K4p path")
    ms = _time_ms(torch, lambda: G.segment_percentile(*args), reps=20)
    plain_ms = _time_ms(torch, lambda: G.segment_percentile_plain(*args))
    groups = len(p_starts)
    # a start and a count read once a group; two 8-byte gathers, the f64
    # result and its validity byte a (group, q)
    nbytes = groups * (4 + 8) + groups * len(_PATH_QS) * (8 + 8 + 8 + 1)
    print(f"[K4p percentile] 2^24 stress rows ({len(sizes)} segments, q "
          f"{_STRESS_QS}) and the path's {len(r_sorted)} rates in {groups} "
          f"hash groups, q {_PATH_QS}: equal; ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms=none (no PyTorch call "
          f"computes a segmented percentile) bound_ms="
          f"{_bound_ms(nbytes):.4f}", flush=True)
    return dict(name="segment_percentile", route="cuda",
                source="spark_rapids_tpu_torch/csrc/segmented.cu",
                replaces="spark_rapids_tpu/ops/segmented.py:262",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=None)


_MORTGAGE_ENTRIES = ("hex_string", "segment_percentile")


def _all_but(entries, required) -> tuple:
    """Every counter of ``entries`` but ``required`` (the counters a path
    must leave at 0)."""
    return tuple(k for e in entries for k in _counters()[e]
                 if k not in required)


def run_mortgage_phase(torch, dev, warm: int):
    """K13i and K4p against their plain versions, then the mortgage jobs
    over 1M loans, each cold + warm and checked against numpy/pyarrow;
    returns ({kernel: entry}, {path: launches})."""
    from spark_rapids_tpu_torch.bench import mortgage as M
    from spark_rapids_tpu_torch.bench.mortgage_gen import perf_schema
    from spark_rapids_tpu_torch.exec.core import ExecCtx
    from spark_rapids_tpu_torch.io import CsvScanExec
    data_dir = os.path.join(ROOT, ".bench_data",
                            f"mortgage_sf{MORTGAGE_SF}_seed7")
    t0 = time.perf_counter()
    made = M.generate_mortgage(data_dir, sf=MORTGAGE_SF, seed=7)
    gen_s = time.perf_counter() - t0
    files = sorted(os.path.join(r, f) for r, _d, fs in os.walk(data_dir)
                   for f in fs if f.endswith(".txt_0"))
    t0 = time.perf_counter()
    want = reference_mortgage(data_dir)
    print(f"[mortgage] {'generated' if made else 'reused'} in {gen_s:.1f} "
          f"s: {len(files)} files, {sum(os.path.getsize(f) for f in files)} "
          f"bytes, {want['loans']} loans, {want['perf_rows']} performance "
          f"rows, {want['collided']} loans whose 32-bit hash another loan "
          f"has; numpy/pyarrow references in "
          f"{time.perf_counter() - t0:.1f} s ({len(want['simple_agg'])} "
          f"simple_agg rows)", flush=True)
    rng = np.random.default_rng(7)
    entries = {"hex_string": check_hex(torch, dev, rng, want["loan_ids"]),
               "segment_percentile": check_percentile(torch, dev, rng,
                                                      want["k4p"])}
    del want["k4p"], want["loan_ids"]
    torch.cuda.empty_cache()
    session = _cuda_session()
    perf1 = os.path.join(data_dir, "perf", "Performance_2003Q1.txt_0")
    for _ in range(2):
        scan = CsvScanExec(perf1, schema=perf_schema(), header=False,
                           delimiter="|", columns=["loan_id",
                                                   "interest_rate"])
        ctx = ExecCtx(device=session.device, conf=session.conf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scanned = sum(b.num_rows for b in scan.execute(ctx))
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
    print(f"[mortgage] one performance file's scan alone (loan_id, "
          f"interest_rate; host parse + upload), warm: {scanned} rows in "
          f"{scan_s:.3f} s", flush=True)
    every = _Q6_ENTRIES + _SHUFFLE_ENTRIES + _STRING_ENTRIES + \
        _CASE_ENTRIES + _MORTGAGE_ENTRIES
    base = ("sort_permutation", "gather_columns", "segment_aggregate",
            "segment_flags", "decode_fixed")
    strings = ("substring", "string_match", "concat", "case_map")
    paths = {}
    # one holistic aggregate: no exchange, no join, one K4p launch for the
    # four q's; K9's hash mode and K13i once a scan batch
    need = base + ("murmur3_columns", "hex_string", "segment_percentile")
    near = []
    paths["percentiles"] = _drive(
        torch, "percentiles", lambda: M.MORTGAGE_QUERIES["percentiles"](
            session, data_dir),
        lambda r: near.append(_check_percentiles(r, want["percentiles"],
                                                 want["avg"])),
        every, warm, _MAY_DICT, _all_but(every, need + _MAY_DICT))
    print(f"[percentiles] averages within 1e-12 of a rounding tie: "
          f"{near[0]}", flush=True)
    # the hash on both tables, a rank-path left join on it; the exchanges'
    # map sides are coalesced (their K9/K10 and K2 may stay at 0)
    need = base + ("murmur3_columns", "hex_string", "key_ids",
                   "join_search", "join_indices_from_probe")
    maybe = ("partition_ids_for_keys", "group_by_part", "compact") + \
        _MAY_DICT

    def check_join(rows):
        _check_keyed_doubles("agg_join", [(r[0], r[2]) + r[1:2] + r[3:]
                                          for r in rows],
                             [(r[0], r[2]) + r[1:2] + r[3:]
                              for r in want["agg_join"]], 2)

    paths["agg_join"] = _drive(
        torch, "agg_join", lambda: M.MORTGAGE_QUERIES["agg_join"](
            session, data_dir), check_join, every, warm, maybe,
        _all_but(every, need + maybe))
    # a long-keyed fast-path join and a hashed exchange of the (month,
    # loan) partials; no hash expression, no strings
    need = base + ("join_search", "build_prepare_fast",
                   "join_indices_from_probe", "partition_ids_for_keys",
                   "group_by_part", "decode_dict")
    maybe = ("compact",)

    def check_simple(rows):
        if rows != want["simple_agg"]:
            bad = next(i for i, (a, b) in enumerate(zip(
                rows, want["simple_agg"])) if a != b) \
                if len(rows) == len(want["simple_agg"]) else None
            raise AssertionError(f"simple_agg: {len(rows)} rows, numpy "
                                 f"{len(want['simple_agg'])}; first "
                                 f"difference at {bad}")

    paths["simple_agg"] = _drive(
        torch, "simple_agg", lambda: M.MORTGAGE_QUERIES["simple_agg"](
            session, data_dir), check_simple, every, warm, maybe,
        _all_but(every, need + maybe))
    return entries, paths


# ---------------------------------------------------------------------------
# K8: the scan's wire codec (K8a fixed-width decode, K8b dictionary strings)
# ---------------------------------------------------------------------------

#: rows of each K8 stress case
CODEC_STRESS_ROWS = 1 << 24
_BUCKETS = (1, 2, 4, 8, 12, 16, 20, 24, 28, 32)
#: validity of a stress case: all valid, random with every word's first
#: and last row and every 7th word null, or all null
_K8_PATTERNS = ("none", "edges", "all")


def _k8a_stress_cases() -> list:
    """(output dtype, bits, FOR base, factor) over every bit bucket and
    output type, with bases near the int64 limits, the integral divisors
    and both float scales."""
    cases = []
    for bits in _BUCKETS:
        cases += [("int64", bits, -2 ** 63, 1),
                  ("int64", bits, 2 ** 63 - 2 ** bits, 1),
                  ("int64", bits, -(2 ** 40), 1_000_000),
                  ("float64", bits, -(2 ** 40), 0.01),
                  ("float64", bits, 2 ** 52 - 2 ** bits, 1.0)]
        if bits >= 16:
            cases.append(("int64", bits, 2 ** 45, 1_000))
        if bits <= 28:
            cases.append(("int32", bits, -2 ** 31, 1))
        if bits <= 12:
            cases.append(("int16", bits, -2 ** 15, 1))
        if bits <= 4:
            cases.append(("int8", bits, -128, 1))
    cases.append(("bool", 1, 0, 1))
    return cases


def _k8_words(torch, gen, n: int, bits: int, dev):
    from spark_rapids_tpu_torch.columnar.wirecodec import packed_words
    return torch.randint(-2 ** 31, 2 ** 31, (packed_words(n, bits),),
                         generator=gen, dtype=torch.int32, device=dev)


def _k8_validity(torch, gen, n: int, pattern: str, dev):
    if pattern == "none":
        return None
    v = _k8_words(torch, gen, n, 1, dev)
    if pattern == "all":
        return torch.zeros_like(v)
    v &= 0x7FFFFFFE
    v[::7] = 0
    return v


def _k8_same(torch, got, want, what: str) -> None:
    """Every leaf equal, doubles bit for bit."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} leaves vs {len(want)}")
    for a, b in zip(got, want):
        if a is None and b is None:
            continue
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} vs "
                                 f"plain {b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.float64:
            a, b = a.view(torch.int64), b.view(torch.int64)
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: differs from the plain version")


def check_codec_stress(torch, dev) -> None:
    """K8a and K8b exactly against their plain versions on random word
    streams of 2^24 rows a case (every stream of words is a valid one)."""
    from spark_rapids_tpu_torch.columnar import wirecodec as WC
    gen = torch.Generator(device=dev).manual_seed(8)
    n = CODEC_STRESS_ROWS
    dtypes = {"int8": torch.int8, "int16": torch.int16,
              "int32": torch.int32, "int64": torch.int64,
              "bool": torch.bool, "float64": torch.float64}
    cases = _k8a_stress_cases()
    for i, (name, bits, base, factor) in enumerate(cases):
        pattern = _K8_PATTERNS[i % 3]
        words = _k8_words(torch, gen, n, bits, dev)
        v = _k8_validity(torch, gen, n, pattern, dev)
        b = torch.tensor([base], dtype=torch.int64, device=dev)
        args = (words, v, n, bits, b, factor, dtypes[name])
        _k8_same(torch, WC.decode_fixed(*args), WC.decode_fixed_plain(*args),
                 f"K8a stress {name} {bits} bits base {base} factor "
                 f"{factor} validity {pattern}")
    for pattern in ("edges", "all"):
        v = _k8_validity(torch, gen, n, pattern, dev)
        _k8_same(torch, WC.decode_fixed(None, v, n),
                 WC.decode_fixed_plain(None, v, n),
                 f"K8a stress validity alone {pattern}")
    del words, v
    widths = (4, 8, 16, 32, 64, 128, 256)
    for w in widths:
        for j, bits in enumerate((2, 8, 12)):
            base = 3
            k = base + (1 << bits)
            lens = torch.randint(0, w + 1, (k,), generator=gen,
                                 dtype=torch.int32, device=dev)
            mat = torch.randint(0, 256, (k, w), generator=gen,
                                dtype=torch.int32, device=dev)
            mat = torch.where(torch.arange(w, device=dev)[None, :]
                              < lens[:, None], mat, 0).to(torch.uint8)
            words = _k8_words(torch, gen, n, bits, dev)
            pattern = _K8_PATTERNS[j]
            v = _k8_validity(torch, gen, n, pattern, dev)
            b = torch.tensor([base], dtype=torch.int64, device=dev)
            args = (words, v, n, bits, b, mat, lens)
            got = WC.decode_dict(*args)
            _k8_same(torch, got, WC.decode_dict_plain(*args),
                     f"K8b stress W {w} {bits} bits validity {pattern}")
            del got
        torch.cuda.empty_cache()
    print(f"[K8 stress] K8a: {len(cases)} cases of {n} rows (every bucket "
          f"{_BUCKETS}, int8/16/32/64, bool, float64 at scales 0.01 and "
          f"1.0, bases near the int64 limits, divisors 10^6 and 10^3; "
          f"validity {_K8_PATTERNS}) and the validity alone; K8b: W "
          f"{widths} x 2/8/12-bit indices; all equal to the plain "
          "versions, doubles bit for bit", flush=True)


def _k8b_calls(packed, buf, i: int):
    """(kernel call, plain call, bytes moved) of dictionary column i's
    decode (K8b, a launch a column)."""
    spec = packed.col_specs[i]
    n = packed.num_rows
    vdesc = spec[2]
    vb = 0 if vdesc[0] == "av" else packed.layout[vdesc[1]][1]
    k, w = packed.layout[spec[3]][3]
    nbytes = packed.layout[spec[1][1]][1] + vb + k * (w + 4) + \
        n * (w + 4 + 1)
    return (lambda: packed.decode_column(buf, i),
            lambda: packed.decode_column(buf, i, plain=True), nbytes)


def _k8a_bytes(packed) -> int:
    """What K8a must move for a batch: each job's packed words and
    validity words read once, its data and validity written once."""
    n = packed.num_rows
    nbytes = 0
    for spec in packed.col_specs:
        if spec[0] == "dict":
            continue
        desc = spec[1] if spec[0] == "fixed" else spec[3]
        if spec[2][0] != "av":
            nbytes += packed.layout[spec[2][1]][1]
        if desc[0] != "raw":
            nbytes += packed.layout[desc[1]][1] + \
                n * np.dtype(desc[3]).itemsize
        nbytes += n
    return nbytes


def _k8a_entry(torch, jobs, n: int, dev):
    """srt_decode_batch alone on a table and outputs prepared once."""
    from spark_rapids_tpu_torch.columnar import wirecodec as WC
    from spark_rapids_tpu_torch.ops import native
    outs = WC.decode_outputs(jobs, n, dev)
    words = WC.decode_table(jobs, outs)
    host, tab = native.param_table(words, len(words) > WC.DECODE_PARAM_WORDS,
                                   dev)
    lib = native.lib("wirecodec")
    args = (host.buffer_info()[0], len(words), len(jobs),
            None if tab is None else tab.data_ptr(), n,
            native.stream_ptr(dev))

    def run(_keep=(host, tab, outs)):
        native.check(lib.srt_decode_batch(*args), "srt_decode_batch")
    return run


def _describe(packed) -> list:
    out = []
    for f, spec in zip(packed.schema, packed.col_specs):
        d = spec[1] if spec[0] != "var" else spec[3]
        enc = d[0] if d[0] == "raw" else f"{d[0]} {d[2]}" + (
            f" x{d[5]}" if d[5] != 1 else "")
        out.append(f"{f.name}: {spec[0]} {enc}"
                   + ("" if spec[2][0] == "av" else " +vbits"))
    return out


def _check_codec_batch(torch, dev, label: str, rb) -> dict:
    """One scan batch as the scan encodes it: K8 against its plain version
    on the card and against the raw upload, exactly; each kernel's time
    summed over the batch's columns, the copy of the encoded and of the
    raw buffer, and the host's encode."""
    from spark_rapids_tpu_torch.columnar import wirecodec as WC
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    t0 = time.perf_counter()
    packed = ColumnBatch.stage_arrow(rb, dev)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = ColumnBatch.stage_arrow(rb, dev, codec=False)
    raw_s = time.perf_counter() - t0
    buf = packed.buf.to(dev, non_blocking=True)
    got = _leaves(packed.decode(buf))
    _k8_same(torch, got, _leaves(packed.decode(buf, plain=True)),
             f"K8 at {label}")
    _k8_same(torch, got, _leaves(raw.to(dev).columns),
             f"K8 at {label} against the raw upload")
    del got
    out = {"decode_dict": [0.0, 0.0, 0, 0], "library_dict_ms": 0.0}
    # K8a: every job of the batch in one launch (PackedBatch.decode's K8a
    # part: its table and the launch), beside the plain per-column decode
    # of the same columns, its C entry point alone and, where the profiler
    # sees device work, its kernel alone
    n = packed.num_rows
    fixed = [i for i, sp in enumerate(packed.col_specs) if sp[0] != "dict"]
    k8a = {"jobs": len(fixed), "ms": 0.0, "plain_ms": 0.0,
           "entry_ms": 0.0, "kernel_ms": None, "bytes": 0}
    if fixed:
        k8a["ms"] = _time_ms(torch, lambda: WC.decode_jobs(
            [j for _i, j in packed.k8a_jobs(buf)], n, dev), reps=20)
        k8a["plain_ms"] = _time_ms(torch, lambda: [
            packed.decode_column(buf, i, plain=True) for i in fixed])
        jobs = [j for _i, j in packed.k8a_jobs(buf)]
        k8a["entry_ms"] = _time_ms(torch, _k8a_entry(torch, jobs, n, dev),
                                   reps=20)
        saved = WC.decode_fixed.launches
        k8a["kernel_ms"] = _one_kernel_ms(
            torch, f"K8a {label}", lambda: WC.decode_jobs(jobs, n, dev),
            "decode_batch_kernel")
        WC.decode_fixed.launches = saved
        k8a["bytes"] = _k8a_bytes(packed)
    out["decode_fixed"] = k8a
    for i in range(len(packed.col_specs)):
        if packed.col_specs[i][0] != "dict":
            continue
        fn, plain, nbytes = _k8b_calls(packed, buf, i)
        acc = out["decode_dict"]
        acc[0] += _time_ms(torch, fn, reps=20)
        acc[1] += _time_ms(torch, plain)
        acc[2] += nbytes
        acc[3] += 1
        spec = packed.col_specs[i]
        idesc, vdesc = spec[1], spec[2]
        vw = None if vdesc[0] == "av" else packed.leaf(buf, vdesc[1])
        params = packed.leaf(buf, packed.params)
        idx = packed.leaf(buf, idesc[1]).long() if idesc[0] == "raw" \
            else WC.decode_fixed(packed.leaf(buf, idesc[1]), vw,
                                 packed.num_rows, idesc[2],
                                 params[idesc[4]:idesc[4] + 1], 1,
                                 torch.int64)[0]
        mat, lens = packed.leaf(buf, spec[3]), packed.leaf(buf, spec[4])
        out["library_dict_ms"] += _time_ms(
            torch, lambda: (mat.index_select(0, idx),
                            lens.index_select(0, idx)), reps=20)
    copy_ms = _time_ms(torch, lambda: packed.buf.to(dev, non_blocking=True),
                       reps=10)
    raw_copy_ms = _time_ms(torch, lambda: raw.buf.to(dev,
                                                     non_blocking=True),
                           reps=10)
    print(f"[K8 {label}] {packed.num_rows} rows: {'; '.join(_describe(packed))}"
          f". Sent {packed.nbytes} bytes encoded against {raw.nbytes} raw "
          f"(decoded leaves {packed.raw_bytes}); copy to the card "
          f"{copy_ms:.4f} ms encoded, {raw_copy_ms:.4f} ms raw; host "
          f"encode {enc_s:.3f} s, raw staging {raw_s:.3f} s; K8a "
          f"{k8a['jobs']} jobs in one launch {k8a['ms']:.4f} ms "
          f"(the C entry alone {k8a['entry_ms']:.4f}, the kernel alone "
          f"{'not measured' if k8a['kernel_ms'] is None else k8a['kernel_ms']}"
          f"; plain {k8a['plain_ms']:.4f}, bound "
          f"{_bound_ms(k8a['bytes']):.4f}); K8b "
          f"{out['decode_dict'][3]} columns {out['decode_dict'][0]:.4f} ms "
          f"(plain {out['decode_dict'][1]:.4f}, bound "
          f"{_bound_ms(out['decode_dict'][2]):.4f}, index_select "
          f"{out['library_dict_ms']:.4f}); equal to the plain versions and "
          "to the raw upload", flush=True)
    return out


def run_codec_phase(torch, dev, sf: float) -> dict:
    """K8 on its stress rows, then on the first scan batch of q1's
    lineitem, of q6's store_sales in the default layout and of
    simple_agg's performance file, as their scans read and encode them;
    returns {kernel: entry} (K8a timed at the q1 batch, K8b at the
    mortgage batch)."""
    from spark_rapids_tpu_torch.bench import mortgage as M
    from spark_rapids_tpu_torch.bench.profile_query import fact_scan
    from spark_rapids_tpu_torch.bench.tpcds_queries import TPCDS_QUERIES
    from spark_rapids_tpu_torch.bench.tpch_queries import q1
    from spark_rapids_tpu_torch.io.scan import _effective_batch_rows
    check_codec_stress(torch, dev)
    torch.cuda.empty_cache()
    session = _cuda_session()
    settings = session.conf.settings
    bench = os.path.join(ROOT, ".bench_data")
    shapes = {
        "q1 lineitem": (q1, os.path.join(bench, f"tpch_sf{sf:g}_seed7"),
                        "lineitem"),
        "q6 store_sales": (TPCDS_QUERIES["q6"][0], os.path.join(
            bench, f"tpcds_sf{Q6_SF:g}_seed42_default"), "store_sales"),
        "simple_agg performance": (
            M.MORTGAGE_QUERIES["simple_agg"], os.path.join(
                bench, f"mortgage_sf{MORTGAGE_SF}_seed7"),
            "Performance_2003Q1"),
    }
    res = {}
    for label, (query, data_dir, table) in shapes.items():
        scan = fact_scan(query(session, data_dir)._prepared(), table)
        rows = _effective_batch_rows(scan.output_schema, settings)
        rb = next(iter(scan._read_file(sorted(scan._files)[0], rows)))
        res[label] = _check_codec_batch(torch, dev, label, rb)
        del rb
        torch.cuda.empty_cache()
    a = res["q1 lineitem"]["decode_fixed"]
    b = res["simple_agg performance"]["decode_dict"]
    if not a["jobs"] or not b[3]:
        raise AssertionError("the q1 batch decoded no K8a job or the "
                             "mortgage batch no K8b column")
    k8a = {f"k8a_{label.split()[0]}_{k}": v for label, r in res.items()
           for k, v in r["decode_fixed"].items() if k != "bytes"}
    k8a.update({f"k8a_{label.split()[0]}_bound_ms":
                _bound_ms(r["decode_fixed"]["bytes"])
                for label, r in res.items()})
    return {
        "decode_fixed": dict(
            name="decode_fixed", route="cuda",
            source="spark_rapids_tpu_torch/csrc/wirecodec.cu",
            replaces="spark_rapids_tpu/columnar/wirecodec.py:104",
            max_abs_err=0.0, ms=a["ms"], plain_ms=a["plain_ms"],
            bound_ms=_bound_ms(a["bytes"]), bound_by="bytes",
            library_ms=None, entry_ms=a["entry_ms"],
            kernel_ms=a["kernel_ms"] if a["kernel_ms"] is not None
            else PHASE3_K8A.get("kernel_ms"),
            kernel_ms_source="phase 11" if a["kernel_ms"] is not None
            else "phase 3 (a synthetic q1 batch)", **k8a),
        "decode_dict": dict(
            name="decode_dict", route="cuda",
            source="spark_rapids_tpu_torch/csrc/wirecodec.cu",
            replaces="spark_rapids_tpu/columnar/batch.py:263",
            max_abs_err=0.0, ms=b[0], plain_ms=b[1],
            bound_ms=_bound_ms(b[2]), bound_by="bytes",
            library_ms=res["simple_agg performance"]["library_dict_ms"])}


# ---------------------------------------------------------------------------
# phase 12: K11 range-partition ids and K12c bounded-frame min/max; the
# round-robin, range and moving-window paths
# ---------------------------------------------------------------------------

#: rows of the K11 and K12c stress batches
PARTITION_STRESS_ROWS = 1 << 24
#: rows of moving_extrema's windows at SF10: the (item, day) groups of
#: store_sales in 2000, measured by the path
MOVING_ROWS = 4_200_000
#: K12c's frames: trailing, centred, following-only (empty at a
#: partition's tail), one row back, wider than any partition (the
#: stress batch's largest partition is 40% of its rows), and the RANGE
#: CURRENT ROW frames over peers
_K12C_FRAMES = [("rows", -6, 0), ("rows", -3, 3), ("rows", 2, 5),
                ("rows", -1, -1), ("rows", -(1 << 23), 1 << 23),
                ("range", 0, 0), ("range", 0, None)]
#: string rows of the K11 stress: shared prefixes, NULs, multi-byte and
#: high bytes, the empty string
_K11_WORDS = [b"", b"a", b"a\x00", b"ab", b"abc", b"abcd", b"abcde",
              "é".encode(), "éa".encode(), b"\xff", b"zzzz", b"b",
              b"the quick brown fox", b"the quick brown fox jumps over",
              b"the quick brown fox jumps over the lazy dog, again",
              "😀 emoji".encode()]


def _k11_string(torch, rng, n: int, w: int, dev, null_p: float = 0.1,
                words=None):
    """A string column of ``n`` rows at matrix width ``w``: rows drawn
    from ``_K11_WORDS`` (cut to ``w`` bytes), null rows zeroed."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    words = words or _K11_WORDS
    vocab = np.zeros((len(words), w), np.uint8)
    lens = np.zeros(len(words), np.int32)
    for i, bs in enumerate(words):
        bs = bs[:w]
        vocab[i, :len(bs)] = np.frombuffer(bs, np.uint8)
        lens[i] = len(bs)
    idx = rng.integers(0, len(words), n)
    valid = rng.random(n) >= null_p
    data = vocab[idx] * valid[:, None]
    return DeviceColumn(torch.from_numpy(data).to(dev),
                        torch.from_numpy(valid).to(dev), T.StringType(),
                        torch.from_numpy(lens[idx] * valid).to(dev))


def _k11_fixed(torch, rng, n: int, kind: str, dev, null_p: float = 0.1):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    valid = rng.random(n) >= null_p
    if kind == "int32":
        v, dt = rng.integers(-1000, 1000, n).astype(np.int32), T.IntegerType()
    elif kind == "low":  # three values: bounds tie
        v, dt = rng.integers(0, 3, n).astype(np.int32), T.IntegerType()
    elif kind == "int64":
        v, dt = rng.integers(-2 ** 62, 2 ** 62, n), T.LongType()
    elif kind == "int8":
        v, dt = rng.integers(-128, 128, n).astype(np.int8), T.ByteType()
    elif kind == "int16":
        v, dt = rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16), \
            T.ShortType()
    elif kind == "bool":
        v, dt = rng.random(n) < 0.5, T.BooleanType()
    else:
        v = rng.choice(np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5,
                                 -2.25, 1e300, -1e-300]), n) \
            * rng.integers(1, 4, n)
        dt = T.DoubleType()
    v = np.where(valid, v, np.zeros((), v.dtype))
    return DeviceColumn(torch.from_numpy(v).to(dev),
                        torch.from_numpy(valid).to(dev), dt)


def _k11_bounds(torch, keys, orders, parts: int):
    """RangePartitioning's bounds of ``keys``: rows at (i * n) // P of
    K1's order, gathered with K3."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.ops import range_partition as RP
    from spark_rapids_tpu_torch.ops.sort import sort_permutation
    n = keys[0].capacity
    perm = sort_permutation(ColumnBatch(keys, n, None, keys[0].device),
                            orders)
    pos = torch.clamp(torch.arange(1, parts, device=perm.device) * n
                      // parts, 0, n - 1)
    return RP.RangeBounds(K.gather_columns(keys, perm[pos]), orders)


def _k11_same(torch, keys, bounds, what: str) -> None:
    from spark_rapids_tpu_torch.ops import range_partition as RP
    got = RP.range_partition_ids(keys, bounds)
    want = RP.range_partition_ids_plain(keys, bounds)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"K11 {what}: {bad} ids differ from the plain "
                             "version")


def _k11_entry_ms(torch, keys, bounds) -> float:
    """K11's C entry point alone, its descriptors and output prepared
    once: the launch and the kernel without the wrapper's Python."""
    from array import array
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops import range_partition as RP
    statics, nfields, fields = bounds.at(bounds.widths(keys))
    host = array("q", RP.key_descriptors(keys, statics))
    out = torch.empty(keys[0].capacity, dtype=torch.int32,
                      device=keys[0].device)
    lib = native.lib("range_partition")
    stream = native.stream_ptr(out.device)
    args = (host.buffer_info()[0], None, len(keys), nfields,
            fields.data_ptr(), bounds.count, out.numel(), out.data_ptr(),
            stream)
    native.check(lib.srt_range_partition(*args), "srt_range_partition")
    if not torch.equal(out, RP.range_partition_ids(keys, bounds)):
        raise AssertionError("K11's C entry point alone gave other ids")
    return _time_ms(torch, lambda: lib.srt_range_partition(*args), reps=50)


def _k11_tied(torch, key, bound_col):
    """Rows of the fixed-width ``key`` whose value equals some bound's
    (null equals null): the rows for which K11 reads the lower keys."""
    tie = key.validity & torch.isin(key.data,
                                    bound_col.data[bound_col.validity])
    if not bool(bound_col.validity.all()):
        tie |= ~key.validity
    return tie


def _k11_bytes(torch, keys, bounds) -> tuple:
    """(bytes, tied rows) K11 must move at ``keys`` against ``bounds``
    (fixed-width top key): the top key's data and validity read once and
    the ids written once; the lower keys' leaves only in the 32-byte
    sectors that hold a row tied with a bound on the top key."""
    n = keys[0].capacity
    tied = _k11_tied(torch, keys[0], bounds.cols[0])
    rows = torch.nonzero(tied).flatten()
    nbytes = _nbytes(_leaves(keys[:1])) + 4 * n
    for leaf in _leaves(keys[1:]):
        row_bytes = leaf.element_size() * (leaf.shape[1] if leaf.dim() > 1
                                           else 1)
        nbytes += 32 * int(torch.unique(rows * row_bytes // 32).numel())
    return nbytes, int(rows.numel())


def check_range_partition(torch, dev, rng, data_dir: str) -> dict:
    """K11 exactly against its plain version: 2^24 stress rows of every
    key type (int8, int16, int32, int64, doubles with NaN/+-0.0/+-inf,
    bools, strings at W 4 to 64) alone and in 2-3-key mixes, both
    directions and null orders, P of 2, 8, 200 and 1024; bounds from a
    wider string column than the rows (three W 64 string keys against W
    16 rows too); rows that tie with the bounds on every key but the
    last; 40 keys, whose descriptors leave the kernel's parameters for a
    device copy; P 1024 with the bounds' fields in global memory; tied
    bounds; an empty batch; and path 2's map batch (one store_sales
    file's date and net paid, P = 8), where it is timed at two keys and
    at one (the date), through the wrapper and the kernel alone
    (torch.profiler, which must see one kernel a call), beside its plain
    version and torch.searchsorted over the date's one packed limb."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.ops import range_partition as RP
    from spark_rapids_tpu_torch.ops.sort import SortOrder, pack_keys
    n = PARTITION_STRESS_ROWS
    cols = {k: _k11_fixed(torch, rng, n, k, dev)
            for k in ("int32", "int64", "double", "bool", "low", "int8",
                      "int16")}
    for w in (4, 16, 64):
        cols[f"s{w}"] = _k11_string(torch, rng, n, w, dev)
    extra = ("s16b", "s16c", "s64b", "s64c")
    for name in extra:
        cols[name] = _k11_string(torch, rng, n, int(name[1:3]), dev)
    cases = [[c] for c in cols if c not in extra] + [
        ["double", "int32"], ["s16", "double"], ["bool", "s64", "int64"],
        ["low", "s4", "double"], ["int64", "low"], ["int8", "int16"],
        ["int16", "s16", "int8"]]
    parts_cycle = (2, 8, 200, 1024)
    checked = 0
    for ci, names in enumerate(cases):
        for di in range(4 if len(names) == 1 else 2):
            asc = [bool((di + j) % 2 == 0) for j in range(len(names))]
            nf = [bool((di // 2 + j) % 2 == 0) for j in range(len(names))]
            orders = [SortOrder(j, a, f) for j, (a, f) in
                      enumerate(zip(asc, nf))]
            keys = [cols[c] for c in names]
            parts = parts_cycle[(ci + di) % 4]
            bounds = _k11_bounds(torch, keys, orders, parts)
            _k11_same(torch, keys, bounds, f"{names} asc={asc} "
                      f"nulls_first={nf} P={parts}")
            checked += 1
    # bounds from a wider batch: W 64 strings against rows at W 16, one
    # key and three string keys
    for names, rows_of in ((["s64"], ["s16"]),
                           (["s64", "int32"], ["s16", "int32"]),
                           (["s64", "s64b", "s64c"], ["s16", "s16b",
                                                      "s16c"])):
        for asc in (True, False):
            orders = [SortOrder(j, asc, not asc) for j in range(len(names))]
            bounds = _k11_bounds(torch, [cols[c] for c in names], orders,
                                 200)
            _k11_same(torch, [cols[c] for c in rows_of], bounds,
                      f"W 16 rows {rows_of} against W 64 bounds {names} "
                      f"asc={asc}")
            checked += 1
    # rows that tie with the bounds on every key but the last: the upper
    # keys have 3 x 2 values, the last is (nearly) unique
    for names in (["low", "bool", "int64"], ["bool", "low", "s64"],
                  ["low", "int8", "double"]):
        orders = [SortOrder(j, j % 2 == 0, True) for j in range(len(names))]
        keys = [cols[c] for c in names]
        bounds = _k11_bounds(torch, keys, orders, 8)
        _k11_same(torch, keys, bounds, f"ties on every key but the last "
                  f"{names}")
        checked += 1
    # 40 keys: the descriptor table leaves the kernel's parameters
    many = ["low", "bool", "int8", "bool", "low"] * 7 + \
        ["int16", "bool", "low", "s4", "int32"]
    orders = [SortOrder(j, j % 3 != 0, j % 2 == 0) for j in range(40)]
    keys = [cols[c] for c in many]
    if len(keys) <= RP.PARAM_KEYS:
        raise AssertionError("K11's device-copy case fits the parameters")
    bounds = _k11_bounds(torch, keys, orders, 8)
    _k11_same(torch, keys, bounds, f"{len(keys)} keys (the descriptors' "
              "device copy)")
    checked += 1
    # P 1024 whose bound fields do not fit in 48 KB of shared memory
    keys = [cols[c] for c in ("low", "s4", "double")]
    orders = [SortOrder(0, True, True), SortOrder(1, False, True),
              SortOrder(2, True, False)]
    bounds = _k11_bounds(torch, keys, orders, 1024)
    _k11_same(torch, keys, bounds, "P 1024, bounds in global memory")
    fields = bounds.at(bounds.widths(keys))[2]
    if fields.numel() * 8 <= RP.SHARED_BYTES:
        raise AssertionError(f"K11's global-bounds case holds "
                             f"{fields.numel() * 8} bytes of fields")
    checked += 1
    # tied bounds (three values, P = 1024) and an empty batch
    keys = [cols["low"]]
    orders = [SortOrder(0, True, True)]
    bounds = _k11_bounds(torch, keys, orders, 1024)
    if int(torch.unique(bounds.cols[0].data).numel()) > 4:
        raise AssertionError("K11 tied-bound case has untied bounds")
    _k11_same(torch, keys, bounds, "tied bounds")
    empty = [K.slice_rows(ColumnBatch(keys, n, None, dev), 0, 0).columns[0]]
    if RP.range_partition_ids(empty, bounds).numel() != 0:
        raise AssertionError("K11 on an empty batch returned ids")
    checked += 2
    del cols, keys, bounds, empty, fields
    torch.cuda.empty_cache()
    # path 2's map batch: the first store_sales file of the default layout
    f = sorted(x for x in os.listdir(os.path.join(data_dir, "store_sales"))
               if x.endswith(".parquet"))[0]
    t = pq.read_table(os.path.join(data_dir, "store_sales", f),
                      columns=["ss_sold_date_sk", "ss_net_paid"])
    b = ColumnBatch.from_arrow(t.combine_chunks().to_batches()[0], dev)
    orders = [SortOrder(0, True, True), SortOrder(1, False)]
    keys = list(b.columns)
    bounds = _k11_bounds(torch, keys, orders, 8)
    _k11_same(torch, keys, bounds, "path 2's map batch")
    rows = b.num_rows
    one = [keys[0]]
    one_bounds = _k11_bounds(torch, one, orders[:1], 8)
    limb = pack_keys(one, orders[:1])[0]
    blimb = pack_keys(one_bounds.cols, orders[:1])[0].contiguous()
    if not torch.equal(torch.searchsorted(blimb, limb, side="left").int(),
                       RP.range_partition_ids(one, one_bounds)):
        raise AssertionError("K11 one-key ids differ from searchsorted over "
                             "the packed limb")

    def two():
        return RP.range_partition_ids(keys, bounds)

    def one_key():
        return RP.range_partition_ids(one, one_bounds)

    def library():
        return torch.searchsorted(blimb, limb, side="left")

    # in turns: two keys, one key, the library call, then again
    ms, one_ms, lib_ms = [], [], []
    for _ in range(2):
        ms.append(_time_ms(torch, two, reps=50))
        one_ms.append(_time_ms(torch, one_key, reps=50))
        lib_ms.append(_time_ms(torch, library, reps=50))
    ms, one_ms, lib_ms = min(ms), min(one_ms), min(lib_ms)
    plain_ms = _time_ms(torch, lambda: RP.range_partition_ids_plain(
        keys, bounds))
    one_plain_ms = _time_ms(torch, lambda: RP.range_partition_ids_plain(
        one, one_bounds))
    c_ms = _k11_entry_ms(torch, keys, bounds)
    one_c_ms = _k11_entry_ms(torch, one, one_bounds)
    kernel_ms = _one_kernel_ms(torch, "K11 two keys", two,
                               "range_ids_kernel")
    one_kernel_ms = _one_kernel_ms(torch, "K11 one key", one_key,
                                   "range_ids_kernel")
    lib_device_ms = _device_ms(torch, library)
    # the top key (data and validity) read once, the ids written once, the
    # net paid only where a row ties a bound's date
    nbytes, tied = _k11_bytes(torch, keys, bounds)
    one_bytes, _ = _k11_bytes(torch, one, one_bounds)

    def fmt(x):
        return "not measured" if x is None else f"{x:.4f}"
    print(f"[K11 range partition] checked {checked} cases exactly against "
          f"the plain version (2^24 stress rows; every key type alone and "
          f"in 2-3-key mixes, int8 and int16 too, both directions and null "
          f"orders, P 2/8/200/1024; W 16 rows against W 64 bounds, three "
          f"string keys too; ties on every key but the last; 40 keys (the "
          f"descriptors' device copy); P 1024 with the bounds in global "
          f"memory; tied bounds; an empty batch) and path 2's map batch; "
          f"timed rows={rows} (date asc nulls first, net paid desc, P=8) "
          f"ms={ms:.4f} (the C entry point alone {c_ms:.4f}, the kernel "
          f"alone {fmt(kernel_ms)}) plain_ms="
          f"{plain_ms:.4f} bound_ms={_bound_ms(nbytes):.4f} ({nbytes} "
          f"bytes: the date, its validity and the ids, the net paid's "
          f"sectors for the {tied} rows tied with a bound's date) "
          f"library_ms=none (the two keys pack into two limbs: no "
          f"one PyTorch call searches them); one key (the date) ms="
          f"{one_ms:.4f} (the C entry point alone {one_c_ms:.4f}, the "
          f"kernel alone {fmt(one_kernel_ms)}) plain_ms="
          f"{one_plain_ms:.4f} bound_ms={_bound_ms(one_bytes):.4f} "
          f"library_ms={lib_ms:.4f} (torch.searchsorted over its one "
          f"packed limb, the packing apart: same ids; its device time "
          f"{fmt(lib_device_ms)}); the best of two rounds in turns, 50 "
          f"calls each", flush=True)
    return dict(name="range_partition_ids", route="cuda",
                source="spark_rapids_tpu_torch/csrc/range_partition.cu",
                replaces="spark_rapids_tpu/exec/partitioning.py:258",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=None, kernel_ms=kernel_ms, entry_ms=c_ms,
                tied_rows=tied, one_key_ms=one_ms,
                one_key_kernel_ms=one_kernel_ms, one_key_entry_ms=one_c_ms,
                one_key_plain_ms=one_plain_ms,
                one_key_bound_ms=_bound_ms(one_bytes),
                one_key_library_ms=lib_ms,
                one_key_library_kernel_ms=lib_device_ms)


def profile_unpack(torch, dev) -> None:
    """One K15b call under torch.profiler, in phase 3 (later in the run
    the tracer has seen no device work): an all-gather's 8 shard
    slices of 4,621,613 int32 rows, top_customers_mesh's destination
    shape; it must run one kernel a call and no copy of its span table.
    A check call: K15b's count is put back, so that phases 3-14 still
    read 0 launches."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    n = 4_621_613
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    col = DeviceColumn(
        torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen, device=dev,
                      dtype=torch.int32),
        torch.rand(n, generator=gen, device=dev) < 0.9, T.IntegerType())
    cuts = [i * n // 8 + (i % 3) for i in range(8)] + [n]
    segs = [[DeviceColumn(col.data[a:b], col.validity[a:b], col.dtype)]
            for a, b in zip(cuts, cuts[1:])]
    counts = [b - a for a, b in zip(cuts, cuts[1:])]
    saved = ME.mesh_unpack.launches
    _k15_bytes_same(torch, ME.mesh_unpack(segs, counts),
                    ME.mesh_unpack_plain(segs, counts), "K15b probe")
    ms = _one_kernel_ms(torch, "K15b probe", lambda: ME.mesh_unpack(
        segs, counts), "unpack_kernel")
    ME.mesh_unpack.launches = saved
    cat_ms = _device_ms(torch, lambda: [
        torch.cat([s[0].data for s in segs]),
        torch.cat([s[0].validity for s in segs])])

    def fmt(x):
        return "not measured" if x is None else f"{x:.4f}"
    print(f"[K15b profile] 8 shard slices, {n} int32 rows, a "
          f"{_k15_table_words(torch, segs, counts)}-word span table: one "
          f"unpack_kernel a call and no copy, the kernel alone {fmt(ms)} "
          f"ms; torch.cat of every leaf {fmt(cat_ms)} ms of device time",
          flush=True)


#: K15a's kernel alone (ms) by column count, from phase 3's profile at
#: the mesh paths' shard shapes (phase 15's profiler sees no device work)
_PACK_PROFILE = {}


def profile_pack(torch, dev) -> None:
    """K15a's kernel alone under torch.profiler, beside K15b's in phase 3
    (later in the run the tracer has seen no device work): a 4,194,304-row
    shard
    (top_customers_mesh's largest) of one int32 column and of three (q6_
    mesh_partitioned's), in K10's order to 8 sections; each call must run
    one pack_kernel and no copy of its table.  Check calls: K15a's and
    K10's counts are put back, so that phases 3-14 still read 0 launches
    of K15a."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    from spark_rapids_tpu_torch.ops import partition as PT
    n = 4_194_304
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    saved = (ME.mesh_pack.launches, PT.group_by_part.launches)
    ids = torch.randint(0, 8, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    perm, counts = PT.partition_order(ids, 8)[:2]
    counts = [int(c) for c in counts.tolist()]
    idx = perm.long()
    for ncols in (1, 3):
        cols = [DeviceColumn(
            torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                          device=dev, dtype=torch.int32),
            torch.rand(n, generator=gen, device=dev) < 0.9, T.IntegerType())
            for _ in range(ncols)]
        buf, _layout = ME.mesh_pack(cols, perm, counts)
        if not torch.equal(buf, ME.mesh_pack_plain(cols, perm, counts)):
            raise AssertionError("K15a probe differs from the plain version")
        ms = _one_kernel_ms(torch, "K15a probe", lambda: ME.mesh_pack(
            cols, perm, counts), "pack_kernel")
        leaves = _leaves(cols)
        lib_ms = _device_ms(torch, lambda: [torch.index_select(t, 0, idx)
                                            for t in leaves])
        _PACK_PROFILE[ncols] = ms

        def fmt(x):
            return "not measured" if x is None else f"{x:.4f}"
        print(f"[K15a profile] {n} rows x {ncols} int32 column(s) into 8 "
              f"sections: one pack_kernel a call and no copy, the kernel "
              f"alone {fmt(ms)} ms; index_select of every leaf {fmt(lib_ms)} "
              f"ms of device time", flush=True)
    ME.mesh_pack.launches, PT.group_by_part.launches = saved


def _k12c_same(torch, W, op, col, lo, hi, what: str) -> None:
    gd, gv = W.frame_min_max(op, col, lo, hi)
    wd, wv = W.frame_min_max_plain(op, col, lo, hi)
    if gd.dtype != wd.dtype or not torch.equal(gv, wv):
        raise AssertionError(f"K12c {what}: validity or type differs")
    if gd.dtype.is_floating_point:  # NaN bit for bit
        as_int = torch.int32 if gd.dtype == torch.float32 else torch.int64
        gd, wd = gd.view(as_int), wd.view(as_int)
    if not torch.equal(gd, wd):
        raise AssertionError(f"K12c {what}: differs from the plain version")


def _moving_batch(torch, rng, dev, n: int):
    """moving_extrema's window input, sorted by (item, day): int32 items
    (56,920), one row per (item, day) of 366 days, day sales as sums of
    1-3 cent prices."""
    import pyarrow as pa
    days = 366
    keys = np.sort(rng.choice(56_920 * days, n, replace=False))
    sales = np.round(np.exp(rng.normal(2.5, 1.0, n)).clip(0.01, 300.0)
                     * rng.integers(1, 4, n), 2)
    return _arrow_batch(torch, dev, {
        "item": pa.array((keys // days + 1).astype(np.int32)),
        "day": pa.array((keys % days + 10957).astype(np.int32)),
        "sales": pa.array(sales)})


def check_frame_min_max(torch, dev, rng) -> dict:
    """K12c exactly against its plain version: min and max over int32,
    int64, f32, f64 and bool on the 2^24-row window stress batch (one 40%
    partition, 30% one-row partitions, all-null and all-NaN partitions,
    NaN, +-inf, -0.0) over every bounded-lower frame of _K12C_FRAMES, and
    at moving_extrema's shape, where it is timed beside its plain version
    and max_pool1d."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import window as W
    stress = _stress_window_batch(torch, rng, dev, PARTITION_STRESS_ROWS)
    seg = W.sorted_segments(stress, (0,), (1,))
    k, v, i = stress.columns[0], stress.columns[2], stress.columns[3]
    all_nan = k.validity & (k.data % 13 == 5)
    vn = torch.where(all_nan, torch.full_like(v.data, float("nan")), v.data)
    cols = {
        "f64": DeviceColumn(vn, v.validity | all_nan, T.DoubleType()),
        "f32": DeviceColumn(vn.float(), v.validity | all_nan,
                            T.FloatType()),
        "int64": i,
        "int32": DeviceColumn((i.data % 100_000).int(), i.validity,
                              T.IntegerType()),
        "bool": DeviceColumn((i.data % 3 == 0) & i.validity, i.validity,
                             T.BooleanType())}
    checked = 0
    for frame in _K12C_FRAMES:
        lo, hi = W._frame_edges(seg, W.WindowFrame(*frame))
        for op in ("min", "max"):
            for name, c in cols.items():
                _k12c_same(torch, W, op, c, lo, hi, f"{op} {name} {frame}")
                checked += 1
    del stress, seg, cols, vn, lo, hi
    torch.cuda.empty_cache()
    n = MOVING_ROWS
    b = _moving_batch(torch, rng, dev, n)
    seg = W.sorted_segments(b, (0,), (1,))
    sales = b.columns[2]
    edges = {}
    for op, frame in (("max", ("rows", -6, 0)), ("min", ("rows", -3, 3)),
                      ("max", ("range", 0, None))):
        edges[frame] = W._frame_edges(seg, W.WindowFrame(*frame))
        _k12c_same(torch, W, op, sales, *edges[frame],
                   f"moving_extrema {op} {frame}")
        checked += 1
    lo, hi = edges[("rows", -6, 0)]
    ms = _time_ms(torch, lambda: W.frame_min_max("max", sales, lo, hi),
                  reps=20)
    plain_ms = _time_ms(torch, lambda: W.frame_min_max_plain(
        "max", sales, lo, hi))
    fwd_ms = _time_ms(torch, lambda: W.frame_min_max(
        "max", sales, *edges[("range", 0, None)]), reps=20)
    x = sales.data.view(1, 1, n)
    lib_ms = _time_ms(torch, lambda: torch.nn.functional.max_pool1d(
        x, 7, stride=1, padding=3), reps=20)
    # value, validity and the two edges read, result and validity written
    nbytes = n * (8 + 1 + 4 + 4) + n * (8 + 1)
    print(f"[K12c frame min/max] checked {checked} (op, type, frame) cases "
          f"exactly against the plain version (2^24 stress rows over "
          f"{len(_K12C_FRAMES)} bounded-lower frames, min and max over "
          f"int32, int64, f32, f64 and bool; moving_extrema's three "
          f"windows); timed rows={n} trailing 7-day max ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={_bound_ms(nbytes):.4f}; "
          f"forward max (RANGE CURRENT ROW .. UNBOUNDED FOLLOWING) "
          f"ms={fwd_ms:.4f}; library_ms=None (no PyTorch call computes "
          f"it; max_pool1d, kernel 7, stride 1, over the same values, "
          f"another function without partition edges or nulls: "
          f"{lib_ms:.4f})", flush=True)
    return dict(name="frame_min_max", route="cuda",
                source="spark_rapids_tpu_torch/csrc/window_range.cu",
                replaces="spark_rapids_tpu/ops/window.py:126",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=None, k12c_max_pool1d_ms=lib_ms)


def reference_top_customers_rr(data_dir: str) -> list[tuple]:
    """top_customers_rr with numpy/pyarrow alone: (customer, purchases,
    max net paid, total net paid) of the 100 customers with the most
    purchases, count descending, key ascending with the null customer
    first."""
    import pyarrow.parquet as pq
    t = pq.read_table(os.path.join(data_dir, "store_sales"),
                      columns=["ss_customer_sk", "ss_net_paid"])
    key, valid = _arrow_col(t, "ss_customer_sk")
    paid, _ = _arrow_col(t, "ss_net_paid")
    key = np.where(valid, key.astype(np.int64), -1)
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    mx = np.full(len(uniq), -np.inf)
    np.maximum.at(mx, inv, paid)
    tot = np.zeros(len(uniq), np.longdouble)
    np.add.at(tot, inv, paid.astype(np.longdouble))
    rows = [(None if u < 0 else int(u), int(c), float(m), float(s))
            for u, c, m, s in zip(uniq, counts, mx, tot)]
    rows.sort(key=lambda r: (-r[1], r[0] is not None, r[0] or 0))
    return rows[:100]


def _check_top_rr(rows, want) -> None:
    if len(rows) != len(want):
        raise AssertionError(f"top_customers_rr: {len(rows)} rows, "
                             f"expected {len(want)}")
    for g, w in zip(rows, want):
        if g[:3] != w[:3] or not abs(g[3] - w[3]) <= F64_RTOL * abs(w[3]):
            raise AssertionError(f"top_customers_rr row {g} != {w} (sums "
                                 f"rtol {F64_RTOL})")


def _runs(sorted_keys) -> np.ndarray:
    """True where a row of the sorted key columns starts a run of equal
    keys."""
    n = len(sorted_keys[0])
    new = np.zeros(n, bool)
    if n:
        new[0] = True
        for k in sorted_keys:
            new[1:] |= k[1:] != k[:-1]
    return new


def _range_counts(new, parts: int) -> list[int]:
    """Rows per partition of a range partitioning of sorted rows (``new``:
    :func:`_runs`) whose bounds sit at (i * n) // P: a row goes above a
    bound only when its key is strictly greater, so a partition ends at
    the last row of its bound's run of equal keys."""
    n = len(new)
    if n == 0 or parts == 1:
        return [n] + [0] * (parts - 1)
    pos = np.clip(np.arange(1, parts) * n // parts, 0, n - 1)
    run_end = np.r_[np.flatnonzero(new)[1:] - 1, n - 1]
    ends = run_end[np.cumsum(new)[pos] - 1] + 1
    return np.diff(np.r_[0, ends, n]).tolist()


def reference_range_store_sales(data_dir: str) -> dict:
    """range_sort_store_sales with numpy alone: rows per partition, and
    the date (-1 for null) and net paid columns in sorted order (date
    ascending, nulls first; net paid descending, never null)."""
    import pyarrow.parquet as pq
    t = pq.read_table(os.path.join(data_dir, "store_sales"),
                      columns=["ss_sold_date_sk", "ss_net_paid"])
    date, valid = _arrow_col(t, "ss_sold_date_sk")
    paid, _ = _arrow_col(t, "ss_net_paid")
    codes = np.where(valid, date.astype(np.int64), -1)
    _u, prank = np.unique(paid, return_inverse=True)  # no -0.0, no NaN
    key = ((codes + 1) << 26) + (int(prank.max()) - prank)
    order = np.argsort(key, kind="stable")
    return {"counts": _range_counts(_runs([key[order]]), 8),
            "date": codes[order], "paid": paid[order]}


def reference_range_customers(data_dir: str) -> dict:
    """range_sort_customer_names with numpy/pyarrow alone: rows per
    partition and the three key columns in sorted order (last name
    ascending, nulls first; first name descending, nulls last; the unique
    customer id ascending).  Strings order by their UTF-8 bytes."""
    import pyarrow.parquet as pq
    t = pq.read_table(os.path.join(data_dir, "customer"),
                      columns=["c_last_name", "c_first_name",
                               "c_customer_id"])
    codes, vals = [], []
    for name in ("c_last_name", "c_first_name", "c_customer_id"):
        py = t.column(name).to_pylist()
        rank = {u.decode(): r for r, u in enumerate(
            sorted({v.encode() for v in py if v is not None}))}
        codes.append(np.array([-1 if v is None else rank[v] for v in py]))
        vals.append(py)
    # a null code of -1 sorts first ascending, and last once negated
    order = np.lexsort((codes[2], -codes[1], codes[0]))
    new = _runs([c[order] for c in codes])
    return {"counts": _range_counts(new, 200),
            "rows": [(vals[0][i], vals[1][i], vals[2][i]) for i in order]}


def reference_moving_extrema(data_dir: str) -> list[tuple]:
    """moving_extrema with numpy alone, in exact cents: per (item, day)
    sums of 2000, then per item the sliding windows over its days (rows
    frames as shifted copies within the item, the forward high as a
    reversed running max per item)."""
    sk, day, _qoy = _dates_of_year_2000(data_dir)
    items, days, sums = _day_sales(data_dir, "store_sales", "ss", sk, day)
    sales = np.rint(sums * 100).astype(np.int64)
    n = len(sales)
    idx = np.arange(n)

    def shifted(k, fill):
        j = np.clip(idx + k, 0, n - 1)
        inside = (idx + k >= 0) & (idx + k < n) & (items[j] == items)
        return np.where(inside, sales[j], fill)

    high7 = np.max([shifted(-k, -1) for k in range(7)], axis=0)
    low7 = np.min([shifted(k, 2 ** 62) for k in range(-3, 4)], axis=0)
    starts = np.flatnonzero(np.r_[True, items[1:] != items[:-1]])
    ends = np.r_[starts[1:], n]
    high_on = np.empty(n, np.int64)
    for a, b in zip(starts, ends):
        high_on[a:b] = np.maximum.accumulate(sales[a:b][::-1])[::-1]
    hi_days = np.add.reduceat((sales == high7).astype(np.int64), starts)
    on_days = np.add.reduceat((sales == high_on).astype(np.int64), starts)
    low_sum = np.add.reduceat(low7, starts)
    return [(int(items[a]), int(h), int(o), float(s) / 100)
            for a, h, o, s in zip(starts, hi_days, on_days, low_sum)]


def _check_moving(rows, want) -> None:
    if len(rows) != len(want):
        raise AssertionError(f"moving_extrema: {len(rows)} rows, expected "
                             f"{len(want)}")
    for g, w in zip(rows, want):
        if g[:3] != w[:3] or not abs(g[3] - w[3]) <= F64_RTOL * abs(w[3]):
            raise AssertionError(f"moving_extrema row {g} != {w} (sums "
                                 f"rtol {F64_RTOL})")


def _host_partitions(parts) -> list:
    """Each partition's batches as (data, validity, lengths) numpy leaves
    per column: the range sorts' result on the host, as a collect would
    bring it (and no device memory held past the run)."""
    return [[b.host_leaves() for b in p] for p in parts]


def _column(part, ci: int) -> list:
    """One column's leaves over a partition's batches."""
    return [leaves[ci] for leaves in part]


def _check_range_store_sales(parts, want) -> None:
    counts = [sum(len(d) for d, _v, _l in _column(p, 0)) for p in parts]
    if counts != want["counts"]:
        raise AssertionError(f"range_sort_store_sales: partition rows "
                             f"{counts}, numpy {want['counts']}")
    date = np.concatenate([np.where(v, d, -1) for p in parts
                           for d, v, _l in _column(p, 0)])
    paid = np.concatenate([d for p in parts for d, _v, _l in _column(p, 1)])
    if not (np.array_equal(date, want["date"])
            and np.array_equal(paid, want["paid"])):
        raise AssertionError("range_sort_store_sales: the partitions read "
                             "in order differ from numpy's sorted keys")


def _check_range_customers(parts, want) -> None:
    counts = [sum(len(v) for _d, v, _l in _column(p, 0)) for p in parts]
    if counts != want["counts"]:
        raise AssertionError(f"range_sort_customer_names: partition rows "
                             f"{counts}, numpy {want['counts']}")

    def strings(leaves):
        return [bytes(d[i, :n[i]]).decode() if v[i] else None
                for d, v, n in leaves for i in range(len(v))]

    cols = [strings([x for p in parts for x in _column(p, ci)])
            for ci in range(3)]
    if list(zip(*cols)) != want["rows"]:
        raise AssertionError("range_sort_customer_names: the partitions "
                             "read in order differ from numpy's sort")


def _exchange_sides(torch, session, plan) -> list:
    """[(exchange, {partition: bytes}, {partition: rows})] of one run of
    the physical ``plan``, read before the context releases them."""
    from spark_rapids_tpu_torch.exec.core import ExecCtx
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    ctx = ExecCtx(device=session.device, conf=session.conf)
    try:
        for _b in plan.execute(ctx):
            pass
        out, stack = [], [plan]
        while stack:
            node = stack.pop()
            stack.extend(reversed(node.children))
            if isinstance(node, ShuffleExchangeExec):
                t = ctx._cache[("shuffle", node.shuffle_id)]
                out.append((node.node_desc(),
                            t.partition_sizes(node.shuffle_id),
                            t.partition_rows(node.shuffle_id)))
        return out
    finally:
        ctx.close()
        torch.cuda.synchronize()


_PARTITION_ENTRIES = ("range_partition_ids", "frame_min_max")


def run_partition_phase(torch, dev, warm: int):
    """K11 and K12c against their plain versions, then top_customers_rr,
    range_sort_store_sales, range_sort_customer_names and moving_extrema
    over the generator's default layout at SF10; (entries, {path:
    launches})."""
    from spark_rapids_tpu_torch.bench import tpcds_gen
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    data_dir = os.path.join(ROOT, ".bench_data",
                            f"tpcds_sf{Q6_SF:g}_seed42_default")
    tables = ("date_dim", "customer", "store_sales")
    t0 = time.perf_counter()
    tpcds_gen.generate_tpcds(data_dir, sf=Q6_SF, seed=42, tables=tables,
                             rows_per_file=DEFAULT_ROWS_PER_FILE)
    print(f"[partition] TPC-DS SF{Q6_SF:g} {list(tables)} ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    entries = {"range_partition_ids": check_range_partition(
        torch, dev, np.random.default_rng(11), data_dir)}
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    entries["frame_min_max"] = check_frame_min_max(
        torch, dev, np.random.default_rng(12))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want_rr = reference_top_customers_rr(data_dir)
    want_ss = reference_range_store_sales(data_dir)
    want_cu = reference_range_customers(data_dir)
    want_mv = reference_moving_extrema(data_dir)
    print(f"[partition] numpy/pyarrow references in "
          f"{time.perf_counter() - t0:.1f} s: store_sales by partition "
          f"{want_ss['counts']}; customers by partition: "
          f"{sum(1 for c in want_cu['counts'] if c == 0)} of 200 empty; "
          f"moving_extrema {len(want_mv)} items", flush=True)
    session = _cuda_session()
    # the range sorts pin the advisory size to 0: the map side is never
    # coalesced into partition 0 (exchange.py tiny-input coalescing)
    pinned = _cuda_session(
        {"spark.sql.adaptive.advisoryPartitionSizeInBytes": 0})
    paths = {}
    maps = _scan_batches(data_dir, "store_sales", ["ss_customer_sk",
                                                   "ss_net_paid"])
    scan_agg = ("sort_permutation", "gather_columns", "segment_aggregate")
    explain = Q.top_customers_rr(session, data_dir).explain()
    if "ShuffleExchangeExec[RoundRobinPartitioning(8)]" not in explain:
        raise AssertionError("top_customers_rr planned no round-robin "
                             "exchange")
    paths["top_customers_rr"] = _drive(
        torch, "top_customers_rr (round-robin repartition)",
        lambda: Q.top_customers_rr(session, data_dir),
        lambda r: _check_top_rr(r, want_rr),
        scan_agg + _SHUFFLE_ENTRIES + _SCAN_ENTRIES, warm,
        ("murmur3_columns", "partition_ids_for_keys") + _MAY_DICT)
    k10 = paths["top_customers_rr"]["group_by_part"]["group_by_part"]
    # the aggregate's hash exchange, where it is not coalesced, hashes
    # (K9) and groups (K10) once per partial batch
    k9 = paths["top_customers_rr"]["partition_ids_for_keys"][
        "partition_ids_for_keys"]
    sides = _exchange_sides(torch, session, Q.top_customers_rr(
        session, data_dir)._prepared())
    rr = [s for s in sides if "RoundRobin" in s[0]]
    rr_rows = list(rr[0][2].values()) if rr else []
    if k10 != maps + k9 or len(rr_rows) != 8 or \
            max(rr_rows) - min(rr_rows) > 1:
        raise AssertionError(f"top_customers_rr: K10 launched {k10} times "
                             f"for {maps} map batches and {k9} hashed "
                             f"partial batches; round-robin rows by "
                             f"partition {rr_rows}")
    print(f"[top_customers_rr] K10 launched {k10} times: once per map "
          f"batch of the round-robin exchange ({maps}; never coalesced) "
          f"and of the aggregate's hash exchange ({k9}, K9 as often); rows "
          f"by partition {rr_rows}; exchanges (bytes, rows by partition): "
          f"{sides}", flush=True)

    def drive_plan(label, build, check, want, expect_k11):
        plan = build(pinned, data_dir)
        print(plan.tree_string(), flush=True)
        got = _drive(
            torch, label, None, lambda r: check(r, want),
            ("sort_permutation", "gather_columns", "group_by_part")
            + _PARTITION_ENTRIES[:1] + _SCAN_ENTRIES, warm, _MAY_DICT,
            run=lambda: _host_partitions(Q.partition_batches(
                pinned, build(pinned, data_dir))),
            describe=lambda r: f"{sum(len(v) for p in r for _d, v, _l in
                                      _column(p, 0))} rows in {len(r)} "
            "partitions, fetched to the host")
        k11 = got["range_partition_ids"]["range_partition_ids"]
        if k11 != expect_k11:
            raise AssertionError(f"{label}: K11 launched {k11} times, "
                                 f"expected once per map batch "
                                 f"({expect_k11})")
        [(desc, sizes, rows)] = _exchange_sides(torch, pinned,
                                                build(pinned, data_dir))
        counts = [rows.get(p, 0) for p in range(len(want["counts"]))]
        print(f"[{label}] K11 launched once per map batch ({k11}); {desc}'s "
              f"map side (advisoryPartitionSizeInBytes pinned to 0, not "
              f"coalesced): {sum(sizes.values())} bytes, rows by partition "
              f"min {min(counts)} max {max(counts)}, "
              f"{counts.count(0)} empty", flush=True)
        return got

    paths["range_sort_store_sales"] = drive_plan(
        "range_sort_store_sales", Q.range_sort_store_sales,
        _check_range_store_sales, want_ss,
        _scan_batches(data_dir, "store_sales",
                      ["ss_sold_date_sk", "ss_net_paid",
                       "ss_ticket_number"]))
    paths["range_sort_customer_names"] = drive_plan(
        "range_sort_customer_names", Q.range_sort_customer_names,
        _check_range_customers, want_cu,
        _scan_batches(data_dir, "customer",
                      ["c_last_name", "c_first_name", "c_customer_id"]))
    explain = Q.moving_extrema(session, data_dir).explain()
    if explain.count("WindowExec") != 3:
        raise AssertionError("moving_extrema planned no three WindowExecs")
    paths["moving_extrema"] = _drive(
        torch, "moving_extrema", lambda: Q.moving_extrema(session, data_dir),
        lambda r: _check_moving(r, want_mv),
        _Q6_ENTRIES + _SHUFFLE_ENTRIES + ("sorted_segments",
                                          "running_or_bounded_agg",
                                          "frame_min_max"), warm,
        ("matched_build_rows", "murmur3_columns", "key_ids",
         "partition_ids_for_keys", "group_by_part") + _MAY_DICT,
        zero=("running_or_bounded_agg",))
    k12c = paths["moving_extrema"]["frame_min_max"]["frame_min_max"]
    if k12c < 3:
        raise AssertionError(f"moving_extrema launched K12c {k12c} times, "
                             "expected at least 3")
    for desc, sizes in _map_side_bytes(torch, Q.moving_extrema(session,
                                                               data_dir)):
        print(f"[moving_extrema exchange] {desc}: map side "
              f"{sum(sizes.values())} bytes, by partition {sizes}",
              flush=True)
    return entries, paths


# ---------------------------------------------------------------------------
# phase 13: the Generate exec -- K14a/K14b (explode of split strings) and
# K14c (explode of arrays); review_words and basket_items
# ---------------------------------------------------------------------------

#: rows of the K14 stress batches
K14_ROWS = 1 << 22
#: the delimiter of the split stress and of review_words
K14_DELIM = 0x20
#: bytes besides the delimiter: NUL, ASCII, ',' and the bytes of 2-, 3-
#: and 4-byte UTF-8 sequences
_K14_OTHER = [0, ord("a"), ord("b"), ord(","), 0xC3, 0xA9, 0xE2, 0x82,
              0xAC, 0xF0, 0x9F, 0x98, 0x80]
#: K14a/K14b stress: width -> (per-row delimiter shares of 256, their
#: weights).  A share of 0 gives pieces as long as the row (the piece
#: width W' is then W); "dense" cases keep every piece short, so that
#: W' is below W; 256 is a row of delimiters only
_K14_SPLIT_CASES = [
    (4, (0, 26, 77, 256), (3, 3, 3, 1)),
    (16, (0, 13, 77, 256), (3, 3, 3, 1)),
    (64, (0, 3, 26, 256), (3, 3, 3, 1)),
    (256, (0, 1, 13, 256), (4, 3, 2, 1)),
    (64, (128,), (1,)),
    (256, (77,), (1,)),
]
#: K14c stress: element dtype name -> widths
_K14_ARRAY_CASES = {"int8": (1, 8), "int32": (1, 16, 64), "int64": (8, 64),
                    "float32": (4, 16), "float64": (1, 64), "bool": (8, 32)}
#: the counters of phase 13's kernels
_GENERATE_ENTRIES = ("split_counts", "split_emit", "array_emit")
#: output rows compared with the plain versions at a time
_K14_CHUNK = 1 << 28


def _k14_strings(torch, gen, n: int, w: int, shares, weights, dev,
                 null_p: float = 0.1):
    """uint8 [n, w] strings on the card: each row's delimiter share drawn
    from ``shares`` (of 256) with ``weights``, lengths 0..w with a tenth
    at w, NULs and UTF-8 bytes, ``null_p`` nulls, zeros past each
    length."""
    other = torch.tensor(_K14_OTHER, dtype=torch.uint8, device=dev)
    probs = torch.tensor(weights, dtype=torch.float64, device=dev)
    share = torch.tensor(shares, device=dev)[
        torch.multinomial(probs, n, replacement=True, generator=gen)]
    data = torch.empty((n, w), dtype=torch.uint8, device=dev)
    step = max(1, (1 << 24) // w)  # rows drawn at a time
    for r in range(0, n, step):
        rows = min(step, n - r)
        data[r:r + rows] = torch.where(
            torch.randint(0, 256, (rows, w), device=dev, generator=gen)
            < share[r:r + rows, None], K14_DELIM,
            other[torch.randint(0, len(_K14_OTHER), (rows, w), device=dev,
                                generator=gen)])
    lengths = torch.randint(0, w + 1, (n,), device=dev, generator=gen)
    lengths = torch.where(torch.rand(n, device=dev, generator=gen) < 0.1,
                          w, lengths)
    valid = torch.rand(n, device=dev, generator=gen) >= null_p
    lengths = torch.where(valid, lengths, 0).to(torch.int32)
    inside = torch.arange(w, device=dev)[None, :] < lengths[:, None]
    return torch.where(inside, data, 0).to(torch.uint8), lengths, valid


def _row_chunks(torch, emit, w: int):
    """[(r0, r1, o0, o1)]: row ranges whose output rows times ``w`` stay
    near _K14_CHUNK, with their output slots."""
    cum = np.concatenate([[0], torch.cumsum(emit.long(), 0).cpu().numpy()])
    per = max(_K14_CHUNK // max(w, 1), 1)
    cuts = np.searchsorted(cum, np.arange(per, cum[-1], per), side="right")
    bounds = [0] + [int(c) - 1 for c in cuts] + [emit.numel()]
    bounds = sorted(set(b for b in bounds if 0 <= b <= emit.numel()))
    return [(a, b, int(cum[a]), int(cum[b])) for a, b in zip(bounds,
                                                             bounds[1:])]


def _k14_split_same(torch, data, lengths, valid, outer: bool, what: str):
    """K14a and K14b against their plain versions, exactly, the plain ones
    over row chunks; returns (total, W')."""
    from spark_rapids_tpu_torch.columnar.column import round_string_width
    from spark_rapids_tpu_torch.ops import generate as GE
    n, w = data.shape
    emit, total, widest = GE.split_counts(data, lengths, valid, K14_DELIM,
                                          outer)
    out_w = round_string_width(widest)
    got = GE.split_emit(data, lengths, valid, K14_DELIM, outer, emit, total,
                        out_w)
    ptot, pwide = 0, 0
    for r0, r1, o0, o1 in _row_chunks(torch, emit, w):
        t = (data[r0:r1], lengths[r0:r1], valid[r0:r1])
        pe, pt, pw = GE.split_counts_plain(*t, K14_DELIM, outer)
        if not torch.equal(pe, emit[r0:r1]):
            raise AssertionError(f"K14a {what}: rows {r0}..{r1} differ "
                                 "from the plain version")
        ptot, pwide = ptot + pt, max(pwide, pw)
        want = GE.split_emit_plain(*t, K14_DELIM, outer, pe, pt, out_w)
        got_c = [x[o0:o1] for x in got]
        got_c[3] = got_c[3] - r0
        for name, a, b in zip(("bytes", "lengths", "validity", "src",
                               "pos"), got_c, want):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"K14b {what}: {name} of rows "
                                     f"{r0}..{r1} differs from the plain "
                                     "version")
    if (ptot, pwide) != (total, widest):
        raise AssertionError(f"K14a {what}: total/widest {total}/{widest}, "
                             f"plain {ptot}/{pwide}")
    return total, out_w


def check_split_explode(torch, dev, words) -> dict:
    """K14a/K14b exactly against their plain versions on the stress
    batches (2^22 rows a case, W 4, 16, 64, 256; nulls, empty strings,
    rows of delimiters only, leading, trailing and consecutive
    delimiters, rows of length W, NULs and UTF-8 bytes; outer off and
    on -- pos is always written; W' below W in the dense cases; an
    all-null batch, whose total is 0) and on review_words' scan batch;
    timed at review_words' batch.  Returns (K14a entry, K14b entry)."""
    from spark_rapids_tpu_torch.columnar.column import round_string_width
    from spark_rapids_tpu_torch.ops import generate as GE
    gen = torch.Generator(device=dev)
    gen.manual_seed(1410)
    cases, narrowed = 0, 0
    for w, shares, weights in _K14_SPLIT_CASES:
        t = _k14_strings(torch, gen, K14_ROWS, w, shares, weights, dev)
        for outer in (False, True):
            total, out_w = _k14_split_same(torch, *t, outer,
                                           f"W={w} shares={shares} "
                                           f"outer={outer}")
            cases += 1
            narrowed += out_w < w
        print(f"[K14a/K14b] stress W={w} shares={shares}: {total} pieces, "
              f"W'={out_w}: equal", flush=True)
        del t
        torch.cuda.empty_cache()
    if not narrowed:
        raise AssertionError("no K14 stress case narrowed W' below W")
    t = _k14_strings(torch, gen, 1 << 16, 16, (13,), (1,), dev, null_p=1.0)
    if GE.split_counts(*t, K14_DELIM, False)[1] != 0 or \
            _k14_split_same(torch, *t, True, "all null")[0] != 1 << 16:
        raise AssertionError("K14 all-null batch: total not 0, or not one "
                             "row a row under outer")
    data, lengths, valid = words
    n, w = data.shape
    for outer in (False, True):
        total, out_w = _k14_split_same(torch, data, lengths, valid, outer,
                                       "review_words batch")
    emit, total, widest = GE.split_counts(data, lengths, valid, K14_DELIM,
                                          False)
    out_w = round_string_width(widest)
    a_ms = _time_ms(torch, lambda: GE.split_counts(
        data, lengths, valid, K14_DELIM, False), reps=20)
    a_plain = _time_ms(torch, lambda: GE.split_counts_plain(
        data, lengths, valid, K14_DELIM, False))
    j = torch.arange(w, device=dev)
    a_lib = _time_ms(torch, lambda: ((data == K14_DELIM) & (
        j[None, :] < lengths[:, None])).sum(1), reps=20)
    b_ms = _time_ms(torch, lambda: GE.split_emit(
        data, lengths, valid, K14_DELIM, False, emit, total, out_w), reps=20)
    b_plain = _time_ms(torch, lambda: GE.split_emit_plain(
        data, lengths, valid, K14_DELIM, False, emit, total, out_w), reps=3)
    # in: the sectors inside the lengths, lengths, validity; K14a writes
    # emit and two int64, K14b reads emit and writes every piece row
    inb = _sector_bytes(torch, lengths, w) + n * 5
    a_bytes = inb + n * 4 + 16
    b_bytes = inb + n * 4 + total * (out_w + 13)
    print(f"[K14a/K14b] checked {cases} stress cases of {K14_ROWS} rows, "
          f"an all-null batch and review_words' batch (both outer modes): "
          f"equal; timed at review_words' batch: rows={n} W={w} "
          f"pieces={total} W'={out_w}; K14a ms={a_ms:.4f} (a host read of "
          f"the total inside) plain_ms={a_plain:.4f} library_ms="
          f"{a_lib:.4f} ((data == d) & in-length).sum(1)) bound_ms="
          f"{_bound_ms(a_bytes):.4f}; K14b ms={b_ms:.4f} (K7's offsets "
          f"scan inside) plain_ms={b_plain:.4f} library_ms=none (no "
          f"PyTorch call splits rows into pieces) bound_ms="
          f"{_bound_ms(b_bytes):.4f}", flush=True)
    src = "spark_rapids_tpu_torch/csrc/generate.cu"
    return (dict(name="split_counts", route="cuda", source=src,
                 replaces="spark_rapids_tpu/exec/generate.py:138",
                 max_abs_err=0.0, ms=a_ms, plain_ms=a_plain,
                 bound_ms=_bound_ms(a_bytes), bound_by="bytes",
                 library_ms=a_lib),
            dict(name="split_emit", route="cuda", source=src,
                 replaces="spark_rapids_tpu/exec/generate.py:149",
                 max_abs_err=0.0, ms=b_ms, plain_ms=b_plain,
                 bound_ms=_bound_ms(b_bytes), bound_by="bytes",
                 library_ms=None))


def _k14_array_same(torch, data, lengths, valid, outer: bool, what: str):
    from spark_rapids_tpu_torch.ops import generate as GE
    emit, total = GE.array_counts(lengths, valid, outer)
    got = GE.array_emit(data, lengths, valid, outer, emit, total)
    for r0, r1, o0, o1 in _row_chunks(torch, emit, 8):
        pe, pt = GE.array_counts(lengths[r0:r1], valid[r0:r1], outer)
        want = GE.array_emit_plain(data[r0:r1], lengths[r0:r1], valid[r0:r1],
                                   outer, pe, pt)
        got_c = [x[o0:o1] for x in got]
        got_c[2] = got_c[2] - r0
        # the elements bit for bit: -0.0 and NaN included
        got_c[0] = got_c[0].view(torch.uint8)
        want = (want[0].view(torch.uint8),) + tuple(want[1:])
        for name, a, b in zip(("elements", "validity", "src", "pos"), got_c,
                              want):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"K14c {what}: {name} of rows "
                                     f"{r0}..{r1} differs from the plain "
                                     "version")
    return total


def _k14_arrays(torch, gen, n: int, w: int, dtype, dev):
    """[n, w] arrays on the card: ~10% null and ~10% empty, lengths 1..w
    else; floats from {0, -0.0, 1.5, NaN, inf, -inf}; zeros past each
    length."""
    if dtype.is_floating_point:
        vals = torch.tensor([0.0, -0.0, 1.5, float("nan"), float("inf"),
                             float("-inf")], dtype=dtype, device=dev)
        data = vals[torch.randint(0, 6, (n, w), device=dev, generator=gen)]
    elif dtype == torch.bool:
        data = torch.randint(0, 2, (n, w), device=dev, generator=gen) > 0
    else:
        info = torch.iinfo(dtype)
        data = torch.randint(max(info.min, -(1 << 40)),
                             min(info.max, 1 << 40), (n, w), device=dev,
                             generator=gen).to(dtype)
    u = torch.rand(n, device=dev, generator=gen)
    lengths = torch.randint(1, w + 1, (n,), device=dev, generator=gen)
    valid = u >= 0.1
    lengths = torch.where(valid & (u >= 0.2), lengths, 0).to(torch.int32)
    inside = torch.arange(w, device=dev)[None, :] < lengths[:, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    return torch.where(inside, data, zero).contiguous(), lengths, valid


def check_array_explode(torch, dev, items) -> dict:
    """K14c exactly against its plain version on 2^22-row stress batches
    (int8, int32, int64, f32 and f64 with NaN and -0.0, bool; W 1 to 64;
    null and empty arrays; outer off and on) and on one basket_items scan
    batch after its filter; timed at that batch."""
    from spark_rapids_tpu_torch.ops import generate as GE
    gen = torch.Generator(device=dev)
    gen.manual_seed(1411)
    cases = 0
    for name, widths in _K14_ARRAY_CASES.items():
        for w in widths:
            t = _k14_arrays(torch, gen, K14_ROWS, w, getattr(torch, name),
                            dev)
            for outer in (False, True):
                _k14_array_same(torch, *t, outer, f"{name} W={w} "
                                f"outer={outer}")
                cases += 1
            del t
        torch.cuda.empty_cache()
    data, lengths, valid = items
    n, w = data.shape
    for outer in (False, True):
        _k14_array_same(torch, data, lengths, valid, outer,
                        "basket_items batch")
    emit, total = GE.array_counts(lengths, valid, False)
    ms = _time_ms(torch, lambda: GE.array_emit(data, lengths, valid, False,
                                               emit, total), reps=20)
    plain_ms = _time_ms(torch, lambda: GE.array_emit_plain(
        data, lengths, valid, False, emit, total))
    j = torch.arange(w, device=dev)
    rows = torch.arange(n, device=dev)

    def library():
        torch.repeat_interleave(rows, emit, output_size=total)
        return data[j[None, :] < lengths[:, None]]

    lib_ms = _time_ms(torch, library, reps=20)
    es = data.element_size()
    # in: the element sectors inside the lengths, lengths, validity and
    # emit; out: element, validity, src and pos a row
    nbytes = _sector_bytes(torch, lengths * es, w * es) + n * 9 + \
        total * (es + 9)
    print(f"[K14c] checked {cases} stress cases of {K14_ROWS} rows and one "
          f"basket_items batch (both outer modes): equal; timed at the "
          f"batch: rows={n} W={w} elements={total} ms={ms:.4f} (K7's "
          f"offsets scan inside) plain_ms={plain_ms:.4f} library_ms="
          f"{lib_ms:.4f} (repeat_interleave of the rows + the in-length "
          f"mask of the elements) bound_ms={_bound_ms(nbytes):.4f}",
          flush=True)
    return dict(name="array_emit", route="cuda",
                source="spark_rapids_tpu_torch/csrc/generate.cu",
                replaces="spark_rapids_tpu/exec/generate.py:90",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes",
                library_ms=lib_ms)


def reference_review_words(data_dir: str) -> list[tuple]:
    """review_words by Python's str.split(" "): (word, uses, average
    rating, first position, last position), by uses descending, then
    word."""
    import pyarrow.parquet as pq
    t = pq.read_table(os.path.join(data_dir, "product_reviews"),
                      columns=["pr_review_rating", "pr_review_content"])
    stats: dict = {}
    for r, text in zip(t.column(0).to_pylist(), t.column(1).to_pylist()):
        if text is None:
            continue
        for k, word in enumerate(text.split(" ")):
            s = stats.get(word)
            if s is None:
                stats[word] = [1, r, k, k]
            else:
                s[0] += 1
                s[1] += r
                s[2] = min(s[2], k)
                s[3] = max(s[3], k)
    return sorted(((w_, c, tot / c, lo, hi) for w_, (c, tot, lo, hi)
                   in stats.items()), key=lambda x: (-x[1], x[0]))


def _check_review_words(rows, want) -> None:
    if len(rows) != len(want):
        raise AssertionError(f"review_words: {len(rows)} words, expected "
                             f"{len(want)}")
    for g, w_ in zip(rows, want):
        if (g[0], g[1], g[3], g[4]) != (w_[0], w_[1], w_[3], w_[4]) or \
                not abs(g[2] - w_[2]) <= F64_RTOL * abs(w_[2]):
            raise AssertionError(f"review_words row {g} != {w_}")


def reference_basket_items(data_dir: str) -> list[tuple]:
    """basket_items from store_sales itself (not the baskets file): every
    ticket's rows in file order, positions within the ticket, tickets of
    at least two rows, joined with item's category; (category, items,
    sum of positions, largest position), nulls first."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.io.scan import _expand_paths
    ss = pa.concat_tables(
        pq.read_table(f, columns=["ss_ticket_number", "ss_item_sk"])
        for f in _expand_paths(os.path.join(data_dir, "store_sales")))
    ticket = ss.column(0).to_numpy()
    item_sk = ss.column(1).to_numpy()
    order = np.argsort(ticket, kind="stable")
    t = ticket[order]
    starts = np.flatnonzero(np.r_[True, t[1:] != t[:-1]])
    size = np.diff(np.r_[starts, t.size])
    pos = np.arange(t.size) - np.repeat(starts, size)
    keep = np.repeat(size >= 2, size)
    items, pos = item_sk[order][keep], pos[keep]
    it = pq.read_table(os.path.join(data_dir, "item"),
                       columns=["i_item_sk", "i_category"])
    sk = it.column(0).to_numpy()
    if np.unique(sk).size != sk.size:
        raise AssertionError("item keys are not unique")
    cats = it.column(1).to_pylist()
    names = sorted(set(cats), key=lambda c: (c is not None, c or ""))
    code = np.array([names.index(c) for c in cats])
    row = _lookup(sk, items)
    hit = row >= 0
    c = code[row[hit]]
    p = pos[hit]
    n = np.bincount(c, minlength=len(names))
    psum = np.bincount(c, weights=p, minlength=len(names))
    pmax = np.full(len(names), -1)
    np.maximum.at(pmax, c, p)
    return [(names[k], int(n[k]), int(psum[k]), int(pmax[k]))
            for k in range(len(names)) if n[k]]


def _path_batch(torch, session, query, data_dir: str, table: str):
    """The first scan batch of ``table`` in ``query``'s plan, read and
    staged as the scan does, on the card."""
    from spark_rapids_tpu_torch.bench.profile_query import fact_scan
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.io.scan import _effective_batch_rows
    scan = fact_scan(query(session, data_dir)._prepared(), table)
    rows = _effective_batch_rows(scan.output_schema, session.conf.settings)
    rb = next(iter(scan._read_file(sorted(scan._files)[0], rows)))
    return ColumnBatch.from_arrow(rb, session.device)


def _check_collections_on_cpu(torch, batch) -> None:
    """GetArrayItem(items, 0) and ArrayContains(items, k) on the card
    against the same expressions on the CPU."""
    from spark_rapids_tpu_torch.expr import (ArrayContains, GetArrayItem,
                                             Size, bind, col, eval_device,
                                             lit)
    cpu = batch.to("cpu")
    k = int(batch.columns[2].data[0, 0])
    for e in (GetArrayItem(col("items"), lit(0)),
              GetArrayItem(col("items"), lit(2)),
              ArrayContains(col("items"), lit(k)), Size(col("items"))):
        b = bind(e, batch.schema)
        got, want = eval_device(b, batch), eval_device(b, cpu)
        if not (torch.equal(got.data.cpu(), want.data)
                and torch.equal(got.validity.cpu(), want.validity)):
            raise AssertionError(f"{e!r} on the card differs from the CPU")
    print(f"[basket_items] GetArrayItem(items, 0|2), ArrayContains(items, "
          f"{k}) and Size(items) over one basket batch ({batch.num_rows} "
          "rows): the card equals the CPU", flush=True)


def run_generate_phase(torch, dev, warm: int):
    """product_reviews and store_baskets at SF10; K14a/K14b and K14c
    against their plain versions; review_words and basket_items cold +
    warm against Python/numpy; (entries, {path: launches})."""
    from spark_rapids_tpu_torch.bench import generate_queries as GQ
    from spark_rapids_tpu_torch.bench.profile_query import fact_scan
    from spark_rapids_tpu_torch.exec.core import collect_device
    from spark_rapids_tpu_torch.ops import kernels as dk
    bench = os.path.join(ROOT, ".bench_data")
    t0 = time.perf_counter()
    rw_dir = GQ.prepare_review_words(bench, Q6_SF)
    bi_dir = GQ.prepare_basket_items(bench, Q6_SF)
    print(f"[generate] SF{Q6_SF:g} product_reviews and store_baskets ready "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    session = _cuda_session()
    rw = _path_batch(torch, session, GQ.review_words, rw_dir,
                     "product_reviews").columns[1]
    entries = dict(zip(("split_counts", "split_emit"), check_split_explode(
        torch, dev, (rw.data, rw.lengths, rw.validity))))
    del rw
    torch.cuda.empty_cache()
    bb = _path_batch(torch, session, GQ.basket_items, bi_dir,
                     "store_baskets")
    _check_collections_on_cpu(torch, bb)
    bb = dk.compact(bb, bb.columns[2].validity & (bb.columns[2].lengths
                                                  >= 2))
    items = bb.columns[2]
    entries["array_emit"] = check_array_explode(
        torch, dev, (items.data, items.lengths, items.validity))
    del bb, items
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want_rw = reference_review_words(rw_dir)
    want_bi = reference_basket_items(bi_dir)
    print(f"[generate] Python/numpy references in "
          f"{time.perf_counter() - t0:.1f} s: {len(want_rw)} words, "
          f"{len(want_bi)} categories", flush=True)
    paths = {}
    for label, build, data_dir, fact, cols, want, check, need, zero in (
            ("review_words", GQ.review_words, rw_dir, "product_reviews",
             ["pr_review_rating", "pr_review_content"], want_rw,
             _check_review_words,
             ("split_counts", "split_emit", "sort_permutation",
              "gather_columns", "segment_aggregate") + _SCAN_ENTRIES,
             ("array_emit",)),
            ("basket_items", GQ.basket_items, bi_dir, "store_baskets",
             ["ticket", "customer", "items"], want_bi,
             lambda r, w_: _check_equal_rows("basket_items", r, w_),
             ("array_emit", "compact", "sort_permutation", "gather_columns",
              "segment_aggregate", "join_probe_fast", "join_expand")
             + _SCAN_ENTRIES, ("split_counts", "split_emit"))):
        held = {}

        def run(build=build, data_dir=data_dir):
            df = build(session, data_dir)
            held["root"] = df._prepared()
            return collect_device(held["root"], df._ctx())

        print(build(session, data_dir).explain(), flush=True)
        got = _drive(torch, label, None, lambda r, c=check, w_=want: c(r, w_),
                     need + zero, warm,
                     _MAY_DICT + ("build_prepare_fast", "matched_build_rows"),
                     zero=zero, run=run,
                     describe=lambda r: f"{len(r)} rows, first {r[:2]}")
        paths[label] = got
        batches = _scan_batches(data_dir, fact, cols)
        k14 = [got[e][e] for e in need if e in _GENERATE_ENTRIES]
        if any(k != batches for k in k14):
            raise AssertionError(f"{label}: K14 launched {k14} times for "
                                 f"{batches} scan batches")
        if label == "basket_items" and got["compact"]["compact"] != batches:
            raise AssertionError("basket_items: K2 did not compact each "
                                 "basket batch once")
        gen_rows = sum(r[1] for r in want)
        split = fact_scan(held["root"], fact).stats.as_dict()
        print(f"[{label}] K14 launched {k14} times, once per scan batch "
              f"({batches}); generate output rows {gen_rows}; last warm "
              f"run's scan of {fact}: {split}", flush=True)
    return entries, paths


# ---------------------------------------------------------------------------
# phase 14: the last string kernels -- K13e-h (trims, length, locate,
# substring_index) and K4s (string min/max); loan_period_span and
# seller_legal_forms over the mortgage files
# ---------------------------------------------------------------------------

#: rows of the K13e-h and K4s stress batches
K13EH_ROWS = 1 << 22
#: rows compared with a plain version at a time
_PLAIN_CHUNK = 1 << 20
#: bytes of the K13e-h stress rows: spaces (thrice as often), the
#: delimiters ',' and '/', NUL, ASCII, the bytes of 2-, 3- and 4-byte
#: UTF-8 sequences and a lone continuation byte
_K13EH_BYTES = [0x20, 0x20, 0x20, ord(","), ord("/"), 0x00, ord("a"),
                ord("b"), 0xC3, 0xA9, 0xE2, 0x82, 0xAC, 0xF0, 0x9F, 0x98,
                0x80]
#: bytes of the K4s stress rows: few, so that prefixes, ties and NUL
#: tails are common
_K4S_BYTES = [0x00, ord("a"), ord("b"), 0xC3, 0xA9, 0xFF]
#: the counters of phase 14's kernels
_STRING_FUNC_ENTRIES = ("trim", "char_length", "locate", "substring_index",
                        "segment_string_min_max")
_TRIM_MODES = ((True, True), (True, False), (False, True))


def _byte_rows(torch, gen, n: int, w: int, alphabet, dev,
               spaces_p: float = 0.0):
    """uint8 [n, w] rows of bytes drawn from ``alphabet`` on the card,
    ``spaces_p`` of them spaces only; lengths 0..w with a tenth at w, a
    tenth null, zeros past every length."""
    table = torch.tensor(alphabet, dtype=torch.uint8, device=dev)
    data = torch.empty((n, w), dtype=torch.uint8, device=dev)
    step = max(1, (1 << 24) // w)  # rows drawn at a time
    for r in range(0, n, step):
        rows = min(step, n - r)
        data[r:r + rows] = table[torch.randint(
            0, len(alphabet), (rows, w), device=dev, generator=gen)]
    if spaces_p:
        data[torch.rand(n, device=dev, generator=gen) < spaces_p] = 0x20
    lengths = torch.randint(0, w + 1, (n,), device=dev, generator=gen)
    lengths = torch.where(torch.rand(n, device=dev, generator=gen) < 0.1,
                          w, lengths)
    valid = torch.rand(n, device=dev, generator=gen) >= 0.1
    lengths = torch.where(valid, lengths, 0).to(torch.int32)
    inside = torch.arange(w, device=dev)[None, :] < lengths[:, None]
    return torch.where(inside, data, 0).to(torch.uint8), lengths, valid


def _chunked_same(torch, got, plain, n: int, what: str) -> None:
    """``got`` (a tensor or a tuple of [n, ...] tensors) equals
    ``plain(r0, r1)`` on every chunk of rows."""
    got = got if isinstance(got, tuple) else (got,)
    for r0 in range(0, n, _PLAIN_CHUNK):
        r1 = min(n, r0 + _PLAIN_CHUNK)
        want = plain(r0, r1)
        want = want if isinstance(want, tuple) else (want,)
        for g, w_ in zip(got, want):
            if g[r0:r1].shape != w_.shape or not torch.equal(g[r0:r1], w_):
                raise AssertionError(f"{what}: rows {r0}..{r1} differ from "
                                     "the plain version")


def _rows_of(ts, r0: int, r1: int):
    return tuple(t[r0:r1] for t in ts)


def _string_funcs_stress(torch, dev) -> int:
    """K13e-h against their plain versions on 2^22-row batches at W 4, 16,
    64 and 256; returns the number of kernel calls compared."""
    from spark_rapids_tpu_torch.ops import strings as OS
    gen = torch.Generator(device=dev)
    gen.manual_seed(1411)
    n, calls = K13EH_ROWS, 0
    for w in (4, 16, 64, 256):
        s = _byte_rows(torch, gen, n, w, _K13EH_BYTES, dev, spaces_p=0.1)
        for left, right in _TRIM_MODES:
            _chunked_same(torch, OS.trim(*s, left, right),
                          lambda a, b: OS.trim_plain(*_rows_of(s, a, b),
                                                     left, right),
                          n, f"K13e stress W{w} {left}/{right}")
        _chunked_same(torch, OS.char_length(*s),
                      lambda a, b: OS.char_length_plain(*_rows_of(s, a, b)),
                      n, f"K13f stress W{w}")
        calls += 4
        for delim in (ord(","), 0x20, 0x00):
            for count in (-3, -1, 0, 1, 2):
                _chunked_same(
                    torch, OS.substring_index(*s, delim, count),
                    lambda a, b: OS.substring_index_plain(
                        *_rows_of(s, a, b), delim, count),
                    n, f"K13h stress W{w} delim {delim} count {count}")
                calls += 1
        needles = [OS.literal_needle(t, dev)
                   for t in ["", "a", " a", "é", "\x80"]]
        if w <= 64:  # the plain version compares every needle byte
            needles.append(OS.literal_needle("x" * (w + 4), dev))
        needles.append(_byte_rows(torch, gen, n, 4, _K13EH_BYTES, dev))
        for nd in needles:
            col = nd[0].shape[0] == n
            for start in ((1, 3) if col else (-1, 1, 2, w // 2, w + 2)):
                _chunked_same(
                    torch, OS.locate(*s, *nd, start),
                    lambda a, b: OS.locate_plain(
                        *_rows_of(s, a, b),
                        *(_rows_of(nd, a, b) if col else nd), start),
                    n, f"K13g stress W{w} needle {nd[0].shape} start "
                    f"{start}")
                calls += 1
        del s, needles
        torch.cuda.empty_cache()
    return calls


def _k4s_stress(torch, dev) -> int:
    """K4s against its plain version on 2^22-row batches at W 4, 16 and
    64: one giant segment, ~1000 segments and one-row segments, min and
    max; returns the number of kernel calls compared."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import segmented as G
    gen = torch.Generator(device=dev)
    gen.manual_seed(1412)
    n, calls = K13EH_ROWS, 0
    for w in (4, 16, 64):
        data, lengths, valid = _byte_rows(torch, gen, n, w, _K4S_BYTES, dev)
        col = DeviceColumn(data, valid, T.StringType(), lengths)
        for groups in (1, 1000, n):
            if groups == n:
                flags = torch.ones(n, dtype=torch.uint8, device=dev)
            else:
                key = torch.sort(torch.randint(0, groups, (n,), device=dev,
                                               generator=gen))[0]
                flags = torch.ones(n, dtype=torch.uint8, device=dev)
                flags[1:] = (key[1:] != key[:-1]).to(torch.uint8)
            starts = torch.nonzero(flags).squeeze(1).to(torch.int32)
            for is_max in (False, True):
                got = G.segment_string_min_max(col, flags, starts, is_max)
                want = G.segment_string_min_max_plain(col, flags, starts,
                                                      is_max)
                _assert_equal_cols(torch, [got], [want],
                                   f"K4s stress W{w} {starts.numel()} "
                                   f"segments max={is_max}")
                calls += 1
        del data, lengths, valid, col
        torch.cuda.empty_cache()
    return calls


def _read_quarters(data_dir: str, sub: str, schema, columns):
    """The named columns of every quarter's file, in quarter order, as
    pyarrow arrays, each row's quarter as an index into the quarter names,
    and the names."""
    import glob
    import pyarrow as pa
    import pyarrow.csv as pc
    at = schema.to_arrow()
    tables, quarters, qnames = [], [], []
    for p in sorted(glob.glob(os.path.join(data_dir, sub, "*.txt_0"))):
        t = pc.read_csv(
            p, read_options=pc.ReadOptions(column_names=at.names),
            parse_options=pc.ParseOptions(delimiter="|"),
            convert_options=pc.ConvertOptions(
                column_types={f.name: f.type for f in at},
                include_columns=columns))
        tables.append(t)
        quarters.append(np.full(t.num_rows, len(qnames), np.int64))
        qnames.append(os.path.basename(p).split(".")[0].split("_")[-1])
    t = pa.concat_tables(tables)
    return ({c: t.column(c).combine_chunks() for c in columns},
            np.concatenate(quarters), qnames)


def _codes(arr):
    """(int64 codes, the distinct python values) of a pyarrow string
    array without nulls."""
    if arr.null_count:
        raise AssertionError("mortgage data: unexpected null strings")
    d = arr.dictionary_encode()
    return (d.indices.to_numpy().astype(np.int64),
            d.dictionary.to_pylist())


def reference_loan_period_span(perf, q, qnames) -> list:
    """loan_period_span with numpy and Python's str.split: the period
    ``YYYY-MM`` of each distinct reporting date, its rank in byte order,
    per (quarter, loan) the least and greatest rank, then per (quarter,
    first rank) the loans and the least and greatest last rank."""
    codes, dates = _codes(perf["monthly_reporting_period"])
    periods = [d.split("/")[-1] + "-" + d.split("/")[0] for d in dates]
    uniq = sorted(set(periods), key=str.encode)
    rank_of = {p: i for i, p in enumerate(uniq)}
    r = np.array([rank_of[p] for p in periods], np.int64)[codes]
    loan = perf["loan_id"].to_numpy()
    o = np.lexsort((loan, q))
    qs, ls, rs = q[o], loan[o], r[o]
    s1 = np.flatnonzero(np.r_[True, (qs[1:] != qs[:-1])
                              | (ls[1:] != ls[:-1])])
    first = np.minimum.reduceat(rs, s1)
    last = np.maximum.reduceat(rs, s1)
    q1 = qs[s1]
    o2 = np.lexsort((first, q1))
    q2, f2, l2 = q1[o2], first[o2], last[o2]
    s2 = np.flatnonzero(np.r_[True, (q2[1:] != q2[:-1])
                              | (f2[1:] != f2[:-1])])
    cnt = np.diff(np.r_[s2, len(q2)])
    lo = np.minimum.reduceat(l2, s2)
    hi = np.maximum.reduceat(l2, s2)
    return [(qnames[q2[i]], uniq[f2[i]], int(c), uniq[a], uniq[b])
            for i, c, a, b in zip(s2, cnt, lo, hi)]


def reference_seller_legal_forms(acq) -> list:
    """seller_legal_forms with Python's str functions over the distinct
    names and numpy counts of each (name, state) pair."""
    ncode, names = _codes(acq["seller_name"])
    scode, states = _codes(acq["property_state"])
    pair, cnt = np.unique(ncode * len(states) + scode, return_counts=True)
    groups: dict = {}
    for p, c in zip(pair.tolist(), cnt.tolist()):
        name, state = names[p // len(states)], states[p % len(states)]
        base = name.split(",")[0].rstrip(" ")
        form = name.split(",")[-1].strip(" ")
        g = groups.setdefault((state, form), [0, None, None, 0, 0, 0])
        g[0] += c
        g[1] = base if g[1] is None else min(g[1], base, key=str.encode)
        g[2] = base if g[2] is None else max(g[2], base, key=str.encode)
        g[3] = max(g[3], len(base))
        g[4] += c * int("BANK" in name)
        g[5] = max(g[5], name.find(",", 1) + 1)
    keys = sorted(groups, key=lambda k: (k[0].encode(), k[1].encode()))
    return [(k[0], k[1], *groups[k]) for k in keys]


def _to_card(torch, dev, arrays: dict):
    """A ColumnBatch of pyarrow arrays on the card."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    return ColumnBatch.from_arrow(pa.record_batch(list(arrays.values()),
                                                  names=list(arrays)), dev)


def check_string_funcs(torch, dev, period_batch, names) -> dict:
    """K13e-h against their plain versions on the stress batches, at path
    A's period batch (K13h at both signs) and at path B's seller names
    (every function of the path); timed at those shapes."""
    from spark_rapids_tpu_torch.ops import strings as OS
    t0 = time.perf_counter()
    calls = _string_funcs_stress(torch, dev)
    stress_s = time.perf_counter() - t0
    p = (period_batch.data, period_batch.lengths, period_batch.validity)
    n = p[0].shape[0]
    for count in (-1, 1):
        _chunked_same(torch, OS.substring_index(*p, ord("/"), count),
                      lambda a, b: OS.substring_index_plain(
                          *_rows_of(p, a, b), ord("/"), count),
                      n, f"K13h period batch count {count}")
    s = (names.data, names.lengths, names.validity)
    m = s[0].shape[0]
    first = OS.substring_index(*s, ord(","), 1)
    last = OS.substring_index(*s, ord(","), -1)
    for got, count in ((first, 1), (last, -1)):
        _chunked_same(torch, got, lambda a, b: OS.substring_index_plain(
            *_rows_of(s, a, b), ord(","), count), m,
            f"K13h seller names count {count}")
    base = OS.trim(*first, False, True)
    form = OS.trim(*last, True, True)
    for got, src, left, right in ((base, first, False, True),
                                  (form, last, True, True)):
        _chunked_same(torch, got, lambda a, b: OS.trim_plain(
            *_rows_of(src, a, b), left, right), m, "K13e seller names")
    _chunked_same(torch, OS.char_length(*base),
                  lambda a, b: OS.char_length_plain(*_rows_of(base, a, b)),
                  m, "K13f base names")
    bank = OS.literal_needle("BANK", dev)
    comma = OS.literal_needle(",", dev)
    for nd, start in ((bank, 1), (comma, 2)):
        _chunked_same(torch, OS.locate(*s, *nd, start),
                      lambda a, b: OS.locate_plain(*_rows_of(s, a, b), *nd,
                                                   start),
                      m, f"K13g seller names start {start}")
    print(f"[string funcs] K13e-h: {calls} stress calls of 2^22 rows (W 4, "
          f"16, 64, 256) in {stress_s:.1f} s, path A's period batch "
          f"({n} x W{p[0].shape[1]}) and path B's {m} seller names "
          f"(W{s[0].shape[1]}): equal to the plain versions", flush=True)
    out = {}
    timed = (
        ("trim", "K13e trim (the forms)",
         lambda: OS.trim(*last, True, True),
         lambda: OS.trim_plain(*last, True, True),
         _sector_bytes(torch, last[1], last[0].shape[1]) + 5 * m
         + _nbytes(form[:2]), "spark_rapids_tpu/expr/strings.py:91"),
        ("char_length", "K13f length (the base names)",
         lambda: OS.char_length(*base),
         lambda: OS.char_length_plain(*base),
         _sector_bytes(torch, base[1], base[0].shape[1]) + 5 * m + 4 * m,
         "spark_rapids_tpu/expr/strings.py:126"),
        ("locate", "K13g locate('BANK', name)",
         lambda: OS.locate(*s, *bank, 1),
         lambda: OS.locate_plain(*s, *bank, 1),
         _sector_bytes(torch, s[1], s[0].shape[1]) + 5 * m + _nbytes(bank)
         + 5 * m,
         "spark_rapids_tpu/expr/strings.py:539"),
        ("substring_index", "K13h substring_index(period, '/', -1)",
         lambda: OS.substring_index(*p, ord("/"), -1),
         lambda: OS.substring_index_plain(*p, ord("/"), -1),
         _sector_bytes(torch, p[1], p[0].shape[1]) + 5 * n + p[0].numel()
         + 4 * n,
         "spark_rapids_tpu/expr/strings.py:612"))
    for name, label, fn, plain, nbytes, replaces in timed:
        ms = _time_ms(torch, fn, reps=20)
        plain_ms = _time_ms(torch, plain)
        print(f"[{label}] ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms=none (no PyTorch call computes it) "
              f"bound_ms={_bound_ms(nbytes):.4f} ({nbytes} bytes)",
              flush=True)
        out[name] = dict(name=name, route="cuda",
                         source="spark_rapids_tpu_torch/csrc/"
                         "string_funcs.cu", replaces=replaces,
                         max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=_bound_ms(nbytes), bound_by="bytes",
                         library_ms=None)
    return out


def _sorted_segments(torch, batch, keys):
    """The batch sorted by ``keys`` (K1 + K3), its segment flags and
    starts."""
    from spark_rapids_tpu_torch.ops.segmented import _cols_differ
    from spark_rapids_tpu_torch.ops.sort import SortOrder, sort_batch
    sb = sort_batch(batch, [SortOrder(k, True, True) for k in keys])
    flag = torch.zeros(sb.num_rows, dtype=torch.bool, device=sb.device)
    flag[0] = True
    for k in keys:
        flag |= _cols_differ(sb.columns[k])
    flags = flag.to(torch.uint8)
    return sb, flags, torch.nonzero(flags).squeeze(1).to(torch.int32)


def check_string_min_max(torch, dev, periods, sellers) -> dict:
    """K4s against its plain version on the stress batches, at path A's
    per-loan shape (every performance row's period, sorted by loan: ~1M
    segments) and at path B's (the base names sorted by state and form:
    ~66 segments); timed at path A's."""
    from spark_rapids_tpu_torch.ops import segmented as G
    t0 = time.perf_counter()
    calls = _k4s_stress(torch, dev)
    stress_s = time.perf_counter() - t0
    shapes = {}
    for label, (batch, keys, ci) in (("A", periods), ("B", sellers)):
        sb, flags, starts = _sorted_segments(torch, batch, keys)
        col = sb.columns[ci]
        for is_max in (False, True):
            _assert_equal_cols(
                torch, [G.segment_string_min_max(col, flags, starts,
                                                 is_max)],
                [G.segment_string_min_max_plain(col, flags, starts,
                                                is_max)],
                f"K4s path {label} max={is_max}")
        shapes[label] = (col, flags, starts)
    col, flags, starts = shapes["A"]
    n, g = col.data.shape[0], starts.numel()
    ms = _time_ms(torch, lambda: G.segment_string_min_max(col, flags, starts,
                                                          False), reps=10)
    plain_ms = _time_ms(torch, lambda: G.segment_string_min_max_plain(
        col, flags, starts, False), reps=3)
    b_col, b_flags, b_starts = shapes["B"]
    ms_b = _time_ms(torch, lambda: G.segment_string_min_max(
        b_col, b_flags, b_starts, False), reps=10)
    w = col.data.shape[1]
    nbytes = _sector_bytes(torch, col.lengths, w) + n * (4 + 1 + 1) + \
        g * 4 + g * (w + 4 + 1)
    print(f"[K4s string min/max] {calls} stress calls of 2^22 rows (W 4, "
          f"16, 64; 1, ~1000 and 2^22 segments) in {stress_s:.1f} s, path "
          f"A ({n} periods in {g} loans, W{w}) and path B "
          f"({b_col.data.shape[0]} base names in {b_starts.numel()} "
          f"groups, W{b_col.data.shape[1]}): equal to the plain version; "
          f"path A ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=none "
          f"(no PyTorch call takes a segmented string min) "
          f"bound_ms={_bound_ms(nbytes):.4f} ({nbytes} bytes); path B "
          f"ms={ms_b:.4f}",
          flush=True)
    return {"segment_string_min_max": dict(
        name="segment_string_min_max", route="cuda",
        source="spark_rapids_tpu_torch/csrc/segmented.cu",
        replaces="spark_rapids_tpu/ops/segmented.py:216", max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, bound_ms=_bound_ms(nbytes),
        bound_by="bytes", library_ms=None)}


def _path_inputs(torch, dev, data_dir: str, perf, acq):
    """Path A's first period scan batch, every period sorted-ready with
    its loan, and path B's names, states, bases and forms, on the card."""
    from spark_rapids_tpu_torch.bench.mortgage_gen import perf_schema
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.io import CsvScanExec
    from spark_rapids_tpu_torch.io.scan import _effective_batch_rows
    from spark_rapids_tpu_torch.ops import strings as OS
    scan = CsvScanExec(os.path.join(data_dir, "perf",
                                    "Performance_2003Q1.txt_0"),
                       schema=perf_schema(), header=False, delimiter="|",
                       columns=["loan_id", "monthly_reporting_period"])
    rows = _effective_batch_rows(scan.output_schema, TorchConf().settings)
    rb = next(iter(scan._read_file(scan._files[0], rows)))
    period_batch = ColumnBatch.from_arrow(rb, dev).columns[1]
    allp = _to_card(torch, dev, {
        "loan_id": perf["loan_id"],
        "p": perf["monthly_reporting_period"]})
    pc = allp.columns[1]
    p = (pc.data, pc.lengths, pc.validity)
    dash = OS.literal_needle("-", dev)
    d, ln, v = OS.concat([OS.substring_index(*p, ord("/"), -1), dash,
                          OS.substring_index(*p, ord("/"), 1)])
    period = DeviceColumn(d, v, T.StringType(), ln)
    periods = ColumnBatch([allp.columns[0], period], allp.num_rows,
                          T.Schema([T.StructField("loan_id", T.LongType()),
                                    T.StructField("period",
                                                  T.StringType())]), dev)
    ab = _to_card(torch, dev, {"seller_name": acq["seller_name"],
                               "property_state": acq["property_state"]})
    names = ab.columns[0]
    s = (names.data, names.lengths, names.validity)
    base = OS.trim(*OS.substring_index(*s, ord(","), 1), False, True)
    form = OS.trim(*OS.substring_index(*s, ord(","), -1), True, True)
    st = T.StringType()
    sellers = ColumnBatch(
        [ab.columns[1], DeviceColumn(form[0], form[2], st, form[1]),
         DeviceColumn(base[0], base[2], st, base[1])], ab.num_rows,
        T.Schema([T.StructField(x, st) for x in ("state", "form", "base")]),
        dev)
    return period_batch, names, (periods, [0], 1), (sellers, [0, 1], 2)


def run_string_funcs_phase(torch, dev, warm: int):
    """K13e-h and K4s against their plain versions, then loan_period_span
    and seller_legal_forms over 1M loans, cold + warm against
    numpy/Python; returns ({kernel: entry}, {path: launches})."""
    from spark_rapids_tpu_torch.bench import mortgage as M
    from spark_rapids_tpu_torch.bench import string_queries as SQ
    from spark_rapids_tpu_torch.bench.mortgage_gen import (acq_schema,
                                                           perf_schema)
    data_dir = os.path.join(ROOT, ".bench_data",
                            f"mortgage_sf{MORTGAGE_SF}_seed7")
    t0 = time.perf_counter()
    made = M.generate_mortgage(data_dir, sf=MORTGAGE_SF, seed=7)
    perf, perf_q, qnames = _read_quarters(
        data_dir, "perf", perf_schema(),
        ["loan_id", "monthly_reporting_period"])
    acq, _q, _names = _read_quarters(data_dir, "acq", acq_schema(),
                                     ["seller_name", "property_state"])
    if qnames != sorted(qnames):
        raise AssertionError(f"quarters out of order: {qnames}")
    want = {"loan_period_span": reference_loan_period_span(perf, perf_q,
                                                           qnames),
            "seller_legal_forms": reference_seller_legal_forms(acq)}
    print(f"[string paths] mortgage sf {MORTGAGE_SF} "
          f"{'generated' if made else 'reused'}; {len(perf_q)} performance "
          f"and {len(acq['seller_name'])} acquisition rows; numpy/Python "
          f"references in {time.perf_counter() - t0:.1f} s: "
          f"{len(want['loan_period_span'])} and "
          f"{len(want['seller_legal_forms'])} rows", flush=True)
    period_batch, names, periods, sellers = _path_inputs(torch, dev,
                                                         data_dir, perf, acq)
    del perf, perf_q, acq
    entries = check_string_funcs(torch, dev, period_batch, names)
    entries.update(check_string_min_max(torch, dev, periods, sellers))
    del period_batch, names, periods, sellers
    torch.cuda.empty_cache()
    session = _cuda_session()
    every = tuple(_counters())
    base = ("sort_permutation", "gather_columns", "segment_aggregate",
            "segment_flags", "segment_string_min_max")
    paths = {}
    # path A's loan ids decode through K8a, its dates through K8b; path
    # B reads two dictionary-encoded string columns (K8b) and no number
    for label, need, maybe in (
            ("loan_period_span",
             base + ("substring_index", "concat", "decode_fixed"),
             _MAY_DICT),
            ("seller_legal_forms",
             base + ("substring_index", "trim", "char_length", "locate",
                     "decode_dict"), ("decode_fixed",))):
        maybe += ("partition_ids_for_keys", "group_by_part", "compact")
        build = SQ.STRING_PATHS[label][0]
        paths[label] = _drive(
            torch, label, lambda b=build: b(session, data_dir),
            lambda r, w_=want[label], lb=label: _check_equal_rows(lb, r,
                                                                  w_),
            every, warm, maybe, _all_but(every, need + maybe),
            describe=lambda r: f"{len(r)} rows, first {r[:2]}")
    return entries, paths


def _check_equal_rows(label: str, rows, want) -> None:
    if rows != want:
        raise AssertionError(f"{label}: rows {rows[:3]}... differ from the "
                             f"numpy evaluation {want[:3]}...")


# ---------------------------------------------------------------------------
# phase 15: the mesh shuffle (K15a pack, K15b unpack) and the mesh paths
# ---------------------------------------------------------------------------

_MESH_ENTRIES = ("mesh_pack", "mesh_unpack")
#: the mesh paths' conf: 8 slots, laid over the card by SRT_VIRTUAL_DEVICES
_MESH_CONF = {"spark.rapids.tpu.mesh.deviceCount": 8}
_MESH_SLOTS = 8
#: string widths of the stress sources, by source index
_K15_WIDTHS = (4, 16, 64, 256, 8, 32, 128, 4)
_K15_ROWS = 1 << 24


def _k15_source(torch, gen, n: int, w: int, dev):
    """A seeded source of ``n`` rows on the card: int8, int16, int32 (and
    a date), int64, f32 and f64 (NaN, -0.0, +-inf), bool and a string of
    width ``w``; ~10% nulls per column, null slots zeroed, string bytes
    zero past the length."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn

    def valid():
        return torch.rand(n, generator=gen, device=dev) >= 0.1

    def fixed(t, dt):
        v = valid()
        return DeviceColumn(torch.where(v, t, torch.zeros((), dtype=t.dtype,
                                                          device=dev)),
                            v, dt)

    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=dtype)

    def floats(dtype):
        x = (torch.randn(n, generator=gen, device=dev) * 1e6).to(dtype)
        special = torch.tensor([float("nan"), -0.0, float("inf"),
                                -float("inf")], dtype=dtype, device=dev)
        pick = torch.rand(n, generator=gen, device=dev) < 0.05
        return torch.where(pick, special[ints(0, 4, torch.int64)], x)

    sv = valid()
    lens = torch.where(sv, ints(0, w + 1, torch.int32),
                       torch.zeros((), dtype=torch.int32, device=dev))
    data = torch.randint(1, 256, (n, w), generator=gen, device=dev,
                         dtype=torch.uint8)
    data[torch.arange(w, device=dev)[None, :] >= lens[:, None]] = 0
    cols = [fixed(ints(-128, 128, torch.int8), T.ByteType()),
            fixed(ints(-2 ** 15, 2 ** 15, torch.int16), T.ShortType()),
            fixed(ints(-2 ** 31, 2 ** 31 - 1, torch.int32), T.IntegerType()),
            fixed(ints(0, 20000, torch.int32), T.DateType()),
            fixed(ints(-2 ** 62, 2 ** 62, torch.int64), T.LongType()),
            fixed(floats(torch.float32), T.FloatType()),
            fixed(floats(torch.float64), T.DoubleType()),
            fixed(torch.rand(n, generator=gen, device=dev) < 0.5,
                  T.BooleanType()),
            DeviceColumn(data, sv, T.StringType(), lens)]
    schema = T.Schema([T.StructField(f"c{i}", c.dtype)
                       for i, c in enumerate(cols)])
    return ColumnBatch(cols, n, schema, dev)


def _k15_bytes_same(torch, got, want, what: str) -> None:
    """Columns equal byte for byte (floats by their bits)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} columns vs {len(want)}")
    for g, w in zip(got, want):
        for a, b in ((g.data, w.data), (g.validity, w.validity),
                     (g.lengths, w.lengths)):
            if (a is None) != (b is None):
                raise AssertionError(f"{what}: lengths differ in presence")
            if a is None:
                continue
            if a.shape != b.shape or not torch.equal(
                    a.contiguous().view(torch.uint8),
                    b.contiguous().view(torch.uint8)):
                raise AssertionError(f"{what}: a column differs from the "
                                     "plain version")


def _k15_check(torch, sources, ids, p: int, what: str,
               branches=None) -> int:
    """K15a and K15b against their plain versions over one exchange of
    ``sources`` by ``ids`` into ``p`` destinations: every send buffer
    byte for byte, every destination's columns; returns the calls and
    adds the K15b tables' branches (:func:`_table_branch`) to
    ``branches``."""
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    from spark_rapids_tpu_torch.ops.partition import partition_order
    from spark_rapids_tpu_torch.parallel.mesh_shuffle import count_matrix
    orders = []
    for b, part in zip(sources, ids):
        if b.num_rows == 0:
            orders.append((torch.empty(0, dtype=torch.int32,
                                       device=b.device),
                           torch.zeros(p, dtype=torch.int32,
                                       device=b.device)))
        else:
            perm, counts, _starts = partition_order(part, p)
            orders.append((perm, counts))
    matrix = count_matrix([c for _perm, c in orders])
    if sum(map(sum, matrix)) != sum(b.num_rows for b in sources):
        raise AssertionError(f"{what}: the count matrix lost rows")
    calls, packs = 0, []
    for s, (b, (perm, _c)) in enumerate(zip(sources, orders)):
        buf, layout = ME.mesh_pack(b.columns, perm, matrix[s])
        want = ME.mesh_pack_plain(b.columns, perm, matrix[s])
        if not torch.equal(buf, want):
            raise AssertionError(f"{what}: source {s}'s send buffer "
                                 "differs from the plain version")
        packs.append((buf, layout))
        calls += 1
    for d in range(p):
        segs = []
        for s, (buf, (sections, blocks)) in enumerate(packs):
            segs.append(ME.section_columns(
                buf[sections[d]:sections[d + 1]], sources[s].columns,
                matrix[s][d], blocks[d], sections[d]))
        counts = [matrix[s][d] for s in range(len(sources))]
        _k15_bytes_same(torch, ME.mesh_unpack(segs, counts),
                        ME.mesh_unpack_plain(segs, counts),
                        f"{what}: destination {d}")
        if branches is not None and sum(counts):
            branches.add(_table_branch(_k15_table_words(torch, segs,
                                                        counts)))
        calls += 1
    return calls


def _k15_table_words(torch, segments, counts) -> int:
    """Words of K15b's span table for one destination (host only)."""
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    out = ME.unpack_outputs(segments, counts, segments[0][0].data.device)
    return len(ME.unpack_plan(segments, counts, out)[0])


def _k15_gather_check(torch, shards, what: str) -> int:
    """K15b over shard columns (an all-gather's segments, no K15a)
    against its plain version; returns the table's words."""
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    segs = [b.columns for b in shards]
    counts = [b.num_rows for b in shards]
    _k15_bytes_same(torch, ME.mesh_unpack(segs, counts),
                    ME.mesh_unpack_plain(segs, counts), what)
    return _k15_table_words(torch, segs, counts)


def _k15_stress(torch, dev) -> int:
    """K15a/K15b exactly against their plain versions on 2^24-row
    exchanges: P 1, 2, 8 and 64; empty sources; every row to one
    destination; a 0-row total; odd row counts a source (unaligned heads
    and tails of 1-, 2-, 4- and 8-byte columns, spans under 16 bytes,
    0-row sources between non-empty ones); a narrower string source
    beside sources of equal W; and K15b alone over shard columns (an
    all-gather: slices at odd row offsets, P 8 and P 4096, whose span
    table leaves the kernel's parameters).  The span tables of the cases
    take all three of the kernel's table branches (small and large
    parameters, a device copy)."""
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    calls = 0
    odd = [1_000_003, 7, 0, 2_000_001, 3, 999_999, 1, 1_048_577]
    cases = (("P=1", 1, [_K15_ROWS], None, _K15_WIDTHS),
             ("P=2", 2, [_K15_ROWS // 4, 3 * _K15_ROWS // 4], None,
              _K15_WIDTHS),
             ("P=8, empty sources", 8,
              [0, _K15_ROWS // 4, _K15_ROWS // 8, 0, _K15_ROWS // 8,
               _K15_ROWS // 4, _K15_ROWS // 8, _K15_ROWS // 8], None,
              _K15_WIDTHS),
             ("P=8, every row to slot 5", 8, [_K15_ROWS // 8] * 8, 5,
              _K15_WIDTHS),
             ("P=64", 64, [_K15_ROWS // 64] * 64, None, _K15_WIDTHS),
             ("P=8, 0 rows", 8, [0] * 8, None, _K15_WIDTHS),
             ("P=8, odd rows a source", 8, odd, None, _K15_WIDTHS),
             ("P=4, a narrower string source", 4,
              [_K15_ROWS // 8 + 5, _K15_ROWS // 8 + 1, _K15_ROWS // 8 + 3,
               _K15_ROWS // 8], None, (64, 64, 16, 64)))
    branches = set()
    for what, p, sizes, only, widths in cases:
        sources = [_k15_source(torch, gen, n, widths[s % len(widths)], dev)
                   for s, n in enumerate(sizes)]
        ids = [torch.full((b.num_rows,), only, dtype=torch.int32,
                          device=dev) if only is not None else
               torch.randint(0, p, (b.num_rows,), generator=gen,
                             device=dev, dtype=torch.int32)
               for b in sources]
        calls += _k15_check(torch, sources, ids, p, what, branches)
        del sources, ids
        torch.cuda.empty_cache()
    # all-gathers of shard columns: slices at odd row offsets
    src = _k15_source(torch, gen, 1 << 22, 32, dev)
    cuts = [0, 3, 3, 1_000_004, 1_000_005, 2_500_001, 2_500_001, 4_000_000,
            1 << 22]
    shards = [K.slice_rows(src, lo, hi) for lo, hi in zip(cuts, cuts[1:])]
    branches.add(_table_branch(_k15_gather_check(
        torch, shards, "all-gather of 8 shard slices")))
    cuts = [0] + sorted(int(x) for x in torch.randint(
        0, 1 << 22, (4095,), generator=gen, device=dev).tolist()) + [1 << 22]
    shards = [K.slice_rows(src, lo, hi) for lo, hi in zip(cuts, cuts[1:])]
    words = _k15_gather_check(torch, shards, "all-gather of 4096 shard "
                              "slices")
    if words <= ME.UNPACK_PARAM_WORDS:
        raise AssertionError(f"K15b's P 4096 table of {words} words fits "
                             "the parameters")
    branches.add(_table_branch(words))
    calls += 2
    if branches != {"small", "large", "device"}:
        raise AssertionError(f"K15b's stress took table branches "
                             f"{sorted(branches)}")
    del src, shards
    torch.cuda.empty_cache()
    return calls


def _table_branch(words: int) -> str:
    """Where K15b's kernel reads a table of ``words`` words
    (csrc/mesh_exchange.cu srt_mesh_unpack)."""
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    if words <= ME.UNPACK_SMALL_WORDS:
        return "small"
    return "large" if words <= ME.UNPACK_PARAM_WORDS else "device"


def _k15_entry_ms(torch, segments, counts) -> float:
    """K15b's C entry point alone, its span table and outputs prepared
    once (a table that fits the kernel's parameters): the launch and the
    kernel without the wrapper's Python."""
    from array import array
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    from spark_rapids_tpu_torch.ops import native
    dev = segments[0][0].data.device
    out = ME.unpack_outputs(segments, counts, dev)
    words, nspans, ntiles = ME.unpack_plan(segments, counts, out)
    if len(words) > ME.UNPACK_PARAM_WORDS:
        raise AssertionError("K15b's timed table does not fit the "
                             "parameters")
    host = array("q", words)
    lib = native.lib("mesh_exchange")
    args = (host.buffer_info()[0], len(words), nspans, ntiles, None,
            native.stream_ptr(dev))
    native.check(lib.srt_mesh_unpack(*args), "srt_mesh_unpack")
    _k15_bytes_same(torch, out, ME.mesh_unpack_plain(segments, counts),
                    "K15b's C entry point alone")
    return _time_ms(torch, lambda: lib.srt_mesh_unpack(*args), reps=20)


def _k15a_entry_ms(torch, cols, perm, counts) -> float:
    """K15a's C entry point alone, its table, its column operands and
    its output prepared once (a table that fits the kernel's
    parameters): the launch and the kernel without the wrapper's
    Python."""
    from array import array
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    from spark_rapids_tpu_torch.ops import native
    dev = perm.device
    layout = ME.pack_layout(cols, counts)
    words, ntiles = ME.pack_plan(cols, counts, layout)
    if len(words) > ME.UNPACK_PARAM_WORDS:
        raise AssertionError("K15a's timed table does not fit the "
                             "parameters")
    host = array("q", words)
    out = torch.empty(layout[0][-1], dtype=torch.uint8, device=dev)
    lib = native.lib("mesh_exchange")
    args = (host.buffer_info()[0], len(words), len(counts), len(cols),
            ntiles, None, perm.data_ptr(), out.data_ptr(),
            native.stream_ptr(dev))
    native.check(lib.srt_mesh_pack(*args), "srt_mesh_pack")
    if not torch.equal(out, ME.mesh_pack_plain(cols, perm, counts)):
        raise AssertionError("K15a's C entry point alone differs from the "
                             "plain version")
    return _time_ms(torch, lambda: lib.srt_mesh_pack(*args), reps=20)


class _K15Recorder:
    """Keeps the arguments of the largest K15a and K15b calls of a path
    (the first of equal size), for checks and times at its shapes; the
    calls themselves run unchanged."""

    def __init__(self):
        self.pack = None
        self.unpack = None

    def __enter__(self):
        from spark_rapids_tpu_torch.exec import mesh_exec as MX
        from spark_rapids_tpu_torch.parallel import mesh_shuffle as MS
        self._mods = (MS, MX)
        self._orig = (MS.mesh_pack, MS.mesh_unpack, MX.mesh_unpack)
        pack, unpack = MS.mesh_pack, MS.mesh_unpack

        def rec_pack(cols, perm, counts):
            if self.pack is None or perm.numel() > self.pack[1].numel():
                self.pack = (list(cols), perm, list(counts))
            return pack(cols, perm, counts)

        def rec_unpack(segments, counts):
            if self.unpack is None or sum(counts) > sum(self.unpack[1]):
                self.unpack = ([list(s) for s in segments], list(counts))
            return unpack(segments, counts)

        MS.mesh_pack, MS.mesh_unpack, MX.mesh_unpack = \
            rec_pack, rec_unpack, rec_unpack
        return self

    def __exit__(self, *exc):
        MS, MX = self._mods
        MS.mesh_pack, MS.mesh_unpack, MX.mesh_unpack = self._orig
        return False


def _k15_time(torch, label: str, rec) -> dict:
    """K15a and K15b at a path's recorded shapes: exact against the plain
    versions, then timed beside their bounds, plain versions and library
    yardsticks (index_select of every leaf by the permutation; torch.cat
    of every leaf of the sources)."""
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    cols, perm, counts = rec.pack
    buf, _layout = ME.mesh_pack(cols, perm, counts)
    if not torch.equal(buf, ME.mesh_pack_plain(cols, perm, counts)):
        raise AssertionError(f"{label}: K15a differs from the plain version")
    segs, ucounts = rec.unpack
    _k15_bytes_same(torch, ME.mesh_unpack(segs, ucounts),
                    ME.mesh_unpack_plain(segs, ucounts),
                    f"{label}: K15b")
    idx = perm.long()
    leaves = _leaves(cols)
    pack_bytes = _nbytes(leaves) + _nbytes([perm]) + buf.numel()

    def pack():
        return ME.mesh_pack(cols, perm, counts)

    def pack_plain_fn():
        return ME.mesh_pack_plain(cols, perm, counts)

    def index_select():
        return [torch.index_select(t, 0, idx) for t in leaves]
    # in turns: kernel, plain, library, then again; the best of two
    ptimes = {pack: [], pack_plain_fn: [], index_select: []}
    for _ in range(2):
        for fn in ptimes:
            ptimes[fn].append(_time_ms(torch, fn, reps=20))
    pack_ms, pack_plain, pack_lib = (min(ptimes[f]) for f in
                                     (pack, pack_plain_fn, index_select))
    pack_entry = _k15a_entry_ms(torch, cols, perm, counts)
    out = ME.mesh_unpack(segs, ucounts)
    seg_leaves = [t for s in segs for t in _leaves(s)]
    unpack_bytes = _nbytes(seg_leaves) + _nbytes(_leaves(out))

    def unpack():
        return ME.mesh_unpack(segs, ucounts)

    def unpack_plain():
        return ME.mesh_unpack_plain(segs, ucounts)

    def cat():
        return [torch.cat([s[j].data for s in segs]) for j in
                range(len(segs[0]))] + \
            [torch.cat([s[j].validity for s in segs]) for j in
             range(len(segs[0]))]
    # in turns: kernel, plain, library, then again; the best of two
    times = {unpack: [], unpack_plain: [], cat: []}
    for _ in range(2):
        for fn in times:
            times[fn].append(_time_ms(torch, fn, reps=20))
    unpack_ms, unpack_plain, unpack_lib = (min(times[f]) for f in
                                           (unpack, unpack_plain, cat))
    unpack_kernel = _one_kernel_ms(torch, f"{label} K15b", unpack,
                                   "unpack_kernel")
    words = _k15_table_words(torch, segs, ucounts)
    unpack_entry = _k15_entry_ms(torch, segs, ucounts)
    n, total = perm.numel(), sum(ucounts)
    print(f"[{label} K15a] one shard, {n} rows x {len(cols)} columns into "
          f"{len(counts)} sections ({buf.numel()} bytes): ms={pack_ms:.4f} "
          f"(the C entry point alone {pack_entry:.4f}; the kernel alone: "
          f"phase 3's profile) plain_ms={pack_plain:.4f} library_ms="
          f"{pack_lib:.4f} (index_select of every leaf) bound_ms="
          f"{_bound_ms(pack_bytes):.4f} ({pack_bytes} bytes); the best of "
          f"two rounds in turns", flush=True)
    alone = "not measured by torch.profiler" if unpack_kernel is None \
        else f"{unpack_kernel:.4f}"
    print(f"[{label} K15b] one destination, {len(segs)} segments, {total} "
          f"rows, a {words}-word span table ({_table_branch(words)}): "
          f"ms={unpack_ms:.4f} (the C entry point alone "
          f"{unpack_entry:.4f}, the kernel alone {alone}) plain_ms="
          f"{unpack_plain:.4f} library_ms={unpack_lib:.4f} (torch.cat of "
          f"every leaf) bound_ms={_bound_ms(unpack_bytes):.4f} "
          f"({unpack_bytes} bytes); the best of two rounds in turns",
          flush=True)
    return {
        "mesh_pack": dict(
            name="mesh_pack", route="cuda",
            source="spark_rapids_tpu_torch/csrc/mesh_exchange.cu",
            replaces="spark_rapids_tpu/parallel/mesh_shuffle.py:70",
            max_abs_err=0.0, ms=pack_ms, plain_ms=pack_plain,
            bound_ms=_bound_ms(pack_bytes), bound_by="bytes",
            library_ms=pack_lib, entry_ms=pack_entry,
            kernel_ms=_PACK_PROFILE.get(len(cols))),
        "mesh_unpack": dict(
            name="mesh_unpack", route="cuda",
            source="spark_rapids_tpu_torch/csrc/mesh_exchange.cu",
            replaces="spark_rapids_tpu/parallel/mesh_shuffle.py:114",
            max_abs_err=0.0, ms=unpack_ms, plain_ms=unpack_plain,
            bound_ms=_bound_ms(unpack_bytes), bound_by="bytes",
            library_ms=unpack_lib, kernel_ms=unpack_kernel,
            entry_ms=unpack_entry)}


def run_mesh_phase(torch, dev, sf: float, warm: int):
    """K15a/K15b exactly against their plain versions on the stress
    exchanges, then top_customers_mesh, q6_mesh, q6_mesh_partitioned and
    q22_mesh over 8 virtual slots on the card, each cold + warm against
    numpy/pyarrow, K15 checked and timed at the paths' shapes; returns
    ({kernel: entry}, {path: launches})."""
    from spark_rapids_tpu_torch.bench.tpcds_queries import (TPCDS_QUERIES,
                                                            top_customers)
    from spark_rapids_tpu_torch.bench.tpch_queries import q22
    from spark_rapids_tpu_torch.parallel.mesh import COUNTERS, reset_counters
    os.environ["SRT_VIRTUAL_DEVICES"] = str(_MESH_SLOTS)
    t0 = time.perf_counter()
    calls = _k15_stress(torch, dev)
    print(f"[mesh] K15a/K15b: {calls} stress calls over 2^24-row "
          f"exchanges (P 1, 2, 8, 64; W {sorted(set(_K15_WIDTHS))} by "
          f"source; empty sources, one destination, 0 rows; odd rows a "
          f"source; a narrower string source beside equal ones) and K15b "
          f"over all-gathers of shard slices (P 8 and 4096) in "
          f"{time.perf_counter() - t0:.1f} s: equal to the plain versions, "
          f"every span-table branch taken", flush=True)
    q6, _tables = TPCDS_QUERIES["q6"]
    tpcds_dir = os.path.join(ROOT, ".bench_data",
                             f"tpcds_sf{Q6_SF:g}_seed42_default")
    tpch_dir = os.path.join(ROOT, ".bench_data", f"tpch_sf{sf:g}_seed7")
    t0 = time.perf_counter()
    want_top = reference_top_customers(tpcds_dir)
    want_q6 = reference_q6(tpcds_dir)
    want_q22, _gap = reference_q22(tpch_dir)
    print(f"[mesh] numpy/pyarrow references in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mesh = _cuda_session(_MESH_CONF)
    part = _cuda_session({**_MESH_CONF,
                          "spark.rapids.tpu.mesh.join.buildThresholdBytes":
                          0})
    every = tuple(_counters())
    base = _MESH_ENTRIES + ("sort_permutation", "gather_columns",
                            "segment_aggregate")
    joins = ("join_search", "join_indices_from_probe")
    specs = (
        ("top_customers_mesh", lambda: top_customers(mesh, tpcds_dir),
         lambda r: _check_equal_rows("top_customers_mesh", r, want_top),
         base + ("partition_ids_for_keys", "group_by_part"),
         ["MeshSortExec", "MeshAggregateExec", "MeshExchangeExec"]),
        ("q6_mesh", lambda: q6(mesh, tpcds_dir),
         lambda r: _check_q6(r, want_q6),
         base + joins + ("partition_ids_for_keys", "group_by_part"),
         ["MeshSortExec", "MeshAggregateExec", "MeshJoinExec"]),
        ("q6_mesh_partitioned", lambda: q6(part, tpcds_dir),
         lambda r: _check_q6(r, want_q6),
         base + joins + ("partition_ids_for_keys", "group_by_part"),
         ["MeshSortExec", "MeshAggregateExec", "MeshJoinExec"]),
        ("q22_mesh", lambda: q22(mesh, tpch_dir),
         lambda r: _check_keyed_doubles("q22_mesh", r, want_q22, 2),
         base + joins + ("partition_ids_for_keys", "group_by_part"),
         ["MeshSortExec", "MeshAggregateExec", "MeshJoinExec"]))
    paths, entries = {}, {}
    for label, make_df, check, need, nodes in specs:
        explain = make_df().explain()
        print(explain, flush=True)
        names = [ln.strip().lstrip("*").strip().split("[")[0]
                 for ln in explain.splitlines()]
        if any(n not in names for n in nodes):
            raise AssertionError(f"{label} planned no {nodes}: {names}")
        reset_counters()
        with _K15Recorder() as rec:
            paths[label] = _drive(
                torch, label, make_df, check, every, warm,
                _all_but(every, need), run=lambda m=make_df: m().collect())
        counters = dict(COUNTERS)
        print(f"[{label}] mesh counters over the cold and warm runs: "
              f"{counters}", flush=True)
        if counters["mesh_send_overflows"] != 0:
            raise AssertionError(f"{label}: mesh_send_overflows "
                                 f"{counters['mesh_send_overflows']}")
        if label == "top_customers_mesh":
            entries = _k15_time(torch, label, rec)
        elif label == "q6_mesh_partitioned":
            _k15_time(torch, label, rec)
        del rec
        torch.cuda.empty_cache()
    return entries, paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=5.0,
                    help="TPC-H scale factor of q1, q14 and q22 (the "
                    "TPC-DS queries run at SF10 always)")
    # two warm runs: the peak-memory check compares the first with the
    # last, and a third cost ~85 s of a run near its 1200 s limit on a slow
    # host
    ap.add_argument("--warm", type=int, default=2,
                    help="warm runs of each query")
    args = ap.parse_args(argv)
    # blocks split to the bytes asked for, so a path's allocated peak does
    # not depend on what earlier runs left in the allocator's cache (with
    # the default, basket_items' peak rose 149,504 bytes from its first
    # warm run to the second, its requested bytes the same); set before
    # torch initialises CUDA
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
    # K14 runs on phase 13's paths only, K13e-h and K4s on phase 14's,
    # K15 on phase 15's: their counters stay 0 until then
    _reset_counters(_GENERATE_ENTRIES + _STRING_FUNC_ENTRIES
                    + _MESH_ENTRIES)
    rng = np.random.default_rng(20261017)
    entries = {}
    entries["compact"] = check_compact(torch, dev, rng)
    q1_batch = _batch(torch, _q1_host_columns(rng, 1 << 24), dev)
    entries["sort_permutation"], perm = check_sort(torch, dev, rng, q1_batch)
    # the mesh kernels alone, while torch.profiler still sees the device
    # (later in a run it has seen no device work)
    profile_unpack(torch, dev)
    profile_pack(torch, dev)
    entries["gather_columns"], sorted_cols = check_gather(torch, dev,
                                                          q1_batch, perm)
    entries["segment_aggregate"] = check_segmented(torch, dev, q1_batch,
                                                   sorted_cols)
    PHASE3_K8A.update(profile_decode(torch, dev))
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
    _C_ENTRIES.install()
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
    torch.cuda.empty_cache()
    mortgage_entries, mortgage_paths = run_mortgage_phase(torch, dev,
                                                          args.warm)
    entries.update(mortgage_entries)
    paths.update(mortgage_paths)
    torch.cuda.empty_cache()
    entries.update(run_codec_phase(torch, dev, args.sf))
    torch.cuda.empty_cache()
    partition_entries, partition_paths = run_partition_phase(torch, dev,
                                                             args.warm)
    entries.update(partition_entries)
    paths.update(partition_paths)
    earlier = {k: v for g in _GENERATE_ENTRIES
               for k, v in _read_counters((g,), "phases 3-12",
                                          _GENERATE_ENTRIES)[g].items()}
    if any(earlier.values()):
        raise AssertionError(f"K14 launched on an earlier path: {earlier}")
    print(f"[generate] K14 launches over phases 3-12: {earlier}",
          flush=True)
    torch.cuda.empty_cache()
    generate_entries, generate_paths = run_generate_phase(torch, dev,
                                                          args.warm)
    entries.update(generate_entries)
    paths.update(generate_paths)
    earlier = {k: v for g in _STRING_FUNC_ENTRIES
               for k, v in _read_counters((g,), "phases 3-13",
                                          _STRING_FUNC_ENTRIES)[g].items()}
    if any(earlier.values()):
        raise AssertionError(f"K13e-h or K4s launched on an earlier path: "
                             f"{earlier}")
    print(f"[string paths] K13e-h and K4s launches over phases 3-13: "
          f"{earlier}", flush=True)
    torch.cuda.empty_cache()
    func_entries, func_paths = run_string_funcs_phase(torch, dev, args.warm)
    entries.update(func_entries)
    paths.update(func_paths)
    earlier = {k: v for g in _MESH_ENTRIES
               for k, v in _read_counters((g,), "phases 3-14",
                                          _MESH_ENTRIES)[g].items()}
    if any(earlier.values()):
        raise AssertionError(f"K15 launched on an earlier path: {earlier}")
    print(f"[mesh] K15a and K15b launches over phases 3-14: {earlier}",
          flush=True)
    torch.cuda.empty_cache()
    mesh_entries, mesh_paths = run_mesh_phase(torch, dev, args.sf,
                                              args.warm)
    entries.update(mesh_entries)
    paths.update(mesh_paths)
    kernels = []
    for name, e in entries.items():
        counters = list(_counters()[name])
        by_path = {p: c[name] for p, c in paths.items() if name in c}
        # every path's cold run, its counts set to 0 just before it
        e["launches"] = sum(c[counters[0]] for c in by_path.values())
        row = {k: e[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        row.update({k: v for k, v in e.items() if k.startswith(
            ("kernel_ms", "entry_ms", "one_key_", "k1_", "k2_", "k3_",
             "k4_", "k5_", "k6_", "k7_", "k8a_", "k10_", "k12c_"))})
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
