"""Where a query's time goes on the card: TPC-H q1, q14 or q22, TPC-DS
q6, q15, q24, q51, q63, q84 or q84_all_cities, the ``top_customers``
repartition, the round-robin, range and moving-window paths
(``top_customers_rr``, ``range_sort_store_sales``,
``range_sort_customer_names``, ``moving_extrema``), the mortgage jobs
simple_agg, percentiles and agg_join, the Generate paths
``review_words`` and ``basket_items`` (``bench/generate_queries.py``), or
the string paths ``loan_period_span`` and ``seller_legal_forms``
(``bench/string_queries.py``, over the mortgage files).

Runs the query through ``TorchSession()`` on CUDA over data generated by
``bench/tpch_gen.py`` (the TPC-H query's tables), ``bench/tpcds_gen.py``
(the TPC-DS query's tables), ``bench/mortgage_gen.py`` (``--sf``
thousand loans, 1000 by default, seed 7) or ``bench/tpcxbb_gen.py`` and
``generate_queries.write_baskets`` (product_reviews; store_baskets from
the default layout's store_sales), reused when present, then:

* times a cold and a warm run (host clock, ending in a device
  synchronise), each building the query -- so q6's and q24's scalar
  subqueries, collected while the query is built, are inside the time;
* records the warm run's peak device memory;
* times the largest scan alone (host decode and encode, one copy and the
  K8 decode per batch), draining the planned tree's scan of the fact
  table (lineitem for q1 and q14, orders for q22, catalog_sales for q15,
  store_returns for q84 and q84_all_cities, store_sales for the other
  TPC-DS queries, the first quarter's performance file for the mortgage
  jobs and loan_period_span, the first quarter's acquisition file for
  seller_legal_forms, product_reviews and store_baskets for the Generate
  paths), and
  splits it: pyarrow's decode and the encode seconds on the
  prefetch thread, the bytes sent against the raw leaves', and, from a
  second drain under ``torch.profiler``, the device time of the copies
  to the card and of K8a and K8b;
* records one more warm run under ``torch.profiler`` and sums the device
  time of every CUDA kernel and copy, giving the device's busy share of
  the run, the kernels that take most of it, and K8's, K14's, K13e-h's,
  K4s's, K15's and the copies' share.

The mesh paths run through ``--conf spark.rapids.tpu.mesh.deviceCount=8``
with ``SRT_VIRTUAL_DEVICES=8`` in the environment (8 slots on the card):
``--query repartition --layout default`` is top_customers_mesh, ``--query
q6 --layout default`` q6_mesh (add
``--conf spark.rapids.tpu.mesh.join.buildThresholdBytes=0`` for
q6_mesh_partitioned) and ``--query q22`` q22_mesh.

The wire codec follows ``SRT_WIRE_CODEC`` (on unless ``0``), so an A/B of
the codec runs this script with and without ``SRT_WIRE_CODEC=0``, in
turns, in one call.

``--layout onefile`` (q6's default here) writes one parquet file per
table, so q6 plans no exchange; ``--layout default`` writes the
generator's 2^20-row files, so the scan has 8 partitions and the grouped
aggregate runs partial -> exchange -> final (the repartition query, the
partition paths and the queries q15, q24, q51, q63, q84 and
q84_all_cities always read this layout).  ``--conf key=value`` sets a
session conf, e.g. ``spark.sql.adaptive.enabled=false``.  The range sorts
are physical plans run partition by partition, with
``spark.sql.adaptive.advisoryPartitionSizeInBytes`` at 0 unless set, so
that their map side is not coalesced.

Prints one JSON line.  Usage, from the repo root on a machine with a card:

    python -m spark_rapids_tpu_torch.bench.profile_query --query q6 --sf 10
    python -m spark_rapids_tpu_torch.bench.profile_query --query q6 \
        --layout default --conf spark.sql.adaptive.enabled=false
    python -m spark_rapids_tpu_torch.bench.profile_query --query repartition
    python -m spark_rapids_tpu_torch.bench.profile_query --query q51
    python -m spark_rapids_tpu_torch.bench.profile_query \
        --query range_sort_store_sales
    python -m spark_rapids_tpu_torch.bench.profile_query --query q22
    python -m spark_rapids_tpu_torch.bench.profile_query --query q24
    python -m spark_rapids_tpu_torch.bench.profile_query --query percentiles
    python -m spark_rapids_tpu_torch.bench.profile_query --query review_words
    python -m spark_rapids_tpu_torch.bench.profile_query \
        --query loan_period_span
    SRT_WIRE_CODEC=0 python -m spark_rapids_tpu_torch.bench.profile_query \
        --query q1
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.bench import mortgage, tpcds_gen, tpch_gen
from spark_rapids_tpu_torch.bench.generate_queries import GENERATE_PATHS
from spark_rapids_tpu_torch.bench.string_queries import STRING_PATHS
from spark_rapids_tpu_torch.bench.tpcds_queries import (PARTITION_PATHS,
                                                        TPCDS_QUERIES,
                                                        partition_batches,
                                                        top_customers)
from spark_rapids_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from spark_rapids_tpu_torch.columnar.batch import _CODEC_DEFAULT
from spark_rapids_tpu_torch.exec.core import ExecCtx
from spark_rapids_tpu_torch.io import FileScanExec

#: the TPC-H tables of q14 and q22 beside lineitem, written in one call
#: (as chip_smoke.py writes them)
TPCH_OTHER = ("customer", "orders", "part")
#: TPC-H query -> (the table groups it reads, one generator call each; its
#: largest table)
_TPCH = {"q1": ((("lineitem",),), "lineitem"),
         "q14": ((("lineitem",), TPCH_OTHER), "lineitem"),
         "q22": ((TPCH_OTHER,), "orders")}

_MORTGAGE = ("simple_agg", "percentiles", "agg_join")
#: the conf that keeps a range exchange's map side from being coalesced
_ADVISORY = "spark.sql.adaptive.advisoryPartitionSizeInBytes"

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def fact_scan(node, table: str):
    """The plan's scan of ``table`` (the first one, depth first)."""
    stack = [node]
    while stack:
        node = stack.pop()
        if isinstance(node, FileScanExec) and any(
                os.path.basename(os.path.dirname(f)) == table
                or os.path.basename(f).startswith(table)
                for f in node._files):
            return node
        stack.extend(reversed(node.children))
    raise ValueError(f"no scan of {table} in the plan")


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _device_ops(fn):
    """[(device us, name, calls)] of every device-side event (kernels,
    copies, memsets) of one call of ``fn`` under torch.profiler, and the
    call's wall seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # a CPU op's own device-time column repeats its kernels' time
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    return rows, wall


def _ms_of(rows, *needles) -> float:
    return sum(us for us, k, _c in rows if any(x in k for x in needles)) \
        / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--query",
                    choices=("q1", "q14", "q22", "q6", "q15", "q24", "q51",
                             "q63", "q84", "q84_all_cities", "repartition")
                    + tuple(PARTITION_PATHS) + _MORTGAGE
                    + tuple(GENERATE_PATHS) + tuple(STRING_PATHS),
                    default="q6")
    ap.add_argument("--sf", type=float, default=None,
                    help="scale factor (default 10); for the mortgage "
                    "jobs thousands of loans (default 1000)")
    ap.add_argument("--layout", choices=("onefile", "default"),
                    default="onefile",
                    help="TPC-DS file layout (every TPC-DS query but q6: "
                    "always default)")
    ap.add_argument("--conf", action="append", default=[],
                    metavar="KEY=VALUE", help="a session conf entry")
    ap.add_argument("--top", type=int, default=12,
                    help="kernels listed by device time")
    args = ap.parse_args(argv)
    bench = os.path.join(_ROOT, ".bench_data")
    if args.sf is None:
        args.sf = 1000.0 if args.query in _MORTGAGE + tuple(STRING_PATHS) \
            else 10.0
    if args.query in _MORTGAGE + tuple(STRING_PATHS):
        data_dir = os.path.join(bench, f"mortgage_sf{args.sf:g}_seed7")
        mortgage.generate_mortgage(data_dir, sf=args.sf, seed=7)
        if args.query in STRING_PATHS:
            query, table = STRING_PATHS[args.query]
            fact = (table, None)
        else:
            query = mortgage.MORTGAGE_QUERIES[args.query]
            fact = ("Performance_2003Q1", None)
    elif args.query in GENERATE_PATHS:
        query, prepare, table = GENERATE_PATHS[args.query]
        data_dir = prepare(bench, args.sf)
        fact = (table, None)
        # the baskets sit beside store_sales in the default layout
        args.layout = "default" if args.query == "basket_items" \
            else "onefile"
    elif args.query in _TPCH:
        data_dir = os.path.join(bench, f"tpch_sf{args.sf:g}_seed7")
        groups, big = _TPCH[args.query]
        for tables in groups:
            tpch_gen.generate_tpch(data_dir, sf=args.sf, seed=7,
                                   tables=tables)
        query = TPCH_QUERIES[args.query]
        fact = (big, tpch_gen.table_row_counts(args.sf)[big])
    else:
        query, tables = PARTITION_PATHS.get(args.query) or TPCDS_QUERIES[
            args.query if args.query in TPCDS_QUERIES else "q6"]
        if args.query == "repartition":
            query = top_customers
        if args.query != "q6":
            args.layout = "default"
        data_dir = os.path.join(
            bench, f"tpcds_sf{args.sf:g}_seed42_{args.layout}")
        tpcds_gen.generate_tpcds(
            data_dir, sf=args.sf, seed=42, tables=tables,
            rows_per_file=1 << 40 if args.layout == "onefile" else 1 << 20)
        big = {"q15": "catalog_sales", "q84": "store_returns",
               "q84_all_cities": "store_returns",
               "range_sort_customer_names": "customer"}.get(args.query,
                                                            "store_sales")
        fact = (big, tpcds_gen.table_row_counts(args.sf)[big])
    conf = dict(kv.split("=", 1) for kv in args.conf)
    if args.query.startswith("range_sort"):
        conf.setdefault(_ADVISORY, 0)
    session = TorchSession(conf)

    def plan():
        q = query(session, data_dir)
        return q._prepared() if hasattr(q, "_prepared") else q

    def run():
        q = query(session, data_dir)
        if hasattr(q, "collect"):
            return q.collect()
        return partition_batches(session, q)

    cold = _timed(run)
    torch.cuda.reset_peak_memory_stats()
    warm = _timed(run)
    peak = torch.cuda.max_memory_allocated()
    ctx = ExecCtx(device=session.device, conf=session.conf)
    scan = fact_scan(plan(), fact[0])
    # the batches are held on the card until the scan ends
    scanned = []
    scan.stats.reset()
    scan_s = _timed(lambda: scanned.extend(scan.execute(ctx)))
    scan_rows = sum(b.num_rows for b in scanned)
    split = scan.stats.as_dict()
    del scanned
    scan_ops, _w = _device_ops(lambda: [None for _b in scan.execute(ctx)])
    split.update(copy_to_card_ms=_ms_of(scan_ops, "HtoD"),
                 k8a_ms=_ms_of(scan_ops, "decode_batch_kernel"),
                 k8b_ms=_ms_of(scan_ops, "decode_dict_kernel"))

    rows, prof_wall = _device_ops(run)
    device_us = sum(us for us, _k, _c in rows)
    out = {
        "card": torch.cuda.get_device_name(0),
        "query": args.query, "sf": args.sf, "layout": args.layout,
        "conf": args.conf, "wire_codec": _CODEC_DEFAULT,
        f"{fact[0]}_rows": fact[1], "scan_rows": scan_rows,
        "cold_s": cold, "warm_s": warm, "warm_peak_bytes": peak,
        "scan_only_s": scan_s, "scan_split": split,
        "profiled_wall_s": prof_wall,
        "device_busy_s": device_us / 1e6 if rows else None,
        "device_busy_share": (device_us / 1e6 / prof_wall) if rows else None,
        "copy_to_card_ms": _ms_of(rows, "HtoD"),
        "k8a_ms": _ms_of(rows, "decode_batch_kernel"),
        "k8b_ms": _ms_of(rows, "decode_dict_kernel"),
        "k14_ms": _ms_of(rows, "split_counts_kernel", "split_emit_kernel",
                         "array_emit_kernel"),
        "k13eh_ms": _ms_of(rows, "slice_kernel", "length_kernel",
                           "locate_kernel"),
        "k4s_ms": _ms_of(rows, "MinMaxS"),
        "k15_ms": _ms_of(rows, "srt_mesh::"),
        "top_device_ops": [{"name": k[:80], "calls": c, "ms": us / 1e3}
                           for us, k, c in rows[:args.top]],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
