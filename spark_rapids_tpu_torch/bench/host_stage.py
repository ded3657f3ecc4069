"""Host staging of one scan batch, and the bit packer against the
reference's.

``ColumnBatch.stage_arrow`` is the scan's prefetch-thread work: the wire
codec's encode (or the raw leaves) into one pinned buffer.  Inside a scan
it shares the host with the consumer thread; this script times it alone,
on one 2^20-row batch of q1's lineitem columns and one of q6's
store_sales columns (data from ``bench/tpch_gen.py`` and
``bench/tpcds_gen.py`` at SF1 in ``.bench_data/``, reused when there),
with the codec on and off, and the same plus the buffer's copy to the
card.  It also times ``wirecodec.pack_bits_host`` at every bucketed width
against the reference's block packer (a shift/or over blocks of
lcm(bits, 32) bits, ``spark_rapids_tpu/columnar/wirecodec.py:64-101``,
copied below as the yardstick), and checks that both write the same
words.

Prints one JSON line (milliseconds: min and median of 15 calls after 3).
Usage, from the repo root on a machine with a card:

    python3 -m spark_rapids_tpu_torch.bench.host_stage
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time
from math import gcd

import numpy as np
import pyarrow.parquet as pq
import torch

from spark_rapids_tpu_torch.bench import tpcds_gen, tpch_gen
from spark_rapids_tpu_torch.columnar import wirecodec as wc
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROWS = 1 << 20
Q1_COLUMNS = ["l_returnflag", "l_linestatus", "l_quantity",
              "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
Q6_COLUMNS = ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk"]


def block_pack(vals: np.ndarray, bits: int) -> np.ndarray:
    """The reference's packer for ``len(vals)`` slots: value j of a block
    of lcm(bits, 32) bits starts at bit j*bits, so no value crosses a
    block and each of the block's values is one vectorised shift/or."""
    n = vals.shape[0]
    nwords = wc.packed_words(n, bits)
    if bits in (8, 16, 32):
        buf = np.zeros(nwords * (32 // bits), dtype=f"<u{bits // 8}")
        buf[:n] = vals
        return buf.view(np.uint32)
    lcm = bits * 32 // gcd(bits, 32)
    g, wpb = lcm // bits, lcm // 32
    nblocks = (nwords + wpb - 1) // wpb
    padded = np.zeros(nblocks * g, dtype=vals.dtype)
    padded[:n] = vals
    blocks = padded.reshape(nblocks, g)
    acc = np.zeros((nblocks, wpb + 1), np.uint64)
    for j in range(g):
        wi, sh = j * bits // 32, np.uint64(j * bits % 32)
        contrib = blocks[:, j].astype(np.uint64) << sh
        acc[:, wi] |= contrib & np.uint64(0xFFFFFFFF)
        acc[:, wi + 1] |= contrib >> np.uint64(32)
    return acc[:, :wpb].reshape(-1)[:nwords].astype(np.uint32)


def _ms(fn, sync=lambda: None) -> dict:
    for _ in range(3):
        fn()
    sync()
    ts = []
    for _ in range(15):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return {"min": ts[0], "median": ts[7]}


def _first_batch(table_dir: str, columns) -> "pa.RecordBatch":
    f = sorted(glob.glob(os.path.join(table_dir, "*.parquet")))[0]
    return next(pq.ParquetFile(f).iter_batches(batch_size=ROWS,
                                               columns=columns))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    bench = os.path.join(_ROOT, ".bench_data")
    tpch = os.path.join(bench, "tpch_sf1_seed7")
    tpch_gen.generate_tpch(tpch, sf=1, seed=7, tables=("lineitem",))
    tpcds = os.path.join(bench, "tpcds_sf1_seed42_default")
    tpcds_gen.generate_tpcds(tpcds, sf=1, seed=42, tables=("store_sales",),
                             rows_per_file=ROWS)
    out = {"device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu", "stage": {}, "pack": {}}
    for name, rb in (
            ("q1_lineitem", _first_batch(os.path.join(tpch, "lineitem"),
                                         Q1_COLUMNS)),
            ("q6_store_sales", _first_batch(
                os.path.join(tpcds, "store_sales"), Q6_COLUMNS))):
        res = {"rows": rb.num_rows}
        for codec in (True, False):
            arm = "on" if codec else "off"
            packed = ColumnBatch.stage_arrow(rb, dev, codec)
            res[f"sent_bytes_{arm}"] = packed.nbytes
            res[f"stage_ms_{arm}"] = _ms(
                lambda: ColumnBatch.stage_arrow(rb, dev, codec))
            res[f"stage_copy_ms_{arm}"] = _ms(
                lambda: ColumnBatch.stage_arrow(rb, dev, codec).to(dev),
                sync)
        out["stage"][name] = res
    rng = np.random.default_rng(0)
    for bits in wc._BIT_BUCKETS:
        vals = rng.integers(0, 1 << bits, ROWS, dtype=np.uint64) \
            .astype(np.uint32)
        if not np.array_equal(wc.pack_bits_host(vals, bits),
                              block_pack(vals, bits)):
            raise AssertionError(f"{bits} bits: words differ")
        out["pack"][str(bits)] = {
            "port_ms": _ms(lambda: wc.pack_bits_host(vals, bits)),
            "reference_ms": _ms(lambda: block_pack(vals, bits))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
