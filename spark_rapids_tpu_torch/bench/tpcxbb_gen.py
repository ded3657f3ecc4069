"""TPCx-BB ``product_reviews`` (port of the review part of
``spark_rapids_tpu/bench/tpcxbb_gen.py:44-105``).

The reference writes three TPCx-BB tables from one
``default_rng(seed + 7)``: ``web_clickstreams`` (2.5 rows per store_sales
row) first, then ``product_reviews`` (1.5 reviews per item, 5-14 words of
a fixed vocabulary each, a rating clustered per item), then
``item_marketprices``.  This port writes ``product_reviews`` alone: it
makes the clickstream draws in the same order and discards them (in
chunks, so that the 72M-row SF10 stream never sits in memory), then draws
and writes the reviews exactly as the reference does, so that for the
same sf and seed its files equal the reference's.  Row counts come from
the TPC-DS generator's ``table_row_counts``.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from spark_rapids_tpu_torch.bench.tpcds_gen import table_row_counts

__all__ = ["generate_product_reviews", "product_review_rows", "WORDS"]

#: the review vocabulary (reference tpcxbb_gen.py:27-30)
WORDS = ("great product fast shipping works as described would buy again "
         "poor quality broke after a week disappointed returned it "
         "average okay for the price decent value excellent service "
         "terrible support never again love it highly recommend").split()

#: dsdgen's d_date_sk of 1900-01-01 (tpcds_gen._DATE_SK_EPOCH)
_DATE_SK_EPOCH = 2415022

#: values drawn at a time when a draw is discarded
_CHUNK = 1 << 22

_SCHEMA_VERSION = "v1"


def product_review_rows(sf: float) -> int:
    """Rows of product_reviews at ``sf`` (reference tpcxbb_row_counts)."""
    return max(int(table_row_counts(sf)["item"] * 1.5), 100)


def _skip_integers(rng, lo: int, hi: int, n: int) -> None:
    """Advance ``rng`` past ``rng.integers(lo, hi, n)`` (bounded draws
    below 2^32 take the generator's 32-bit outputs one by one, so chunks
    draw the same stream)."""
    for i in range(0, n, _CHUNK):
        rng.integers(lo, hi, min(_CHUNK, n - i))


def _count_below(rng, p: float, n: int) -> int:
    """``int((rng.random(n) < p).sum())``, drawn in chunks."""
    return sum(int((rng.random(min(_CHUNK, n - i)) < p).sum())
               for i in range(0, n, _CHUNK))


def generate_product_reviews(data_dir: str, sf: float = 0.01,
                             seed: int = 42,
                             rows_per_file: int = 250_000) -> int:
    """Write ``data_dir/product_reviews/`` (reused when its stamp of
    schema version, sf, seed and layout is there); returns its rows."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    out = os.path.join(data_dir, "product_reviews")
    stamp = f"_{_SCHEMA_VERSION}_sf{sf:g}_seed{seed}_rpf{rows_per_file}"
    n = product_review_rows(sf)
    if os.path.exists(os.path.join(out, stamp)):
        return n
    if os.path.isdir(out):
        shutil.rmtree(out)
    rng = np.random.default_rng(seed + 7)
    base = table_row_counts(sf)
    n_item = base["item"]
    n_cust = base["customer"]

    # web_clickstreams' draws (reference :66-84), in its order
    nw = int(base["store_sales"] * 2.5)
    _skip_integers(rng, 1, n_cust + 1, nw)      # wcs_user_sk
    _count_below(rng, 0.08, nw)                 # its nulls
    buys = _count_below(rng, 0.1, nw)           # purchases
    _skip_integers(rng, 1, nw // 10 + 2, buys)  # wcs_sales_sk
    _skip_integers(rng, 36890, 37620, nw)       # wcs_click_date_sk
    _skip_integers(rng, 0, 86400, nw)           # wcs_click_time_sk
    _skip_integers(rng, 1, n_item + 1, nw)      # wcs_item_sk

    # product_reviews (reference :87-105)
    item = rng.integers(1, n_item + 1, n).astype(np.int32)
    item_bias = (item % 5).astype(np.float64)
    rating = np.clip(np.round(1 + item_bias + rng.normal(0, 1, n)),
                     1, 5).astype(np.int32)
    content = np.array(
        [" ".join(rng.choice(WORDS, size=rng.integers(5, 15)))
         for _ in range(n)], dtype=object)
    unattributed = rng.random(n) < 0.02
    date = (rng.integers(36890, 37620, n) + _DATE_SK_EPOCH).astype(np.int64)
    user = rng.integers(1, n_cust + 1, n).astype(np.int32)
    table = pa.table({
        "pr_review_sk": pa.array(np.arange(1, n + 1, dtype=np.int64)),
        "pr_review_date": pa.array(date),
        "pr_review_rating": pa.array(rating),
        "pr_item_sk": pa.array(item, type=pa.int32(), mask=unattributed),
        "pr_user_sk": pa.array(user),
        "pr_review_content": pa.array(list(content), type=pa.string()),
    })
    os.makedirs(out, exist_ok=True)
    for i in range(max(1, -(-n // rows_per_file))):
        part = table.slice(i * rows_per_file,
                           min(rows_per_file, n - i * rows_per_file))
        pq.write_table(part, os.path.join(out, f"part-{i:05d}.parquet"))
    with open(os.path.join(out, stamp), "w") as f:
        f.write(stamp + "\n")
    return n
