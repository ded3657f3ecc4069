"""The Generate exec's paths: TPCx-BB review words and market baskets.

* :func:`review_words` is the tokenising step of TPCx-BB's
  review-sentiment queries (q10, q18, q19): every review's text split on
  spaces into words (``explode_split`` with ``pos``), then per word the
  number of uses, the average rating of the reviews that use it, and its
  first and last positions.  It reads ``product_reviews``
  (``bench/tpcxbb_gen.py``).
* :func:`basket_items` is the market-basket input of TPCx-BB q1, q29 and
  q30, which pair the items of a basket: the baskets of at least two
  items exploded into their items with each item's position, joined with
  ``item`` on the item key, then per category the items, the sum of their
  positions and the largest position.  It reads ``store_baskets``, one
  row per store_sales ticket with the ticket's items as an array column
  (:func:`write_baskets`), and ``item``.

Each builder takes a :class:`TorchSession` and the data directory and
returns a DataFrame.  :data:`GENERATE_PATHS` maps a path's name to its
builder, the function that writes its data under a benchmark directory
(reused when there) and returns the data directory, and its fact table.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from spark_rapids_tpu_torch.bench import tpcds_gen, tpcxbb_gen
from spark_rapids_tpu_torch.expr.aggregates import (Average, CountStar, Max,
                                                    Min, Sum)
from spark_rapids_tpu_torch.expr.collections import Size
from spark_rapids_tpu_torch.expr.core import col, lit

__all__ = ["review_words", "basket_items", "write_baskets",
           "prepare_review_words", "prepare_basket_items",
           "GENERATE_PATHS"]

_BASKETS = "store_baskets"
_BASKETS_VERSION = "v1"


def review_words(session, data_dir: str):
    """Words of the reviews: uses, average rating, first and last
    position; by uses descending, then word."""
    return session.read_parquet(
        os.path.join(data_dir, "product_reviews"),
        columns=["pr_review_rating", "pr_review_content"]) \
        .explode_split("pr_review_content", " ", output_name="word",
                       pos=True) \
        .group_by("word").agg(
            CountStar().alias("n"),
            Average(col("pr_review_rating")).alias("avg_rating"),
            Min(col("pos")).alias("min_pos"),
            Max(col("pos")).alias("max_pos")) \
        .order_by(("n", False), ("word", True))


def basket_items(session, data_dir: str):
    """Items of the baskets of at least two items, by category: items,
    sum of their positions in the basket, largest position."""
    item = session.read_parquet(os.path.join(data_dir, "item"),
                                columns=["i_item_sk", "i_category"])
    return session.read_parquet(os.path.join(data_dir, _BASKETS)) \
        .where(Size(col("items")) >= lit(2)) \
        .explode("items", output_name="item_sk", pos=True) \
        .join(item, on=[("item_sk", "i_item_sk")]) \
        .group_by("i_category").agg(
            CountStar().alias("n"), Sum(col("pos")).alias("pos_sum"),
            Max(col("pos")).alias("max_pos")) \
        .order_by(("i_category", True))


def _parquet_files(table_dir: str) -> list[str]:
    return sorted(f for f in glob.glob(os.path.join(table_dir, "*.parquet"))
                  if not os.path.basename(f).startswith(("_", ".")))


def write_baskets(data_dir: str, rows_per_file: int = 1 << 20) -> int:
    """Write ``data_dir/store_baskets`` from ``data_dir/store_sales``: one
    row per ticket, by ticket number -- ``ticket`` (int64), ``customer``
    (int32, the ticket's first row's customer, null where that is null)
    and ``items`` (list<int32>, the ticket's item keys in file order) --
    in files of ``rows_per_file`` rows.  Reused when its stamp (naming
    store_sales' own) is there; returns the baskets."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    src = os.path.join(data_dir, "store_sales")
    out = os.path.join(data_dir, _BASKETS)
    stamps = sorted(os.path.basename(f) for f in
                    glob.glob(os.path.join(src, "_*")))
    stamp = f"_{_BASKETS_VERSION}{''.join(stamps)}_rpf{rows_per_file}"
    done = os.path.join(out, stamp)
    if os.path.exists(done):
        return int(open(done).read())
    t = pa.concat_tables(pq.read_table(
        f, columns=["ss_ticket_number", "ss_customer_sk", "ss_item_sk"])
        for f in _parquet_files(src))
    ticket = t.column("ss_ticket_number").to_numpy().astype(np.int64)
    cust = t.column("ss_customer_sk").combine_chunks()
    cust_valid = ~np.asarray(cust.is_null())
    cust = cust.fill_null(0).to_numpy().astype(np.int32)
    item = t.column("ss_item_sk").to_numpy().astype(np.int32)
    order = np.argsort(ticket, kind="stable")
    ticket = ticket[order]
    first = np.flatnonzero(np.r_[True, ticket[1:] != ticket[:-1]]) \
        if ticket.size else np.zeros(0, np.int64)
    offsets = np.r_[first, ticket.size].astype(np.int32)
    head = order[first]
    baskets = pa.table({
        "ticket": pa.array(ticket[first]),
        "customer": pa.array(cust[head], type=pa.int32(),
                             mask=~cust_valid[head]),
        "items": pa.ListArray.from_arrays(pa.array(offsets),
                                          pa.array(item[order])),
    })
    if os.path.isdir(out):
        for f in os.listdir(out):
            os.remove(os.path.join(out, f))
    os.makedirs(out, exist_ok=True)
    n = baskets.num_rows
    for i in range(max(1, -(-n // rows_per_file))):
        pq.write_table(baskets.slice(i * rows_per_file, rows_per_file),
                       os.path.join(out, f"part-{i:05d}.parquet"),
                       row_group_size=rows_per_file)
    with open(done, "w") as f:
        f.write(str(n))
    return n


def prepare_review_words(bench_dir: str, sf: float) -> str:
    """product_reviews at ``sf``, seed 42 (``tpcxbb_sf<sf>_seed42``)."""
    data_dir = os.path.join(bench_dir, f"tpcxbb_sf{sf:g}_seed42")
    tpcxbb_gen.generate_product_reviews(data_dir, sf=sf, seed=42)
    return data_dir


def prepare_basket_items(bench_dir: str, sf: float) -> str:
    """store_sales and item in the generator's default layout
    (``tpcds_sf<sf>_seed42_default``, seed 42), and store_baskets beside
    them."""
    data_dir = os.path.join(bench_dir, f"tpcds_sf{sf:g}_seed42_default")
    tpcds_gen.generate_tpcds(data_dir, sf=sf, seed=42,
                             tables=("item", "store_sales"))
    write_baskets(data_dir)
    return data_dir


#: path -> (builder, data preparation, fact table)
GENERATE_PATHS = {
    "review_words": (review_words, prepare_review_words, "product_reviews"),
    "basket_items": (basket_items, prepare_basket_items, _BASKETS),
}
