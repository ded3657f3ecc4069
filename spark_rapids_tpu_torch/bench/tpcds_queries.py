"""TPC-DS queries as DataFrame code (port of ``spark_rapids_tpu/bench/tpcds_queries.py``:
q3, q6, q42 and q52, the ones whose operators the port has), and
:func:`top_customers`, an explicit repartition of the fact table.

Each builder takes a :class:`TorchSession` and the data directory and
returns a DataFrame over the generated tables (``bench/tpcds_gen.py``).
q6's scalar subquery (the month_seq) is evaluated eagerly and folded in as
a literal -- the plan shape Spark produces after subquery execution.
"""
from __future__ import annotations

import os

from spark_rapids_tpu_torch.expr.aggregates import Average, CountStar, Sum
from spark_rapids_tpu_torch.expr.core import col, lit

__all__ = ["TPCDS_QUERIES", "q3", "q6", "q42", "q52", "top_customers"]


def _t(session, data_dir: str, table: str, columns=None):
    return session.read_parquet(os.path.join(data_dir, table),
                                columns=columns)


def q3(session, data_dir: str):
    """TPC-DS q3: brand revenue by year for one manufacturer in November."""
    dt = _t(session, data_dir, "date_dim",
            ["d_date_sk", "d_year", "d_moy"]).where(col("d_moy") == lit(11))
    it = _t(session, data_dir, "item",
            ["i_item_sk", "i_brand_id", "i_brand", "i_manufact_id"]) \
        .where(col("i_manufact_id") == lit(128)) \
        .select(col("i_item_sk"), col("i_brand_id"), col("i_brand"))
    ss = _t(session, data_dir, "store_sales",
            ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
    return ss.join(dt, on=[("ss_sold_date_sk", "d_date_sk")]) \
        .join(it, on=[("ss_item_sk", "i_item_sk")]) \
        .group_by("d_year", "i_brand_id", "i_brand") \
        .agg(Sum(col("ss_ext_sales_price")).alias("sum_agg")) \
        .order_by(("d_year", True), ("sum_agg", False),
                  ("i_brand_id", True)) \
        .limit(100)


def q6(session, data_dir: str):
    """TPC-DS q6: state count of customers buying items priced >=120% of
    their category average, for one month (BASELINE configs[0])."""
    dd = _t(session, data_dir, "date_dim",
            ["d_date_sk", "d_year", "d_moy", "d_month_seq"])
    # scalar subquery: the (distinct) month_seq of 2001-01
    ms_rows = dd.where((col("d_year") == lit(2001))
                       & (col("d_moy") == lit(1))) \
        .select(col("d_month_seq")).limit(1).collect()
    ms = ms_rows[0][0]
    dt = dd.where(col("d_month_seq") == lit(ms)).select(col("d_date_sk"))

    item = _t(session, data_dir, "item",
              ["i_item_sk", "i_category", "i_current_price"])
    avg_cat = item.group_by("i_category").agg(
        Average(col("i_current_price")).alias("avg_price")) \
        .select(col("i_category").alias("cat_avg_key"), col("avg_price"))
    it = item.join(avg_cat, on=[("i_category", "cat_avg_key")]) \
        .where(col("i_current_price") > lit(1.2) * col("avg_price")) \
        .select(col("i_item_sk"))

    cust = _t(session, data_dir, "customer",
              ["c_customer_sk", "c_current_addr_sk"])
    ca = _t(session, data_dir, "customer_address",
            ["ca_address_sk", "ca_state"])
    ss = _t(session, data_dir, "store_sales",
            ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk"])

    return ss.join(dt, on=[("ss_sold_date_sk", "d_date_sk")]) \
        .join(it, on=[("ss_item_sk", "i_item_sk")]) \
        .join(cust, on=[("ss_customer_sk", "c_customer_sk")]) \
        .join(ca, on=[("c_current_addr_sk", "ca_address_sk")]) \
        .group_by("ca_state") \
        .agg(CountStar().alias("cnt")) \
        .where(col("cnt") >= lit(10)) \
        .order_by(("cnt", True)) \
        .limit(100)


def q42(session, data_dir: str):
    """TPC-DS q42: category revenue for one month/year, manager 1."""
    dt = _t(session, data_dir, "date_dim",
            ["d_date_sk", "d_year", "d_moy"]) \
        .where((col("d_moy") == lit(11)) & (col("d_year") == lit(2000)))
    it = _t(session, data_dir, "item",
            ["i_item_sk", "i_category_id", "i_category", "i_manager_id"]) \
        .where(col("i_manager_id") == lit(1)) \
        .select(col("i_item_sk"), col("i_category_id"), col("i_category"))
    ss = _t(session, data_dir, "store_sales",
            ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
    return ss.join(dt, on=[("ss_sold_date_sk", "d_date_sk")]) \
        .join(it, on=[("ss_item_sk", "i_item_sk")]) \
        .group_by("d_year", "i_category_id", "i_category") \
        .agg(Sum(col("ss_ext_sales_price")).alias("total_sales")) \
        .order_by(("total_sales", False), ("d_year", True),
                  ("i_category_id", True), ("i_category", True)) \
        .limit(100)


def q52(session, data_dir: str):
    """TPC-DS q52: brand revenue for one month/year, manager 1."""
    dt = _t(session, data_dir, "date_dim",
            ["d_date_sk", "d_year", "d_moy"]) \
        .where((col("d_moy") == lit(11)) & (col("d_year") == lit(2000)))
    it = _t(session, data_dir, "item",
            ["i_item_sk", "i_brand_id", "i_brand", "i_manager_id"]) \
        .where(col("i_manager_id") == lit(1)) \
        .select(col("i_item_sk"), col("i_brand_id"), col("i_brand"))
    ss = _t(session, data_dir, "store_sales",
            ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
    return ss.join(dt, on=[("ss_sold_date_sk", "d_date_sk")]) \
        .join(it, on=[("ss_item_sk", "i_item_sk")]) \
        .group_by("d_year", "i_brand_id", "i_brand") \
        .agg(Sum(col("ss_ext_sales_price")).alias("ext_price")) \
        .order_by(("d_year", True), ("ext_price", False),
                  ("i_brand_id", True)) \
        .limit(100)


def top_customers(session, data_dir: str):
    """The 100 customers with the most store purchases (the null customer
    included), over store_sales hash-repartitioned on the customer key:
    the shape of a data engineer's repartition before a per-key
    aggregation, a join or a write.  Ordered by count descending, then
    key ascending (nulls first, Spark's default for ascending)."""
    return _t(session, data_dir, "store_sales", ["ss_customer_sk"]) \
        .repartition(8, "ss_customer_sk") \
        .group_by("ss_customer_sk").agg(CountStar().alias("n")) \
        .order_by(("n", False), ("ss_customer_sk", True)) \
        .limit(100)


#: query name -> (builder, tables it reads)
TPCDS_QUERIES = {
    "q3": (q3, ("date_dim", "item", "store_sales")),
    "q6": (q6, ("date_dim", "item", "customer", "customer_address",
                "store_sales")),
    "q42": (q42, ("date_dim", "item", "store_sales")),
    "q52": (q52, ("date_dim", "item", "store_sales")),
}
