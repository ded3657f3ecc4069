"""TPC-H queries as DataFrame code (port of
``spark_rapids_tpu/bench/tpch_queries.py``: q1, q14 and q22, the ones
whose operators and expressions the port has).

q22's scalar subquery (the average positive balance) is collected inside
its builder and folded in as a literal, as the reference does."""
from __future__ import annotations

import datetime as _dt
import os

from spark_rapids_tpu_torch.expr.aggregates import Average, CountStar, Sum
from spark_rapids_tpu_torch.expr.conditional import If
from spark_rapids_tpu_torch.expr.core import col, lit
from spark_rapids_tpu_torch.expr.predicates import In
from spark_rapids_tpu_torch.expr.strings import Substring

__all__ = ["TPCH_QUERIES", "q1", "q14", "q22"]


def _t(session, data_dir: str, table: str, columns=None):
    return session.read_parquet(os.path.join(data_dir, table),
                                columns=columns)


def _d(y, m, d):
    return lit(_dt.date(y, m, d))


def _disc_price():
    return col("l_extendedprice") * (lit(1.0) - col("l_discount"))


def q1(session, data_dir: str):
    """TPC-H q1: pricing summary report."""
    li = _t(session, data_dir, "lineitem",
            ["l_returnflag", "l_linestatus", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax", "l_shipdate"])
    return li.where(col("l_shipdate") <= _d(1998, 9, 2)) \
        .group_by("l_returnflag", "l_linestatus") \
        .agg(Sum(col("l_quantity")).alias("sum_qty"),
             Sum(col("l_extendedprice")).alias("sum_base_price"),
             Sum(_disc_price()).alias("sum_disc_price"),
             Sum(_disc_price() * (lit(1.0) + col("l_tax")))
             .alias("sum_charge"),
             Average(col("l_quantity")).alias("avg_qty"),
             Average(col("l_extendedprice")).alias("avg_price"),
             Average(col("l_discount")).alias("avg_disc"),
             CountStar().alias("count_order")) \
        .order_by(("l_returnflag", True), ("l_linestatus", True))


def q14(session, data_dir: str):
    """TPC-H q14: promotion effect."""
    li = _t(session, data_dir, "lineitem",
            ["l_partkey", "l_shipdate", "l_extendedprice", "l_discount"]) \
        .where((col("l_shipdate") >= _d(1995, 9, 1))
               & (col("l_shipdate") < _d(1995, 10, 1)))
    pt = _t(session, data_dir, "part", ["p_partkey", "p_type"])
    j = li.join(pt, on=[("l_partkey", "p_partkey")])
    return j.agg(
        (lit(100.0)
         * Sum(If(col("p_type").like("PROMO%"), _disc_price(), lit(0.0)))
         / Sum(_disc_price())).alias("promo_revenue"))


def q22(session, data_dir: str):
    """TPC-H q22: global sales opportunity."""
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cu = _t(session, data_dir, "customer",
            ["c_custkey", "c_phone", "c_acctbal"]) \
        .with_column("cntrycode", Substring(col("c_phone"), lit(1),
                                            lit(2))) \
        .where(In(col("cntrycode"), [lit(c) for c in codes]))
    avg_rows = cu.where(col("c_acctbal") > lit(0.0)) \
        .agg(Average(col("c_acctbal")).alias("a")).collect()
    avg_bal = float(avg_rows[0][0] or 0.0)
    od = _t(session, data_dir, "orders", ["o_custkey"]) \
        .select(col("o_custkey"))
    return cu.where(col("c_acctbal") > lit(avg_bal)) \
        .join(od, on=[("c_custkey", "o_custkey")], how="anti") \
        .group_by("cntrycode") \
        .agg(CountStar().alias("numcust"),
             Sum(col("c_acctbal")).alias("totacctbal")) \
        .order_by(("cntrycode", True))


TPCH_QUERIES = {"q1": q1, "q14": q14, "q22": q22}
