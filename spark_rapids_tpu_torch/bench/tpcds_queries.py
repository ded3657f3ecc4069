"""TPC-DS queries as DataFrame code (port of
``spark_rapids_tpu/bench/tpcds_queries.py``: q3, q6, q15, q42, q52, q53, q63,
of ``tpcds_queries4.py``: q84, and of ``tpcds_queries5.py``: q24 and q51,
the ones whose operators the port has), :func:`q84_all_cities`, q84
without its city filter, :func:`top_customers` and
:func:`top_customers_rr`, explicit repartitions of the fact table (hash
and round-robin), :func:`moving_extrema`, moving-window highs and lows on
q51's store half, and two distributed sorts over a range exchange,
:func:`range_sort_store_sales` and :func:`range_sort_customer_names`.

Each builder takes a :class:`TorchSession` and the data directory and
returns a DataFrame over the generated tables (``bench/tpcds_gen.py``);
the range sorts return a physical plan (the reference has no DataFrame
method for a range repartition), run partition by partition with
:func:`partition_batches`.
q6's scalar subquery (the month_seq) and q24's (5% of the average net
paid) are evaluated eagerly and folded in as literals -- the plan shape
Spark produces after subquery execution.
"""
from __future__ import annotations

import os

from spark_rapids_tpu_torch.expr.aggregates import (Average, CountStar, Max,
                                                    Min, Sum)
from spark_rapids_tpu_torch.expr.arithmetic import Abs
from spark_rapids_tpu_torch.expr.conditional import Coalesce, If
from spark_rapids_tpu_torch.expr.core import col, lit
from spark_rapids_tpu_torch.expr.predicates import In, Or
from spark_rapids_tpu_torch.expr.strings import Concat, Substring, Upper
from spark_rapids_tpu_torch.expr.window import (CURRENT_ROW, UNBOUNDED,
                                                WindowExpression,
                                                WindowFrame, WindowSpec)

__all__ = ["TPCDS_QUERIES", "q3", "q6", "q15", "q24", "q42", "q51", "q52",
           "q53", "q63", "q84", "q84_all_cities", "top_customers",
           "top_customers_rr", "moving_extrema", "range_sort_store_sales",
           "range_sort_customer_names", "partition_batches",
           "RANGE_STORE_SALES_ORDERS", "RANGE_CUSTOMER_ORDERS",
           "PARTITION_PATHS"]


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


def q15(session, data_dir: str):
    """TPC-DS q15: catalog sales by customer zip for 2001Q1 (zip prefix
    / state / big-ticket filter, applied after the three joins)."""
    cs = _t(session, data_dir, "catalog_sales",
            ["cs_sold_date_sk", "cs_bill_customer_sk", "cs_sales_price"])
    cust = _t(session, data_dir, "customer",
              ["c_customer_sk", "c_current_addr_sk"])
    ca = _t(session, data_dir, "customer_address",
            ["ca_address_sk", "ca_state", "ca_zip"])
    dt = _t(session, data_dir, "date_dim",
            ["d_date_sk", "d_qoy", "d_year"]) \
        .where((col("d_qoy") == lit(1)) & (col("d_year") == lit(2001))) \
        .select(col("d_date_sk"))
    zips = ["85669", "86197", "88274", "83405", "86475",
            "85392", "85460", "80348", "81792"]
    cond = Or(Or(In(Substring(col("ca_zip"), lit(1), lit(5)),
                    [lit(z) for z in zips]),
                 In(col("ca_state"), [lit(s) for s in
                                      ("CA", "WA", "GA")])),
              col("cs_sales_price") > lit(500.0))
    return cs.join(cust, on=[("cs_bill_customer_sk", "c_customer_sk")]) \
        .join(ca, on=[("c_current_addr_sk", "ca_address_sk")]) \
        .join(dt, on=[("cs_sold_date_sk", "d_date_sk")]) \
        .where(cond) \
        .group_by("ca_zip") \
        .agg(Sum(col("cs_sales_price")).alias("sum_price")) \
        .order_by(("ca_zip", True)).limit(100)


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


def q51(session, data_dir: str):
    """TPC-DS q51: first dates where cumulative web sales exceed
    cumulative store sales per item."""
    dd = _t(session, data_dir, "date_dim",
            ["d_date_sk", "d_date", "d_month_seq"]) \
        .where((col("d_month_seq") >= lit(1200))
               & (col("d_month_seq") <= lit(1211)))
    cum = WindowFrame("rows", UNBOUNDED, CURRENT_ROW)

    def v1(sales, item_c, date_c, price_c, name):
        g = sales.where(col(item_c).is_not_null()) \
            .join(dd, on=[(date_c, "d_date_sk")]) \
            .group_by(item_c, "d_date") \
            .agg(Sum(col(price_c)).alias("day_sales"))
        cume = WindowExpression(
            Sum(col("day_sales")),
            WindowSpec(partition_by=(col(item_c),),
                       order_by=((col("d_date"), True),), frame=cum))
        return g.select(col(item_c).alias(f"{name}_item_sk"),
                        col("d_date").alias(f"{name}_date"),
                        cume.alias(f"{name}_cume"))

    web = v1(_t(session, data_dir, "web_sales",
                ["ws_item_sk", "ws_sold_date_sk", "ws_sales_price"]),
             "ws_item_sk", "ws_sold_date_sk", "ws_sales_price", "web")
    sto = v1(_t(session, data_dir, "store_sales",
                ["ss_item_sk", "ss_sold_date_sk", "ss_sales_price"]),
             "ss_item_sk", "ss_sold_date_sk", "ss_sales_price", "store")
    j = web.join(sto, on=[("web_item_sk", "store_item_sk"),
                          ("web_date", "store_date")], how="full")
    merged = j.select(
        Coalesce(col("web_item_sk"), col("store_item_sk"))
        .alias("item_sk"),
        Coalesce(col("web_date"), col("store_date")).alias("d_date"),
        col("web_cume").alias("web_sales"),
        col("store_cume").alias("store_sales"))
    web_c = WindowExpression(
        Max(col("web_sales")),
        WindowSpec(partition_by=(col("item_sk"),),
                   order_by=((col("d_date"), True),), frame=cum))
    sto_c = WindowExpression(
        Max(col("store_sales")),
        WindowSpec(partition_by=(col("item_sk"),),
                   order_by=((col("d_date"), True),), frame=cum))
    y = merged.select(col("item_sk"), col("d_date"), col("web_sales"),
                      col("store_sales"), web_c.alias("web_cumulative"),
                      sto_c.alias("store_cumulative"))
    return y.where(col("web_cumulative") > col("store_cumulative")) \
        .order_by(("item_sk", True), ("d_date", True)).limit(100)


def _quarterly_outlier(session, data_dir, group_col, filter_expr):
    """Shared q53/q63 shape: quarterly sales vs the group's average."""
    ss = _t(session, data_dir, "store_sales",
            ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
             "ss_sales_price"])
    dt = _t(session, data_dir, "date_dim",
            ["d_date_sk", "d_month_seq", "d_qoy"]) \
        .where((col("d_month_seq") >= lit(1200))
               & (col("d_month_seq") <= lit(1211)))
    st = _t(session, data_dir, "store", ["s_store_sk"])
    it = _t(session, data_dir, "item",
            ["i_item_sk", "i_manufact_id", "i_manager_id", "i_category",
             "i_class", "i_brand"]).where(filter_expr)
    base = ss.join(dt, on=[("ss_sold_date_sk", "d_date_sk")]) \
        .join(st, on=[("ss_store_sk", "s_store_sk")]) \
        .join(it, on=[("ss_item_sk", "i_item_sk")]) \
        .group_by(group_col, "d_qoy") \
        .agg(Sum(col("ss_sales_price")).alias("sum_sales"))
    avg_w = WindowExpression(
        Average(col("sum_sales")),
        WindowSpec(partition_by=(col(group_col),)))
    out = base.select(col(group_col), col("d_qoy"), col("sum_sales"),
                      avg_w.alias("avg_sales"))
    return out.where((col("avg_sales") > lit(0.0))
                     & (Abs(col("sum_sales") - col("avg_sales"))
                        / col("avg_sales") > lit(0.1))) \
        .order_by((group_col, True), ("avg_sales", True),
                  ("sum_sales", True)) \
        .limit(100)


def q53(session, data_dir: str):
    """TPC-DS q53: manufacturers with outlier quarterly sales (window)."""
    return _quarterly_outlier(
        session, data_dir, "i_manufact_id",
        In(col("i_category"), [lit(c) for c in
                               ("Books", "Children", "Electronics")]))


def q63(session, data_dir: str):
    """TPC-DS q63: managers with outlier quarterly sales (window)."""
    return _quarterly_outlier(
        session, data_dir, "i_manager_id",
        In(col("i_class"), [lit(c) for c in
                            ("accent", "dresses", "fiction", "shirts")]))


def _q84(session, data_dir: str, city):
    cu = _t(session, data_dir, "customer",
            ["c_customer_sk", "c_customer_id", "c_first_name",
             "c_last_name", "c_current_addr_sk", "c_current_cdemo_sk",
             "c_current_hdemo_sk"])
    ca = _t(session, data_dir, "customer_address",
            ["ca_address_sk", "ca_city"])
    if city is not None:
        ca = ca.where(col("ca_city") == lit(city))
    ca = ca.select(col("ca_address_sk"))
    hd = _t(session, data_dir, "household_demographics",
            ["hd_demo_sk", "hd_income_band_sk"])
    ib = _t(session, data_dir, "income_band") \
        .where((col("ib_lower_bound") >= lit(38128))
               & (col("ib_upper_bound") <= lit(38128 + 50000))) \
        .select(col("ib_income_band_sk"))
    sr = _t(session, data_dir, "store_returns", ["sr_cdemo_sk"]) \
        .select(col("sr_cdemo_sk"))
    cd = _t(session, data_dir, "customer_demographics", ["cd_demo_sk"])
    name = Concat(Coalesce(col("c_last_name"), lit("")), lit(", "),
                  Coalesce(col("c_first_name"), lit("")))
    return cu.join(ca, on=[("c_current_addr_sk", "ca_address_sk")],
                   how="semi") \
        .join(hd, on=[("c_current_hdemo_sk", "hd_demo_sk")]) \
        .join(ib, on=[("hd_income_band_sk", "ib_income_band_sk")],
              how="semi") \
        .join(cd, on=[("c_current_cdemo_sk", "cd_demo_sk")]) \
        .join(sr, on=[("cd_demo_sk", "sr_cdemo_sk")], how="semi") \
        .select(col("c_customer_id").alias("customer_id"),
                name.alias("customername")) \
        .order_by(("customer_id", True)).limit(100)


def q84(session, data_dir: str):
    """TPC-DS q84: Edgewood customers in an income band with store
    returns."""
    return _q84(session, data_dir, "Edgewood")


def q84_all_cities(session, data_dir: str):
    """q84 without its ``ca_city = 'Edgewood'`` filter, nothing else
    changed (the semi join on customer_address stays).  The generator
    writes cities City000..City399 and never Edgewood, so q84 as written
    returns no rows at any scale and its Concat sees none; this variant
    concatenates the names of every customer in the income bands."""
    return _q84(session, data_dir, None)


def q24(session, data_dir: str):
    """TPC-DS q24a: pale-item net paid per customer/store, above 5% of
    the average."""
    ss = _t(session, data_dir, "store_sales",
            ["ss_ticket_number", "ss_item_sk", "ss_customer_sk",
             "ss_store_sk", "ss_net_paid"])
    sr = _t(session, data_dir, "store_returns",
            ["sr_ticket_number", "sr_item_sk"])
    st = _t(session, data_dir, "store",
            ["s_store_sk", "s_store_name", "s_market_id", "s_state",
             "s_zip"]) \
        .where(col("s_market_id") == lit(8))
    it = _t(session, data_dir, "item",
            ["i_item_sk", "i_color", "i_current_price", "i_manager_id",
             "i_units", "i_size"])
    cu = _t(session, data_dir, "customer",
            ["c_customer_sk", "c_first_name", "c_last_name",
             "c_birth_country"])
    ca = _t(session, data_dir, "customer_address",
            ["ca_address_sk", "ca_state", "ca_country", "ca_zip"]) \
        .with_column("ca_country_up", Upper(col("ca_country")))
    base = ss.join(sr, on=[("ss_ticket_number", "sr_ticket_number"),
                           ("ss_item_sk", "sr_item_sk")]) \
        .join(st, on=[("ss_store_sk", "s_store_sk")]) \
        .join(it, on=[("ss_item_sk", "i_item_sk")]) \
        .join(cu, on=[("ss_customer_sk", "c_customer_sk")]) \
        .join(ca, on=[("c_birth_country", "ca_country_up"),
                      ("s_zip", "ca_zip")])
    ssales = base.group_by("c_last_name", "c_first_name", "s_store_name",
                           "ca_state", "s_state", "i_color",
                           "i_current_price", "i_manager_id", "i_units",
                           "i_size") \
        .agg(Sum(col("ss_net_paid")).alias("netpaid"))
    avg_rows = ssales.agg(Average(col("netpaid")).alias("a")).collect()
    threshold = 0.05 * float(avg_rows[0][0] or 0.0)
    return ssales.where(col("i_color") == lit("pale")) \
        .group_by("c_last_name", "c_first_name", "s_store_name") \
        .agg(Sum(col("netpaid")).alias("paid")) \
        .where(col("paid") > lit(threshold)) \
        .order_by(("c_last_name", True), ("c_first_name", True),
                  ("s_store_name", True), ("paid", True))


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


def top_customers_rr(session, data_dir: str):
    """top_customers over store_sales round-robin-repartitioned into 8
    partitions (no keys): a data engineer's rebalancing repartition
    before an aggregation or a write.  The 100 customers with the most
    purchases, with their largest and total net paid."""
    return _t(session, data_dir, "store_sales",
              ["ss_customer_sk", "ss_net_paid"]) \
        .repartition(8) \
        .group_by("ss_customer_sk").agg(
            CountStar().alias("n"), Max(col("ss_net_paid")).alias("max_paid"),
            Sum(col("ss_net_paid")).alias("paid")) \
        .order_by(("n", False), ("ss_customer_sk", True)) \
        .limit(100)


def moving_extrema(session, data_dir: str):
    """Moving-window highs and lows over q51's store half: per (item,
    day) sales in 2000 (built as q51's ``v1``), then over each item's days
    the trailing 7-day high (ROWS 6 PRECEDING .. CURRENT ROW), the
    centred 7-day low (ROWS 3 PRECEDING .. 3 FOLLOWING) and the high from
    the day on (RANGE CURRENT ROW .. UNBOUNDED FOLLOWING); per item, the
    days at their trailing high, the days at their forward high and the
    sum of the centred lows, ordered by item.  An analyst's moving
    high/low.  A day is at a high when its sales are within half a cent
    of it (a day's sales never exceed a high over a frame that holds the
    day): the order in which a day's cent prices are summed moves its
    double by an ulp, which must not split two equal days."""
    dd = _t(session, data_dir, "date_dim",
            ["d_date_sk", "d_date", "d_month_seq"]) \
        .where((col("d_month_seq") >= lit(1200))
               & (col("d_month_seq") <= lit(1211)))
    days = _t(session, data_dir, "store_sales",
              ["ss_item_sk", "ss_sold_date_sk", "ss_sales_price"]) \
        .where(col("ss_item_sk").is_not_null()) \
        .join(dd, on=[("ss_sold_date_sk", "d_date_sk")]) \
        .group_by("ss_item_sk", "d_date") \
        .agg(Sum(col("ss_sales_price")).alias("day_sales"))

    def over(fn, frame):
        return WindowExpression(fn(col("day_sales")), WindowSpec(
            partition_by=(col("ss_item_sk"),),
            order_by=((col("d_date"), True),), frame=frame))

    w = days.select(
        col("ss_item_sk"), col("day_sales"),
        over(Max, WindowFrame("rows", -6, CURRENT_ROW)).alias("high7"),
        over(Min, WindowFrame("rows", -3, 3)).alias("low7"),
        over(Max, WindowFrame("range", CURRENT_ROW, UNBOUNDED))
        .alias("high_on"))
    return w.group_by("ss_item_sk").agg(
        Sum(If(col("day_sales") >= col("high7") - lit(0.005), lit(1),
               lit(0))).alias("high_days"),
        Sum(If(col("day_sales") >= col("high_on") - lit(0.005), lit(1),
               lit(0))).alias("peak_days"),
        Sum(col("low7")).alias("low_sum")) \
        .order_by(("ss_item_sk", True))


#: range_sort_store_sales's sort: the sale date ascending (nulls first,
#: Spark's default), then the net paid descending
RANGE_STORE_SALES_ORDERS = [("ss_sold_date_sk", True, True),
                            ("ss_net_paid", False)]
#: range_sort_customer_names's sort: last name ascending, first name
#: descending (nulls last), customer id ascending
RANGE_CUSTOMER_ORDERS = [("c_last_name", True), ("c_first_name", False, False),
                         ("c_customer_id", True)]


def _range_sorted(df, orders, num_partitions: int):
    from spark_rapids_tpu_torch.exec import (RangePartitioning,
                                             ShuffleExchangeExec, SortExec)
    ex = ShuffleExchangeExec(RangePartitioning(orders, num_partitions),
                             df._prepared())
    return SortExec(orders, ex, global_sort=False)


def range_sort_store_sales(session, data_dir: str, num_partitions: int = 8):
    """A distributed sort of all store_sales rows (date, net paid,
    ticket): a range exchange into ``num_partitions`` by
    :data:`RANGE_STORE_SALES_ORDERS`, then a sort of each partition; the
    partitions read in order are the sorted table.  The physical plan."""
    return _range_sorted(_t(session, data_dir, "store_sales",
                            ["ss_sold_date_sk", "ss_net_paid",
                             "ss_ticket_number"]),
                         RANGE_STORE_SALES_ORDERS, num_partitions)


def range_sort_customer_names(session, data_dir: str,
                              num_partitions: int = 200):
    """The customers sorted by name over a range exchange into
    ``num_partitions`` (200, Spark's default shuffle partitions): string
    keys, two of them with 12 values, so many bounds tie and some
    partitions stay empty.  The physical plan."""
    return _range_sorted(_t(session, data_dir, "customer",
                            ["c_last_name", "c_first_name", "c_customer_id"]),
                         RANGE_CUSTOMER_ORDERS, num_partitions)


def partition_batches(session, plan) -> list[list]:
    """Run a physical plan on the session's device: each partition's
    batches, in partition order.  The exchange's map-side coalescing
    follows the session's conf: pin
    ``spark.sql.adaptive.advisoryPartitionSizeInBytes`` to 0 (or turn the
    adaptive layer off) to keep a range exchange's partitions."""
    from spark_rapids_tpu_torch.exec.core import ExecCtx
    ctx = ExecCtx(device=session.device, conf=session.conf)
    try:
        return [list(plan.partition_iter(ctx, pid))
                for pid in range(plan.num_partitions(ctx))]
    finally:
        ctx.close()


#: query name -> (builder, tables it reads)
TPCDS_QUERIES = {
    "q3": (q3, ("date_dim", "item", "store_sales")),
    "q6": (q6, ("date_dim", "item", "customer", "customer_address",
                "store_sales")),
    "q15": (q15, ("date_dim", "customer", "customer_address",
                  "catalog_sales")),
    "q42": (q42, ("date_dim", "item", "store_sales")),
    "q52": (q52, ("date_dim", "item", "store_sales")),
    "q51": (q51, ("date_dim", "store_sales", "web_sales")),
    "q53": (q53, ("date_dim", "item", "store", "store_sales")),
    "q63": (q63, ("date_dim", "item", "store", "store_sales")),
    "q24": (q24, ("item", "customer", "customer_address", "store",
                  "store_sales", "store_returns")),
    "q84": (q84, ("customer", "customer_address", "customer_demographics",
                  "household_demographics", "income_band",
                  "store_returns")),
    "q84_all_cities": (q84_all_cities, (
        "customer", "customer_address", "customer_demographics",
        "household_demographics", "income_band", "store_returns")),
}

#: the round-robin, range and moving-window paths: name -> (builder,
#: tables it reads); the range sorts build physical plans
PARTITION_PATHS = {
    "top_customers_rr": (top_customers_rr, ("store_sales",)),
    "range_sort_store_sales": (range_sort_store_sales, ("store_sales",)),
    "range_sort_customer_names": (range_sort_customer_names,
                                  ("customer",)),
    "moving_extrema": (moving_extrema, ("date_dim", "store_sales")),
}
