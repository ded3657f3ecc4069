"""TPC-DS-shaped data generator for the tables of q3, q6, q15, q24, q42,
q51, q52, q53, q63 and q84 (port of ``spark_rapids_tpu/bench/tpcds_gen.py``).

It writes the same tables as the reference generator for the same scale
factor and seed: the same per-table ``default_rng(seed + crc32(name) %
1000)``, every draw in the same order (columns no query reads included)
and the same Arrow types.  The table builders below are the reference's;
what differs is the writer.  The reference builds a nullable column as an
object array with ``None`` and converts it element by element, which at
SF10 takes minutes for each nullable store_sales column; here
``_with_nulls`` keeps the values and a null mask (drawn exactly as the
reference draws it) and pyarrow converts both at once.

Row counts, key ranges, null fractions and surrogate-key conventions are
dsdgen-like (store_sales ~2.88M rows per SF); the values are synthetic,
not dsdgen's.  ``rows_per_file`` sets the file layout; each file holds
row groups of 2^20 rows.

store_returns is sampled from the rows of store_sales, as the
reference samples it: generated in the same call, store_sales is held in
memory until its returns are written; already on disk, it is generated
again in memory from its own rng (the same rows, since the stamp pins sf
and seed).
"""
from __future__ import annotations

import os
import shutil
import zlib
from typing import Sequence

import numpy as np

__all__ = ["generate_tpcds", "relayout_tpcds", "table_row_counts",
           "TABLES"]

#: the tables this port generates (those of its TPC-DS queries)
TABLES = ("date_dim", "item", "customer", "customer_address", "store",
          "customer_demographics", "household_demographics", "income_band",
          "store_sales", "store_returns", "catalog_sales", "web_sales")

#: bump when generated schemas change; tables regenerate on mismatch
_SCHEMA_VERSION = "v6"

#: a returns table is sampled from its parent's rows, so that joins on
#: (item_sk, ticket number) match
_RETURNS_PARENT = {"store_returns": "store_sales"}

#: rows per parquet row group (pyarrow's default, stated)
_ROW_GROUP = 1 << 20

_DATE_SK_EPOCH = 2415022            # dsdgen: d_date_sk of 1900-01-01
_DATE_DIM_DAYS = 73049              # 1900-01-01 .. 2099-12-31
_SALES_DATE_LO = 35794              # days(1998-01-01 - 1900-01-01)
_SALES_DATE_HI = 37985              # days(2003-12-31 - 1900-01-01)
_UNIX_EPOCH_OFF = 25567             # days(1970-01-01 - 1900-01-01)

_CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
               "Men", "Music", "Shoes", "Sports", "Women"]
_CLASSES = ["accent", "bedding", "birdal", "blinds/shades", "classical",
            "computers", "curtains/drapes", "decor", "dresses", "earings",
            "fiction", "fragrances", "furniture", "glassware", "history",
            "infants", "jewelry boxes", "kids", "maternity", "mattresses",
            "mens", "musical", "mystery", "pants", "pendants", "pop",
            "reference", "rock", "romance", "rugs", "scanners", "shirts",
            "swimwear", "tables", "wallpaper", "womens"]
_STATES = ["AL", "AK", "AZ", "AR", "CA", "CO", "CT", "DE", "FL", "GA",
           "HI", "ID", "IL", "IN", "IA", "KS", "KY", "LA", "ME", "MD",
           "MA", "MI", "MN", "MS", "MO", "MT", "NE", "NV", "NH", "NJ",
           "NM", "NY", "NC", "ND", "OH", "OK", "OR", "PA", "RI", "SC",
           "SD", "TN", "TX", "UT", "VT", "VA", "WA", "WV", "WI", "WY"]
_FIRST = ["James", "Mary", "John", "Patricia", "Robert", "Jennifer",
          "Michael", "Linda", "William", "Elizabeth", "David", "Barbara"]
_LAST = ["Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia",
         "Miller", "Davis", "Rodriguez", "Martinez", "Hernandez", "Lopez"]


def table_row_counts(sf: float) -> dict[str, int]:
    """dsdgen-like scaling: fact tables linear in SF; dimensions
    sublinear (item SF1=18k, customer SF1=100k)."""
    sf = max(sf, 0.001)
    n_cust = max(200, int(100_000 * sf ** 0.7))
    n_ss = max(1000, int(2_880_000 * sf))
    n_cs = max(500, int(1_440_000 * sf))
    n_ws = max(250, int(720_000 * sf))
    return {
        "date_dim": _DATE_DIM_DAYS,
        "time_dim": 86_400,
        "item": max(100, int(18_000 * sf ** 0.5)),
        "customer": n_cust,
        "customer_address": max(100, n_cust // 2),
        "store": max(4, int(12 * sf ** 0.5)),
        "customer_demographics": max(500, int(50_000 * sf ** 0.5)),
        "household_demographics": 7_200,
        "promotion": max(30, int(300 * sf ** 0.5)),
        "warehouse": max(2, int(5 * sf ** 0.5)),
        "ship_mode": 20,
        "reason": 35,
        "income_band": 20,
        "call_center": max(2, int(6 * sf ** 0.25)),
        "web_site": max(2, int(30 * sf ** 0.25)),
        "web_page": max(10, int(60 * sf ** 0.25)),
        "catalog_page": max(100, int(11_000 * sf ** 0.25)),
        # dsdgen inventory is (items x warehouses x weeks); sampled to a
        # bench-sized subset that still exercises the same join/agg shapes
        "inventory": max(5000, int(1_200_000 * sf)),
        "store_sales": n_ss,
        "store_returns": max(100, n_ss // 10),
        "catalog_sales": n_cs,
        "catalog_returns": max(50, n_cs // 10),
        "web_sales": n_ws,
        "web_returns": max(25, n_ws // 10),
    }


def _gen_date_dim(counts) -> dict[str, np.ndarray]:
    days = np.arange(_DATE_DIM_DAYS, dtype=np.int64)
    dates = np.datetime64("1900-01-01") + days
    y = dates.astype("datetime64[Y]").astype(int) + 1970
    m = dates.astype("datetime64[M]").astype(int) % 12 + 1
    dom = (dates - dates.astype("datetime64[M]")).astype(int) + 1
    dow = (days + 1) % 7            # 1900-01-01 was a Monday; 0 = Sunday
    day_names = np.array(["Sunday", "Monday", "Tuesday", "Wednesday",
                          "Thursday", "Friday", "Saturday"], dtype=object)
    q = ((m - 1) // 3 + 1)
    return {
        "d_date_sk": (days + _DATE_SK_EPOCH).astype(np.int32),
        "d_date": (days - _UNIX_EPOCH_OFF).astype(np.int32),  # DateType
        "d_year": y.astype(np.int32),
        "d_moy": m.astype(np.int32),
        "d_dom": dom.astype(np.int32),
        "d_dow": dow.astype(np.int32),
        "d_month_seq": ((y - 1900) * 12 + (m - 1)).astype(np.int32),
        "d_qoy": q.astype(np.int32),
        # weeks start Sunday (dow 0); 1900-01-01 (Monday) is in week 1
        "d_week_seq": ((days + 1) // 7 + 1).astype(np.int32),
        "d_day_name": day_names[dow],
        "d_quarter_name": np.array([f"{yy}Q{qq}" for yy, qq in zip(y, q)],
                                   dtype=object),
    }


class _Nullable:
    """A column with nulls: values plus a boolean null mask."""

    __slots__ = ("values", "mask")

    def __init__(self, values: np.ndarray, mask: np.ndarray):
        self.values = values
        self.mask = mask

    def __len__(self) -> int:
        return len(self.values)


def _with_nulls(rng, arr: np.ndarray, frac: float) -> _Nullable:
    """~frac nulls, drawn as the reference's ``_with_nulls`` draws them."""
    mask = np.zeros(len(arr), dtype=np.bool_)
    if frac > 0:
        mask = rng.random(len(arr)) < frac
    return _Nullable(arr, mask)


def _gen_item(rng, n: int) -> dict[str, np.ndarray]:
    brand_id = rng.integers(1001001, 1010016, n).astype(np.int32)
    cat_idx = rng.integers(0, len(_CATEGORIES), n)
    cls_idx = rng.integers(0, len(_CLASSES), n)
    manu = rng.integers(1, 1001, n).astype(np.int32)
    return {
        "i_item_sk": np.arange(1, n + 1, dtype=np.int32),
        "i_item_id": np.array([f"AAAAAAAA{k:08d}" for k in range(1, n + 1)],
                              dtype=object),
        "i_item_desc": np.array(
            [f"desc {k} {_CLASSES[c]}" for k, c in enumerate(cls_idx)],
            dtype=object),
        "i_brand_id": brand_id,
        "i_brand": np.array([f"Brand#{b % 100}" for b in brand_id],
                            dtype=object),
        "i_class_id": (cls_idx + 1).astype(np.int32),
        "i_class": np.array([_CLASSES[i] for i in cls_idx], dtype=object),
        "i_category_id": (cat_idx + 1).astype(np.int32),
        "i_category": _with_nulls(
            rng, np.array([_CATEGORIES[i] for i in cat_idx], dtype=object),
            0.005),
        "i_current_price": _with_nulls(
            rng, np.round(rng.uniform(0.09, 99.99, n), 2), 0.01),
        "i_manufact_id": manu,
        "i_manufact": np.array([f"manufact#{v}" for v in manu], dtype=object),
        "i_manager_id": rng.integers(1, 101, n).astype(np.int32),
        "i_size": np.array([("small", "medium", "large", "extra large",
                             "economy", "N/A", "petite")[v]
                            for v in rng.integers(0, 7, n)], dtype=object),
        "i_color": np.array([("red", "blue", "green", "yellow", "pale",
                              "chiffon", "smoke", "orchid", "peach",
                              "saddle", "powder", "burnished")[v]
                             for v in rng.integers(0, 12, n)], dtype=object),
        "i_units": np.array([("Each", "Dozen", "Case", "Pallet", "Gross",
                              "Oz", "Lb", "Ton")[v]
                             for v in rng.integers(0, 8, n)], dtype=object),
        "i_product_name": np.array([f"product{k}" for k in range(1, n + 1)],
                                   dtype=object),
        "i_wholesale_cost": np.round(rng.uniform(0.05, 80.0, n), 2),
    }


def _gen_customer(rng, n: int, n_addr: int, n_cdemo: int,
                  n_hdemo: int) -> dict[str, np.ndarray]:
    return {
        "c_customer_sk": np.arange(1, n + 1, dtype=np.int32),
        "c_customer_id": np.array(
            [f"AAAAAAAA{k:08d}" for k in range(1, n + 1)], dtype=object),
        "c_current_addr_sk": _with_nulls(
            rng, rng.integers(1, n_addr + 1, n).astype(np.int32), 0.01),
        "c_current_cdemo_sk": _with_nulls(
            rng, rng.integers(1, n_cdemo + 1, n).astype(np.int32), 0.01),
        "c_current_hdemo_sk": _with_nulls(
            rng, rng.integers(1, n_hdemo + 1, n).astype(np.int32), 0.01),
        "c_first_name": _with_nulls(
            rng, np.array([_FIRST[i] for i in
                           rng.integers(0, len(_FIRST), n)], dtype=object),
            0.01),
        "c_last_name": _with_nulls(
            rng, np.array([_LAST[i] for i in
                           rng.integers(0, len(_LAST), n)], dtype=object),
            0.01),
        "c_salutation": _with_nulls(
            rng, np.array([("Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir")[v]
                           for v in rng.integers(0, 6, n)], dtype=object),
            0.01),
        "c_preferred_cust_flag": _with_nulls(
            rng, np.array([("Y", "N")[v] for v in rng.integers(0, 2, n)],
                          dtype=object), 0.03),
        "c_birth_year": _with_nulls(
            rng, rng.integers(1924, 1993, n).astype(np.int32), 0.02),
        "c_birth_month": _with_nulls(
            rng, rng.integers(1, 13, n).astype(np.int32), 0.02),
        "c_birth_day": _with_nulls(
            rng, rng.integers(1, 29, n).astype(np.int32), 0.02),
        "c_birth_country": _with_nulls(
            rng, np.array([("UNITED STATES", "CANADA", "MEXICO", "FRANCE",
                            "GERMANY", "JAPAN", "BRAZIL", "INDIA")[v]
                           for v in rng.integers(0, 8, n)], dtype=object),
            0.02),
        "c_first_sales_date_sk": _with_nulls(
            rng, (rng.integers(_SALES_DATE_LO - 1500, _SALES_DATE_HI - 300,
                               n) + _DATE_SK_EPOCH).astype(np.int32), 0.03),
        "c_first_shipto_date_sk": _with_nulls(
            rng, (rng.integers(_SALES_DATE_LO - 1400, _SALES_DATE_HI - 200,
                               n) + _DATE_SK_EPOCH).astype(np.int32), 0.03),
        "c_email_address": np.array(
            [f"user{k}@example.com" for k in range(1, n + 1)], dtype=object),
        # dsdgen leaves c_login almost entirely NULL
        "c_login": _with_nulls(
            rng, np.array([f"login{k}" for k in range(1, n + 1)],
                          dtype=object), 0.95),
        # StringType in the reference schema (TpcdsLikeSpark.scala:442)
        "c_last_review_date": _with_nulls(
            rng, np.array([str(_DATE_SK_EPOCH + int(v)) for v in
                           rng.integers(_SALES_DATE_LO, _SALES_DATE_HI, n)],
                          dtype=object), 0.05),
    }


def _gen_customer_address(rng, n: int) -> dict[str, np.ndarray]:
    return {
        "ca_address_sk": np.arange(1, n + 1, dtype=np.int32),
        "ca_state": _with_nulls(
            rng, np.array([_STATES[i] for i in
                           rng.integers(0, len(_STATES), n)], dtype=object),
            0.01),
        "ca_city": np.array([f"City{v:03d}" for v in
                             rng.integers(0, 400, n)], dtype=object),
        "ca_county": np.array([f"County{v:03d}" for v in
                               rng.integers(0, 200, n)], dtype=object),
        "ca_zip": np.array([f"{v:05d}" for v in
                            rng.integers(10000, 99999, n)], dtype=object),
        "ca_gmt_offset": rng.choice([-10.0, -9.0, -8.0, -7.0, -6.0, -5.0],
                                    n),
        "ca_country": _with_nulls(
            rng, np.array(["United States"] * n, dtype=object), 0.005),
        "ca_street_number": np.array([f"{v}" for v in
                                      rng.integers(1, 1000, n)],
                                     dtype=object),
        "ca_street_name": np.array([f"Street{v:03d}" for v in
                                    rng.integers(0, 300, n)], dtype=object),
        "ca_street_type": _with_nulls(
            rng, np.array([("Street", "Ave", "Blvd", "Ct", "Dr", "Ln")[v]
                           for v in rng.integers(0, 6, n)], dtype=object),
            0.01),
        "ca_suite_number": _with_nulls(
            rng, np.array([f"Suite {v}" for v in rng.integers(0, 100, n)],
                          dtype=object), 0.01),
        "ca_location_type": _with_nulls(
            rng, np.array([("apartment", "condo", "single family")[v]
                           for v in rng.integers(0, 3, n)], dtype=object),
            0.01),
    }


def _gen_store(rng, n: int) -> dict[str, np.ndarray]:
    return {
        "s_store_sk": np.arange(1, n + 1, dtype=np.int32),
        "s_store_id": np.array([f"AAAAAAAA{k:08d}" for k in range(1, n + 1)],
                               dtype=object),
        "s_store_name": np.array(
            [["ought", "able", "pri", "ese", "anti", "cally", "ation",
              "eing"][k % 8] for k in range(n)], dtype=object),
        "s_state": np.array([_STATES[i] for i in
                             rng.integers(0, 10, n)], dtype=object),
        "s_county": np.array([f"County{v:03d}" for v in
                              rng.integers(0, 30, n)], dtype=object),
        "s_city": np.array([f"City{v:03d}" for v in
                            rng.integers(0, 40, n)], dtype=object),
        "s_company_id": rng.integers(1, 7, n).astype(np.int32),
        "s_company_name": np.array(["Unknown"] * n, dtype=object),
        "s_gmt_offset": np.array([(-8.0, -7.0, -6.0, -5.0)[k % 4]
                                  for k in range(n)]),
        "s_number_employees": rng.integers(200, 301, n).astype(np.int32),
        "s_floor_space": rng.integers(5_000_000, 10_000_000,
                                      n).astype(np.int32),
        "s_market_id": rng.integers(1, 11, n).astype(np.int32),
        "s_zip": np.array([f"{v:05d}" for v in
                           rng.integers(10000, 99999, n)], dtype=object),
        "s_street_number": np.array([f"{v}" for v in
                                     rng.integers(1, 1000, n)], dtype=object),
        "s_street_name": np.array([f"Street{v:03d}" for v in
                                   rng.integers(0, 300, n)], dtype=object),
        "s_street_type": np.array([("Street", "Ave", "Blvd", "Ct")[k % 4]
                                   for k in range(n)], dtype=object),
        "s_suite_number": np.array([f"Suite {v}" for v in
                                    rng.integers(0, 100, n)], dtype=object),
    }


def _gen_customer_demographics(rng, n: int) -> dict[str, np.ndarray]:
    eds = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
           "Advanced Degree", "Unknown"]
    return {
        "cd_demo_sk": np.arange(1, n + 1, dtype=np.int32),
        "cd_gender": np.array([("M", "F")[v] for v in
                               rng.integers(0, 2, n)], dtype=object),
        "cd_marital_status": np.array(
            [("M", "S", "D", "W", "U")[v] for v in rng.integers(0, 5, n)],
            dtype=object),
        "cd_education_status": np.array(
            [eds[v] for v in rng.integers(0, len(eds), n)], dtype=object),
        "cd_purchase_estimate": (rng.integers(1, 21, n) * 500).astype(
            np.int32),
        "cd_credit_rating": np.array(
            [("Low Risk", "Good", "High Risk", "Unknown")[v]
             for v in rng.integers(0, 4, n)], dtype=object),
        "cd_dep_count": rng.integers(0, 7, n).astype(np.int32),
        "cd_dep_employed_count": rng.integers(0, 7, n).astype(np.int32),
        "cd_dep_college_count": rng.integers(0, 7, n).astype(np.int32),
    }


def _gen_household_demographics(rng, n: int) -> dict[str, np.ndarray]:
    return {
        "hd_demo_sk": np.arange(1, n + 1, dtype=np.int32),
        "hd_dep_count": rng.integers(0, 10, n).astype(np.int32),
        "hd_vehicle_count": rng.integers(-1, 5, n).astype(np.int32),
        "hd_buy_potential": np.array(
            [(">10000", "5001-10000", "1001-5000", "501-1000", "0-500",
              "Unknown")[v] for v in rng.integers(0, 6, n)], dtype=object),
        "hd_income_band_sk": rng.integers(1, 21, n).astype(np.int32),
    }


def _gen_income_band(rng, n: int) -> dict[str, np.ndarray]:
    sk = np.arange(1, n + 1, dtype=np.int32)
    return {
        "ib_income_band_sk": sk,
        "ib_lower_bound": ((sk - 1) * 10_000).astype(np.int32),
        "ib_upper_bound": (sk * 10_000 - 1).astype(np.int32),
    }


def _sales_common(rng, n, counts, prefix):
    qty = rng.integers(1, 101, n).astype(np.int32)
    price = np.round(np.exp(rng.normal(2.5, 1.0, n)).clip(0.01, 300.0), 2)
    wholesale = np.round(price * rng.uniform(0.3, 0.9, n), 2)
    ext = np.round(price * qty, 2)
    return qty, price, wholesale, ext


def _gen_store_sales(rng, n: int, counts) -> dict[str, np.ndarray]:
    qty, price, wholesale, ext = _sales_common(rng, n, counts, "ss")
    return {
        "ss_sold_date_sk": _with_nulls(
            rng, (rng.integers(_SALES_DATE_LO, _SALES_DATE_HI + 1, n)
                  + _DATE_SK_EPOCH).astype(np.int32), 0.02),
        "ss_sold_time_sk": _with_nulls(
            rng, rng.integers(0, 86_400, n).astype(np.int32), 0.02),
        "ss_item_sk": rng.integers(1, counts["item"] + 1, n).astype(np.int32),
        "ss_customer_sk": _with_nulls(
            rng, rng.integers(1, counts["customer"] + 1, n).astype(np.int32),
            0.04),
        "ss_cdemo_sk": _with_nulls(
            rng, rng.integers(1, counts["customer_demographics"] + 1,
                              n).astype(np.int32), 0.04),
        "ss_hdemo_sk": _with_nulls(
            rng, rng.integers(1, counts["household_demographics"] + 1,
                              n).astype(np.int32), 0.04),
        "ss_store_sk": _with_nulls(
            rng, rng.integers(1, counts["store"] + 1, n).astype(np.int32),
            0.02),
        "ss_promo_sk": _with_nulls(
            rng, rng.integers(1, counts["promotion"] + 1, n).astype(np.int32),
            0.02),
        "ss_ticket_number": rng.integers(1, max(n // 3, 2),
                                         n).astype(np.int64),
        "ss_addr_sk": _with_nulls(
            rng, rng.integers(1, counts["customer_address"] + 1,
                              n).astype(np.int32), 0.03),
        "ss_quantity": qty,
        "ss_list_price": np.round(price * rng.uniform(1.0, 1.5, n), 2),
        "ss_sales_price": price,
        "ss_ext_sales_price": ext,
        "ss_ext_list_price": np.round(price * rng.uniform(1.0, 1.5, n)
                                      * qty, 2),
        "ss_ext_discount_amt": np.round(
            ext * rng.choice([0.0, 0.0, 0.05, 0.2], n), 2),
        "ss_ext_tax": np.round(ext * 0.08, 2),
        "ss_wholesale_cost": wholesale,
        "ss_ext_wholesale_cost": np.round(wholesale * qty, 2),
        "ss_coupon_amt": np.round(
            ext * rng.choice([0.0, 0.0, 0.0, 0.1, 0.3], n), 2),
        "ss_net_paid": np.round(ext * rng.uniform(0.7, 1.0, n), 2),
        "ss_net_paid_inc_tax": np.round(ext * 1.08, 2),
        "ss_net_profit": np.round(ext - wholesale * qty, 2),
    }


def _gen_catalog_sales(rng, n: int, counts) -> dict[str, np.ndarray]:
    qty, price, wholesale, ext = _sales_common(rng, n, counts, "cs")
    sold = (rng.integers(_SALES_DATE_LO, _SALES_DATE_HI + 1, n)
            + _DATE_SK_EPOCH).astype(np.int64)
    return {
        "cs_sold_date_sk": _with_nulls(rng, sold.astype(np.int32), 0.02),
        "cs_sold_time_sk": _with_nulls(
            rng, rng.integers(0, 86_400, n).astype(np.int32), 0.02),
        "cs_ship_date_sk": _with_nulls(
            rng, (sold + rng.integers(1, 120, n)).astype(np.int32), 0.02),
        "cs_item_sk": rng.integers(1, counts["item"] + 1, n).astype(np.int32),
        "cs_order_number": rng.integers(1, max(n // 2, 2),
                                        n).astype(np.int64),
        "cs_bill_customer_sk": _with_nulls(
            rng, rng.integers(1, counts["customer"] + 1, n).astype(np.int32),
            0.03),
        "cs_bill_cdemo_sk": _with_nulls(
            rng, rng.integers(1, counts["customer_demographics"] + 1,
                              n).astype(np.int32), 0.03),
        "cs_bill_hdemo_sk": _with_nulls(
            rng, rng.integers(1, counts["household_demographics"] + 1,
                              n).astype(np.int32), 0.03),
        "cs_bill_addr_sk": _with_nulls(
            rng, rng.integers(1, counts["customer_address"] + 1,
                              n).astype(np.int32), 0.03),
        "cs_ship_customer_sk": _with_nulls(
            rng, rng.integers(1, counts["customer"] + 1, n).astype(np.int32),
            0.03),
        "cs_ship_addr_sk": _with_nulls(
            rng, rng.integers(1, counts["customer_address"] + 1,
                              n).astype(np.int32), 0.03),
        "cs_ship_mode_sk": _with_nulls(
            rng, rng.integers(1, counts["ship_mode"] + 1,
                              n).astype(np.int32), 0.02),
        "cs_warehouse_sk": _with_nulls(
            rng, rng.integers(1, counts["warehouse"] + 1,
                              n).astype(np.int32), 0.02),
        "cs_call_center_sk": _with_nulls(
            rng, rng.integers(1, counts["call_center"] + 1,
                              n).astype(np.int32), 0.02),
        "cs_catalog_page_sk": _with_nulls(
            rng, rng.integers(1, counts["catalog_page"] + 1,
                              n).astype(np.int32), 0.02),
        "cs_promo_sk": _with_nulls(
            rng, rng.integers(1, counts["promotion"] + 1, n).astype(np.int32),
            0.02),
        "cs_quantity": qty,
        "cs_list_price": np.round(price * rng.uniform(1.0, 1.5, n), 2),
        "cs_sales_price": price,
        "cs_ext_sales_price": ext,
        "cs_ext_list_price": np.round(price * rng.uniform(1.0, 1.5, n)
                                      * qty, 2),
        "cs_ext_discount_amt": np.round(
            ext * rng.choice([0.0, 0.0, 0.05, 0.2], n), 2),
        "cs_ext_ship_cost": np.round(ext * rng.uniform(0.01, 0.1, n), 2),
        "cs_wholesale_cost": wholesale,
        "cs_ext_wholesale_cost": np.round(wholesale * qty, 2),
        "cs_coupon_amt": np.round(
            ext * rng.choice([0.0, 0.0, 0.0, 0.1, 0.3], n), 2),
        "cs_net_paid": np.round(ext * rng.uniform(0.7, 1.0, n), 2),
        "cs_net_paid_inc_tax": np.round(ext * 1.08, 2),
        "cs_net_profit": np.round(ext - wholesale * qty, 2),
    }


def _gen_web_sales(rng, n: int, counts) -> dict[str, np.ndarray]:
    qty, price, wholesale, ext = _sales_common(rng, n, counts, "ws")
    sold = (rng.integers(_SALES_DATE_LO, _SALES_DATE_HI + 1, n)
            + _DATE_SK_EPOCH).astype(np.int64)
    return {
        "ws_sold_date_sk": _with_nulls(rng, sold.astype(np.int32), 0.02),
        "ws_sold_time_sk": _with_nulls(
            rng, rng.integers(0, 86_400, n).astype(np.int32), 0.02),
        "ws_ship_date_sk": _with_nulls(
            rng, (sold + rng.integers(1, 120, n)).astype(np.int32), 0.02),
        "ws_item_sk": rng.integers(1, counts["item"] + 1, n).astype(np.int32),
        "ws_order_number": rng.integers(1, max(n // 2, 2),
                                        n).astype(np.int64),
        "ws_bill_customer_sk": _with_nulls(
            rng, rng.integers(1, counts["customer"] + 1, n).astype(np.int32),
            0.03),
        "ws_bill_addr_sk": _with_nulls(
            rng, rng.integers(1, counts["customer_address"] + 1,
                              n).astype(np.int32), 0.03),
        "ws_ship_addr_sk": _with_nulls(
            rng, rng.integers(1, counts["customer_address"] + 1,
                              n).astype(np.int32), 0.03),
        "ws_web_site_sk": _with_nulls(
            rng, rng.integers(1, counts["web_site"] + 1,
                              n).astype(np.int32), 0.02),
        "ws_web_page_sk": _with_nulls(
            rng, rng.integers(1, counts["web_page"] + 1,
                              n).astype(np.int32), 0.02),
        "ws_ship_mode_sk": _with_nulls(
            rng, rng.integers(1, counts["ship_mode"] + 1,
                              n).astype(np.int32), 0.02),
        "ws_promo_sk": _with_nulls(
            rng, rng.integers(1, counts["promotion"] + 1, n).astype(np.int32),
            0.02),
        "ws_warehouse_sk": _with_nulls(
            rng, rng.integers(1, counts["warehouse"] + 1,
                              n).astype(np.int32), 0.02),
        "ws_ship_customer_sk": _with_nulls(
            rng, rng.integers(1, counts["customer"] + 1, n).astype(np.int32),
            0.03),
        "ws_ship_hdemo_sk": _with_nulls(
            rng, rng.integers(1, counts["household_demographics"] + 1,
                              n).astype(np.int32), 0.03),
        "ws_quantity": qty,
        "ws_list_price": np.round(price * rng.uniform(1.0, 1.5, n), 2),
        "ws_sales_price": price,
        "ws_ext_sales_price": ext,
        "ws_ext_list_price": np.round(price * rng.uniform(1.0, 1.5, n)
                                      * qty, 2),
        "ws_ext_discount_amt": np.round(
            ext * rng.choice([0.0, 0.0, 0.05, 0.2], n), 2),
        "ws_ext_ship_cost": np.round(ext * rng.uniform(0.01, 0.1, n), 2),
        "ws_wholesale_cost": wholesale,
        "ws_ext_wholesale_cost": np.round(wholesale * qty, 2),
        "ws_net_paid": np.round(ext * rng.uniform(0.7, 1.0, n), 2),
        "ws_net_profit": np.round(ext - wholesale * qty, 2),
    }


def _pick(col, idx):
    """Parent column values at row indices ``idx`` (a nullable column
    keeps its nulls)."""
    if isinstance(col, _Nullable):
        return _Nullable(col.values[idx], col.mask[idx])
    return np.asarray(col)[idx]


def _ret_date_col(rng, ret_date: np.ndarray, null_frac: float) -> _Nullable:
    """returned_date_sk: the sentinel 0 (the parent's sold date was null)
    is null, as dsdgen writes it, and ~null_frac more nulls are drawn."""
    col = _with_nulls(rng, ret_date, null_frac)
    return _Nullable(ret_date, col.mask | (ret_date == 0))


def _returns_common(rng, parent: dict, n: int, item_col: str,
                    date_col: str, qty_col: str, price_col: str):
    """Sample n parent rows; returned date = sold date + U(1,90) days,
    return qty <= sold qty, amounts derived from the parent price."""
    pn = len(parent[item_col])
    idx = rng.choice(pn, size=min(n, pn), replace=False)
    idx.sort()
    sold = parent[date_col]
    if isinstance(sold, _Nullable):
        sold_days = np.where(sold.mask[idx], 0,
                             sold.values[idx]).astype(np.int64)
    else:
        sold_days = np.asarray(sold)[idx].astype(np.int64)
    ret_date = np.where(sold_days > 0,
                        sold_days + rng.integers(1, 91, len(idx)),
                        0).astype(np.int64)
    qty = np.asarray(parent[qty_col])[idx].astype(np.int64)
    rqty = rng.integers(1, np.maximum(qty, 1) + 1).astype(np.int32)
    price = np.asarray(parent[price_col])[idx].astype(np.float64)
    amt = np.round(price * rqty, 2)
    return idx, ret_date, rqty, amt


def _gen_store_returns(rng, counts, parent: dict) -> dict[str, np.ndarray]:
    n = counts["store_returns"]
    idx, ret_date, rqty, amt = _returns_common(
        rng, parent, n, "ss_item_sk",
        "ss_sold_date_sk", "ss_quantity", "ss_sales_price")
    return {
        "sr_returned_date_sk": _ret_date_col(rng, ret_date, 0.02),
        "sr_item_sk": _pick(parent["ss_item_sk"], idx).astype(np.int32),
        "sr_ticket_number": _pick(parent["ss_ticket_number"],
                                  idx).astype(np.int64),
        "sr_customer_sk": _pick(parent["ss_customer_sk"], idx),
        "sr_cdemo_sk": _pick(parent["ss_cdemo_sk"], idx),
        "sr_store_sk": _pick(parent["ss_store_sk"], idx),
        "sr_reason_sk": _with_nulls(
            rng, rng.integers(1, counts["reason"] + 1,
                              len(idx)).astype(np.int32), 0.02),
        "sr_return_quantity": _with_nulls(rng, rqty, 0.02),
        "sr_return_amt": amt,
        "sr_net_loss": np.round(amt * rng.uniform(0.3, 1.1, len(idx)), 2),
        "sr_fee": np.round(rng.uniform(0.5, 100.0, len(idx)), 2),
        "sr_refunded_cash": np.round(amt * rng.uniform(0.0, 1.0, len(idx)),
                                     2),
        "sr_return_amt_inc_tax": np.round(amt * 1.08, 2),
    }


_GENERATORS = {
    "date_dim": lambda rng, counts: _gen_date_dim(counts),
    "item": lambda rng, counts: _gen_item(rng, counts["item"]),
    "customer": lambda rng, counts: _gen_customer(
        rng, counts["customer"], counts["customer_address"],
        counts["customer_demographics"],
        counts["household_demographics"]),
    "customer_address": lambda rng, counts: _gen_customer_address(
        rng, counts["customer_address"]),
    "store": lambda rng, counts: _gen_store(rng, counts["store"]),
    "customer_demographics": lambda rng, counts: _gen_customer_demographics(
        rng, counts["customer_demographics"]),
    "household_demographics": lambda rng, counts:
        _gen_household_demographics(rng, counts["household_demographics"]),
    "income_band": lambda rng, counts: _gen_income_band(
        rng, counts["income_band"]),
    "store_sales": lambda rng, counts: _gen_store_sales(
        rng, counts["store_sales"], counts),
    "catalog_sales": lambda rng, counts: _gen_catalog_sales(
        rng, counts["catalog_sales"], counts),
    "web_sales": lambda rng, counts: _gen_web_sales(
        rng, counts["web_sales"], counts),
}

_RETURNS_GENERATORS = {"store_returns": _gen_store_returns}


def _arrow(arr, is_date: bool):
    """One column as a pyarrow array, typed as the reference writer types
    it: nullable strings, floats and ints as string, float64 and int32."""
    import pyarrow as pa
    if is_date:
        return pa.array(np.asarray(arr, dtype=np.int32),
                        type=pa.int32()).cast(pa.date32())
    if isinstance(arr, _Nullable):
        v, mask = arr.values, arr.mask
        if mask.all():  # the reference types an all-null column int32
            return pa.nulls(len(v), type=pa.int32())
        if v.dtype == object:
            return pa.array(v, type=pa.string(), mask=mask)
        if v.dtype.kind == "f":
            return pa.array(v.astype(np.float64), type=pa.float64(),
                            mask=mask)
        return pa.array(v.astype(np.int32), type=pa.int32(), mask=mask)
    if arr.dtype == object:
        return pa.array(arr, type=pa.string())
    return pa.array(arr)


def _write_parquet(path: str, data: dict, rows_per_file: int,
                   date_cols: Sequence[str] = ()) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(path, exist_ok=True)
    n = len(next(iter(data.values())))
    table = pa.table({name: _arrow(arr, name in date_cols)
                      for name, arr in data.items()})
    nfiles = max(1, -(-n // rows_per_file))
    for i in range(nfiles):
        part = table.slice(i * rows_per_file,
                           min(rows_per_file, n - i * rows_per_file))
        pq.write_table(part, os.path.join(path, f"part-{i:05d}.parquet"),
                       row_group_size=_ROW_GROUP)


def generate_tpcds(data_dir: str, sf: float = 0.01, seed: int = 42,
                   tables: Sequence[str] = TABLES,
                   rows_per_file: int = 1 << 20) -> dict[str, int]:
    """Generate the tables under ``data_dir/<table>/``; returns {table:
    rows}.  A table whose stamp (schema version, sf, seed, file layout)
    is present is reused; any other is regenerated."""
    counts = table_row_counts(sf)
    stamp = f"_{_SCHEMA_VERSION}_sf{sf:g}_seed{seed}_rpf{rows_per_file}"

    def needs_gen(t: str) -> bool:
        return not os.path.exists(os.path.join(data_dir, t, stamp))

    def rng_of(t: str):
        return np.random.default_rng(seed + zlib.crc32(t.encode()) % 1000)

    written = {}
    # a parent's rows, held only until its returns table is written
    parents: dict[str, dict] = {}
    for t in tables:
        out = os.path.join(data_dir, t)
        written[t] = counts[t]
        if not needs_gen(t):
            continue
        if os.path.isdir(out):
            shutil.rmtree(out)
        if t in _RETURNS_GENERATORS:
            pname = _RETURNS_PARENT[t]
            parent = parents.pop(pname, None)
            if parent is None:  # on disk: the same rows, made again
                parent = _GENERATORS[pname](rng_of(pname), counts)
            data = _RETURNS_GENERATORS[t](rng_of(t), counts, parent)
            del parent
        else:
            data = _GENERATORS[t](rng_of(t), counts)
            ret = next((r for r, p in _RETURNS_PARENT.items() if p == t),
                       None)
            if ret in tables and needs_gen(ret):
                parents[t] = data
        _write_parquet(out, data, rows_per_file,
                       date_cols=("d_date",) if t == "date_dim" else ())
        del data
        with open(os.path.join(out, stamp), "w") as f:
            f.write(stamp + "\n")
    return written


def relayout_tpcds(src_dir: str, data_dir: str, sf: float, seed: int,
                   tables: Sequence[str],
                   rows_per_file: int = 1 << 20) -> dict[str, int]:
    """The tables of ``src_dir``, generated there at ``sf`` and ``seed``
    in another file layout, written under ``data_dir`` in files of
    ``rows_per_file`` rows (the rows :func:`generate_tpcds` would draw,
    read back instead of drawn again); returns {table: rows}.  A table
    whose stamp is present is reused; one missing from ``src_dir``
    raises."""
    import glob as _glob

    import pyarrow as pa
    import pyarrow.parquet as pq
    stamp = f"_{_SCHEMA_VERSION}_sf{sf:g}_seed{seed}_rpf{rows_per_file}"
    src_stamp = f"_{_SCHEMA_VERSION}_sf{sf:g}_seed{seed}_rpf"
    written = {}
    for t in tables:
        out = os.path.join(data_dir, t)
        written[t] = table_row_counts(sf)[t]
        if os.path.exists(os.path.join(out, stamp)):
            continue
        src = os.path.join(src_dir, t)
        if not _glob.glob(os.path.join(_glob.escape(src), src_stamp + "*")):
            raise FileNotFoundError(f"{src} holds no {t} at sf {sf:g}, "
                                    f"seed {seed}")
        table = pa.concat_tables(
            pq.read_table(f) for f in
            sorted(_glob.glob(os.path.join(_glob.escape(src),
                                           "part-*.parquet"))))
        if os.path.isdir(out):
            shutil.rmtree(out)
        os.makedirs(out)
        n = table.num_rows
        for i in range(max(1, -(-n // rows_per_file))):
            pq.write_table(table.slice(i * rows_per_file, rows_per_file),
                           os.path.join(out, f"part-{i:05d}.parquet"),
                           row_group_size=_ROW_GROUP)
        with open(os.path.join(out, stamp), "w") as f:
            f.write(stamp + "\n")
    return written
