"""Synthetic TPC-H data generator (seeded), writing the same parquet as
``spark_rapids_tpu/bench/tpch_gen.py`` for the same scale factor and seed.

The random draws are the reference generator's, made in the same order,
so every table holds the same values.  What differs is speed, so that a
scale factor of 10 (60M lineitem rows) generates within a benchmark run:

* string columns are built only for the tables that are written, from
  the drawn codes, and the large ones (lineitem, orders) with pyarrow
  compute instead of a Python loop per row;
* lineitem line numbers come from a vectorized run-position computation
  instead of a per-row loop;
* lineitem, drawn last, is not drawn at all when it is not written.
"""
from __future__ import annotations

import os

import numpy as np

TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem")

_SCHEMA_VERSION = "v1"

_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
             "HOUSEHOLD"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
               "5-LOW"]
_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                 "TAKE BACK RETURN"]
_TYPES = [f"{a} {b} {c}" for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE",
                                   "ECONOMY", "PROMO")
          for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                    "BRUSHED")
          for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
_CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
               for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                         "CAN", "DRUM")]
_COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "black", "blanched", "blue", "blush", "brown", "burlywood",
           "burnished", "chartreuse", "chiffon", "chocolate", "coral",
           "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
           "dim", "dodger", "drab", "firebrick", "floral", "forest",
           "frosted", "gainsboro", "ghost", "goldenrod", "green",
           "grey", "honeydew", "hot", "hot pink", "indian", "ivory",
           "khaki", "lace", "lavender", "lawn", "lemon", "light",
           "lime", "linen", "magenta", "maroon", "medium", "metallic",
           "midnight", "mint", "misty", "moccasin", "navajo", "navy",
           "olive", "orange", "orchid", "pale", "papaya", "peach",
           "peru", "pink", "plum", "powder", "puff", "purple", "red",
           "rose", "rosy", "royal", "saddle", "salmon", "sandy",
           "seashell", "sienna", "sky", "slate", "smoke", "snow",
           "spring", "steel", "tan", "thistle", "tomato", "turquoise",
           "violet", "wheat", "white", "yellow"]

#: dates are DAYS since 1970-01-01 (DateType), TPC-H range 1992..1998
_DATE_LO = 8035    # 1992-01-01
_DATE_HI = 10591   # 1998-12-31

_DATE_COLS = {"o_orderdate", "l_shipdate", "l_commitdate",
              "l_receiptdate"}


def table_row_counts(sf: float) -> dict[str, int]:
    return {
        "region": 5,
        "nation": 25,
        "supplier": max(10, int(10_000 * sf)),
        "customer": max(30, int(150_000 * sf)),
        "part": max(40, int(200_000 * sf)),
        "partsupp": max(160, int(800_000 * sf)),
        "orders": max(300, int(1_500_000 * sf)),
        "lineitem": max(1200, int(6_000_000 * sf)),
    }


# -- lazy column builders (run only for written tables) ----------------------

def _pick(values: list[str], codes: np.ndarray):
    """values[codes] as a pyarrow string array."""
    def build():
        import pyarrow as pa
        return pa.array(values, type=pa.string()).take(
            pa.array(np.asarray(codes, dtype=np.int64)))
    return build


def _numbered(prefix: str, n: int):
    """[f"{prefix}{k}" for k in range(n)] as a pyarrow string array."""
    def build():
        import pyarrow as pa
        import pyarrow.compute as pc
        nums = pc.cast(pa.array(np.arange(n, dtype=np.int64)), pa.string())
        return pc.binary_join_element_wise(prefix, nums, "")
    return build


def _strings(fn):
    """A per-row Python formatter, deferred."""
    def build():
        import pyarrow as pa
        return pa.array(fn(), type=pa.string())
    return build


def _gen_region() -> dict:
    return {
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": _strings(lambda: list(_REGIONS)),
        "r_comment": _strings(lambda: [f"region comment {i}"
                                       for i in range(5)]),
    }


def _gen_nation() -> dict:
    return {
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": _strings(lambda: [n for n, _ in _NATIONS]),
        "n_regionkey": np.array([r for _, r in _NATIONS], dtype=np.int32),
        "n_comment": _strings(lambda: [f"nation comment {i}"
                                       for i in range(25)]),
    }


def _gen_supplier(rng, n: int) -> dict:
    marked = rng.choice(n, size=max(1, n // 100), replace=False)

    def comments():
        out = [f"supplier comment {i}" for i in range(n)]
        for i in marked:  # dbgen plants Complaint markers used by q16
            out[i] = f"blah Customer Complaints blah {i}"
        return out

    return {
        "s_suppkey": np.arange(1, n + 1, dtype=np.int32),
        "s_name": _strings(lambda: [f"Supplier#{k:09d}"
                                    for k in range(1, n + 1)]),
        "s_address": _strings(lambda: [f"addr {k}" for k in range(n)]),
        "s_nationkey": rng.integers(0, 25, n).astype(np.int32),
        "s_phone": _strings(lambda: [
            f"{11 + k % 25}-{k % 999:03d}-555-{k % 9999:04d}"
            for k in range(n)]),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n), 2),
        "s_comment": _strings(comments),
    }


def _gen_customer(rng, n: int) -> dict:
    nat = rng.integers(0, 25, n).astype(np.int32)
    return {
        "c_custkey": np.arange(1, n + 1, dtype=np.int32),
        "c_name": _strings(lambda: [f"Customer#{k:09d}"
                                    for k in range(1, n + 1)]),
        "c_address": _strings(lambda: [f"addr {k}" for k in range(n)]),
        "c_nationkey": nat,
        "c_phone": _strings(lambda: [
            f"{11 + v}-{k % 999:03d}-555-{k % 9999:04d}"
            for k, v in enumerate(nat)]),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n), 2),
        "c_mktsegment": _pick(_SEGMENTS, rng.integers(0, 5, n)),
        "c_comment": _numbered("customer comment ", n),
    }


def _gen_part(rng, n: int) -> dict:
    c1 = rng.integers(0, len(_COLORS), n)
    c2 = rng.integers(0, len(_COLORS), n)
    return {
        "p_partkey": np.arange(1, n + 1, dtype=np.int32),
        "p_name": _strings(lambda: [f"{_COLORS[a]} {_COLORS[b]}"
                                    for a, b in zip(c1, c2)]),
        "p_mfgr": _strings(lambda: [f"Manufacturer#{1 + k % 5}"
                                    for k in range(n)]),
        "p_brand": _strings(lambda: [f"Brand#{1 + k % 5}{1 + (k // 5) % 5}"
                                     for k in range(n)]),
        "p_type": _pick(_TYPES, rng.integers(0, len(_TYPES), n)),
        "p_size": rng.integers(1, 51, n).astype(np.int32),
        "p_container": _pick(_CONTAINERS,
                             rng.integers(0, len(_CONTAINERS), n)),
        "p_retailprice": np.round(900.0 + rng.uniform(0, 1200, n), 2),
        "p_comment": _numbered("part comment ", n),
    }


def _gen_partsupp(rng, n: int, n_part: int, n_supp: int) -> dict:
    part = np.repeat(np.arange(1, n_part + 1, dtype=np.int32), 4)[:n]
    supp = ((part * 7919 + np.tile(np.arange(4), n_part)[:n] *
             (n_supp // 4 + 1)) % n_supp + 1).astype(np.int32)
    m = len(part)
    return {
        "ps_partkey": part,
        "ps_suppkey": supp,
        "ps_availqty": rng.integers(1, 10_000, m).astype(np.int32),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, m), 2),
        "ps_comment": _numbered("partsupp comment ", m),
    }


def _clerks(n: int):
    def build():
        import pyarrow as pa
        import pyarrow.compute as pc
        nums = pc.cast(pa.array(np.arange(n, dtype=np.int64) % 1000),
                       pa.string())
        return pc.binary_join_element_wise(
            "Clerk#", pc.utf8_lpad(nums, 9, "0"), "")
    return build


def _gen_orders(rng, n: int, n_cust: int) -> dict:
    odate = rng.integers(_DATE_LO, _DATE_HI - 121, n).astype(np.int32)
    return {
        "o_orderkey": np.arange(1, n + 1, dtype=np.int32),
        "o_custkey": (rng.integers(1, max(n_cust * 2 // 3, 2), n)
                      .astype(np.int32)),
        "o_orderstatus": _pick(["F", "O", "P"], rng.integers(0, 3, n)),
        "o_totalprice": np.round(rng.uniform(800.0, 500_000.0, n), 2),
        "o_orderdate": odate,
        "o_orderpriority": _pick(_PRIORITIES, rng.integers(0, 5, n)),
        "o_clerk": _clerks(n),
        "o_shippriority": np.zeros(n, dtype=np.int32),
        "o_comment": _numbered("order comment ", n),
    }


def _gen_lineitem(rng, n: int, orders: dict, n_part: int,
                  n_supp: int) -> dict:
    n_ord = len(orders["o_orderkey"])
    # ~4 lines per order, line numbers 1..7
    oidx = np.sort(rng.integers(0, n_ord, n))
    okey = orders["o_orderkey"][oidx]
    odate = orders["o_orderdate"][oidx].astype(np.int64)
    # line number = position within the run of equal (sorted) order keys
    pos = np.arange(n, dtype=np.int64)
    new_run = np.ones(n, dtype=np.bool_)
    new_run[1:] = okey[1:] != okey[:-1]
    linenumber = pos - np.maximum.accumulate(np.where(new_run, pos, 0)) + 1
    qty = rng.integers(1, 51, n).astype(np.int32)
    price = np.round(rng.uniform(900.0, 2100.0, n) * qty, 2)
    disc = np.round(rng.integers(0, 11, n) * 0.01, 2)
    tax = np.round(rng.integers(0, 9, n) * 0.01, 2)
    ship = odate + rng.integers(1, 122, n)
    commit = odate + rng.integers(30, 91, n)
    receipt = ship + rng.integers(1, 31, n)
    # dbgen splits on the receipt date: R/A before 1995-06-17-ish, else N
    flag_codes = np.where(receipt <= 9204, rng.integers(0, 2, n), 2)
    return {
        "l_orderkey": okey.astype(np.int32),
        "l_partkey": rng.integers(1, n_part + 1, n).astype(np.int32),
        "l_suppkey": rng.integers(1, n_supp + 1, n).astype(np.int32),
        "l_linenumber": linenumber.astype(np.int32),
        "l_quantity": qty.astype(np.float64),
        "l_extendedprice": price,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": _pick(["R", "A", "N"], flag_codes),
        "l_linestatus": _pick(["F", "O"], (ship > 9204).astype(np.int64)),
        "l_shipdate": ship.astype(np.int32),
        "l_commitdate": commit.astype(np.int32),
        "l_receiptdate": receipt.astype(np.int32),
        "l_shipinstruct": _pick(_INSTRUCTIONS, rng.integers(0, 4, n)),
        "l_shipmode": _pick(_SHIPMODES, rng.integers(0, 7, n)),
        "l_comment": _numbered("line comment ", n),
    }


def _write_parquet(path: str, data: dict) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq
    arrays, names = [], []
    for name, arr in data.items():
        if callable(arr):
            arrays.append(arr())
        elif name in _DATE_COLS:
            arrays.append(pa.array(np.asarray(arr, dtype=np.int32),
                                   type=pa.date32()))
        else:
            arrays.append(pa.array(arr))
        names.append(name)
    os.makedirs(path, exist_ok=True)
    pq.write_table(pa.Table.from_arrays(arrays, names=names),
                   os.path.join(path, "part-0.parquet"))


def _stamp(data_dir: str, sf: float, seed: int, tables) -> str:
    which = "" if tables is None else "_" + "-".join(sorted(tables))
    return os.path.join(data_dir, f".generated_{_SCHEMA_VERSION}_"
                                  f"sf{sf:g}_seed{seed}{which}")


def generate_tpch(data_dir: str, sf: float = 0.01, seed: int = 7,
                  tables=None) -> bool:
    """Generate (or re-use) the TPC-H tables under ``data_dir``; only
    ``tables`` when given.  Returns False when a stamp shows the data is
    already there."""
    stamp = _stamp(data_dir, sf, seed, tables)
    if os.path.exists(stamp) or os.path.exists(
            _stamp(data_dir, sf, seed, None)):
        return False
    counts = table_row_counts(sf)
    os.makedirs(data_dir, exist_ok=True)
    want = set(tables or TABLES)
    rng = np.random.default_rng(seed)
    datasets: dict[str, dict] = {}
    datasets["region"] = _gen_region()
    datasets["nation"] = _gen_nation()
    datasets["supplier"] = _gen_supplier(rng, counts["supplier"])
    datasets["customer"] = _gen_customer(rng, counts["customer"])
    datasets["part"] = _gen_part(rng, counts["part"])
    datasets["partsupp"] = _gen_partsupp(rng, counts["partsupp"],
                                         counts["part"],
                                         counts["supplier"])
    datasets["orders"] = _gen_orders(rng, counts["orders"],
                                     counts["customer"])
    if "lineitem" in want:  # drawn last: the other tables do not wait
        datasets["lineitem"] = _gen_lineitem(rng, counts["lineitem"],
                                             datasets["orders"],
                                             counts["part"],
                                             counts["supplier"])
    for t in TABLES:
        if t in want:
            _write_parquet(os.path.join(data_dir, t), datasets.pop(t))
    with open(stamp, "w") as f:
        f.write("ok\n")
    return True
