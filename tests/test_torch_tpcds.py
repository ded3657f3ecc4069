"""TPC-DS q6 (the main path) and every other query of the port's
``TPCDS_QUERIES``: the PyTorch/CUDA port against the JAX package.

Both generators write the port's tables at sf0.1, one parquet file per
table (the layout whose q6 plan has no exchange).  The port's generator
must write the same tables; each query must return the same rows in the
same order through ``TpuSession`` and ``TorchSession(device="cpu")``, and
q6's two planned trees must have the same operators.

q24 and q84 return no rows below SF1 in both packages (no store in
market 8; no address in Edgewood at any scale), so at SF0.01 their rows
(empty) and explain trees are compared, and two variants built here
through both packages' DataFrame APIs carry rows: q84 without its city
filter (the port's ``q84_all_cities``) and q24 over the market of an
existing store, joining the address on the customer's own address key.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu.bench import tpcds_gen as jgen
from spark_rapids_tpu.bench import tpcds_queries as jq
from spark_rapids_tpu.bench import tpcds_queries4 as jq4
from spark_rapids_tpu.bench import tpcds_queries5 as jq5
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import conditional as JCo
from spark_rapids_tpu.expr import core as JC
from spark_rapids_tpu.expr import strings as JS
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.bench import tpcds_gen as pgen
from spark_rapids_tpu_torch.bench.tpcds_queries import TPCDS_QUERIES
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import core as PC
from spark_rapids_tpu_torch.expr import strings as PS

ROOT = Path(__file__).resolve().parent.parent
ONE_FILE = 1 << 40
#: queries that return no rows below SF1 in both packages
EMPTY_BELOW_SF1 = ("q24", "q84")
#: the returns table and the demographics tables it is joined with
RETURNS_TABLES = ("customer_demographics", "household_demographics",
                  "income_band", "store_returns")


def _jt(session, data_dir, table, columns=None):
    return session.read_parquet(os.path.join(data_dir, table),
                                columns=columns)


def _jax_q84_all_cities(session, data_dir):
    """The reference's q84 (tpcds_queries4.py) without its ca_city
    filter, through the JAX package's DataFrame API."""
    col, lit = JC.col, JC.lit
    cu = _jt(session, data_dir, "customer",
             ["c_customer_sk", "c_customer_id", "c_first_name",
              "c_last_name", "c_current_addr_sk", "c_current_cdemo_sk",
              "c_current_hdemo_sk"])
    ca = _jt(session, data_dir, "customer_address",
             ["ca_address_sk", "ca_city"]).select(col("ca_address_sk"))
    hd = _jt(session, data_dir, "household_demographics",
             ["hd_demo_sk", "hd_income_band_sk"])
    ib = _jt(session, data_dir, "income_band") \
        .where((col("ib_lower_bound") >= lit(38128))
               & (col("ib_upper_bound") <= lit(38128 + 50000))) \
        .select(col("ib_income_band_sk"))
    sr = _jt(session, data_dir, "store_returns", ["sr_cdemo_sk"]) \
        .select(col("sr_cdemo_sk"))
    cd = _jt(session, data_dir, "customer_demographics", ["cd_demo_sk"])
    name = JS.Concat(JCo.Coalesce(col("c_last_name"), lit("")), lit(", "),
                     JCo.Coalesce(col("c_first_name"), lit("")))
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


def _jax_query(name):
    if name == "q84_all_cities":
        return _jax_q84_all_cities
    return getattr(jq, name, None) or getattr(jq4, name, None) \
        or getattr(jq5, name)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("tpcds_torch")
    jdir, pdir = str(base / "jax"), str(base / "port")
    jgen.generate_tpcds(jdir, sf=0.1, tables=pgen.TABLES,
                        rows_per_file=ONE_FILE)
    pgen.generate_tpcds(pdir, sf=0.1, rows_per_file=ONE_FILE)
    return jdir, pdir


def _node_names(explain: str) -> list:
    out = []
    for line in explain.splitlines():
        name = line.strip().lstrip("*!").strip().split("[")[0]
        out.append((len(line) - len(line.lstrip()), name))
    return out


@pytest.mark.parametrize("table", pgen.TABLES)
def test_generator_writes_the_jax_tables(dirs, table):
    jdir, pdir = dirs
    files = sorted(os.listdir(os.path.join(pdir, table)))
    assert [f for f in files if f.endswith(".parquet")] == \
        ["part-00000.parquet"]
    a = pq.read_table(os.path.join(jdir, table, "part-00000.parquet"))
    b = pq.read_table(os.path.join(pdir, table, "part-00000.parquet"))
    assert a.schema.equals(b.schema)
    for name in a.column_names:
        assert a.column(name).equals(b.column(name)), (table, name)
    assert b.num_rows == pgen.table_row_counts(0.1)[table]


def test_generator_reuses_and_counts(dirs, tmp_path):
    _jdir, pdir = dirs
    stamp = [f for f in os.listdir(os.path.join(pdir, "item"))
             if f.startswith("_")]
    assert len(stamp) == 1
    mtime = os.path.getmtime(os.path.join(pdir, "item", "part-00000.parquet"))
    pgen.generate_tpcds(pdir, sf=0.1, tables=("item",),
                        rows_per_file=ONE_FILE)
    assert os.path.getmtime(os.path.join(
        pdir, "item", "part-00000.parquet")) == mtime  # reused
    counts = pgen.table_row_counts(10)
    assert counts == {k: v for k, v in jgen.table_row_counts(10).items()
                      if k in counts}
    assert (counts["store_sales"], counts["catalog_sales"],
            counts["customer"], counts["customer_address"], counts["item"],
            counts["date_dim"]) == (28_800_000, 14_400_000, 501_187,
                                    250_593, 56_920, 73_049)
    assert tuple(counts[t] for t in RETURNS_TABLES) == (158_113, 7_200, 20,
                                                        2_880_000)
    # the default layout splits a table into 2^20-row files, as the JAX one
    pgen.generate_tpcds(str(tmp_path), sf=0.01, tables=("date_dim",),
                        rows_per_file=30_000)
    assert len([f for f in os.listdir(tmp_path / "date_dim")
                if f.endswith(".parquet")]) == 3


def _same_rows(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                assert math.isclose(a, b, rel_tol=rtol, abs_tol=1e-9) \
                    or (math.isnan(a) and math.isnan(b)), (g, w)
            else:
                assert a == b, (g, w)


@pytest.mark.parametrize("name", list(TPCDS_QUERIES))
def test_query_rows_match_jax(dirs, name):
    jdir, _pdir = dirs
    want = _jax_query(name)(TpuSession(), jdir).collect()
    pdf = TPCDS_QUERIES[name][0](TorchSession(device="cpu"), jdir)
    got = pdf.collect()
    if "WindowExec" in pdf.explain():
        # a frame sum is a segmented scan here and a difference of
        # whole-batch prefix sums in the reference: the last bits differ
        _same_rows(got, want, rtol=1e-12)
    else:
        assert got == want
    if name in EMPTY_BELOW_SF1:
        assert got == []
    else:
        assert len(got) > 0
    if name == "q6":
        assert len(got) == 51
        cnts = [r[1] for r in got]
        assert cnts == sorted(cnts) and min(cnts) >= 10


def test_q6_on_port_generated_data_matches(dirs):
    jdir, pdir = dirs
    q6 = TPCDS_QUERIES["q6"][0]
    assert q6(TorchSession(device="cpu"), pdir).collect() == \
        q6(TorchSession(device="cpu"), jdir).collect()


def test_q6_plan_matches_jax(dirs):
    jdir, _pdir = dirs
    want = _node_names(jq.q6(TpuSession(), jdir).explain())
    got = _node_names(TPCDS_QUERIES["q6"][0](TorchSession(device="cpu"),
                                             jdir).explain())
    assert got == want
    names = [n for _i, n in got]
    assert names[:5] == ["GlobalLimitExec", "SortExec", "FilterExec",
                         "HashAggregateExec", "CoalesceBatchesExec"]
    assert names.count("JoinExec") == 5
    assert "ShuffleExchangeExec" not in names


def test_q6_path_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        "import spark_rapids_tpu_torch as P\n"
        "from spark_rapids_tpu_torch.bench import tpcds_gen\n"
        "from spark_rapids_tpu_torch.bench.tpcds_queries import q6\n"
        f"d = {str(tmp_path)!r}\n"
        "tpcds_gen.generate_tpcds(d, sf=0.1, rows_per_file=1 << 40)\n"
        "rows = q6(P.TorchSession(device='cpu'), d).collect()\n"
        "assert len(rows) == 51, rows\n"
        "from spark_rapids_tpu_torch.bench.tpcds_queries import (q24, q84,"
        " q84_all_cities)\n"
        "assert q24(P.TorchSession(device='cpu'), d).collect() == []\n"
        "assert q84(P.TorchSession(device='cpu'), d).collect() == []\n"
        "rows = q84_all_cities(P.TorchSession(device='cpu'), d).collect()\n"
        "assert len(rows) == 100, rows\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spark_rapids_tpu' or m.startswith('spark_rapids_tpu.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# the returns tables, q24 and q84 at SF0.01
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sf001(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpcds_sf001") / "jax")
    jgen.generate_tpcds(d, sf=0.01, tables=pgen.TABLES,
                        rows_per_file=ONE_FILE)
    return d


def _same_tables(a_dir, b_dir, table):
    a = pq.read_table(os.path.join(a_dir, table, "part-00000.parquet"))
    b = pq.read_table(os.path.join(b_dir, table, "part-00000.parquet"))
    assert a.schema.equals(b.schema), table
    assert a.equals(b), table


@pytest.mark.parametrize("parent_on_disk", [False, True])
def test_returns_tables_match_jax_at_sf001(sf001, tmp_path, parent_on_disk):
    """store_returns is sampled from store_sales' rows: generated in the
    same call, or with store_sales already on disk (made again in
    memory), the four new tables are the reference's."""
    d = str(tmp_path / "port")
    if parent_on_disk:
        pgen.generate_tpcds(d, sf=0.01, tables=("store_sales",),
                            rows_per_file=ONE_FILE)
        pgen.generate_tpcds(d, sf=0.01, tables=RETURNS_TABLES,
                            rows_per_file=ONE_FILE)
    else:
        pgen.generate_tpcds(d, sf=0.01, tables=("store_sales",)
                            + RETURNS_TABLES, rows_per_file=ONE_FILE)
    for t in RETURNS_TABLES + ("store_sales",):
        _same_tables(sf001, d, t)


@pytest.mark.parametrize("name", EMPTY_BELOW_SF1)
def test_empty_queries_match_jax_at_sf001(sf001, name):
    jdf = _jax_query(name)(TpuSession(), sf001)
    pdf = TPCDS_QUERIES[name][0](TorchSession(device="cpu"), sf001)
    assert _node_names(pdf.explain()) == _node_names(jdf.explain())
    assert pdf.collect() == jdf.collect() == []


def test_q84_all_cities_matches_jax_at_sf001(sf001):
    jdf = _jax_q84_all_cities(TpuSession(), sf001)
    pdf = TPCDS_QUERIES["q84_all_cities"][0](TorchSession(device="cpu"),
                                             sf001)
    assert _node_names(pdf.explain()) == _node_names(jdf.explain())
    got = pdf.collect()
    assert got == jdf.collect()
    assert len(got) == 100 and all(", " in r[1] for r in got)


def _q24_market(X, session, data_dir, market):
    """q24 over the stores of ``market``, joining the address on
    (c_birth_country, upper(ca_country)) and the customer's own address
    (c_current_addr_sk, ca_address_sk); X holds one package's col, lit,
    Sum, Average and Upper."""
    col, lit = X.col, X.lit
    ss = _jt(session, data_dir, "store_sales",
             ["ss_ticket_number", "ss_item_sk", "ss_customer_sk",
              "ss_store_sk", "ss_net_paid"])
    sr = _jt(session, data_dir, "store_returns",
             ["sr_ticket_number", "sr_item_sk"])
    st = _jt(session, data_dir, "store",
             ["s_store_sk", "s_store_name", "s_market_id", "s_state",
              "s_zip"]).where(col("s_market_id") == lit(market))
    it = _jt(session, data_dir, "item",
             ["i_item_sk", "i_color", "i_current_price", "i_manager_id",
              "i_units", "i_size"])
    cu = _jt(session, data_dir, "customer",
             ["c_customer_sk", "c_first_name", "c_last_name",
              "c_birth_country", "c_current_addr_sk"])
    ca = _jt(session, data_dir, "customer_address",
             ["ca_address_sk", "ca_state", "ca_country", "ca_zip"]) \
        .with_column("ca_country_up", X.Upper(col("ca_country")))
    base = ss.join(sr, on=[("ss_ticket_number", "sr_ticket_number"),
                           ("ss_item_sk", "sr_item_sk")]) \
        .join(st, on=[("ss_store_sk", "s_store_sk")]) \
        .join(it, on=[("ss_item_sk", "i_item_sk")]) \
        .join(cu, on=[("ss_customer_sk", "c_customer_sk")]) \
        .join(ca, on=[("c_birth_country", "ca_country_up"),
                      ("c_current_addr_sk", "ca_address_sk")])
    ssales = base.group_by("c_last_name", "c_first_name", "s_store_name",
                           "ca_state", "s_state", "i_color",
                           "i_current_price", "i_manager_id", "i_units",
                           "i_size") \
        .agg(X.Sum(col("ss_net_paid")).alias("netpaid"))
    avg_rows = ssales.agg(X.Average(col("netpaid")).alias("a")).collect()
    threshold = 0.05 * float(avg_rows[0][0] or 0.0)
    return ssales.where(col("i_color") == lit("pale")) \
        .group_by("c_last_name", "c_first_name", "s_store_name") \
        .agg(X.Sum(col("netpaid")).alias("paid")) \
        .where(col("paid") > lit(threshold)) \
        .order_by(("c_last_name", True), ("c_first_name", True),
                  ("s_store_name", True), ("paid", True))


def test_q24_variant_with_rows_matches_jax_at_sf001(sf001):
    import types
    J = types.SimpleNamespace(col=JC.col, lit=JC.lit, Sum=JA.Sum,
                              Average=JA.Average, Upper=JS.Upper)
    P = types.SimpleNamespace(col=PC.col, lit=PC.lit, Sum=PA.Sum,
                              Average=PA.Average, Upper=PS.Upper)
    market = pq.read_table(os.path.join(sf001, "store"),
                           columns=["s_market_id"]).column(0)[0].as_py()
    jdf = _q24_market(J, TpuSession(), sf001, market)
    pdf = _q24_market(P, TorchSession(device="cpu"), sf001, market)
    assert _node_names(pdf.explain()) == _node_names(jdf.explain())
    got = pdf.collect()
    assert got == jdf.collect()
    assert len(got) >= 1
