"""TPC-DS q6 (the main path) and q3, q42, q52: the PyTorch/CUDA port
against the JAX package.

Both generators write q6's five tables at sf0.1, one parquet file per
table (the layout whose q6 plan has no exchange).  The port's generator
must write the same tables; each query must return the same rows in the
same order through ``TpuSession`` and ``TorchSession(device="cpu")``, and
q6's two planned trees must have the same operators.
"""
import os
import subprocess
import sys
from pathlib import Path

import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu.bench import tpcds_gen as jgen
from spark_rapids_tpu.bench import tpcds_queries as jq
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.bench import tpcds_gen as pgen
from spark_rapids_tpu_torch.bench.tpcds_queries import TPCDS_QUERIES

ROOT = Path(__file__).resolve().parent.parent
ONE_FILE = 1 << 40


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
    assert (counts["store_sales"], counts["customer"],
            counts["customer_address"], counts["item"],
            counts["date_dim"]) == (28_800_000, 501_187, 250_593, 56_920,
                                    73_049)
    # the default layout splits a table into 2^20-row files, as the JAX one
    pgen.generate_tpcds(str(tmp_path), sf=0.01, tables=("date_dim",),
                        rows_per_file=30_000)
    assert len([f for f in os.listdir(tmp_path / "date_dim")
                if f.endswith(".parquet")]) == 3


@pytest.mark.parametrize("name", list(TPCDS_QUERIES))
def test_query_rows_match_jax(dirs, name):
    jdir, _pdir = dirs
    want = getattr(jq, name)(TpuSession(), jdir).collect()
    got = TPCDS_QUERIES[name][0](TorchSession(device="cpu"), jdir).collect()
    assert got == want
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
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spark_rapids_tpu' or m.startswith('spark_rapids_tpu.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
