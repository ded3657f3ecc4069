"""TPC-H q14 and q22, the string paths: the PyTorch/CUDA port against the
JAX package at SF0.01.

q14 matches ``p_type LIKE 'PROMO%'`` (K13b's prefix mode) inside an
``If`` under a grand aggregate over a join; q22 takes
``substring(c_phone, 1, 2)`` of every customer (K13a), filters it with
``In``, collects a scalar subquery (the average positive balance) and
anti-joins orders.  Both run through ``TpuSession`` and
``TorchSession(device="cpu")`` over the same parquet; rows must be equal,
in order, and the planned trees must have the same operators.
"""
import os
import subprocess
import sys
from pathlib import Path

import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu.bench import tpch_gen as jgen
from spark_rapids_tpu.bench import tpch_queries as jq
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.bench import tpch_gen as pgen
from spark_rapids_tpu_torch.bench.tpch_queries import TPCH_QUERIES

ROOT = Path(__file__).resolve().parent.parent
CODES = ["13", "17", "18", "23", "29", "30", "31"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_strings") / "sf001")
    jgen.generate_tpch(d, sf=0.01)
    return d


def _node_names(explain: str) -> list:
    out = []
    for line in explain.splitlines():
        name = line.strip().lstrip("*!").strip().split("[")[0]
        out.append((len(line) - len(line.lstrip()), name))
    return out


@pytest.mark.parametrize("name", ["q14", "q22"])
def test_query_rows_match_jax(data_dir, name):
    want = getattr(jq, name)(TpuSession(), data_dir).collect()
    got = TPCH_QUERIES[name](TorchSession(device="cpu"), data_dir).collect()
    assert got == want
    if name == "q14":
        assert len(got) == 1 and 0.0 < got[0][0] < 100.0
    else:
        assert [r[0] for r in got] == CODES
        assert all(isinstance(r[1], int) and r[1] > 0 for r in got)


@pytest.mark.parametrize("name", ["q14", "q22"])
def test_query_plans_match_jax(data_dir, name):
    want = _node_names(getattr(jq, name)(TpuSession(), data_dir).explain())
    pdf = TPCH_QUERIES[name](TorchSession(device="cpu"), data_dir)
    got = _node_names(pdf.explain())
    assert got == want
    names = [n for _i, n in got]
    if name == "q14":
        assert names[:3] == ["HashAggregateExec", "CoalesceBatchesExec",
                             "JoinExec"]
    else:
        assert "JoinExec[anti" in pdf.explain()
        assert names[:4] == ["SortExec", "HashAggregateExec",
                             "CoalesceBatchesExec", "JoinExec"]


def test_generator_writes_the_string_tables_without_lineitem(data_dir,
                                                             tmp_path):
    """part, customer and orders alone are the reference's tables (the
    one rng draws lineitem last, so skipping it changes nothing)."""
    assert pgen.generate_tpch(str(tmp_path), sf=0.01,
                              tables=("customer", "orders", "part"))
    assert not os.path.exists(tmp_path / "lineitem")
    for t in ("customer", "orders", "part"):
        a = pq.read_table(os.path.join(data_dir, t, "part-0.parquet"))
        b = pq.read_table(tmp_path / t / "part-0.parquet")
        assert a.equals(b), t
    assert not pgen.generate_tpch(str(tmp_path), sf=0.01,
                                  tables=("customer", "orders", "part"))


def test_string_paths_import_no_jax(tmp_path):
    code = (
        "import sys\n"
        "import spark_rapids_tpu_torch as P\n"
        "from spark_rapids_tpu_torch.bench import tpch_gen\n"
        "from spark_rapids_tpu_torch.bench.tpch_queries import q14, q22\n"
        f"d = {str(tmp_path)!r}\n"
        "tpch_gen.generate_tpch(d, sf=0.01)\n"
        "s = P.TorchSession(device='cpu')\n"
        "assert len(q14(s, d).collect()) == 1\n"
        "assert len(q22(s, d).collect()) == 7\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spark_rapids_tpu' or m.startswith('spark_rapids_tpu.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
