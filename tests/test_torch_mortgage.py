"""The mortgage aggregate jobs of the PyTorch/CUDA port against the JAX
package, and the pieces they brought into the port.

``simple_agg``, ``percentiles`` and ``agg_join`` run through ``TpuSession``
and ``TorchSession(device="cpu")`` over the same files -- those of the
reference's generator at sf0.2 and those of the port's vectorized one --
and must return the same rows in the same order (keys exactly, doubles
within rtol 1e-9) with the same planned operators.  Beside them: the
CSV scan (headerless, pipe-delimited, empty fields), ``union``,
``First``/``Last`` with and without ignoreNulls, ``Round``,
``ParseDateFixed``/``Month``/``Year``, ``hex(hash(long))`` and the
holistic aggregate's rules, each against the reference through both
sessions on one parquet or CSV file.  The percentile kernel's arithmetic
and ``Hex``'s are held against the reference's device branches in
``test_torch_segmented.py`` and ``test_torch_strings.py``.
"""
import ast
import datetime as dt
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.bench import mortgage as jm
from spark_rapids_tpu.bench.mortgage_gen import \
    generate_mortgage as jgenerate
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import core as JC
from spark_rapids_tpu.expr import datetime_ops as JD
from spark_rapids_tpu.expr import hashing as JH
from spark_rapids_tpu.expr import math_ops as JM
from spark_rapids_tpu.expr import strings as JS
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench import mortgage as pm
from spark_rapids_tpu_torch.bench import mortgage_gen as pgen
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import core as PC
from spark_rapids_tpu_torch.expr import datetime_ops as PD
from spark_rapids_tpu_torch.expr import hashing as PH
from spark_rapids_tpu_torch.expr import math_ops as PM
from spark_rapids_tpu_torch.expr import strings as PS

ROOT = Path(__file__).resolve().parent.parent
JOBS = ["simple_agg", "percentiles", "agg_join"]
RTOL = 1e-9


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mortgage")
    ref, port = str(base / "reference_sf02"), str(base / "port_sf02")
    jgenerate(ref, sf=0.2)
    assert pgen.generate_mortgage(port, sf=0.2, seed=11)
    return {"reference": ref, "port": port}


def _cpu():
    return TorchSession(device="cpu")


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert a == b or (math.isnan(a) and math.isnan(b)) or \
                    abs(a - b) <= RTOL * abs(b), (g, w)
            else:
                assert a == b, (g, w)


def _node_names(explain: str) -> list:
    out = []
    for line in explain.splitlines():
        name = line.strip().lstrip("*!").strip().split("[")[0]
        out.append((len(line) - len(line.lstrip()), name))
    return out


@pytest.mark.parametrize("job", JOBS)
@pytest.mark.parametrize("gen", ["reference", "port"])
def test_job_rows_match_jax(data_dirs, gen, job):
    d = data_dirs[gen]
    want = jm.MORTGAGE_QUERIES[job](TpuSession({}), d).collect()
    got = pm.MORTGAGE_QUERIES[job](_cpu(), d).collect()
    _same_rows(got, want)
    if job != "simple_agg":  # one group a loan: 200 loans, no collision
        assert len(got) == 200
    assert len(got) >= 200
    if job == "agg_join":  # every performance loan has its acquisition
        assert all(r[0] == r[2] and r[3] is not None for r in got)


def _scan_cols(explain: str) -> list:
    """The columns of each CSV scan of an explain tree, in tree order."""
    return [ast.literal_eval(m) for m in re.findall(r"CsvScanExec\[csv, \d+ files?, "
                                        r"cols=(\[[^\]]*\])\]", explain)]


@pytest.mark.parametrize("job", JOBS)
def test_job_plans_match_jax(data_dirs, job):
    d = data_dirs["reference"]
    jexplain = jm.MORTGAGE_QUERIES[job](TpuSession({}), d).explain()
    want = _node_names(jexplain)
    pdf = pm.MORTGAGE_QUERIES[job](_cpu(), d)
    got = _node_names(pdf.explain())
    assert got == want
    # the reference's jobs parse every column; the port's name the ones
    # they read (no column-pruning pass yet), in the schema's order
    full = {len(jm.perf_schema().names), len(jm.acq_schema().names)}
    pairs = list(zip(_scan_cols(pdf.explain()), _scan_cols(jexplain)))
    assert len(pairs) == sum(n == "CsvScanExec" for _i, n in got)
    for mine, theirs in pairs:
        assert len(theirs) in full
        assert mine == [c for c in theirs if c in mine]
    names = [n for _i, n in got]
    assert names.count("CsvScanExec") == 4 * (1 if job == "percentiles"
                                              else 2)
    assert names.count("UnionExec") == 3 * (1 if job == "percentiles"
                                            else 2)
    if job == "percentiles":  # holistic: complete, no exchange
        assert "HashAggregateExec[complete" in pdf.explain()
        assert "ShuffleExchangeExec" not in names


def test_etl_is_not_ported_yet(data_dirs):
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        pm.MORTGAGE_QUERIES["etl"](_cpu(), data_dirs["port"])


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def _lines(d, sub, prefix):
    out = {}
    for q in pgen.QUARTERS:
        with open(os.path.join(d, sub, f"{prefix}_{q}.txt_0")) as f:
            out[q] = f.read().splitlines()
    return out


_NUM3 = re.compile(r"^\d+\.\d{3}$")
_INT = re.compile(r"^-?\d+$")


def _shape(field: str) -> str:
    """What a field looks like: empty, a %.3f float, an int, MM/01/yyyy,
    MM/yyyy or other text."""
    if field == "":
        return "empty"
    if _NUM3.match(field):
        return "f3"
    if _INT.match(field):
        return "int"
    if re.match(r"^\d\d/01/\d{4}$", field):
        return "MM/01/yyyy"
    if re.match(r"^\d\d/\d{4}$", field):
        return "MM/yyyy"
    return "text"


@pytest.mark.parametrize("sub,prefix,width", [
    ("perf", "Performance", 30), ("acq", "Acquisition", 25)])
def test_generator_writes_the_reference_formats(data_dirs, sub, prefix,
                                                width):
    """Same files, the same number of fields a line, and each column
    drawn from the same kinds of fields (empty, %.3f, int, date, text)."""
    ref = _lines(data_dirs["reference"], sub, prefix)
    port = _lines(data_dirs["port"], sub, prefix)
    assert os.path.exists(os.path.join(data_dirs["port"], "_DONE"))

    def shapes(lines):
        cols = [set() for _ in range(width)]
        for q_lines in lines.values():
            for line in q_lines:
                fields = line.split("|")
                assert len(fields) == width, line
                for c, f in zip(cols, fields):
                    c.add(_shape(f))
        return cols

    assert shapes(port) == shapes(ref)
    schema = pgen.perf_schema() if sub == "perf" else pgen.acq_schema()
    assert [f.name for f in schema] == \
        [f.name for f in (jm.perf_schema() if sub == "perf"
                          else jm.acq_schema())]
    assert [f.data_type.name for f in schema] == \
        [f.data_type.name for f in (jm.perf_schema() if sub == "perf"
                                    else jm.acq_schema())]


def test_generator_draws_the_reference_distributions(data_dirs, tmp_path):
    """50 loans a quarter, 6..29 months each in order from the loan's
    origination month, one rate a loan, and a delinquency ratchet (1, 2,
    ... up to 9 to the end) on some loans; a second call reuses."""
    perf = _lines(data_dirs["port"], "perf", "Performance")
    acq = _lines(data_dirs["port"], "acq", "Acquisition")
    ids = set()
    for q in pgen.QUARTERS:
        assert len(acq[q]) == 50
        orig = {int(r.split("|")[0]): r.split("|")[6] for r in acq[q]}
        ids |= set(orig)
        rows: dict = {}
        for line in perf[q]:
            f = line.split("|")
            rows.setdefault(int(f[0]), []).append(f)
        assert set(rows) == set(orig)
        ratchets = 0
        for loan, fs in rows.items():
            assert 6 <= len(fs) <= 29
            assert len({f[3] for f in fs}) == 1
            assert fs[0][1][:2] + fs[0][1][5:] == orig[loan]
            status = [int(f[10]) for f in fs]
            if status[-1]:
                ratchets += 1
                first = status.index(1)
                assert status[first:] == [min(i + 1, 9) for i in
                                          range(len(status) - first)]
                assert not any(status[:first])
        assert 0 < ratchets < 50
    assert ids == set(range(100001, 100201))
    assert not pgen.generate_mortgage(data_dirs["port"], sf=0.2, seed=11)


def test_mortgage_path_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        "import spark_rapids_tpu_torch as P\n"
        "from spark_rapids_tpu_torch.bench import mortgage as m\n"
        f"d = {str(tmp_path)!r}\n"
        "m.generate_mortgage(d, sf=0.1, seed=3)\n"
        "for job in ('simple_agg', 'percentiles', 'agg_join'):\n"
        "    rows = m.MORTGAGE_QUERIES[job](P.TorchSession(device='cpu'),"
        " d).collect()\n"
        "    assert rows, job\n"
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
# scan and union
# ---------------------------------------------------------------------------

_CSV_FIELDS = [("id", "LongType"), ("name", "StringType"),
               ("x", "DoubleType"), ("n", "IntegerType"),
               ("tag", "StringType")]


def _schemas():
    return (JT.Schema([JT.StructField(n, getattr(JT, t)())
                       for n, t in _CSV_FIELDS]),
            PT.Schema([PT.StructField(n, getattr(PT, t)())
                       for n, t in _CSV_FIELDS]))


@pytest.mark.parametrize("header,delim", [(False, "|"), (True, ",")])
def test_csv_scan_matches_jax(tmp_path, header, delim):
    """Empty numeric fields are null, empty strings are "" (not null)."""
    rows = [["1", "a", "1.500", "7", "x"], ["2", "", "", "", ""],
            ["-3", "bb", "-0.000", "", "Y"], ["4", "ccc", "1e300", "9", ""]]
    rows += [[str(i), f"n{i}", f"{i / 8:.3f}", str(i % 5), "Z" * (i % 3)]
             for i in range(5, 300)]
    path = tmp_path / "t.csv"
    text = "\n".join(delim.join(r) for r in rows) + "\n"
    if header:
        text = delim.join(n for n, _t in _CSV_FIELDS) + "\n" + text
    path.write_text(text)
    js, ps = _schemas()
    want = TpuSession({}).read_csv(str(path), schema=js, header=header,
                                   delimiter=delim).collect()
    pdf = _cpu().read_csv(str(path), schema=ps, header=header,
                          delimiter=delim)
    got = pdf.collect()
    assert got == want
    assert got[1] == (2, "", None, None, "")
    assert len(got) == len(rows)
    assert pdf.schema.names == [n for n, _t in _CSV_FIELDS]
    sub = _cpu().read_csv(str(path), schema=ps, header=header,
                          delimiter=delim, columns=["tag", "id"]).collect()
    assert sub == [(r[4], r[0]) for r in got]
    with pytest.raises(NotImplementedError, match="Queue 1"):
        _cpu().read_csv(str(path))


def test_union_matches_jax(tmp_path):
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    a.write_text("1|x|0.5|1|\n2||1.5||t\n")
    b.write_text("3|yy|2.5|3|u\n")
    js, ps = _schemas()
    j = TpuSession({})
    p = _cpu()

    def both(s, schema):
        def rd(f):
            return s.read_csv(str(f), schema=schema, header=False,
                              delimiter="|")
        return rd(a).union(rd(b)).union(rd(a))

    pdf = both(p, ps)
    assert pdf.collect() == both(j, js).collect()
    assert len(pdf.collect()) == 5
    assert _node_names(pdf.explain()) == _node_names(both(j, js).explain())
    wrong = p.read_csv(str(a), schema=ps, header=False, delimiter="|") \
        .select(PC.col("name"), PC.col("id"))
    with pytest.raises(ValueError, match="union schema mismatch"):
        both(p, ps).union(wrong).collect()


# ---------------------------------------------------------------------------
# expressions, through both sessions over one parquet file
# ---------------------------------------------------------------------------

def _both(tmp_path, table: pa.Table, build):
    """``build(session, E, col)`` over ``table`` in each engine, E the
    engine's expression modules; returns (port rows, reference rows)."""
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path)
    jE = dict(A=JA, C=JC, D=JD, H=JH, M=JM, S=JS)
    pE = dict(A=PA, C=PC, D=PD, H=PH, M=PM, S=PS)
    want = build(TpuSession({}).read_parquet(path), jE, JC.col).collect()
    got = build(_cpu().read_parquet(path), pE, PC.col).collect()
    return got, want


def test_first_last_match_jax(tmp_path):
    rng = np.random.default_rng(41)
    n = 500
    k = rng.integers(0, 12, n)
    x = rng.integers(-50, 50, n).astype(np.float64)
    null = (rng.random(n) < 0.4) | (k == 5)  # group 5: all null
    null[np.flatnonzero(k == 3)[:3]] = True  # group 3 starts with nulls
    table = pa.table({"k": k, "x": pa.array(x, mask=null)})
    for ignore in (False, True):
        got, want = _both(tmp_path, table, lambda df, E, c: df.group_by("k")
                          .agg(E["A"].First(c("x"), ignore).alias("f"),
                               E["A"].Last(c("x"), ignore).alias("l"))
                          .order_by(("k", True)))
        assert got == want
        assert len(got) == 12
        by_k = dict((r[0], r[1:]) for r in got)
        assert by_k[5] == (None, None)
        rows3 = [None if m else v for v, m, kk in zip(x, null, k) if kk == 3]
        assert by_k[3][0] == (next(v for v in rows3 if v is not None)
                              if ignore else None)
    # both modes in one aggregation stay apart
    got, _want = _both(tmp_path, table, lambda df, E, c: df.group_by("k")
                       .agg(E["A"].First(c("x")).alias("f"),
                            E["A"].First(c("x"), True).alias("fn"))
                       .order_by(("k", True)))
    assert dict((r[0], r[1]) for r in got)[3] is None
    assert dict((r[0], r[2]) for r in got)[3] is not None


def test_round_matches_jax(tmp_path):
    """The reference's device formula: ties away from zero through
    floor(|x| * 10^s + 0.5) * 10^-s, so 5.393 at 4 places is
    5.393000000000001; NaN, +-inf and |x| >= 2^53 unchanged."""
    vals = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 5.393, 6.145, 3.235, 1.00005,
            -1.00005, 0.125, -0.125, 123.456789, -0.0, 0.0, np.nan, np.inf,
            -np.inf, 2.0 ** 53, -(2.0 ** 53) - 2, 2.0 ** 60 + 0.0, 1e-300,
            7.34, 7.792, 9.99995, -9.99995, None]
    rng = np.random.default_rng(43)
    vals += list(np.round(rng.normal(size=200) * 100, 5))
    ints = list(rng.integers(-10 ** 6, 10 ** 6, len(vals)))
    ints[:4] = [15, -15, 25, -2 ** 63]
    table = pa.table({"x": pa.array(vals, type=pa.float64()),
                      "i": pa.array(ints, type=pa.int64()),
                      "f": pa.array([None if v is None else float(v)
                                     for v in vals], type=pa.float32())})
    scales = [0, 1, 2, 3, 4, -1]
    got, want = _both(tmp_path, table, lambda df, E, c: df.select(
        *[E["M"].Round(c("x"), s).alias(f"x{s}") for s in scales],
        *[E["M"].Round(c("i"), s).alias(f"i{s}") for s in (-2, -1, 0, 2)],
        *[E["M"].Round(c("f"), s).alias(f"f{s}") for s in (0, 2)]))
    assert len(got) == len(want) == len(vals)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a == b or (a != a and b != b), (g, w)
    assert got[6][4] == 5.393000000000001 and got[6][3] == 5.393
    assert got[0][0] == 1.0 and got[3][0] == -1.0
    assert got[0][7] == 20 and got[1][7] == -20


_DATES = ["01/02/2003", "12/31/1999", "02/29/2004", "02/29/2003",
          "1/02/2003", "13/01/2003", "02/30/2003", "00/10/2003",
          "04/31/2003", "04/30/2003", "01/02/200", "01/02/20033",
          "01-02-2003", "ab/cd/efgh", "", None, "09/01/2003 ", " 9/01/2003",
          "06/01/2018", "02/29/2000", "02/29/1900"]
_MONTHS = ["01/2003", "12/2030", "13/2003", "00/2003", "1/2003", "06-2003",
           "06/20a3", "", None, "07/2003"]


def test_parse_date_fixed_matches_jax(tmp_path):
    """Wrong length, non-digits, a bad separator, month 0 or 13 and days
    past the month's end are null; Month and Year of what parses."""
    n = max(len(_DATES), len(_MONTHS))
    table = pa.table({
        "d": pa.array(_DATES + [None] * (n - len(_DATES)), pa.string()),
        "m": pa.array(_MONTHS + [None] * (n - len(_MONTHS)), pa.string())})

    def build(df, E, c):
        D = E["D"]
        d = D.ParseDateFixed(c("d"), "MM/dd/yyyy")
        m = D.ParseDateFixed(c("m"), "MM/yyyy")
        return df.select(d.alias("d"), D.Month(d).alias("dm"),
                         D.Year(d).alias("dy"), m.alias("m"),
                         D.Month(m).alias("mm"), D.Year(m).alias("my"))

    got, want = _both(tmp_path, table, build)
    assert got == want
    parsed = [r[0] for r in got[:len(_DATES)]]
    assert parsed[0] == dt.date(2003, 1, 2) and parsed[2] == \
        dt.date(2004, 2, 29) and parsed[19] == dt.date(2000, 2, 29)
    for i in (3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15, 16, 17, 20):
        assert parsed[i] is None, _DATES[i]
    assert got[0][1:3] == (1, 2003)
    assert [r[3] for r in got[:len(_MONTHS)]] == [
        dt.date(2003, 1, 1), dt.date(2030, 12, 1), None, None, None, None,
        None, None, None, dt.date(2003, 7, 1)]


def test_hex_of_murmur3_of_long_matches_jax(tmp_path):
    """hash(long) bit for bit, and hex of it: the int hash is cast to
    long, so a negative one has 16 digits."""
    rng = np.random.default_rng(47)
    ids = rng.integers(-2 ** 63, 2 ** 63 - 1, 400, dtype=np.int64)
    ids[:6] = [0, 1, -1, 100001, 2 ** 63 - 1, -2 ** 63]
    table = pa.table({"id": pa.array(ids, mask=rng.random(400) < 0.1)})
    got, want = _both(tmp_path, table, lambda df, E, c: df.select(
        c("id"), E["H"].Murmur3Hash(c("id")).alias("h"),
        E["S"].Hex(E["H"].Murmur3Hash(c("id"))).alias("x"),
        E["S"].Hex(c("id")).alias("y")))
    assert got == want
    lens = {len(r[2]) for r in got}
    assert 16 in lens and min(lens) <= 8
    for r in got:
        assert r[2] == format(r[1] & (2 ** 64 - 1), "X")


def test_holistic_aggregate_rules(tmp_path):
    """Percentile refuses partial mode and first/last beside it; the four
    percentiles of a column share one pre-projected input (one sort)."""
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": [1, 1, 2], "x": [1.0, 2.0, 3.0]}), path)
    scan = _cpu().read_parquet(path)._planned().exec_node
    pcts = [PA.Percentile(PC.col("x"), q).alias(f"p{q}")
            for q in (0.5, 0.75, 0.9, 0.99)]
    with pytest.raises(ValueError, match="partial"):
        HashAggregateExec([PC.col("k")], [PC.col("k")] + pcts, scan,
                          mode="partial")
    with pytest.raises(NotImplementedError, match="first/last"):
        HashAggregateExec([PC.col("k")],
                          [PC.col("k"), pcts[0],
                           PA.First(PC.col("x")).alias("f")], scan)
    ex = HashAggregateExec([PC.col("k")], [PC.col("k")] + pcts, scan)
    assert len(ex._pre_exprs) == 2
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        PA.Percentile(PC.col("x"), 1.5)


def test_hex_compares_equal_to_its_text(tmp_path):
    """hex(26) = '1A' holds in Spark and the port.  The reference's device
    Hex repeats the last digit past the length, and its string equality
    compares whole padded rows, so there it is false (ROADMAP.md Queue
    3); the port's bytes past the length are zero."""
    path = str(tmp_path / "h.parquet")
    pq.write_table(pa.table({"x": pa.array([26, 255, -1], pa.int64())}),
                   path)
    got = _cpu().read_parquet(path).select(
        PS.Hex(PC.col("x")).alias("h"),
        (PS.Hex(PC.col("x")) == PC.lit("1A")).alias("eq"),
        (PS.Hex(PC.col("x")) == PC.lit("F" * 16)).alias("neg")).collect()
    assert got == [("1A", True, False), ("FF", False, False),
                   ("F" * 16, False, True)]
