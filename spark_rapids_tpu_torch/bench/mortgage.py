"""Mortgage benchmark: the aggregate jobs of the reference's Fannie-Mae
suite (port of ``spark_rapids_tpu/bench/mortgage.py:54-90`` and
``:259-322``, after spark-rapids' ``MortgageSpark.scala``).

Each job reads the pipe-delimited, headerless performance and acquisition
files of ``bench/mortgage_gen.py`` -- one CSV scan per quarter with a
literal ``quarter`` column, unioned -- and aggregates them.  Spark prunes
these scans to the columns a job references (its optimizer's column
pruning and the CSV reader's required schema); neither engine of this
repo has that pass, and the reference's jobs parse all 30 (25) columns,
so the jobs here name the columns they read, as both packages' TPC
query functions do.  The rows are the reference's.

* ``simple_agg`` (SimpleAggregates): the highest monthly rate per (month,
  loan), joined to the acquisitions on the loan id, then the lowest of
  those per (zip, month);
* ``percentiles`` (AggregatesWithPercentiles): per anonymized loan,
  ``hex(hash(loan_id))``, the rate's min, max, average and exact 50/75/90/
  99th percentiles, each rounded to 4 places, the first 1000 hashes;
* ``agg_join`` (AggregatesWithJoin): the lowest rate per anonymized loan,
  left-joined to the acquisitions' first non-null original rate and
  highest debt-to-income ratio per anonymized loan.

``etl`` (the delinquency-window feature ETL) is not ported yet: it needs
``from_pydict``, a cross join that explodes every performance row twelve
times, ``Floor`` and four-key left joins (ROADMAP.md Queue 1 item 1).
"""
from __future__ import annotations

import glob
import os

from spark_rapids_tpu_torch.bench.mortgage_gen import (acq_schema,
                                                       generate_mortgage,
                                                       perf_schema)
from spark_rapids_tpu_torch.expr.aggregates import (Average, First, Max,
                                                    Min, Percentile)
from spark_rapids_tpu_torch.expr.conditional import Coalesce
from spark_rapids_tpu_torch.expr.core import col, lit
from spark_rapids_tpu_torch.expr.datetime_ops import Month, ParseDateFixed
from spark_rapids_tpu_torch.expr.hashing import Murmur3Hash
from spark_rapids_tpu_torch.expr.math_ops import Round
from spark_rapids_tpu_torch.expr.strings import Hex

__all__ = ["generate_mortgage", "MORTGAGE_QUERIES", "build_mortgage_query",
           "read_performance", "read_acquisition"]


def _quarter_of(path: str) -> str:
    # .../Performance_2003Q4.txt_0 -> 2003Q4
    return os.path.basename(path).split(".")[0].split("_")[-1]


def _read_with_quarter(session, pattern: str, schema, columns=None):
    """One scan per file (``columns`` of it, default all) with its quarter
    as a literal column, unioned."""
    paths = sorted(glob.glob(pattern))
    if not paths:
        raise FileNotFoundError(
            f"no mortgage data files match {pattern!r}: run "
            "generate_mortgage(data_dir, sf) first")
    out = None
    for p in paths:
        df = session.read_csv(p, schema=schema, header=False,
                              delimiter="|", columns=columns) \
            .with_column("quarter", lit(_quarter_of(p)))
        out = df if out is None else out.union(df)
    return out


def read_performance(session, data_dir: str, columns=None):
    return _read_with_quarter(
        session, os.path.join(data_dir, "perf", "Performance_*"),
        perf_schema(), columns)


def read_acquisition(session, data_dir: str, columns=None):
    return _read_with_quarter(
        session, os.path.join(data_dir, "acq", "Acquisition_*"),
        acq_schema(), columns)


def run_etl(session, data_dir: str):
    raise NotImplementedError(
        "the mortgage ETL (explode(0..11) as a cross join, from_pydict, "
        "Floor, four-key left joins) is ROADMAP.md Queue 1 item 1")


def simple_aggregates(session, data_dir: str):
    """SimpleAggregates (MortgageSpark.scala:350-366)."""
    dfp = read_performance(session, data_dir, ["loan_id",
                                               "monthly_reporting_period",
                                               "interest_rate"])
    dfa = read_acquisition(session, data_dir, ["loan_id", "zip"])
    max_rate = dfp.with_column(
        "monthval",
        Month(ParseDateFixed(col("monthly_reporting_period"),
                             "MM/dd/yyyy"))) \
        .group_by("monthval", "loan_id") \
        .agg(Max(col("interest_rate")).alias("max_monthly_rate"))
    joined = max_rate.select(
        col("loan_id").alias("p_loan_id"), col("monthval"),
        col("max_monthly_rate")) \
        .join(dfa, on=[("p_loan_id", "loan_id")])
    return joined.group_by("zip", "monthval") \
        .agg(Min(col("max_monthly_rate")).alias("min_max_monthly_rate")) \
        .order_by(("zip", True), ("monthval", True))


def aggregates_with_percentiles(session, data_dir: str):
    """AggregatesWithPercentiles (:368-393)."""
    dfp = read_performance(session, data_dir, ["loan_id", "interest_rate"])
    anon = dfp.with_column("loan_id_hash",
                           Hex(Murmur3Hash(col("loan_id")))) \
        .select(col("loan_id_hash"), col("interest_rate"))
    r = col("interest_rate")
    return anon.group_by("loan_id_hash").agg(
        Round(Min(r), 4).alias("interest_rate_min"),
        Round(Max(r), 4).alias("interest_rate_max"),
        Round(Average(r), 4).alias("interest_rate_avg"),
        Round(Percentile(r, 0.5), 4).alias("interest_rate_50p"),
        Round(Percentile(r, 0.75), 4).alias("interest_rate_75p"),
        Round(Percentile(r, 0.90), 4).alias("interest_rate_90p"),
        Round(Percentile(r, 0.99), 4).alias("interest_rate_99p")) \
        .order_by(("loan_id_hash", True)).limit(1000)


def aggregates_with_join(session, data_dir: str):
    """AggregatesWithJoin (:395-421)."""
    dfp = read_performance(session, data_dir, ["loan_id", "interest_rate"])
    dfa = read_acquisition(session, data_dir,
                           ["loan_id", "orig_interest_rate", "dti"])
    a = dfp.with_column("loan_id_hash",
                        Hex(Murmur3Hash(col("loan_id")))) \
        .group_by("loan_id_hash") \
        .agg(Min(col("interest_rate")).alias("min_int_rate"))
    b = dfa.with_column("loan_id_hash",
                        Hex(Murmur3Hash(col("loan_id")))) \
        .group_by("loan_id_hash") \
        .agg(First(col("orig_interest_rate"), ignore_nulls=True)
             .alias("first_int_rate"),
             Coalesce(Max(col("dti")), lit(0.0)).alias("max_dti")) \
        .select(col("loan_id_hash").alias("b_hash"),
                col("first_int_rate"), col("max_dti"))
    return a.join(b, on=[("loan_id_hash", "b_hash")], how="left") \
        .order_by(("loan_id_hash", True)).limit(1000)


MORTGAGE_QUERIES = {
    "etl": run_etl,
    "simple_agg": simple_aggregates,
    "percentiles": aggregates_with_percentiles,
    "agg_join": aggregates_with_join,
}


def build_mortgage_query(name: str, session, data_dir: str):
    return MORTGAGE_QUERIES[name](session, data_dir)
