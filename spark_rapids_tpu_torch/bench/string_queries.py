"""Two string paths over the mortgage data: reporting periods and seller
names.

No benchmark of the reference trims, measures, locates or splits strings
by a delimiter, and every ``Min``/``Max`` there is over numbers, so these
paths run the string functions on the largest string data the repo
generates: the mortgage files of ``bench/mortgage_gen.py`` (one CSV scan
per quarter with a literal ``quarter`` column, unioned, through
``bench/mortgage.py``).

* :func:`loan_period_span` is each loan's seasoning window, which
  servicing analysts compute over loan-level performance data: the
  reporting period ``MM/01/YYYY`` rewritten as ``YYYY-MM``
  (``substring_index`` at both signs and ``concat``), its first and last
  value per (quarter, loan), then per (quarter, first period) the loans
  and the earliest and latest last period.  String min/max over ~1M
  short groups, then over a few large ones.
* :func:`seller_legal_forms` canonicalises the acquisitions' seller
  names, the cleanup that the reference's ``NameMapping`` does with a
  lookup table, here with string functions: the name before its first
  comma (right-trimmed) and the legal form after its last comma
  (trimmed; a name without a comma is its own form), the base name's
  length, whether the name holds ``BANK`` and where its first comma is
  after the first character; then per (property state, form) the
  sellers, the least and greatest base name, the longest base name, the
  banks and the last comma position.  ~66 groups of ~15k rows at 1M
  loans.

Each builder takes a session and the mortgage data directory and returns
a DataFrame.  :data:`STRING_PATHS` maps a path's name to its builder and
the table it reads.
"""
from __future__ import annotations

from spark_rapids_tpu_torch.bench.mortgage import (read_acquisition,
                                                   read_performance)
from spark_rapids_tpu_torch.expr.aggregates import CountStar, Max, Min, Sum
from spark_rapids_tpu_torch.expr.conditional import If
from spark_rapids_tpu_torch.expr.core import col, lit
from spark_rapids_tpu_torch.expr.strings import (Concat, Length,
                                                 StringLocate, StringTrim,
                                                 StringTrimRight,
                                                 SubstringIndex)

__all__ = ["loan_period_span", "seller_legal_forms", "STRING_PATHS"]


def loan_period_span(session, data_dir: str):
    """Per (quarter, first reporting month ``YYYY-MM``): the loans, and the
    earliest and latest of their last reporting months."""
    p = col("monthly_reporting_period")
    period = Concat(SubstringIndex(p, "/", -1), lit("-"),
                    SubstringIndex(p, "/", 1))
    per_loan = read_performance(session, data_dir,
                                ["loan_id", "monthly_reporting_period"]) \
        .with_column("period", period) \
        .group_by("quarter", "loan_id").agg(
            Min(col("period")).alias("first_period"),
            Max(col("period")).alias("last_period"))
    return per_loan.group_by("quarter", "first_period").agg(
        CountStar().alias("loans"),
        Min(col("last_period")).alias("min_last_period"),
        Max(col("last_period")).alias("max_last_period")) \
        .order_by(("quarter", True), ("first_period", True))


def seller_legal_forms(session, data_dir: str):
    """Per (property state, seller's legal form): sellers, least and
    greatest base name, longest base name, banks, last comma position."""
    name = col("seller_name")
    base = StringTrimRight(SubstringIndex(name, ",", 1))
    return read_acquisition(session, data_dir,
                            ["seller_name", "property_state"]) \
        .with_column("base", base) \
        .with_column("form", StringTrim(SubstringIndex(name, ",", -1))) \
        .with_column("name_len", Length(col("base"))) \
        .with_column("is_bank", If(StringLocate(lit("BANK"), name) > lit(0),
                                   lit(1), lit(0))) \
        .with_column("comma_at", StringLocate(lit(","), name, 2)) \
        .group_by("property_state", "form").agg(
            CountStar().alias("sellers"),
            Min(col("base")).alias("min_base"),
            Max(col("base")).alias("max_base"),
            Max(col("name_len")).alias("max_name_len"),
            Sum(col("is_bank")).alias("banks"),
            Max(col("comma_at")).alias("max_comma_at")) \
        .order_by(("property_state", True), ("form", True))


#: path -> (builder, the file of the table it reads for the first quarter)
STRING_PATHS = {
    "loan_period_span": (loan_period_span, "Performance_2003Q1"),
    "seller_legal_forms": (seller_legal_forms, "Acquisition_2003Q1"),
}
