"""Synthetic Fannie-Mae-shaped mortgage data, vectorized.

Port of ``spark_rapids_tpu/bench/mortgage_gen.py``: the same schemas
(``perf_schema`` 30 columns, ``acq_schema`` 25 columns), file names
(``perf/Performance_2003Q<n>.txt_0``, ``acq/Acquisition_2003Q<n>.txt_0``),
``_DONE`` marker and text formats -- pipe-delimited, no header, floats as
``%.3f``, an empty field for a missing value, ``MM/01/yyyy`` reporting
periods and ``MM/yyyy`` acquisition dates -- and the same per-loan
distributions: ``sf`` thousand loans (at least 40) spread evenly over the
four 2003 quarters, 6 to 29 monthly performance rows a loan, one fixed
interest rate a loan, and a delinquency ratchet (status 1, 2, ... up to
9 from a month near the end) on a quarter of the loans.

The reference draws row by row in Python, far too slowly for 1M loans
(~17.4M performance rows, ~1.9 GB of text); here every column of a
quarter is drawn at once with numpy and the lines are built with pyarrow
compute (PERF.md gives the time on the card's host).  The draws are not
the reference's, so the files are not byte-equal to its output at the
same seed.
"""
from __future__ import annotations

import os

import numpy as np

from spark_rapids_tpu_torch import types as T

__all__ = ["generate_mortgage", "SELLERS", "perf_schema", "acq_schema",
           "QUARTERS"]

SELLERS = [
    "WELLS FARGO BANK, N.A.", "JPMORGAN CHASE BANK, NATIONAL ASSOCIATION",
    "BANK OF AMERICA, N.A.", "CITIMORTGAGE, INC.", "QUICKEN LOANS INC.",
    "USAA FEDERAL SAVINGS BANK", "FLAGSTAR BANK, FSB", "OTHER",
    "PNC BANK, N.A.", "SUNTRUST MORTGAGE INC.", "AMTRUST BANK",
    "METLIFE BANK, NA", "GMAC MORTGAGE, LLC",
]

QUARTERS = ["2003Q1", "2003Q2", "2003Q3", "2003Q4"]

_F = T.StructField
_PERF_FIELDS = [
    ("loan_id", T.LongType()), ("monthly_reporting_period", T.StringType()),
    ("servicer", T.StringType()), ("interest_rate", T.DoubleType()),
    ("current_actual_upb", T.DoubleType()), ("loan_age", T.DoubleType()),
    ("remaining_months_to_legal_maturity", T.DoubleType()),
    ("adj_remaining_months_to_maturity", T.DoubleType()),
    ("maturity_date", T.StringType()), ("msa", T.DoubleType()),
    ("current_loan_delinquency_status", T.IntegerType()),
    ("mod_flag", T.StringType()), ("zero_balance_code", T.StringType()),
    ("zero_balance_effective_date", T.StringType()),
    ("last_paid_installment_date", T.StringType()),
    ("foreclosed_after", T.StringType()),
    ("disposition_date", T.StringType()),
    ("foreclosure_costs", T.DoubleType()),
    ("prop_preservation_and_repair_costs", T.DoubleType()),
    ("asset_recovery_costs", T.DoubleType()),
    ("misc_holding_expenses", T.DoubleType()),
    ("holding_taxes", T.DoubleType()),
    ("net_sale_proceeds", T.DoubleType()),
    ("credit_enhancement_proceeds", T.DoubleType()),
    ("repurchase_make_whole_proceeds", T.StringType()),
    ("other_foreclosure_proceeds", T.DoubleType()),
    ("non_interest_bearing_upb", T.DoubleType()),
    ("principal_forgiveness_upb", T.StringType()),
    ("repurchase_make_whole_proceeds_flag", T.StringType()),
    ("servicing_activity_indicator", T.StringType()),
]
_ACQ_FIELDS = [
    ("loan_id", T.LongType()), ("orig_channel", T.StringType()),
    ("seller_name", T.StringType()),
    ("orig_interest_rate", T.DoubleType()),
    ("orig_upb", T.IntegerType()), ("orig_loan_term", T.IntegerType()),
    ("orig_date", T.StringType()), ("first_pay_date", T.StringType()),
    ("orig_ltv", T.DoubleType()), ("orig_cltv", T.DoubleType()),
    ("num_borrowers", T.DoubleType()), ("dti", T.DoubleType()),
    ("borrower_credit_score", T.DoubleType()),
    ("first_home_buyer", T.StringType()), ("loan_purpose", T.StringType()),
    ("property_type", T.StringType()), ("num_units", T.IntegerType()),
    ("occupancy_status", T.StringType()),
    ("property_state", T.StringType()), ("zip", T.IntegerType()),
    ("mortgage_insurance_percent", T.DoubleType()),
    ("product_type", T.StringType()),
    ("coborrow_credit_score", T.DoubleType()),
    ("mortgage_insurance_type", T.DoubleType()),
    ("relocation_mortgage_indicator", T.StringType()),
]


def perf_schema() -> T.Schema:
    return T.Schema([_F(n, t) for n, t in _PERF_FIELDS])


def acq_schema() -> T.Schema:
    return T.Schema([_F(n, t) for n, t in _ACQ_FIELDS])


# ---------------------------------------------------------------------------
# text columns (pyarrow string arrays, no nulls: a missing value is "")
# ---------------------------------------------------------------------------

def _ints(x: np.ndarray):
    import pyarrow as pa
    import pyarrow.compute as pc
    return pc.cast(pa.array(np.asarray(x, dtype=np.int64)), pa.string())


def _fmt3(x: np.ndarray):
    """``f"{v:.3f}"`` of non-negative floats with at most three decimals,
    through integer thousandths."""
    import pyarrow as pa
    import pyarrow.compute as pc
    milli = np.rint(np.asarray(x, dtype=np.float64) * 1000.0) \
        .astype(np.int64)
    if milli.size and milli.min() < 0:
        raise ValueError("_fmt3 formats non-negative values only")
    frac = pc.utf8_lpad(_ints(milli % 1000), 3, "0")
    return pc.binary_join_element_wise(_ints(milli // 1000), frac, ".")


def _pick(words, idx: np.ndarray):
    import pyarrow as pa
    return pa.array(words, type=pa.string()).take(
        pa.array(np.asarray(idx, dtype=np.int64)))


def _const(s: str, n: int):
    return _pick([s], np.zeros(n, dtype=np.int64))


def _or_empty(present: np.ndarray, text):
    import pyarrow as pa
    import pyarrow.compute as pc
    return pc.if_else(pa.array(present), text, "")


def _month_year(month: np.ndarray, year: np.ndarray, day: str | None):
    """``MM/01/yyyy`` (``day="01"``) or ``MM/yyyy`` (``day=None``)."""
    lo = int(year.min()) if year.size else 2000
    hi = int(year.max()) if year.size else 2000
    words = [f"{m:02d}/{day}/{y}" if day else f"{m:02d}/{y}"
             for y in range(lo, hi + 1) for m in range(1, 13)]
    return _pick(words, (year - lo) * 12 + (month - 1))


def _write_lines(path: str, columns) -> None:
    """Join the columns with ``|`` into lines and write them."""
    import pyarrow.compute as pc
    n = len(columns[0])
    lines = pc.binary_join_element_wise(*columns, "|")
    # "line" + "\n" + "": every line ends in a newline
    lines = pc.binary_join_element_wise(lines, _const("", n), "\n") \
        .cast("large_string")
    bufs = lines.buffers()
    offsets = np.frombuffer(bufs[1], dtype=np.int64, count=n + 1,
                            offset=lines.offset * 8)
    data = np.frombuffer(bufs[2], dtype=np.uint8)[offsets[0]:offsets[-1]]
    with open(path, "wb") as f:
        f.write(data.tobytes())


# ---------------------------------------------------------------------------
# one quarter
# ---------------------------------------------------------------------------

def _quarter(rng, q: str, first_id: int, n: int, data_dir: str) -> None:
    """Write one quarter's acquisition and performance files."""
    year, qn = int(q[:4]), int(q[-1])
    loan_id = first_id + np.arange(n, dtype=np.int64)
    rate = np.round(rng.uniform(2.5, 8.5, n), 3)
    upb = rng.integers(50, 800, n) * 1000
    term = np.array([180, 240, 360])[rng.integers(0, 3, n)]
    orig_month = rng.integers(1, 4, n) + (qn - 1) * 3
    coborrow = rng.integers(550, 830, n)
    has_coborrow = rng.random(n) < 0.4
    mi_type = rng.integers(1, 3, n)
    has_mi_type = rng.random(n) < 0.3
    years = np.full(n, year)
    acq = [
        _ints(loan_id), _pick(["R", "C", "B"], rng.integers(0, 3, n)),
        _pick(SELLERS, rng.integers(0, len(SELLERS), n)), _fmt3(rate),
        _ints(upb), _ints(term), _month_year(orig_month, years, None),
        _month_year(orig_month % 12 + 1, years, None),
        _fmt3(np.round(rng.uniform(40, 97, n), 1)),
        _fmt3(np.round(rng.uniform(40, 99, n), 1)),
        _fmt3(rng.integers(1, 3, n)),
        _fmt3(np.round(rng.uniform(10, 60, n), 1)),
        _fmt3(rng.integers(550, 830, n)),
        _pick(["Y", "N"], rng.integers(0, 2, n)),
        _pick(["P", "C", "R"], rng.integers(0, 3, n)),
        _pick(["SF", "PU", "CO"], rng.integers(0, 3, n)),
        _ints(rng.integers(1, 5, n)),
        _pick(["P", "S", "I"], rng.integers(0, 3, n)),
        _pick(["CA", "TX", "NY", "FL", "WA", "CO"], rng.integers(0, 6, n)),
        _ints(rng.integers(10000, 99999, n)),
        _fmt3(np.round(rng.uniform(0, 35, n), 1)), _const("FRM", n),
        _or_empty(has_coborrow, _fmt3(coborrow)),
        _or_empty(has_mi_type, _fmt3(mi_type)),
        _pick(["Y", "N"], rng.integers(0, 2, n)),
    ]
    _write_lines(os.path.join(data_dir, "acq", f"Acquisition_{q}.txt_0"),
                 acq)
    del acq

    # monthly history: 6..29 months a loan; a quarter of the loans turn
    # delinquent some months before the end and ratchet up to status 9
    months = rng.integers(6, 30, n)
    delinquent = rng.random(n) < 0.25
    delinquent_from = months - rng.integers(1, 8, n)
    rows = int(months.sum())
    loan = np.repeat(np.arange(n), months)
    t = np.arange(rows) - np.repeat(np.cumsum(months) - months, months)
    ym = orig_month[loan] - 1 + t
    m = ym % 12 + 1
    y = year + ym // 12
    status = np.where(delinquent[loan] & (t >= delinquent_from[loan]),
                      np.minimum(t - delinquent_from[loan] + 1, 9), 0)
    row_term = term[loan]
    row_upb = upb[loan].astype(np.float64)
    upb_left = np.maximum(row_upb - (t + 1) * (row_upb / row_term), 0.0)
    empty = _const("", rows)
    perf = [
        _ints(loan_id[loan]), _month_year(m, y, "01"),
        _pick(["A", "B", ""], rng.integers(0, 3, rows)),
        _fmt3(rate[loan]), _fmt3(np.round(upb_left, 2)), _fmt3(t),
        _fmt3(row_term - t), _fmt3(row_term - t),
        _month_year(m, y + row_term // 12, None),
        _fmt3(rng.integers(10000, 50000, rows)), _ints(status),
        _pick(["Y", "N"], rng.integers(0, 2, rows)),
        empty, empty, empty, empty, empty,          # zero-balance .. disp.
        empty, empty, empty, empty, empty, empty, empty,  # costs, proceeds
        empty, empty, empty, empty, empty,          # repurchase .. flag
        _const("Y", rows),
    ]
    _write_lines(os.path.join(data_dir, "perf", f"Performance_{q}.txt_0"),
                 perf)


def generate_mortgage(data_dir: str, sf: float = 1.0,
                      seed: int = 7) -> bool:
    """Write ``perf/Performance_<Q>.txt_0`` and ``acq/Acquisition_<Q>.txt_0``
    for the four 2003 quarters, then ``_DONE``.  Returns False (and writes
    nothing) when ``_DONE`` is already there."""
    if os.path.exists(os.path.join(data_dir, "_DONE")):
        return False
    rng = np.random.default_rng(seed)
    n_loans = max(int(1000 * sf), 40)
    os.makedirs(os.path.join(data_dir, "perf"), exist_ok=True)
    os.makedirs(os.path.join(data_dir, "acq"), exist_ok=True)
    per_q = n_loans // len(QUARTERS)
    for i, q in enumerate(QUARTERS):
        _quarter(rng, q, 100001 + i * per_q, per_q, data_dir)
    with open(os.path.join(data_dir, "_DONE"), "w") as f:
        f.write("ok\n")
    return True
