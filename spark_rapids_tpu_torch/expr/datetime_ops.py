"""Date expressions: Year, Month and ParseDateFixed (port of
``spark_rapids_tpu/expr/datetime_ops.py`` :26 ``civil_from_days``, :42-80
Year/Month, :244 ``_last_dom``, :626-721 ParseDateFixed).

Dates are int32 days since 1970-01-01.  The civil-date conversions are
Howard Hinnant's days-from-civil algorithms in exact integer arithmetic
(floor division); all of it is elementwise torch glue, not a hand kernel.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import EvalCtx, Expression

__all__ = ["Year", "Month", "ParseDateFixed", "civil_from_days",
           "days_from_civil"]


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """days since epoch -> (year, month, day), int32 tensors."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097                                     # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                               # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                       # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                   # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y: torch.Tensor, m: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> int32 days since epoch."""
    y, m, d = (t.to(torch.int64) for t in (y, m, d))
    y2 = y - (m <= 2).to(torch.int64)
    era = _fdiv(y2, 400)
    yoe = y2 - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


_MONTH_DAYS = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


def _last_dom(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The last day of month ``m`` (1..12) of year ``y`` (leap-aware)."""
    base = torch.tensor(_MONTH_DAYS, dtype=torch.int64,
                        device=m.device)[m.to(torch.int64) - 1]
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    return torch.where((m == 2) & leap, 29, base)


class _DateExtract(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        return T.IntegerType()

    def coerced(self):
        from spark_rapids_tpu_torch.expr.cast import Cast
        c = self.children[0]
        if isinstance(c.dtype, (T.TimestampType, T.StringType)):
            return type(self)(Cast(c, T.DateType()))
        return self

    def _eval(self, vals, ctx: EvalCtx):
        a = vals[0]
        return ctx.canonical(self._pick(*civil_from_days(a.data)),
                             a.validity, T.IntegerType())


class Year(_DateExtract):
    sql_name = "Year"

    def _pick(self, y, m, d):
        return y


class Month(_DateExtract):
    sql_name = "Month"

    def _pick(self, y, m, d):
        return m


class ParseDateFixed(Expression):
    """to_date(str, fmt) for a fixed-width digit format ("MM/dd/yyyy",
    "MM/yyyy", "yyyy-MM-dd", ...): the digits are read straight from the
    byte matrix at the format's positions.  A row is null unless it has
    exactly the format's length, digits where the format has them, its
    separators where the format has them, a month in 1..12 and a day
    within that month (Spark's non-ANSI to_date gives null for what it
    cannot parse).  A format without ``dd`` takes day 1."""
    sql_name = "ParseDateFixed"

    def __init__(self, child: Expression, fmt: str):
        if "MM" not in fmt or "yyyy" not in fmt:
            raise ValueError(f"format {fmt!r} needs MM and yyyy")
        self.children = (child,)
        self.fmt = fmt

    def with_new_children(self, children):
        return ParseDateFixed(children[0], self.fmt)

    @property
    def dtype(self):
        return T.DateType()

    def __repr__(self):
        return f"ParseDateFixed({self.children[0]!r}, {self.fmt!r})"

    def _eval(self, vals, ctx: EvalCtx):
        a = vals[0]
        if not isinstance(a.dtype, T.StringType):
            raise TypeError(f"ParseDateFixed over {a.dtype}")
        fmt = self.fmt
        data = a.data
        n, w = data.shape
        ok = a.validity & (a.lengths == len(fmt))
        zero = torch.zeros(n, dtype=torch.int64, device=data.device)

        def at(j):
            return data[:, j].to(torch.int64) if j < w else zero

        def digits(start: int, count: int):
            nonlocal ok
            val = zero
            for j in range(start, start + count):
                c = at(j)
                ok = ok & (c >= 48) & (c <= 57)
                val = val * 10 + (c - 48)
            return val

        y = digits(fmt.index("yyyy"), 4)
        m = digits(fmt.index("MM"), 2)
        d = digits(fmt.index("dd"), 2) if "dd" in fmt else zero + 1
        for j, ch in enumerate(fmt):
            if ch not in "yMd":
                ok = ok & (at(j) == ord(ch))
        ok = ok & (m >= 1) & (m <= 12) & (d >= 1) \
            & (d <= _last_dom(y, m.clamp(1, 12)))
        days = days_from_civil(y, m, d)
        return ctx.canonical(days, ok, T.DateType())
