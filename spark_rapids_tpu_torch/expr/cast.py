"""Cast between numeric, boolean, date and timestamp types.

Port of the device branches of ``spark_rapids_tpu/expr/cast.py`` (Spark
non-ANSI semantics): narrowing integer casts wrap; float -> integral
truncates toward zero, maps NaN to 0 and saturates at the 64-bit range
before narrowing; numeric <-> boolean is ``x != 0`` / ``1|0``; date <->
timestamp converts days and microseconds.  Casts to or from strings are
not ported yet (ROADMAP.md Queue 1 item 4, the host oracle).
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import torch_dtype
from spark_rapids_tpu_torch.expr.core import EvalCtx, Expression

__all__ = ["Cast"]

_MICROS_PER_DAY = 86_400_000_000


class Cast(Expression):
    sql_name = "Cast"

    def __init__(self, child: Expression, to: T.DataType):
        self.children = (child,)
        self.to = to

    def with_new_children(self, children):
        return Cast(children[0], self.to)

    @property
    def dtype(self):
        return self.to

    def __repr__(self):
        return f"cast({self.children[0]!r} as {self.to.name})"

    def _eval(self, vals, ctx: EvalCtx):
        a = vals[0]
        src, dst = a.dtype, self.to
        if isinstance(src, T.NullType):
            return ctx.const(None, dst)
        if src == dst:
            return a
        if isinstance(src, T.StringType) or isinstance(dst, T.StringType):
            raise NotImplementedError(
                "string casts are not ported yet (ROADMAP.md Queue 1 "
                "item 4, the host oracle)")
        d = a.data
        out = torch_dtype(dst)
        if isinstance(src, T.BooleanType):
            data = d.to(out)
        elif isinstance(dst, T.BooleanType):
            data = d != 0
        elif isinstance(src, T.DateType) and isinstance(dst, T.TimestampType):
            data = d.to(torch.int64) * _MICROS_PER_DAY
        elif isinstance(src, T.TimestampType) and isinstance(dst, T.DateType):
            data = torch.div(d, _MICROS_PER_DAY,
                             rounding_mode="floor").to(torch.int32)
        elif isinstance(src, (T.DateType, T.TimestampType)) \
                or isinstance(dst, (T.DateType, T.TimestampType)):
            if isinstance(src, T.TimestampType) and dst.integral:
                data = torch.div(d, 1_000_000,
                                 rounding_mode="floor").to(out)
            elif isinstance(src, T.TimestampType) and dst.fractional:
                data = (d.to(torch.float64) / 1e6).to(out)
            elif isinstance(dst, T.TimestampType) and src.integral:
                data = d.to(torch.int64) * 1_000_000
            elif isinstance(dst, T.TimestampType) and src.fractional:
                data = (d * 1e6).to(torch.int64)
            elif isinstance(src, T.DateType):
                data = d.to(out)
            else:
                data = d.to(torch.int32)
        elif dst.integral and src.fractional:
            data = _float_to_int(d, dst)
        else:
            data = d.to(out)
        return ctx.canonical(data, a.validity, dst)


def _float_to_int(d: torch.Tensor, dst: T.DataType) -> torch.Tensor:
    """JLS 5.1.3: truncate toward zero, NaN -> 0, saturate at the long
    range (long) or the int range (then bit-narrow for byte/short)."""
    finite = torch.isfinite(d)
    t = torch.trunc(torch.where(finite, d, torch.zeros((), dtype=d.dtype,
                                                       device=d.device)))
    hi = float(2 ** 63)
    t = t.to(torch.float64).clamp(-hi, hi)
    as64 = t.to(torch.int64)
    as64 = torch.where(d >= hi, torch.iinfo(torch.int64).max, as64)
    as64 = torch.where(d <= -hi, torch.iinfo(torch.int64).min, as64)
    if isinstance(dst, T.LongType):
        return as64
    as64 = as64.clamp(-(2 ** 31), 2 ** 31 - 1)
    return as64.to(torch.int32).to(torch_dtype(dst))
