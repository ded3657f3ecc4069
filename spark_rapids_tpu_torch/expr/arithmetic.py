"""Arithmetic expressions (port of ``spark_rapids_tpu/expr/arithmetic.py``).

Spark non-ANSI semantics, as in the reference: integer add/sub/mul wrap
(torch integer ops wrap too), ``/`` coerces both sides to double and
yields NULL when the divisor is zero.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import EvalCtx, Expression

__all__ = ["Add", "Subtract", "Multiply", "Divide", "Abs",
           "coerce_pair"]


def coerce_pair(left: Expression, right: Expression,
                target: T.DataType | None = None):
    """Insert casts so both sides share a numeric type (Spark promotion)."""
    from spark_rapids_tpu_torch.expr.cast import Cast
    lt, rt = left.dtype, right.dtype
    if target is None:
        if isinstance(lt, T.NullType):
            target = rt
        elif isinstance(rt, T.NullType):
            target = lt
        elif lt == rt:
            target = lt
        elif lt.numeric and rt.numeric:
            target = T.numeric_promote(lt, rt)
        else:
            raise TypeError(f"cannot coerce {lt} with {rt}")
    if lt != target:
        left = Cast(left, target)
    if rt != target:
        right = Cast(right, target)
    return left, right


class BinaryArithmetic(Expression):
    """Binary numeric op: validity = AND of child validities."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def coerced(self):
        l, r = coerce_pair(*self.children)
        if not l.dtype.numeric:
            raise TypeError(f"{self.sql_name} requires numeric, got {l.dtype}")
        return type(self)(l, r)

    @property
    def dtype(self):
        return self.children[0].dtype

    def _eval(self, vals, ctx: EvalCtx):
        a, b = vals
        return ctx.canonical(self._op(a.data, b.data),
                             a.validity & b.validity, self.dtype)


class Add(BinaryArithmetic):
    sql_name = "Add"

    def _op(self, a, b):
        return a + b


class Subtract(BinaryArithmetic):
    sql_name = "Subtract"

    def _op(self, a, b):
        return a - b


class Multiply(BinaryArithmetic):
    sql_name = "Multiply"

    def _op(self, a, b):
        return a * b


class Divide(BinaryArithmetic):
    """Spark Divide: double result, NULL when the divisor is zero."""
    sql_name = "Divide"

    def coerced(self):
        l, r = coerce_pair(*self.children, target=T.DoubleType())
        return Divide(l, r)

    @property
    def dtype(self):
        return T.DoubleType()

    def _eval(self, vals, ctx: EvalCtx):
        a, b = vals
        nonzero = b.data != 0
        safe_b = b.data.masked_fill(~nonzero, 1)
        return ctx.canonical(a.data / safe_b,
                             a.validity & b.validity & nonzero, self.dtype)


class Abs(Expression):
    sql_name = "Abs"

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        return self.children[0].dtype

    def _eval(self, vals, ctx: EvalCtx):
        a = vals[0]
        return ctx.canonical(torch.abs(a.data), a.validity, self.dtype)
