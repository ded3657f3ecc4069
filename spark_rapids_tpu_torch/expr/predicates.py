"""Predicates: comparisons, boolean logic, null tests.

Port of ``spark_rapids_tpu/expr/predicates.py``.  Spark float semantics:
NaN = NaN is TRUE, NaN is larger than any other value, -0.0 == 0.0.
Three-valued logic for AND/OR/NOT.  Strings compare byte-lexicographically,
then by length.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.arithmetic import coerce_pair
from spark_rapids_tpu_torch.expr.core import EvalCtx, Expression, Val

__all__ = ["EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
           "GreaterThanOrEqual", "And", "Or", "Not", "IsNull", "IsNotNull",
           "In"]


def _string_pair(a: Val, b: Val):
    wa, wb = a.data.shape[1], b.data.shape[1]
    w = max(wa, wb)
    pad = torch.nn.functional.pad
    return (pad(a.data, (0, w - wa)) if wa < w else a.data,
            pad(b.data, (0, w - wb)) if wb < w else b.data)


def compare_eq(a: Val, b: Val) -> torch.Tensor:
    if a.is_string:
        da, db = _string_pair(a, b)
        return (da == db).all(1) & (a.lengths == b.lengths)
    if a.dtype.fractional:
        return (a.data == b.data) | (torch.isnan(a.data) & torch.isnan(b.data))
    return a.data == b.data


def compare_lt(a: Val, b: Val) -> torch.Tensor:
    if a.is_string:
        da, db = _string_pair(a, b)
        diff = da != db
        has_diff = diff.any(1)
        first = diff.to(torch.uint8).argmax(1, keepdim=True)
        ab = torch.gather(da, 1, first)[:, 0]
        bb = torch.gather(db, 1, first)[:, 0]
        return torch.where(has_diff, ab < bb, a.lengths < b.lengths)
    if a.dtype.fractional:
        # NaN is the largest value
        return (a.data < b.data) | (torch.isnan(b.data)
                                    & ~torch.isnan(a.data))
    return a.data < b.data


class BinaryComparison(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def coerced(self):
        l, r = coerce_pair(*self.children)
        return type(self)(l, r)

    @property
    def dtype(self):
        return T.BooleanType()

    def _eval(self, vals, ctx: EvalCtx):
        a, b = vals
        return ctx.canonical(self._cmp(a, b), a.validity & b.validity,
                             T.BooleanType())


class EqualTo(BinaryComparison):
    sql_name = "EqualTo"

    def _cmp(self, a, b):
        return compare_eq(a, b)


class LessThan(BinaryComparison):
    sql_name = "LessThan"

    def _cmp(self, a, b):
        return compare_lt(a, b)


class GreaterThan(BinaryComparison):
    sql_name = "GreaterThan"

    def _cmp(self, a, b):
        return compare_lt(b, a)


class LessThanOrEqual(BinaryComparison):
    sql_name = "LessThanOrEqual"

    def _cmp(self, a, b):
        return compare_lt(a, b) | compare_eq(a, b)


class GreaterThanOrEqual(BinaryComparison):
    sql_name = "GreaterThanOrEqual"

    def _cmp(self, a, b):
        return compare_lt(b, a) | compare_eq(a, b)


class And(Expression):
    """Three-valued AND: F & x = F; T & NULL = NULL."""
    sql_name = "And"

    def __init__(self, left, right):
        self.children = (left, right)

    @property
    def dtype(self):
        return T.BooleanType()

    def _eval(self, vals, ctx):
        a, b = vals
        validity = (a.validity & b.validity) | (a.validity & ~a.data) | \
            (b.validity & ~b.data)
        return ctx.canonical(a.data & b.data, validity, T.BooleanType())


class Or(Expression):
    """Three-valued OR: T | x = T; F | NULL = NULL."""
    sql_name = "Or"

    def __init__(self, left, right):
        self.children = (left, right)

    @property
    def dtype(self):
        return T.BooleanType()

    def _eval(self, vals, ctx):
        a, b = vals
        validity = (a.validity & b.validity) | (a.validity & a.data) | \
            (b.validity & b.data)
        return ctx.canonical(a.data | b.data, validity, T.BooleanType())


class Not(Expression):
    sql_name = "Not"

    def __init__(self, child):
        self.children = (child,)

    @property
    def dtype(self):
        return T.BooleanType()

    def _eval(self, vals, ctx):
        a = vals[0]
        return ctx.canonical(~a.data, a.validity, T.BooleanType())


class IsNull(Expression):
    sql_name = "IsNull"

    def __init__(self, child):
        self.children = (child,)

    @property
    def dtype(self):
        return T.BooleanType()

    @property
    def nullable(self):
        return False

    def _eval(self, vals, ctx):
        a = vals[0]
        return ctx.canonical(~a.validity, ctx.row_mask, T.BooleanType())


class IsNotNull(Expression):
    sql_name = "IsNotNull"

    def __init__(self, child):
        self.children = (child,)

    @property
    def dtype(self):
        return T.BooleanType()

    @property
    def nullable(self):
        return False

    def _eval(self, vals, ctx):
        a = vals[0]
        return ctx.canonical(a.validity, ctx.row_mask,
                             T.BooleanType())


class In(Expression):
    """Spark In: NULL if the value is null, or if there is no match and the
    list contains a null.  Children: (value, item0, item1, ...)."""
    sql_name = "In"

    def __init__(self, value: Expression, items: list[Expression]):
        self.children = (value,) + tuple(items)

    def with_new_children(self, children):
        return In(children[0], list(children[1:]))

    def coerced(self):
        # Spark promotes the value AND the list to a common wider type:
        # narrowing the items instead would wrap and create false matches
        from spark_rapids_tpu_torch.expr.cast import Cast
        target = self.children[0].dtype
        for i in self.children[1:]:
            it = i.dtype
            if isinstance(it, T.NullType) or it == target:
                continue
            if it.numeric and target.numeric:
                target = T.numeric_promote(target, it)
            else:
                raise TypeError(f"IN: cannot compare {target} with {it}")
        kids = [c if c.dtype == target or isinstance(c.dtype, T.NullType)
                else Cast(c, target) for c in self.children]
        return In(kids[0], kids[1:])

    @property
    def dtype(self):
        return T.BooleanType()

    def _eval(self, vals, ctx):
        a = vals[0]
        matched = torch.zeros(ctx.capacity, dtype=torch.bool,
                              device=ctx.device)
        any_null_item = torch.zeros_like(matched)
        for iv in vals[1:]:
            if not isinstance(iv.dtype, T.NullType):
                matched = matched | (compare_eq(a, iv) & iv.validity
                                     & a.validity)
            any_null_item = any_null_item | ~iv.validity
        validity = a.validity & (matched | ~any_null_item)
        return ctx.canonical(matched, validity, T.BooleanType())
