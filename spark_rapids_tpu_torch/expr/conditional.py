"""Conditional expressions: If, CaseWhen, Coalesce (port of
``spark_rapids_tpu/expr/conditional.py``).

Every branch is evaluated and the result selected row by row with
``torch.where`` (the reference's strategy, and spark-rapids' on the
GPU); a null predicate takes the false branch (reference ``:71-74``).
Branch values are coerced to one common type as the reference does.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import EvalCtx, Expression, Val

__all__ = ["If", "CaseWhen", "Coalesce"]


def _common_type(types: list[T.DataType]) -> T.DataType:
    target = None
    for t in types:
        if isinstance(t, T.NullType):
            continue
        if target is None or t == target:
            target = t
        elif t.numeric and target.numeric:
            target = T.numeric_promote(target, t)
        else:
            raise TypeError(f"no common type for {types}")
    return target if target is not None else T.NullType()


def _select(pred, t: Val, f: Val, dtype, ctx: EvalCtx) -> Val:
    """where(pred, t, f), padding string matrices to a common width."""
    validity = torch.where(pred, t.validity, f.validity)
    if isinstance(dtype, T.StringType):
        w = max(t.data.shape[1], f.data.shape[1])
        pad = torch.nn.functional.pad
        td = pad(t.data, (0, w - t.data.shape[1]))
        fd = pad(f.data, (0, w - f.data.shape[1]))
        return ctx.canonical(torch.where(pred[:, None], td, fd), validity,
                             dtype, torch.where(pred, t.lengths, f.lengths))
    return ctx.canonical(torch.where(pred, t.data, f.data), validity, dtype)


class If(Expression):
    sql_name = "If"

    def __init__(self, pred: Expression, t: Expression, f: Expression):
        self.children = (pred, t, f)

    def coerced(self):
        from spark_rapids_tpu_torch.expr.cast import Cast
        p, t, f = self.children
        target = _common_type([t.dtype, f.dtype])
        if t.dtype != target:
            t = Cast(t, target)
        if f.dtype != target:
            f = Cast(f, target)
        return If(p, t, f)

    @property
    def dtype(self):
        return self.children[1].dtype

    def _eval(self, vals, ctx):
        p, t, f = vals
        cond = p.data & p.validity  # null predicate -> false branch
        return _select(cond, t, f, self.dtype, ctx)


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 [WHEN c2 THEN v2 ...] [ELSE e] END.

    Children: [c1, v1, c2, v2, ..., (else)]; an odd count means an else
    branch is present."""
    sql_name = "CaseWhen"

    def __init__(self, branches: list[tuple[Expression, Expression]],
                 else_value: Expression | None = None):
        kids = []
        for c, v in branches:
            kids += [c, v]
        if else_value is not None:
            kids.append(else_value)
        self.children = tuple(kids)
        self._nbranches = len(branches)
        self._has_else = else_value is not None

    def _split(self, seq):
        branches = [(seq[2 * i], seq[2 * i + 1])
                    for i in range(self._nbranches)]
        return branches, (seq[-1] if self._has_else else None)

    def with_new_children(self, children):
        return CaseWhen(*self._split(list(children)))

    def coerced(self):
        from spark_rapids_tpu_torch.expr.cast import Cast
        branches, els = self._split(list(self.children))
        vals = [v for _, v in branches] + ([els] if els is not None else [])
        target = _common_type([v.dtype for v in vals])
        branches = [(c, v if v.dtype == target else Cast(v, target))
                    for c, v in branches]
        if els is not None and els.dtype != target:
            els = Cast(els, target)
        return CaseWhen(branches, els)

    @property
    def dtype(self):
        branches, els = self._split(list(self.children))
        for _, v in branches:
            if not isinstance(v.dtype, T.NullType):
                return v.dtype
        return els.dtype if els is not None else T.NullType()

    def _eval(self, vals, ctx):
        branches, els = self._split(vals)
        result = els if els is not None else ctx.const(None, self.dtype)
        # fold right to left so that the first matching branch wins
        for cond, val in reversed(branches):
            result = _select(cond.data & cond.validity, val, result,
                             self.dtype, ctx)
        return result


class Coalesce(Expression):
    """First non-null argument."""
    sql_name = "Coalesce"

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def with_new_children(self, children):
        return Coalesce(*children)

    def coerced(self):
        from spark_rapids_tpu_torch.expr.cast import Cast
        target = _common_type([c.dtype for c in self.children])
        return Coalesce(*[c if c.dtype == target else Cast(c, target)
                          for c in self.children])

    @property
    def dtype(self):
        return _common_type([c.dtype for c in self.children])

    def _eval(self, vals, ctx):
        result = vals[-1]
        for v in reversed(vals[:-1]):
            result = _select(v.validity, v, result, self.dtype, ctx)
        return result
