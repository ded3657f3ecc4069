"""Aggregate function expressions (port of ``spark_rapids_tpu/expr/aggregates.py``).

Declarative nodes lowered by the aggregate exec into the reference's
three phases: ``update_ops`` (segmented ops over the input column),
``merge_ops`` (combining intermediates across batches) and ``final_expr``
(the result over the intermediate columns, e.g. Average = sum / count).
"""
from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import (BoundReference, Expression,
                                              Literal)

__all__ = ["AggregateFunction", "Sum", "Count", "CountStar", "Min", "Max",
           "Average", "First", "Last", "Percentile", "is_aggregate",
           "has_aggregate"]


class AggregateFunction(Expression):
    """Base for aggregate functions. ``children[0]`` is the input (absent
    for COUNT(*))."""

    update_ops: tuple[str, ...] = ()
    merge_ops: tuple[str, ...] = ()

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def input(self) -> Expression:
        return self.children[0]

    def intermediate_types(self) -> list[T.DataType]:
        raise NotImplementedError

    def final_expr(self, offsets: list[int]) -> Expression:
        raise NotImplementedError

    def _eval(self, vals, ctx):
        raise TypeError(f"{self.sql_name} must be planned by an aggregate "
                        "exec, not evaluated elementwise")


def is_aggregate(e: Expression) -> bool:
    return isinstance(e, AggregateFunction)


def has_aggregate(e: Expression) -> bool:
    return is_aggregate(e) or any(has_aggregate(c) for c in e.children)


class Sum(AggregateFunction):
    """Spark Sum: long for integral input, double for fractional; null on
    empty/all-null input; integral overflow wraps (non-ANSI)."""
    sql_name = "Sum"
    update_ops = ("sum",)
    merge_ops = ("sum",)

    @property
    def dtype(self):
        return T.LongType() if self.input.dtype.integral else T.DoubleType()

    @property
    def nullable(self):
        return True

    def coerced(self):
        from spark_rapids_tpu_torch.expr.cast import Cast
        t = self.input.dtype
        if t.integral and not isinstance(t, T.LongType):
            return Sum(Cast(self.input, T.LongType()))
        if isinstance(t, T.FloatType):
            return Sum(Cast(self.input, T.DoubleType()))
        if not t.numeric:
            raise TypeError(f"sum over {t}")
        return self

    def intermediate_types(self):
        return [self.dtype]

    def final_expr(self, offsets):
        return BoundReference(offsets[0], self.dtype, True)


class Count(AggregateFunction):
    sql_name = "Count"
    update_ops = ("count",)
    merge_ops = ("sum",)

    @property
    def dtype(self):
        return T.LongType()

    @property
    def nullable(self):
        return False

    def intermediate_types(self):
        return [T.LongType()]

    def final_expr(self, offsets):
        from spark_rapids_tpu_torch.expr.conditional import Coalesce
        return Coalesce(BoundReference(offsets[0], T.LongType(), True),
                        Literal(0, T.LongType()))


class CountStar(Count):
    sql_name = "CountStar"
    update_ops = ("count_star",)

    def __init__(self):
        self.children = ()

    @property
    def input(self):
        return None

    def with_new_children(self, children):
        return self

    def __repr__(self):
        return "count(*)"


class Min(AggregateFunction):
    sql_name = "Min"
    update_ops = ("min",)
    merge_ops = ("min",)

    @property
    def dtype(self):
        return self.input.dtype

    def intermediate_types(self):
        return [self.dtype]

    def final_expr(self, offsets):
        return BoundReference(offsets[0], self.dtype, True)


class Max(Min):
    sql_name = "Max"
    update_ops = ("max",)
    merge_ops = ("max",)


class Average(AggregateFunction):
    """Spark Average: double result = sum/count, null when count == 0."""
    sql_name = "Average"
    update_ops = ("sum", "count")
    merge_ops = ("sum", "sum")

    @property
    def dtype(self):
        return T.DoubleType()

    def coerced(self):
        from spark_rapids_tpu_torch.expr.cast import Cast
        t = self.input.dtype
        if not t.numeric:
            raise TypeError(f"avg over {t}")
        if not isinstance(t, T.DoubleType):
            return Average(Cast(self.input, T.DoubleType()))
        return self

    def intermediate_types(self):
        return [T.DoubleType(), T.LongType()]

    def final_expr(self, offsets):
        from spark_rapids_tpu_torch.expr.arithmetic import Divide
        from spark_rapids_tpu_torch.expr.cast import Cast
        s = BoundReference(offsets[0], T.DoubleType(), True)
        c = BoundReference(offsets[1], T.LongType(), True)
        return Divide(s, Cast(c, T.DoubleType()))


class First(AggregateFunction):
    """Spark first(x[, ignoreNulls]): the value of the first row of the
    group in input order, or of its first non-null row."""
    sql_name = "First"
    _ops = ("first", "first_non_null")

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        self.children = (child,)
        self.ignore_nulls = ignore_nulls
        op = self._ops[int(bool(ignore_nulls))]
        self.update_ops = (op,)
        self.merge_ops = (op,)

    def with_new_children(self, children):
        return type(self)(children[0], self.ignore_nulls)

    @property
    def dtype(self):
        return self.input.dtype

    def intermediate_types(self):
        return [self.dtype]

    def final_expr(self, offsets):
        return BoundReference(offsets[0], self.dtype, True)

    def __repr__(self):
        # the exec keys aggregates by repr: the two modes must differ
        flag = ", ignore_nulls=True" if self.ignore_nulls else ""
        return f"{self.sql_name}({self.input!r}{flag})"


class Last(First):
    """Spark last(x[, ignoreNulls])."""
    sql_name = "Last"
    _ops = ("last", "last_non_null")


class Percentile(AggregateFunction):
    """Exact percentile with linear interpolation at q * (n - 1) of the
    group's non-null values in ascending order, NaN largest (Spark
    Percentile).  Holistic: there is no mergeable intermediate, so the
    planner keeps it in one complete aggregation (``requires_complete``)
    and the exec reduces the whole input in one pass."""
    sql_name = "Percentile"
    update_ops = ("percentile",)
    merge_ops = ()
    requires_complete = True

    def __init__(self, child: Expression, q: float):
        super().__init__(child)
        if not 0.0 <= float(q) <= 1.0:
            raise ValueError(f"percentile fraction must be in [0, 1]: {q}")
        self.q = float(q)

    def with_new_children(self, children):
        return Percentile(children[0], self.q)

    @property
    def dtype(self):
        return T.DoubleType()

    def coerced(self):
        from spark_rapids_tpu_torch.expr.cast import Cast
        t = self.input.dtype
        if not t.numeric:
            raise TypeError(f"percentile over {t}")
        if not isinstance(t, T.DoubleType):
            return Percentile(Cast(self.input, T.DoubleType()), self.q)
        return self

    def intermediate_types(self):
        return [T.DoubleType()]

    def final_expr(self, offsets):
        return BoundReference(offsets[0], T.DoubleType(), True)

    def __repr__(self):
        return f"Percentile({self.input!r}, {self.q})"
