"""Window expression nodes (declarative, evaluated by WindowExec).

Port of ``spark_rapids_tpu/expr/window.py`` (GpuWindowExpression.scala
:169-830: GpuWindowSpecDefinition, GpuRowNumber:737, GpuLead:797,
GpuLag:811, windowed aggregations).
"""
from __future__ import annotations

from dataclasses import dataclass

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.ops.window import (CURRENT_ROW, UNBOUNDED,
                                               WindowFrame)

__all__ = ["WindowSpec", "WindowExpression", "RowNumber", "Rank",
           "DenseRank", "Lead", "Lag", "WindowFrame", "UNBOUNDED",
           "CURRENT_ROW", "window_agg_op"]


@dataclass(frozen=True)
class WindowSpec:
    """partition_by: expressions; order_by: (expr, ascending[, nulls_first])
    tuples; frame: None = Spark default (RANGE unbounded..current when
    ordered, else whole partition).

    Specs hash by their expressions' identities (``Expression.__hash__``),
    so two specs built from separate ``col()`` objects are two specs: the
    planner gives each its own WindowExec, as the reference does."""
    partition_by: tuple = ()
    order_by: tuple = ()
    frame: WindowFrame | None = None

    def resolved_frame(self) -> WindowFrame:
        if self.frame is not None:
            return self.frame
        if self.order_by:
            return WindowFrame("range", UNBOUNDED, CURRENT_ROW)
        return WindowFrame("range", UNBOUNDED, UNBOUNDED)


def window_agg_op(f) -> str:
    """Frame-aggregation op name for an AggregateFunction node."""
    from spark_rapids_tpu_torch.expr import aggregates as A
    if isinstance(f, A.CountStar):
        return "count_star"
    if isinstance(f, A.Sum):
        return "sum"
    if isinstance(f, A.Count):
        return "count"
    if isinstance(f, A.Max):
        return "max"
    if isinstance(f, A.Min):
        return "min"
    if isinstance(f, A.Average):
        return "avg"
    raise ValueError(f"unsupported window aggregate: {f!r}")


class WindowFunction(Expression):
    """Marker base for ranking/offset window functions."""
    children: tuple = ()

    def with_new_children(self, children):
        return self

    @property
    def nullable(self):
        return False


class RowNumber(WindowFunction):
    sql_name = "row_number"

    def __init__(self):
        self.children = ()

    @property
    def dtype(self):
        return T.IntegerType()


class Rank(WindowFunction):
    sql_name = "rank"

    def __init__(self):
        self.children = ()

    @property
    def dtype(self):
        return T.IntegerType()


class DenseRank(WindowFunction):
    sql_name = "dense_rank"

    def __init__(self):
        self.children = ()

    @property
    def dtype(self):
        return T.IntegerType()


class Lead(WindowFunction):
    sql_name = "lead"

    def __init__(self, child: Expression, offset: int = 1,
                 default: Expression | None = None):
        self.children = (child,) if default is None else (child, default)
        self.offset = offset
        self.default = default

    def with_new_children(self, children):
        d = children[1] if len(children) > 1 else None
        return type(self)(children[0], self.offset, d)

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def nullable(self):
        return True


class Lag(Lead):
    sql_name = "lag"


class WindowExpression(Expression):
    """function OVER spec."""
    sql_name = "window"

    def __init__(self, function: Expression, spec: WindowSpec):
        self.children = (function,)
        self.function = function
        self.spec = spec

    def with_new_children(self, children):
        return WindowExpression(children[0], self.spec)

    @property
    def dtype(self):
        from spark_rapids_tpu_torch.expr.aggregates import AggregateFunction
        f = self.function
        if isinstance(f, AggregateFunction):
            # windowed agg result types follow the agg (sum->long/double..)
            from spark_rapids_tpu_torch.ops.segmented import AggSpec
            op = window_agg_op(f)
            in_t = f.input.dtype if f.input is not None else T.LongType()
            return AggSpec(op, 0).result_type(in_t)
        return f.dtype

    @property
    def nullable(self):
        return True

    def over(self, spec: WindowSpec) -> "WindowExpression":
        return WindowExpression(self.function, spec)
