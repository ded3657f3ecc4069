"""Logical plan nodes (port of ``spark_rapids_tpu/plan/logical.py``, the
nodes the port lowers: Scan, Project, Filter, Aggregate, Join, Sort,
Limit, Repartition, Window, Union, Generate)."""
from __future__ import annotations

from dataclasses import dataclass, field

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.core import PlanNode
from spark_rapids_tpu_torch.expr.core import Expression

__all__ = ["LogicalPlan", "Scan", "Project", "Filter", "Aggregate", "Join",
           "Sort", "Limit", "Repartition", "Window", "Union", "Generate"]


class LogicalPlan:
    children: tuple = ()

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError


@dataclass
class Scan(LogicalPlan):
    """Leaf wrapping a physical source exec."""
    exec_node: PlanNode

    @property
    def children(self):
        return ()

    @property
    def schema(self) -> T.Schema:
        return self.exec_node.output_schema


@dataclass
class Project(LogicalPlan):
    exprs: list
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)


@dataclass
class Filter(LogicalPlan):
    condition: Expression
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        return self.child.schema


@dataclass
class Aggregate(LogicalPlan):
    group_exprs: list
    agg_exprs: list
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)


@dataclass
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    how: str
    left_on: list
    right_on: list
    condition: Expression | None = None

    @property
    def children(self):
        return (self.left, self.right)


@dataclass
class Sort(LogicalPlan):
    orders: list
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        return self.child.schema


@dataclass
class Limit(LogicalPlan):
    n: int
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        return self.child.schema


@dataclass
class Repartition(LogicalPlan):
    num_partitions: int
    keys: list  # empty = round robin
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    @property
    def schema(self):
        return self.child.schema


@dataclass
class Window(LogicalPlan):
    """Window expressions of one spec appended to the child's columns."""
    window_exprs: list
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)


@dataclass
class Union(LogicalPlan):
    """UNION ALL of the inputs, by position."""
    inputs: list

    @property
    def children(self):
        return tuple(self.inputs)

    @property
    def schema(self):
        return self.inputs[0].schema


@dataclass
class Generate(LogicalPlan):
    """A generator (explode/posexplode) appended to the child's columns
    (reference ``plan/logical.py:158-170``)."""
    generator: Expression
    child: LogicalPlan
    outer: bool = False
    pos: bool = False
    output_names: list = field(default_factory=lambda: ["col"])

    @property
    def children(self):
        return (self.child,)
