"""Project, filter, union and limit execs (port of
``spark_rapids_tpu/exec/basic.py`` :93 ProjectExec, :250 FilterExec, :357
UnionExec, :408 LocalLimitExec, :428 GlobalLimitExec)."""
from __future__ import annotations

from typing import Iterator, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.exec.core import (ExecCtx, PlanNode,
                                              drain_partitions)
from spark_rapids_tpu_torch.expr.core import (Alias, Expression,
                                              BoundReference, bind,
                                              eval_device, output_name)
from spark_rapids_tpu_torch.ops import kernels as dk

__all__ = ["ProjectExec", "FilterExec", "UnionExec", "LocalLimitExec",
           "GlobalLimitExec"]


class ProjectExec(PlanNode):
    """Evaluate bound expressions per batch (GpuProjectExec.project)."""

    def __init__(self, exprs: Sequence[Expression], child: PlanNode):
        super().__init__([child])
        self._raw = list(exprs)
        self._bound = [bind(e, child.output_schema) for e in self._raw]
        self._schema = T.Schema([
            T.StructField(output_name(r), b.dtype)
            for r, b in zip(self._raw, self._bound)])

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    @property
    def bound_exprs(self):
        return list(self._bound)

    @property
    def output_batching(self):
        # 1:1 batch mapping: the child's batching contract holds here too
        return self.children[0].output_batching

    @property
    def output_ordering(self):
        """The child's ordering survives as far as its leading columns
        pass through as plain references (possibly renamed)."""
        child_ord = self.children[0].output_ordering
        if not child_ord:
            return None
        child_names = self.children[0].output_schema.names
        renames = {}
        for raw, b in zip(self._raw, self._bound):
            inner = b.children[0] if isinstance(b, Alias) else b
            if isinstance(inner, BoundReference):
                renames.setdefault(child_names[inner.index], output_name(raw))
        names = []
        for n in child_ord:
            if n not in renames:
                break
            names.append(renames[n])
        return names or None

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        for b in self.children[0].partition_iter(ctx, pid):
            cols = [eval_device(e, b) for e in self._bound]
            yield ColumnBatch(cols, b.num_rows, self._schema, b.device)

    def node_desc(self) -> str:
        return f"ProjectExec[{self._schema.names}]"


class FilterExec(PlanNode):
    """Boolean condition -> compact kept rows (K2)."""

    def __init__(self, condition: Expression, child: PlanNode):
        super().__init__([child])
        self._cond = bind(condition, child.output_schema)
        if not isinstance(self._cond.dtype, T.BooleanType):
            raise TypeError(f"filter condition must be boolean, got "
                            f"{self._cond.dtype}")

    @property
    def output_schema(self) -> T.Schema:
        return self.children[0].output_schema

    @property
    def bound_exprs(self):
        return [self._cond]

    @property
    def output_ordering(self):
        # compaction is order-preserving
        return self.children[0].output_ordering

    @property
    def output_batching(self):
        return self.children[0].output_batching

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        for b in self.children[0].partition_iter(ctx, pid):
            c = eval_device(self._cond, b)
            yield dk.compact(b, c.data & c.validity)  # null -> drop

    def node_desc(self) -> str:
        return "FilterExec"


class UnionExec(PlanNode):
    """UNION ALL (GpuUnionExec): the children's partitions back to back,
    each batch relabelled with the first child's schema."""

    def __init__(self, children: Sequence[PlanNode]):
        super().__init__(children)
        want = [f.data_type for f in children[0].output_schema]
        for c in children[1:]:
            got = [f.data_type for f in c.output_schema]
            if got != want:
                raise ValueError(f"union schema mismatch: {got} vs {want}")

    @property
    def output_schema(self) -> T.Schema:
        return self.children[0].output_schema

    def num_partitions(self, ctx: ExecCtx) -> int:
        return sum(c.num_partitions(ctx) for c in self.children)

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        for c in self.children:
            nparts = c.num_partitions(ctx)
            if pid < nparts:
                for b in c.partition_iter(ctx, pid):
                    yield ColumnBatch(b.columns, b.num_rows,
                                      self.output_schema, b.device)
                return
            pid -= nparts
        raise IndexError("partition out of range")


def _limited(it: Iterator, remaining: int) -> Iterator:
    """Yield batches sliced to at most ``remaining`` total rows."""
    for b in it:
        if remaining <= 0:
            return
        b = dk.slice_batch(b, remaining)
        remaining -= b.num_rows
        yield b


class LocalLimitExec(PlanNode):
    """Per-partition limit (GpuLocalLimitExec, limit.scala)."""

    def __init__(self, limit: int, child: PlanNode):
        super().__init__([child])
        self._limit = limit

    @property
    def output_schema(self) -> T.Schema:
        return self.children[0].output_schema

    @property
    def output_ordering(self):
        return self.children[0].output_ordering  # prefix slice

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        yield from _limited(self.children[0].partition_iter(ctx, pid),
                            self._limit)


class GlobalLimitExec(PlanNode):
    """Whole-query limit: one output partition (GpuGlobalLimitExec)."""

    def __init__(self, limit: int, child: PlanNode):
        super().__init__([child])
        self._limit = limit

    @property
    def output_schema(self) -> T.Schema:
        return self.children[0].output_schema

    def num_partitions(self, ctx: ExecCtx) -> int:
        return 1

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        yield from _limited(drain_partitions(ctx, self.children[0]),
                            self._limit)
