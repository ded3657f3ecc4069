"""Hash-aggregate exec (port of ``spark_rapids_tpu/exec/aggregate.py:41``).

The device kernel is sort-based (K1 + K3 + K4, ``ops/segmented.py``).  The
per-batch loop is the reference's ``_run_device`` (:340-467): each input
batch is reduced to its own group buffer; buffers collect until their
summed rows cross ``_MERGE_PENDING_CAP``, then merge in one n-way concat +
segmented merge; the final projection runs over the last buffer.  A
holistic aggregate (percentile, reference :81-95 and :353-361) has no
merge: its raw input is concatenated once and reduced in one pass, and
every percentile over one column rides one value-sort (the pre-projection
keeps one column per distinct input).

Modes (reference :52-263): ``complete`` aggregates every partition of the
child in one pass; ``partial`` runs the update per child partition and
emits the group buffers (``_buf_0``, ...); ``final``
(:meth:`HashAggregateExec.final_from_partial`, :159) merges the buffers
that an exchange routed to its partition with the merge specs (a count is
summed, an average merges its sum and its count) and projects the result.
"""
from __future__ import annotations

from typing import Iterator, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.core import (ExecCtx, PlanNode,
                                              RequireSingleBatch, TargetSize,
                                              drain_partitions)
from spark_rapids_tpu_torch.expr.aggregates import AggregateFunction
from spark_rapids_tpu_torch.expr.core import (Alias, BoundReference,
                                              Expression, Literal, bind,
                                              eval_device, output_name)
from spark_rapids_tpu_torch.ops import kernels as dk
from spark_rapids_tpu_torch.ops.segmented import AggSpec, sorted_group_by

__all__ = ["HashAggregateExec"]


def _strip_alias(e: Expression) -> Expression:
    return e.children[0] if isinstance(e, Alias) else e


class HashAggregateExec(PlanNode):
    """Group-by aggregation over all partitions of the child.

    ``group_exprs``: grouping expressions (resolved against the child
    schema).  ``result_exprs``: output expressions over group keys and
    aggregate functions (e.g. ``Sum(col("x")).alias("s")``)."""

    #: pending group buffers merge once their summed rows cross this bound
    _MERGE_PENDING_CAP = 1 << 23

    def __init__(self, group_exprs: Sequence[Expression],
                 result_exprs: Sequence[Expression], child: PlanNode,
                 mode: str = "complete"):
        if mode == "final":
            raise ValueError("use HashAggregateExec.final_from_partial()")
        if mode not in ("complete", "partial"):
            raise ValueError(f"aggregation mode {mode!r}")
        super().__init__([child])
        self.mode = mode
        child_schema = child.output_schema
        self._group_bound = [bind(_strip_alias(g), child_schema)
                             for g in group_exprs]
        for g in self._group_bound:
            if isinstance(g.dtype, T.ArrayType):
                raise ValueError("cannot group by an array column")
        self._group_names = [output_name(g) for g in group_exprs]
        self._result_raw = list(result_exprs)
        self._result_bound = [bind(r, child_schema) for r in self._result_raw]

        # distinct aggregate functions (structural identity)
        self._aggs: list[AggregateFunction] = []
        seen: dict[str, int] = {}
        for r in self._result_bound:
            for a in _collect_aggs(r):
                key = repr(a)
                if key not in seen:
                    seen[key] = len(self._aggs)
                    self._aggs.append(a)
        self._agg_index = seen
        self._holistic = any(getattr(a, "requires_complete", False)
                             for a in self._aggs)
        if self._holistic and mode == "partial":
            raise ValueError("holistic aggregates (percentile) cannot run "
                             "in partial mode; plan a complete aggregation")
        if self._holistic and any(op.startswith(("first", "last"))
                                  for a in self._aggs for op in a.update_ops):
            raise NotImplementedError(
                "percentile cannot be combined with first/last in one "
                "aggregation: the percentile value-sort would change which "
                "row first/last observe")

        # pre-projection: [group keys..., one col per DISTINCT agg input]
        self._pre_exprs: list[Expression] = list(self._group_bound)
        self._agg_input_col: list[int | None] = []
        in_seen: dict[str, int] = {}
        for a in self._aggs:
            if a.input is None:
                self._agg_input_col.append(None)
                continue
            key = repr(a.input)
            if key not in in_seen:
                in_seen[key] = len(self._pre_exprs)
                self._pre_exprs.append(a.input)
            self._agg_input_col.append(in_seen[key])
        if not self._pre_exprs:
            # rows-only aggregation (bare COUNT(*)): keep the row count
            self._pre_exprs.append(Literal(1, T.ByteType()))
        k = len(self._group_bound)
        self._pre_schema = T.Schema(
            [T.StructField(n, g.dtype, True)
             for n, g in zip(self._group_names, self._group_bound)]
            + [T.StructField(f"_agg_in_{i}", e.dtype, True)
               for i, e in enumerate(self._pre_exprs[k:])])

        # update specs + buffer layout
        self._update_specs: list[AggSpec] = []
        self._agg_offsets: list[list[int]] = []
        buf_fields = list(self._pre_schema.fields[:k])
        for a, ci in zip(self._aggs, self._agg_input_col):
            offs = []
            for op, it in zip(a.update_ops, a.intermediate_types()):
                offs.append(k + len(self._update_specs))
                self._update_specs.append(AggSpec(
                    op, ci if ci is not None else 0,
                    param=getattr(a, "q", None)))
                buf_fields.append(T.StructField(
                    f"_buf_{len(buf_fields) - k}", it, True))
            self._agg_offsets.append(offs)
        self._buffer_schema = T.Schema(buf_fields)

        self._merge_specs: list[AggSpec] = []
        for a, offs in zip(self._aggs, self._agg_offsets):
            for op, off in zip(a.merge_ops, offs):
                self._merge_specs.append(AggSpec(op, off))

        self._final_exprs = [self._to_buffer_space(r)
                             for r in self._result_bound]
        self._output_schema = self._buffer_schema if mode == "partial" \
            else self._result_schema()

    @classmethod
    def final_from_partial(cls, partial: "HashAggregateExec",
                           child: PlanNode) -> "HashAggregateExec":
        """The final-mode exec over ``partial``'s buffer output (through an
        exchange)."""
        self = object.__new__(cls)
        PlanNode.__init__(self, [child])
        self.mode = "final"
        for attr in ("_group_bound", "_group_names", "_result_raw",
                     "_result_bound", "_aggs", "_agg_index", "_holistic",
                     "_pre_exprs",
                     "_agg_input_col", "_pre_schema", "_update_specs",
                     "_agg_offsets", "_buffer_schema", "_merge_specs",
                     "_final_exprs"):
            setattr(self, attr, getattr(partial, attr))
        self._output_schema = self._result_schema()
        return self

    def _result_schema(self) -> T.Schema:
        return T.Schema([T.StructField(output_name(r), b.dtype, True)
                         for r, b in zip(self._result_raw,
                                         self._final_exprs)])

    def _to_buffer_space(self, bound: Expression) -> Expression:
        """Rewrite a bound result expression over the buffer batch:
        aggs -> final_expr(offsets), group exprs -> key refs."""
        group_reprs = {repr(g): i for i, g in enumerate(self._group_bound)}

        def rewrite(node: Expression) -> Expression:
            if isinstance(node, AggregateFunction):
                i = self._agg_index[repr(node)]
                return self._aggs[i].final_expr(self._agg_offsets[i])
            r = repr(node)
            if r in group_reprs:
                i = group_reprs[r]
                f = self._buffer_schema.fields[i]
                return BoundReference(i, f.data_type, True, f.name)
            return node

        return _rewrite_topdown(bound, rewrite)

    # ------------------------------------------------------------------
    @property
    def output_schema(self) -> T.Schema:
        return self._output_schema

    @property
    def bound_exprs(self):
        return list(self._pre_exprs) + list(self._final_exprs)

    @property
    def output_batching(self):
        return RequireSingleBatch

    @property
    def children_coalesce_goal(self):
        # batch scan output up to batchSizeBytes before aggregating;
        # TargetSize(0) resolves to spark.rapids.sql.batchSizeBytes.  The
        # final mode reads shuffle output (coalesced by the adaptive
        # reader where it is on).
        return [None] if self.mode == "final" else [TargetSize(0)]

    def num_partitions(self, ctx: ExecCtx) -> int:
        # complete mode aggregates the whole input: one partition; partial
        # and final run per partition (the exchange between them moves
        # rows across partitions)
        if self.mode == "complete":
            return 1
        return self.children[0].num_partitions(ctx)

    def _child_presorted(self) -> bool:
        """Every group key is a plain child column and the child already
        clusters them in bound order: the update may skip its sort."""
        k = len(self._group_bound)
        if not k or self.mode == "final":
            return False
        ordering = self.children[0].output_ordering
        if not ordering or len(ordering) < k:
            return False
        child_names = self.children[0].output_schema.names
        for g, have in zip(self._group_bound, ordering):
            if not isinstance(g, BoundReference) \
                    or child_names[g.index] != have:
                return False
        return len({g.index for g in self._group_bound}) == k

    def _update(self, b: ColumnBatch, key_idx, presorted) -> ColumnBatch:
        cols = [eval_device(e, b) for e in self._pre_exprs]
        pre = ColumnBatch(cols, b.num_rows, self._pre_schema, b.device)
        return _relabel(sorted_group_by(pre, key_idx, self._update_specs,
                                        presorted=presorted),
                        self._buffer_schema)

    def _merge(self, parts: list[ColumnBatch], key_idx) -> ColumnBatch:
        cat = _relabel(dk.concat_batches(parts), self._buffer_schema)
        return _relabel(sorted_group_by(cat, key_idx, self._merge_specs),
                        self._buffer_schema)

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        child = self.children[0]
        child_it = drain_partitions(ctx, child) if self.mode == "complete" \
            else child.partition_iter(ctx, pid)
        if self._holistic:
            # no merge exists: concatenate the raw input once and reduce it
            # in a single group-by pass
            raw = list(child_it)
            child_it = [dk.concat_batches(raw)] if len(raw) > 1 else raw
        key_idx = list(range(len(self._group_bound)))
        presorted = self._child_presorted()
        parts: list[ColumnBatch] = []
        pending_rows = 0
        for b in child_it:
            part = _relabel(b, self._buffer_schema) if self.mode == "final" \
                else self._update(b, key_idx, presorted)
            if part.num_rows == 0 and key_idx:
                continue
            parts.append(part)
            pending_rows += part.num_rows
            if len(parts) > 1 and pending_rows >= self._MERGE_PENDING_CAP:
                parts = [self._merge(parts, key_idx)]
                pending_rows = parts[0].num_rows
        if len(parts) > 1:
            parts = [self._merge(parts, key_idx)]
        if not parts:
            if key_idx or self.mode == "partial":
                return  # no groups
            # grand aggregate on empty input: the default-values row
            empty = ColumnBatch.nulls(self._pre_schema, 0, ctx.device)
            parts = [_relabel(sorted_group_by(empty, key_idx,
                                              self._update_specs),
                              self._buffer_schema)]
        running = parts[0]
        if self.mode == "partial":
            yield running
            return
        cols = [eval_device(e, running) for e in self._final_exprs]
        yield ColumnBatch(cols, running.num_rows, self._output_schema,
                          running.device)

    def node_desc(self) -> str:
        return (f"HashAggregateExec[{self.mode}, keys={self._group_names}, "
                f"out={self._output_schema.names}]")


def _collect_aggs(e: Expression) -> list[AggregateFunction]:
    if isinstance(e, AggregateFunction):
        return [e]
    out: list[AggregateFunction] = []
    for c in e.children:
        out.extend(_collect_aggs(c))
    return out


def _rewrite_topdown(e: Expression, fn) -> Expression:
    new = fn(e)
    if new is not e:
        return new
    children = [_rewrite_topdown(c, fn) for c in e.children]
    if all(a is b for a, b in zip(children, e.children)):
        return e
    return e.with_new_children(children)


def _relabel(b: ColumnBatch, schema: T.Schema) -> ColumnBatch:
    cols = [DeviceColumn(c.data, c.validity, f.data_type, c.lengths)
            for c, f in zip(b.columns, schema)]
    return ColumnBatch(cols, b.num_rows, schema, b.device)
