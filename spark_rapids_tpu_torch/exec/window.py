"""Window exec: evaluate window expressions over sorted partitions.

Port of ``spark_rapids_tpu/exec/window.py:58-475`` (GpuWindowExec,
GpuWindowExec.scala:92).  The exec concatenates its input's batches into
one (RequireSingleBatch, as the reference's child goal), sorts it once by
(partition keys ascending with nulls first, then the order keys) with K1
and K3, derives the shared segment arrays (K12a) and computes every
window expression from them (K12b for frame aggregates, K12c for min/max
over a frame with a bounded lower edge).  Output rows are
in sorted order (Spark leaves window output order undefined).

With ``keys_partitioned`` the planner has hash-partitioned the input on
the window's partition keys, so each input partition holds whole
partition groups and the window runs per partition; otherwise all input
partitions are concatenated.

All window expressions in one exec share one WindowSpec: the planner makes
one WindowExec per distinct spec, as Spark's does.

Not ported: the bounded-memory two-pass global window (``_stream_global``
:191: plain aggregates over a window with neither partition nor order
keys), which parks its batches in the BufferCatalog (ROADMAP.md Queue 1
item 6); such a window raises NotImplementedError.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    round_string_width)
from spark_rapids_tpu_torch.exec.core import (ExecCtx, PlanNode,
                                              RequireSingleBatch,
                                              drain_partitions)
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr.core import (Alias, Expression, Literal,
                                              bind, eval_device, output_name)
from spark_rapids_tpu_torch.expr.window import (DenseRank, Lag, Lead, Rank,
                                                RowNumber, WindowExpression,
                                                window_agg_op)
from spark_rapids_tpu_torch.ops import kernels as dk
from spark_rapids_tpu_torch.ops import window as W
from spark_rapids_tpu_torch.ops.segmented import AggSpec
from spark_rapids_tpu_torch.ops.sort import SortOrder, sort_batch

__all__ = ["WindowExec"]

_STREAM_GLOBAL = ("a window with neither partition nor order keys runs as "
                  "the reference's two-pass bounded-memory stream, which "
                  "parks batches in the BufferCatalog: it waits for the "
                  "memory runtime (ROADMAP.md Queue 1 item 6)")


def _wexpr_dtype(w: WindowExpression, bound_input) -> T.DataType:
    """Output type from the BOUND function input."""
    f = w.function
    if isinstance(f, A.AggregateFunction):
        in_t = bound_input.dtype if bound_input is not None else T.LongType()
        return AggSpec(window_agg_op(f), 0).result_type(in_t)
    if isinstance(f, (Lead, Lag)):
        return bound_input.dtype
    return f.dtype


class WindowExec(PlanNode):
    """Append one output column per window expression.

    ``window_exprs``: WindowExpression (optionally Alias-wrapped), all
    sharing the same WindowSpec."""

    def __init__(self, window_exprs: Sequence[Expression], child: PlanNode,
                 keys_partitioned: bool = False):
        super().__init__([child])
        self._keys_partitioned = bool(keys_partitioned)
        self._names = [output_name(e) for e in window_exprs]
        self._wexprs: list[WindowExpression] = []
        for e in window_exprs:
            if isinstance(e, Alias):
                e = e.children[0]
            assert isinstance(e, WindowExpression), e
            self._wexprs.append(e)
        assert self._wexprs, "need at least one window expression"
        spec0 = self._wexprs[0].spec
        for e in self._wexprs[1:]:
            if e.spec != spec0:
                raise ValueError("one WindowExec handles one WindowSpec; "
                                 "split plans per spec as Spark does")
        self.spec = spec0
        cs = child.output_schema
        self._part_b = [bind(p, cs) for p in self.spec.partition_by]
        self._order_b = [(bind(o[0], cs), o[1] if len(o) > 1 else True,
                          o[2] if len(o) > 2 else None)
                         for o in self.spec.order_by]
        self._fn_inputs: list[Expression | None] = []
        for w in self._wexprs:
            f = w.function
            if isinstance(f, (Lead, Lag)):
                self._fn_inputs.append(bind(f.children[0], cs))
            elif isinstance(f, A.AggregateFunction) and f.input is not None:
                self._fn_inputs.append(bind(f.input, cs))
            else:
                self._fn_inputs.append(None)
        self._out_dtypes = [_wexpr_dtype(w, b)
                            for w, b in zip(self._wexprs, self._fn_inputs)]
        self._schema = T.Schema(
            list(cs.fields)
            + [T.StructField(n, dt, True)
               for n, dt in zip(self._names, self._out_dtypes)])

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    @property
    def bound_exprs(self):
        return self._part_b + [o[0] for o in self._order_b] + \
            [e for e in self._fn_inputs if e is not None]

    @property
    def output_batching(self):
        return RequireSingleBatch

    def num_partitions(self, ctx: ExecCtx) -> int:
        if self._keys_partitioned:
            return self.children[0].num_partitions(ctx)
        return 1

    def _global_streamable(self) -> bool:
        """The reference's test (:123) for the two-pass global window:
        no partition or order keys, and only plain aggregates over
        fixed-width inputs."""
        if self.spec.partition_by or self.spec.order_by:
            return False
        for w, inp in zip(self._wexprs, self._fn_inputs):
            f = w.function
            if not isinstance(f, A.AggregateFunction):
                return False
            try:
                window_agg_op(f)
            except ValueError:
                return False
            if inp is not None and (inp.dtype.np_dtype is None
                                    or isinstance(inp.dtype, T.StringType)):
                return False
        return True

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        if not self._keys_partitioned and self._global_streamable():
            raise NotImplementedError(_STREAM_GLOBAL)
        child = self.children[0]
        batches = list(child.partition_iter(ctx, pid)
                       if self._keys_partitioned
                       else drain_partitions(ctx, child))
        if not batches:
            return
        big = batches[0] if len(batches) == 1 \
            else dk.concat_batches(batches)
        yield self._run(big)

    # ------------------------------------------------------------------
    def _window_args(self, big: ColumnBatch) -> tuple:
        """``big`` with the evaluated partition, order and input columns
        appended, and the sort orders: ``(aug, orders, part_idx,
        order_idx, input_idx)``."""
        cols = list(big.columns)
        fields = list(big.schema.fields)
        part_idx, order_idx, input_idx = [], [], []
        for e in self._part_b:
            cols.append(eval_device(e, big))
            fields.append(T.StructField(f"_wp{len(part_idx)}", e.dtype, True))
            part_idx.append(len(cols) - 1)
        for e, _asc, _nf in self._order_b:
            cols.append(eval_device(e, big))
            fields.append(T.StructField(f"_wo{len(order_idx)}", e.dtype,
                                        True))
            order_idx.append(len(cols) - 1)
        for e in self._fn_inputs:
            if e is None:
                input_idx.append(None)
            else:
                cols.append(eval_device(e, big))
                fields.append(T.StructField(f"_wi{len(cols)}", e.dtype, True))
                input_idx.append(len(cols) - 1)
        aug = ColumnBatch(cols, big.num_rows, T.Schema(fields), big.device)
        orders = [SortOrder(i, True, True) for i in part_idx] + \
            [SortOrder(i, asc, nf)
             for i, (_, asc, nf) in zip(order_idx, self._order_b)]
        return aug, orders, part_idx, order_idx, input_idx

    def _run(self, big: ColumnBatch) -> ColumnBatch:
        """The reference's ``_window_body`` (:518): sort by (partition,
        order), derive the segment arrays, evaluate every expression."""
        aug, orders, part_idx, order_idx, input_idx = self._window_args(big)
        sb = sort_batch(aug, orders) if orders else aug
        seg = W.sorted_segments(sb, part_idx, order_idx)
        n = sb.num_rows
        dev = sb.device
        every = torch.ones(n, dtype=torch.bool, device=dev)
        out_cols = list(sb.columns[:big.num_columns])
        for w, ii in zip(self._wexprs, input_idx):
            f = w.function
            if isinstance(f, (RowNumber, Rank, DenseRank)):
                fn = {RowNumber: W.row_number, Rank: W.rank,
                      DenseRank: W.dense_rank}[type(f)]
                out_cols.append(DeviceColumn(fn(seg).to(torch.int32), every,
                                             T.IntegerType()))
            elif isinstance(f, (Lead, Lag)):
                # Lag subclasses Lead: test Lag first
                off = -f.offset if isinstance(f, Lag) else f.offset
                col = sb.columns[ii]
                data, validity, lengths = W.lead_lag(
                    col, seg, off, *self._lead_default(f, col, n))
                out_cols.append(DeviceColumn(data, validity, col.dtype,
                                             lengths))
            else:
                op = window_agg_op(f)
                frame = w.spec.resolved_frame()
                if op == "count_star":
                    op, col = "count", DeviceColumn(
                        torch.zeros(n, dtype=torch.int64, device=dev), every,
                        T.LongType())
                else:
                    col = sb.columns[ii]
                data, validity, rtype = W.running_or_bounded_agg(
                    op, col, seg, frame)
                out_cols.append(DeviceColumn(data, validity, rtype))
        return ColumnBatch(out_cols, n, self._schema, dev)

    @staticmethod
    def _lead_default(f: Lead, col: DeviceColumn, n: int) -> tuple:
        """(default_data, default_valid, default_len) of lead/lag's
        literal default, broadcast to ``n`` rows; Nones without one."""
        if f.default is None:
            return None, None, None
        assert isinstance(f.default, Literal)
        if f.default.value is None:
            return None, None, None
        dev = col.validity.device
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        if col.is_string:
            bs = str(f.default.value).encode("utf-8")
            w = max(col.max_len, round_string_width(max(len(bs), 1)))
            row = np.zeros(w, dtype=np.uint8)
            row[:len(bs)] = np.frombuffer(bs, dtype=np.uint8)
            data = torch.from_numpy(row).to(dev).expand(n, w)
            return data, valid, torch.full((n,), len(bs), dtype=torch.int32,
                                           device=dev)
        data = torch.full((n,), f.default.value, dtype=col.data.dtype,
                          device=dev)
        return data, valid, None

    def node_desc(self) -> str:
        return f"WindowExec[{self._names}]"
