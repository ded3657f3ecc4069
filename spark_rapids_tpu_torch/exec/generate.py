"""Generate exec: explode / posexplode of arrays and of split strings
(port of ``spark_rapids_tpu/exec/generate.py``; reference
GpuGenerateExec.scala:101).

Per input row a generator yields 0..n output rows; the child columns are
repeated for each of them, then come the position (``pos``) when asked
and the generated column.  ``outer`` keeps a row whose generator yields
nothing (a null string; a null or empty array) as one row with a null
position and a null generated value.

Two generators, as in the reference: ``Explode`` over an ArrayType column
and ``SplitExplode``, explode(split(string, delimiter)) fused, for a
one-byte delimiter.  Per batch the exec reads one host total (the
reference's single sync, :257-300) and skips a batch whose total is 0;
K14a/K14b (``ops/generate.py``) split the strings, with the piece column
bucketed to the batch's widest piece, K14c emits the array elements, and
K3 gathers the child columns by each output row's source row.  There is
no host branch: the port has no host oracle yet.
"""
from __future__ import annotations

from typing import Iterator

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    round_string_width)
from spark_rapids_tpu_torch.exec.core import ExecCtx, PlanNode
from spark_rapids_tpu_torch.expr.core import Expression, bind, eval_device
from spark_rapids_tpu_torch.ops import generate as G
from spark_rapids_tpu_torch.ops import kernels as dk

__all__ = ["GenerateExec", "SplitExplode", "Explode"]


class SplitExplode(Expression):
    """Generator: explode(split(child, delimiter)), one-byte delimiter."""

    sql_name = "SplitExplode"

    def __init__(self, child: Expression, delimiter: str):
        if len(delimiter.encode("utf-8")) != 1:
            raise ValueError("SplitExplode supports single-byte delimiters")
        self.children = (child,)
        self.delimiter = delimiter

    @property
    def dtype(self):
        return T.StringType()

    @property
    def nullable(self):
        return True

    def with_new_children(self, children):
        return SplitExplode(children[0], self.delimiter)

    def __repr__(self):
        return f"SplitExplode({self.children[0]!r}, {self.delimiter!r})"


class Explode(Expression):
    """Generator: explode(array column)."""

    sql_name = "Explode"

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        at = self.children[0].dtype
        if not isinstance(at, T.ArrayType):
            raise TypeError(f"Explode of a {at}, not an array")
        return at.element_type

    @property
    def nullable(self):
        return True

    def with_new_children(self, children):
        return Explode(children[0])

    def __repr__(self):
        return f"Explode({self.children[0]!r})"


class GenerateExec(PlanNode):
    """explode/posexplode[_outer] of a SplitExplode or Explode generator,
    the child columns repeated for each generated row."""

    def __init__(self, generator: Expression, child: PlanNode,
                 outer: bool = False, pos: bool = False,
                 output_names=("col",)):
        super().__init__([child])
        if not isinstance(generator, (SplitExplode, Explode)):
            raise TypeError("only SplitExplode/Explode generators are "
                            "supported")
        self.generator = generator
        self.outer = outer
        self.pos = pos
        self._gen_bound = bind(generator.children[0], child.output_schema)
        if isinstance(generator, SplitExplode):
            if not isinstance(self._gen_bound.dtype, T.StringType):
                raise TypeError("SplitExplode input must be a string")
            out_dtype = T.StringType()
        else:
            if not isinstance(self._gen_bound.dtype, T.ArrayType):
                raise TypeError("Explode input must be an array")
            out_dtype = self._gen_bound.dtype.element_type
        names = list(output_names)
        fields = list(child.output_schema.fields)
        if pos:
            fields.append(T.StructField(
                names[0] if len(names) > 1 else "pos", T.IntegerType(), True))
        fields.append(T.StructField(names[-1], out_dtype, True))
        self._schema = T.Schema(fields)

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    @property
    def bound_exprs(self):
        return [self._gen_bound]

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        split = isinstance(self.generator, SplitExplode)
        delim = self.generator.delimiter.encode("utf-8")[0] if split \
            else None
        for b in self.children[0].partition_iter(ctx, pid):
            g = eval_device(self._gen_bound, b)
            if split:
                emit, total, widest = G.split_counts(
                    g.data, g.lengths, g.validity, delim, self.outer)
                if total == 0:
                    continue
                data, lengths, valid, src, pos = G.split_emit(
                    g.data, g.lengths, g.validity, delim, self.outer, emit,
                    total, round_string_width(widest))
                gen = DeviceColumn(data, valid, T.StringType(), lengths)
            else:
                emit, total = G.array_counts(g.lengths, g.validity,
                                             self.outer)
                if total == 0:
                    continue
                data, valid, src, pos = G.array_emit(
                    g.data, g.lengths, g.validity, self.outer, emit, total)
                gen = DeviceColumn(data, valid, self._schema.fields[-1]
                                   .data_type)
            cols = dk.gather_columns(b.columns, src)
            if self.pos:
                cols.append(DeviceColumn(pos, valid, T.IntegerType()))
            cols.append(gen)
            yield ColumnBatch(cols, total, self._schema, b.device)

    def node_desc(self) -> str:
        kind = "posexplode" if self.pos else "explode"
        return f"GenerateExec[{kind}{'_outer' if self.outer else ''}]"
