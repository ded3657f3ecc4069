"""Expression tree core: nodes, binding, and device evaluation.

Port of ``spark_rapids_tpu/expr/core.py:111-495``.  The reference evaluates
one kernel body on numpy or ``jax.numpy`` through an ``xp`` namespace; the
port evaluates on torch tensors, per expression, because torch lacks the
numpy surface that code relies on (``.astype``, uint32 shifts and adds on
the CPU).  Null semantics are the reference's: a :class:`Val` carries data
and validity, binary ops AND the validities unless the op says otherwise,
and invalid slots hold zeros (:meth:`EvalCtx.canonical`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    round_string_width,
                                                    torch_dtype)

__all__ = [
    "Val", "EvalCtx", "Expression", "Literal", "BoundReference",
    "UnresolvedAttribute", "Alias", "col", "lit", "bind", "eval_device",
    "output_name",
]


@dataclass
class Val:
    """Column value flowing through expression evaluation.

    data:     tensor [n] (strings: uint8 [n, W] byte matrix; arrays:
              [n, W] element matrix).
    validity: bool tensor [n].
    lengths:  int32 [n] for strings and arrays, else None.
    dtype:    SQL type.
    """
    data: Any
    validity: Any
    lengths: Any
    dtype: T.DataType

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, T.StringType)


class EvalCtx:
    """Evaluation context: device and row count of the batch."""

    def __init__(self, device: torch.device, capacity: int):
        self.device = device
        self.capacity = capacity

    @property
    def row_mask(self) -> torch.Tensor:
        """All rows are real (port batches carry no padding)."""
        return torch.ones(self.capacity, dtype=torch.bool, device=self.device)

    def zeros(self, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros((), dtype=dtype, device=self.device)

    def const(self, value, dtype: T.DataType) -> Val:
        """Broadcast a python scalar (or None) to a full-length Val."""
        n = self.capacity
        if value is None:
            validity = torch.zeros(n, dtype=torch.bool, device=self.device)
            if isinstance(dtype, T.StringType):
                return self._const_string("", validity)
            return Val(torch.zeros(n, dtype=torch_dtype(dtype),
                                   device=self.device), validity, None, dtype)
        validity = self.row_mask
        if isinstance(dtype, T.StringType):
            return self._const_string(str(value), validity)
        data = torch.full((n,), value, dtype=torch_dtype(dtype),
                          device=self.device)
        return Val(data, validity, None, dtype)

    def _const_string(self, s: str, validity) -> Val:
        bs = s.encode("utf-8")
        w = round_string_width(max(len(bs), 1))
        row = np.zeros(w, dtype=np.uint8)
        row[:len(bs)] = np.frombuffer(bs, dtype=np.uint8)
        data = torch.from_numpy(row).to(self.device).expand(self.capacity, w)
        data = torch.where(validity[:, None], data, self.zeros(torch.uint8))
        lengths = torch.where(validity, len(bs), 0).to(torch.int32)
        return Val(data, validity, lengths, T.StringType())

    def canonical(self, data, validity, dtype: T.DataType,
                  lengths=None) -> Val:
        """Zero data at invalid slots (the column invariant)."""
        if isinstance(dtype, (T.StringType, T.ArrayType)):
            data = torch.where(validity[:, None], data,
                               self.zeros(data.dtype))
            lengths = torch.where(validity, lengths, self.zeros(torch.int32))
            return Val(data, validity, lengths, dtype)
        data = torch.where(validity, data, self.zeros(data.dtype))
        return Val(data, validity, None, dtype)


class Expression:
    """Base expression node. Immutable; children in ``self.children``."""

    children: tuple["Expression", ...] = ()
    sql_name: str = "Expression"

    # -- analysis ----------------------------------------------------------
    @property
    def dtype(self) -> T.DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children)

    def with_new_children(self, children: Sequence["Expression"]
                          ) -> "Expression":
        return type(self)(*children)

    def coerced(self) -> "Expression":
        """Hook: insert casts after children are bound (type coercion)."""
        return self

    # -- evaluation --------------------------------------------------------
    def eval(self, inputs: list[Val], ctx: EvalCtx) -> Val:
        return self._eval([c.eval(inputs, ctx) for c in self.children], ctx)

    def _eval(self, vals: list[Val], ctx: EvalCtx) -> Val:
        raise NotImplementedError(type(self).__name__)

    # -- tree utilities ----------------------------------------------------
    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def transform_up(self, fn) -> "Expression":
        new_children = [c.transform_up(fn) for c in self.children]
        node = self if all(a is b for a, b in zip(new_children,
                                                  self.children)) \
            else self.with_new_children(new_children)
        return fn(node)

    def references(self) -> set[str]:
        out = set()
        for c in self.children:
            out |= c.references()
        return out

    def __repr__(self) -> str:
        if self.children:
            return f"{self.sql_name}({', '.join(map(repr, self.children))})"
        return self.sql_name

    # -- operator sugar (DataFrame column API) ------------------------------
    def _bin(self, other, cls, flip=False):
        other = other if isinstance(other, Expression) \
            else Literal.infer(other)
        return cls(other, self) if flip else cls(self, other)

    def __add__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Add
        return self._bin(o, Add)

    def __radd__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Add
        return self._bin(o, Add, flip=True)

    def __sub__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Subtract
        return self._bin(o, Subtract)

    def __rsub__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Subtract
        return self._bin(o, Subtract, flip=True)

    def __mul__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Multiply
        return self._bin(o, Multiply)

    def __rmul__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Multiply
        return self._bin(o, Multiply, flip=True)

    def __truediv__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Divide
        return self._bin(o, Divide)

    def __rtruediv__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Divide
        return self._bin(o, Divide, flip=True)

    def __eq__(self, o):  # noqa: A003 - expression DSL, not identity
        from spark_rapids_tpu_torch.expr.predicates import EqualTo
        return self._bin(o, EqualTo)

    def __ne__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import EqualTo, Not
        return Not(self._bin(o, EqualTo))

    def __lt__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import LessThan
        return self._bin(o, LessThan)

    def __le__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import LessThanOrEqual
        return self._bin(o, LessThanOrEqual)

    def __gt__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import GreaterThan
        return self._bin(o, GreaterThan)

    def __ge__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import GreaterThanOrEqual
        return self._bin(o, GreaterThanOrEqual)

    def __and__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import And
        return self._bin(o, And)

    def __or__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import Or
        return self._bin(o, Or)

    def __invert__(self):
        from spark_rapids_tpu_torch.expr.predicates import Not
        return Not(self)

    def __hash__(self):
        return id(self)

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def is_null(self) -> "Expression":
        from spark_rapids_tpu_torch.expr.predicates import IsNull
        return IsNull(self)

    def is_not_null(self) -> "Expression":
        from spark_rapids_tpu_torch.expr.predicates import IsNotNull
        return IsNotNull(self)

    def isin(self, *values) -> "Expression":
        from spark_rapids_tpu_torch.expr.predicates import In
        return In(self, [v if isinstance(v, Expression) else Literal.infer(v)
                         for v in values])

    def substr(self, pos, length) -> "Expression":
        from spark_rapids_tpu_torch.expr.strings import Substring
        return Substring(self, Literal.infer(pos), Literal.infer(length))

    def startswith(self, s) -> "Expression":
        from spark_rapids_tpu_torch.expr.strings import StartsWith
        return self._bin(s, StartsWith)

    def endswith(self, s) -> "Expression":
        from spark_rapids_tpu_torch.expr.strings import EndsWith
        return self._bin(s, EndsWith)

    def contains(self, s) -> "Expression":
        from spark_rapids_tpu_torch.expr.strings import Contains
        return self._bin(s, Contains)

    def like(self, pattern: str) -> "Expression":
        from spark_rapids_tpu_torch.expr.strings import Like
        return Like(self, pattern)


class Literal(Expression):
    sql_name = "Literal"

    def __init__(self, value, dtype: T.DataType):
        self.value = value
        self._dtype = dtype

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    def with_new_children(self, children):
        return self

    @staticmethod
    def infer(v) -> "Literal":
        if isinstance(v, Literal):
            return v
        if v is None:
            return Literal(None, T.NullType())
        if isinstance(v, bool):
            return Literal(v, T.BooleanType())
        if isinstance(v, int):
            return Literal(v, T.LongType())
        if isinstance(v, float):
            return Literal(v, T.DoubleType())
        if isinstance(v, str):
            return Literal(v, T.StringType())
        if isinstance(v, np.integer):
            return Literal(int(v), T.LongType())
        if isinstance(v, np.floating):
            return Literal(float(v), T.DoubleType())
        import datetime as _dt
        if isinstance(v, _dt.datetime):
            epoch = _dt.datetime(1970, 1, 1,
                                 tzinfo=v.tzinfo or _dt.timezone.utc)
            if v.tzinfo is None:
                v = v.replace(tzinfo=_dt.timezone.utc)
            micros = int((v - epoch).total_seconds() * 1_000_000)
            return Literal(micros, T.TimestampType())
        if isinstance(v, _dt.date):
            return Literal((v - _dt.date(1970, 1, 1)).days, T.DateType())
        raise TypeError(f"cannot create literal from {type(v)}")

    def eval(self, inputs, ctx):
        return ctx.const(self.value, self._dtype)

    def __repr__(self):
        return f"lit({self.value!r})"


class BoundReference(Expression):
    """Resolved input-column reference."""
    sql_name = "BoundReference"

    def __init__(self, index: int, dtype: T.DataType, nullable: bool = True,
                 name: str = ""):
        self.index = index
        self._dtype = dtype
        self._nullable = nullable
        self.name = name

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    def with_new_children(self, children):
        return self

    def references(self):
        return {self.name} if self.name else set()

    def eval(self, inputs, ctx):
        return inputs[self.index]

    def __repr__(self):
        return f"#{self.index}:{self.name or self._dtype.name}"


class UnresolvedAttribute(Expression):
    """Named column before binding (``col("x")``)."""
    sql_name = "UnresolvedAttribute"

    def __init__(self, name: str):
        self.name = name

    @property
    def dtype(self):
        raise TypeError(f"unresolved attribute {self.name!r} has no dtype; "
                        "bind() against a schema first")

    def with_new_children(self, children):
        return self

    def references(self):
        return {self.name}

    def __repr__(self):
        return f"col({self.name!r})"


class Alias(Expression):
    sql_name = "Alias"

    def __init__(self, child: Expression, name: str):
        self.children = (child,)
        self.name = name

    @property
    def child(self):
        return self.children[0]

    @property
    def dtype(self):
        return self.child.dtype

    def with_new_children(self, children):
        return Alias(children[0], self.name)

    def _eval(self, vals, ctx):
        return vals[0]

    def __repr__(self):
        return f"{self.child!r} AS {self.name}"


def col(name: str) -> UnresolvedAttribute:
    return UnresolvedAttribute(name)


def lit(v) -> Literal:
    return Literal.infer(v)


def output_name(e: Expression) -> str:
    if isinstance(e, Alias):
        return e.name
    if isinstance(e, UnresolvedAttribute):
        return e.name
    if isinstance(e, BoundReference) and e.name:
        return e.name
    return repr(e)


def bind(expr: Expression, schema: T.Schema) -> Expression:
    """Resolve names to BoundReferences against ``schema``, then run type
    coercion bottom-up (inserting Casts)."""

    def resolve(node: Expression) -> Expression:
        if isinstance(node, UnresolvedAttribute):
            i = schema.index_of(node.name)
            f = schema.fields[i]
            return BoundReference(i, f.data_type, f.nullable, f.name)
        return node.coerced()

    return expr.transform_up(resolve)


def eval_device(expr: Expression, batch) -> DeviceColumn:
    """Evaluate a bound expression over a ColumnBatch -> DeviceColumn."""
    ctx = EvalCtx(batch.device, batch.num_rows)
    inputs = [Val(c.data, c.validity, c.lengths, c.dtype)
              for c in batch.columns]
    v = expr.eval(inputs, ctx)
    v = ctx.canonical(v.data, v.validity, v.dtype, v.lengths)
    return DeviceColumn(v.data, v.validity, v.dtype, v.lengths)
