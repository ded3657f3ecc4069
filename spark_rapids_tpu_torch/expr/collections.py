"""Array (collection) expressions over ArrayType columns (port of
``spark_rapids_tpu/expr/collections.py:59-157``).

Arrays are element matrices ``[n, W]`` with int32 lengths
(``columnar/column.py``), so each expression is a few torch ops, not a
kernel of its own: ``GetArrayItem`` a one-column gather, ``Size`` a
length read, ``ArrayContains`` a masked compare.

The map expressions (``GetMapValue``, ``MapKeys``, ``MapValues`` and
``MapLookup``) need map columns, which the reference keeps on its host;
the port has no host oracle yet, so they raise (ROADMAP.md Queue 1 item
4).
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Expression

__all__ = ["GetArrayItem", "Size", "ArrayContains", "GetMapValue",
           "MapKeys", "MapValues", "MapLookup"]


def _elements_in(arr) -> torch.Tensor:
    """bool [n, W]: the slots inside each row's length."""
    w = arr.data.shape[1]
    return torch.arange(w, device=arr.data.device)[None, :] < \
        arr.lengths.to(torch.int64)[:, None]


class GetArrayItem(Expression):
    """arr[index] (0-based, Spark's GetArrayItem): null when the array or
    the index is null, or the index is out of range.  The index is read
    as an int, as Spark and the reference read it."""

    sql_name = "GetArrayItem"

    def __init__(self, child: Expression, index: Expression):
        self.children = (child, index)

    @property
    def dtype(self):
        at = self.children[0].dtype
        if not isinstance(at, T.ArrayType):
            raise TypeError(f"GetArrayItem of a {at}, not an array")
        return at.element_type

    def _eval(self, vals, ctx):
        arr, idx = vals
        w = arr.data.shape[1]
        j = idx.data.to(torch.int32).to(torch.int64)
        in_range = (j >= 0) & (j < arr.lengths.to(torch.int64))
        validity = arr.validity & idx.validity & in_range
        picked = torch.gather(arr.data, 1,
                              j.clamp(0, max(w - 1, 0))[:, None])[:, 0]
        return ctx.canonical(picked, validity, self.dtype)


class Size(Expression):
    """size(arr): the element count; -1 for a null array (Spark's legacy
    ``sizeOfNull`` default, under which the reference runs)."""

    sql_name = "Size"

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        return T.IntegerType()

    @property
    def nullable(self):
        return False

    def _eval(self, vals, ctx):
        a = vals[0]
        data = torch.where(a.validity, a.lengths.to(torch.int32), -1)
        return ctx.canonical(data.to(torch.int32), ctx.row_mask,
                             T.IntegerType())


class ArrayContains(Expression):
    """array_contains(arr, value): null when the array or the value is
    null, else whether an element equals the value."""

    sql_name = "ArrayContains"

    def __init__(self, child: Expression, value: Expression):
        self.children = (child, value)

    @property
    def dtype(self):
        return T.BooleanType()

    def _eval(self, vals, ctx):
        arr, val = vals
        hit = ((arr.data == val.data[:, None]) & _elements_in(arr)).any(1)
        validity = arr.validity & val.validity
        return ctx.canonical(hit, validity, T.BooleanType())


class _MapExpression(Expression):
    """A map expression: maps have no device representation."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def dtype(self):
        raise NotImplementedError(self._refusal())

    def _refusal(self) -> str:
        return (f"{self.sql_name} needs map columns, which the reference "
                "keeps on its host; the port has no host oracle yet "
                "(ROADMAP.md Queue 1 item 4)")

    def _eval(self, vals, ctx):
        raise NotImplementedError(self._refusal())


class GetMapValue(_MapExpression):
    sql_name = "GetMapValue"


class MapKeys(_MapExpression):
    sql_name = "MapKeys"


class MapValues(_MapExpression):
    sql_name = "MapValues"


class MapLookup(_MapExpression):
    sql_name = "MapLookup"
