"""String expressions: Substring, StartsWith, EndsWith, Contains, Like,
Concat, ConcatWs, Upper, Lower, Hex.

Port of part of ``spark_rapids_tpu/expr/strings.py``.  Strings are padded
uint8 byte matrices with lengths (``columnar/column.py``); the work is
done by the kernels of ``ops/strings.py``: K13a ``substring`` (UTF-8
character-correct, Spark's ``substringSQL``), K13b ``string_match``
(prefix, suffix, contains, equals), K13c ``concat`` (Concat and
ConcatWs), K13d ``case_map`` (Upper and Lower) and K13i ``hex_string``
(Hex).  A literal operand
reaches a kernel as one row (a pos/len scalar, a one-row needle or
piece), a column as a column.

Upper and Lower map ASCII letters only, as the reference's device branch
does; Spark's are Unicode (ROADMAP.md Queue 3).  Concat's output is
wider than the reference's pairwise fold makes it; the values are the
same.

``Like`` runs the reference's device shapes (``%x``, ``x%``, ``%x%``,
exact; ``_simple_shape`` below is the reference's); any other pattern,
or one with ``_`` or the escape character, raises NotImplementedError on
every device: the reference evaluates those in its host oracle, which
the port does not have yet (ROADMAP.md Queue 1 item 4).  The other
string expressions of the reference (trims, Length,
StringLocate, SubstringIndex, ...) are ROADMAP.md Queue 2 K13e-h.
"""
from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import Expression, Literal, Val
from spark_rapids_tpu_torch.ops.strings import (case_map, concat,
                                                hex_string, literal_needle,
                                                string_match, substring)

__all__ = ["Substring", "StartsWith", "EndsWith", "Contains", "Like",
           "Concat", "ConcatWs", "Upper", "Lower", "Hex"]


def _scalar_or_column(child: Expression, v):
    """A non-null integer literal as a python int, else (data, validity)."""
    if isinstance(child, Literal) and child.value is not None:
        return int(child.value)
    return v.data, v.validity


class Substring(Expression):
    """Spark substring(str, pos, len): 1-based, pos <= 0 counts 0 / from
    the end, character-indexed; out of range gives '' (not null)."""
    sql_name = "Substring"

    def __init__(self, child: Expression, pos: Expression,
                 length: Expression):
        self.children = (child, pos, length)

    @property
    def dtype(self):
        return T.StringType()

    def _eval(self, vals, ctx):
        a, pos, length = vals
        data, lengths, validity = substring(
            a.data, a.lengths, a.validity,
            _scalar_or_column(self.children[1], pos),
            _scalar_or_column(self.children[2], length))
        return ctx.canonical(data, validity, T.StringType(), lengths)


def _needle(child: Expression, v, device):
    """(data, lengths, validity) of the needle: one row for a non-null
    string literal, else the evaluated column."""
    if isinstance(child, Literal) and child.value is not None:
        return literal_needle(str(child.value), device)
    return v.data, v.lengths, v.validity


class _StringPredicate(Expression):
    mode = ""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def dtype(self):
        return T.BooleanType()

    def _eval(self, vals, ctx):
        a, b = vals
        match, validity = string_match(
            self.mode, a.data, a.lengths, a.validity,
            *_needle(self.children[1], b, ctx.device))
        return ctx.canonical(match, validity, T.BooleanType())


class StartsWith(_StringPredicate):
    sql_name = "StartsWith"
    mode = "prefix"


class EndsWith(_StringPredicate):
    sql_name = "EndsWith"
    mode = "suffix"


class Contains(_StringPredicate):
    sql_name = "Contains"
    mode = "contains"


class Like(Expression):
    """SQL LIKE over the shapes the reference runs on its device (%x, x%,
    %x%, exact); other patterns raise."""
    sql_name = "Like"

    def __init__(self, child: Expression, pattern: str, escape: str = "\\"):
        self.children = (child,)
        self.pattern = pattern
        self.escape = escape

    def with_new_children(self, children):
        return Like(children[0], self.pattern, self.escape)

    @property
    def dtype(self):
        return T.BooleanType()

    def _simple_shape(self):
        """(kind, needle) for %-only patterns without _ or escapes."""
        p = self.pattern
        if "_" in p or self.escape in p:
            return None
        body = p.strip("%")
        if "%" in body:
            return None
        if p.startswith("%") and p.endswith("%") and len(p) >= 2:
            return ("contains", body)
        if p.endswith("%"):
            return ("prefix", body)
        if p.startswith("%"):
            return ("suffix", body)
        return ("equals", body)

    def _eval(self, vals, ctx):
        a = vals[0]
        shape = self._simple_shape()
        if shape is None:
            raise NotImplementedError(
                f"LIKE {self.pattern!r}: only the %x, x%, %x% and exact "
                "shapes without '_' or the escape character run on the "
                "port's devices; the reference evaluates other patterns in "
                "its host oracle, which is ROADMAP.md Queue 1 item 4")
        kind, needle = shape
        match, validity = string_match(kind, a.data, a.lengths, a.validity,
                                       *literal_needle(needle, ctx.device))
        return ctx.canonical(match, validity, T.BooleanType())

    def __repr__(self):
        return f"Like({self.children[0]!r}, {self.pattern!r})"


class _CaseMap(Expression):
    upper = True

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        return T.StringType()

    def _eval(self, vals, ctx):
        a = vals[0]
        # a column holds zeros at its null rows, and the map keeps zeros
        data, lengths, validity = case_map(a.data, a.lengths, a.validity,
                                           self.upper)
        return Val(data, validity, lengths, T.StringType())


class Upper(_CaseMap):
    """upper(str): ASCII a-z to A-Z (the reference's device branch)."""
    sql_name = "Upper"
    upper = True


class Lower(_CaseMap):
    """lower(str): ASCII A-Z to a-z (the reference's device branch)."""
    sql_name = "Lower"
    upper = False


def _piece(child: Expression, inputs, ctx):
    """(data, lengths, validity) of one concat piece: one row for a
    string or null literal (not broadcast), else the evaluated column."""
    if isinstance(child, Literal):
        if child.value is None:
            d, ln, v = literal_needle("", ctx.device)
            return d, ln, ~v
        return literal_needle(str(child.value), ctx.device)
    v = child.eval(inputs, ctx)
    return v.data, v.lengths, v.validity


def _concat_val(pieces, sep, ctx) -> Val:
    data, lengths, validity = concat(pieces, sep)
    if data.shape[0] != ctx.capacity:  # literal pieces only: one row
        data = data.expand(ctx.capacity, -1).contiguous()
        lengths = lengths.expand(ctx.capacity).contiguous()
        validity = validity.expand(ctx.capacity).contiguous()
    return Val(data, validity, lengths, T.StringType())


class Concat(Expression):
    """concat(s1, s2, ...): null if any input is null (Spark concat)."""
    sql_name = "Concat"

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def with_new_children(self, children):
        return Concat(*children)

    @property
    def dtype(self):
        return T.StringType()

    def eval(self, inputs, ctx):
        return _concat_val([_piece(c, inputs, ctx) for c in self.children],
                           None, ctx)


class ConcatWs(Expression):
    """concat_ws(sep, s1, s2, ...): null inputs are skipped (no
    separator); the result is never null (``sep`` is a python str)."""
    sql_name = "ConcatWs"

    def __init__(self, separator: str, *children: Expression):
        self.children = tuple(children)
        self.separator = separator

    def with_new_children(self, children):
        return ConcatWs(self.separator, *children)

    @property
    def dtype(self):
        return T.StringType()

    @property
    def nullable(self):
        return False

    def eval(self, inputs, ctx):
        return _concat_val([_piece(c, inputs, ctx) for c in self.children],
                           self.separator, ctx)

    def __repr__(self):
        return (f"ConcatWs({self.separator!r}, "
                f"{', '.join(map(repr, self.children))})")


class Hex(Expression):
    """hex(n): upper-case hex of a long, leading zeros dropped, a negative
    value as its 16-digit two's complement (Spark Hex); an integral input
    is cast to long first, so ``hex(hash(x))`` of a negative int32 hash
    has 16 digits, ``FFFFFFFF`` first."""
    sql_name = "Hex"

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        return T.StringType()

    def coerced(self):
        from spark_rapids_tpu_torch.expr.cast import Cast
        t = self.children[0].dtype
        if t.integral and not isinstance(t, T.LongType):
            return Hex(Cast(self.children[0], T.LongType()))
        if not isinstance(t, T.LongType):
            raise TypeError(f"hex over {t} is not supported")
        return self

    def _eval(self, vals, ctx):
        a = vals[0]
        # a column holds zeros at its null rows; the kernel zeroes them too
        data, lengths, validity = hex_string(a.data, a.validity)
        return Val(data, validity, lengths, T.StringType())
