"""Math expressions: Round (port of ``spark_rapids_tpu/expr/math_ops.py:203``).

Elementwise torch glue, not a hand kernel.  ``Round`` follows the
reference's device formula, not Spark's BigDecimal HALF_UP: a double is
``sign(x) * floor(|x| * 10^s + 0.5) / 10^s`` (so ``round(5.393, 4)`` comes
out as ``5.393000000000001``), with NaN, +-inf and every value at or
beyond 2^53 (2^24 for a float) passed through unchanged; an integer is
unchanged for ``s >= 0`` and rounded half away from zero to a multiple of
``10^-s`` otherwise.  Each step is a separate, separately rounded torch
operation.  The division by ``10^s`` is a multiplication by the float64
reciprocal ``1 / 10^s``: XLA folds the reference's division by a constant
into that, so its answers are that product's (``53930 * 0.0001``).
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import EvalCtx, Expression, Literal

__all__ = ["Round"]


class Round(Expression):
    """round(x, scale) with a literal integer scale."""
    sql_name = "Round"

    def __init__(self, child: Expression, scale: Expression | int = 0):
        if not isinstance(scale, Expression):
            scale = Literal(int(scale), T.IntegerType())
        self.children = (child, scale)

    @property
    def scale(self) -> int:
        s = self.children[1]
        if not isinstance(s, Literal) or s.value is None:
            raise TypeError("round's scale must be a non-null literal")
        return int(s.value)

    @property
    def dtype(self):
        return self.children[0].dtype

    def _eval(self, vals, ctx: EvalCtx):
        a = vals[0]
        x = a.data
        s = self.scale
        if a.dtype.integral:
            if s >= 0:
                return a
            p = 10 ** (-s)
            sign = torch.where(x < 0, -1, 1).to(x.dtype)
            mag = torch.abs(x)
            data = (torch.div(mag + p // 2, p, rounding_mode="floor") * p
                    * sign).to(x.dtype)
            return ctx.canonical(data, a.validity, a.dtype)
        if not a.dtype.fractional:
            raise TypeError(f"round over {a.dtype}")
        p = 10.0 ** s
        exact = 2.0 ** 53 if x.dtype == torch.float64 else 2.0 ** 24
        # in float64 for a float too, as the reference's float64 scale
        # promotes it
        mag = torch.abs(x).to(torch.float64)
        beyond = mag >= exact
        safe = torch.where(beyond, torch.zeros((), dtype=torch.float64,
                                               device=x.device), mag)
        r = torch.floor(safe * p + 0.5) * (1.0 / p)
        data = torch.where(x < 0, -r, r).to(x.dtype)
        keep = torch.isnan(x) | torch.isinf(x) | beyond
        return ctx.canonical(torch.where(keep, x, data), a.validity, a.dtype)
