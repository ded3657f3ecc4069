"""Spark-compatible Murmur3 (x86_32, seed 42) hash: the plain version of K9.

Port of ``spark_rapids_tpu/expr/hashing.py:37-257``, which implements
``org.apache.spark.sql.catalyst.expressions.Murmur3Hash`` bit for bit:

* int/date/bool/byte/short -> hashInt of the 32-bit value;
* long/timestamp -> hashLong; float -> hashInt(bits), double ->
  hashLong(bits), with -0.0 normalized to 0.0 and NaN canonical
  (``0x7FC00000`` / ``0x7FF8000000000000``);
* string -> hashUnsafeBytes over UTF-8: 4-byte little-endian blocks, then
  the remaining bytes one at a time as *signed* ints; ``fmix`` takes the
  byte length;
* null -> passes the running seed through unchanged;
* multiple columns chain: h = hash(col_i, h).

torch on the CPU has no uint32 ``<<``, ``>>`` or ``+``, so the running hash
is an int64 tensor holding the uint32 value, masked to 32 bits after every
step; :func:`_mul32` splits each 32 x 32-bit product so that no int64
product overflows.  A double's bits come from a direct int64 view of the
float64 tensor (the reference's arithmetic decomposition,
``_jax_double_bits``, works around a TPU without 64-bit bitcasts and has
no place here).

These functions are the plain PyTorch version of the hand-written kernel
``csrc/hash_partition.cu``; ``ops/partition.py`` launches the kernel for a
CUDA tensor and uses this version for a CPU tensor.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import EvalCtx, Expression, Val

__all__ = ["Murmur3Hash", "murmur3_val", "DEFAULT_SEED", "to_int32"]

DEFAULT_SEED = 42

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MX = 0xE6546B64


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for an int64 tensor ``a`` in [0, 2^32) and a
    32-bit constant, without an int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) & _M32) | (x >> (32 - n))


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (h1 * 5 + _MX) & _M32


def _fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of an integer tensor's low 32 bits."""
    return x.to(torch.int64) & _M32


def _hash_int(i32: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return _fmix(_mix_h1(seed, _mix_k1(_u32(i32))), 4)


def _hash_long(i64: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    i64 = i64.to(torch.int64)
    h1 = _mix_h1(seed, _mix_k1(i64 & _M32))
    h1 = _mix_h1(h1, _mix_k1((i64 >> 32) & _M32))
    return _fmix(h1, 8)


def _float_bits(f32: torch.Tensor) -> torch.Tensor:
    f32 = torch.where(f32 == 0, torch.zeros((), dtype=f32.dtype,
                                            device=f32.device), f32)
    bits = f32.contiguous().view(torch.int32)
    return torch.where(torch.isnan(f32), torch.tensor(
        0x7FC00000, dtype=torch.int32, device=f32.device), bits)


def _double_bits(f64: torch.Tensor) -> torch.Tensor:
    f64 = torch.where(f64 == 0, torch.zeros((), dtype=f64.dtype,
                                            device=f64.device), f64)
    bits = f64.contiguous().view(torch.int64)
    return torch.where(torch.isnan(f64), torch.tensor(
        0x7FF8000000000000, dtype=torch.int64, device=f64.device), bits)


def _hash_string(data: torch.Tensor, lengths: torch.Tensor,
                 seed: torch.Tensor) -> torch.Tensor:
    """Vectorized over the padded byte matrix (reference
    ``_hash_string_device``): fold each row's first len//4 blocks, then up
    to 3 tail bytes sign-extended."""
    n, w = data.shape
    lengths = lengths.to(torch.int64)
    nblocks_row = lengths // 4
    tail_len = lengths % 4
    d = data.to(torch.int64)
    h = seed
    for j in range(w // 4):
        b = (d[:, 4 * j] | (d[:, 4 * j + 1] << 8) | (d[:, 4 * j + 2] << 16)
             | (d[:, 4 * j + 3] << 24))
        h = torch.where(j < nblocks_row, _mix_h1(h, _mix_k1(b)), h)
    base = nblocks_row * 4
    for t in range(3):
        idx = torch.clamp(base + t, 0, max(w - 1, 0))
        byte = torch.gather(d, 1, idx[:, None])[:, 0] if w else \
            torch.zeros(n, dtype=torch.int64, device=data.device)
        signed = torch.where(byte < 128, byte, byte - 256) & _M32
        h = torch.where(t < tail_len, _mix_h1(h, _mix_k1(signed)), h)
    return _fmix(h, lengths & _M32)


def murmur3_val(v: Val, seed: torch.Tensor) -> torch.Tensor:
    """Hash one column into the running seed (int64 tensor holding uint32
    values); null rows keep their seed."""
    dt = v.dtype
    if isinstance(dt, T.StringType):
        h = _hash_string(v.data, v.lengths, seed)
    elif isinstance(dt, (T.LongType, T.TimestampType)):
        h = _hash_long(v.data, seed)
    elif isinstance(dt, T.DoubleType):
        h = _hash_long(_double_bits(v.data), seed)
    elif isinstance(dt, T.FloatType):
        h = _hash_int(_float_bits(v.data), seed)
    elif isinstance(dt, (T.ArrayType, T.MapType)):
        raise TypeError(f"murmur3 of a {dt} column is not supported")
    else:  # bool/byte/short/int/date: the 32-bit value
        h = _hash_int(v.data.to(torch.int32), seed)
    return torch.where(v.validity, h, seed)


def to_int32(h: torch.Tensor) -> torch.Tensor:
    """The int32 whose bits are the uint32 value held in ``h``."""
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


class Murmur3Hash(Expression):
    """hash(c1, c2, ...) -> IntegerType, seed 42 (never null).  On a CUDA
    batch it runs K9 (``ops/partition.py`` ``murmur3_columns``)."""
    sql_name = "Murmur3Hash"

    def __init__(self, *children: Expression, seed: int = DEFAULT_SEED):
        self.children = tuple(children)
        self.seed = seed

    def with_new_children(self, children):
        return Murmur3Hash(*children, seed=self.seed)

    @property
    def dtype(self):
        return T.IntegerType()

    @property
    def nullable(self):
        return False

    def _eval(self, vals, ctx: EvalCtx):
        from spark_rapids_tpu_torch.ops.partition import murmur3_columns
        h = murmur3_columns(vals, ctx.capacity, ctx.device, self.seed)
        return ctx.canonical(h, ctx.row_mask, T.IntegerType())
