"""Device column: the PyTorch counterpart of ``spark_rapids_tpu/columnar/column.py``.

The column contract is the reference package's (``column.py:44``):

* fixed-width types: ``data`` -- tensor ``[num_rows]`` of the type's torch
  dtype, ``validity`` -- bool ``[num_rows]``;
* strings: ``data`` -- uint8 ``[num_rows, W]`` padded UTF-8 bytes with W
  from :func:`round_string_width`, ``lengths`` -- int32 ``[num_rows]``;
* arrays (reference ``column.py:82-93``): ``data`` -- the element matrix
  ``[num_rows, W]`` in the element's torch dtype (bool as 1-byte bool),
  W from :func:`round_string_width` of the longest array, ``lengths`` --
  int32 ``[num_rows]`` element counts.  Elements are never null.

Null rows carry zeroed data and zero length (no elements), so kernels
may run unmasked and the same inputs reach both packages' functions bit
for bit.

Unlike the reference there is no capacity padding: tensors are exactly
``num_rows`` long (XLA needed static shapes; PyTorch and CUDA do not).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

__all__ = ["DeviceColumn", "round_string_width", "torch_dtype"]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.uint8): torch.uint8,
}


def torch_dtype(dt: T.DataType) -> torch.dtype:
    """Torch dtype of a type's physical device representation (the
    element dtype of the byte matrix for strings)."""
    if isinstance(dt, T.StringType):
        return torch.uint8
    if dt.np_dtype is None:
        raise TypeError(f"{dt} has no device representation")
    return _TORCH_DTYPES[np.dtype(dt.np_dtype)]


def round_string_width(n: int) -> int:
    """Bucket a max string byte-length to a power of two (min 4)."""
    c = 4
    while c < n:
        c <<= 1
    return c


class DeviceColumn:
    """One column of a device batch.  Treated as immutable."""

    __slots__ = ("data", "validity", "lengths", "dtype")

    def __init__(self, data: torch.Tensor, validity: torch.Tensor,
                 dtype: T.DataType, lengths: Optional[torch.Tensor] = None):
        self.data = data
        self.validity = validity
        self.lengths = lengths
        self.dtype = dtype

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, T.StringType)

    @property
    def is_array(self) -> bool:
        return isinstance(self.dtype, T.ArrayType)

    @property
    def is_var_width(self) -> bool:
        """Matrix layout (strings, arrays): data[num_rows, W] +
        lengths."""
        return self.lengths is not None

    @property
    def max_len(self) -> int:
        if not self.is_var_width:
            raise TypeError("max_len of a fixed-width column")
        return self.data.shape[1]

    @property
    def row_bytes(self) -> int:
        """Bytes of one row of ``data``."""
        return self.data.element_size() * (
            self.data.shape[1] if self.data.dim() == 2 else 1)

    def nbytes(self) -> int:
        """Device bytes of every leaf."""
        total = self.data.numel() * self.data.element_size()
        total += self.validity.numel()
        if self.lengths is not None:
            total += self.lengths.numel() * 4
        return total
