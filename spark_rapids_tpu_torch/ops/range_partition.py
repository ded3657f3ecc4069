"""Range-partition ids (K11) and round-robin ids.

Port of ``spark_rapids_tpu/exec/partitioning.py``'s device paths:
``RangePartitioning.device_ids`` :258-268 over ``_rank_operands`` :157 and
``_combined_rank_ids`` :170, and ``RoundRobinPartitioning.device_ids``
:131-134.

The reference ranks a batch's rows together with the P - 1 bound rows in
one stable multi-operand sort, takes dense ranks (equal keys, one rank)
and counts, for each row, the bound ranks strictly below its own
(``searchsorted(..., side="left")``).  That is the number of bounds whose
sort key is strictly less than the row's, where equal means the same key:
null == null, NaN == NaN (the largest value), -0.0 == 0.0.

* K11, ``csrc/range_partition.cu``: one launch per batch.  The kernel
  reads each row's key columns in place through their descriptors
  (:func:`key_descriptors`: pointers, kind, item size, packed width,
  direction, null order) and binary-searches the bounds, whose fields
  (K1's order, ``csrc/sort_key.cuh``) are encoded once per layout
  (:meth:`RangeBounds.at`; string keys at the wider of the row and
  bound widths, so that a batch narrower than the bounds compares with
  them).  No sort, no packed intermediate and no host sync per batch.
* :func:`range_partition_ids_plain` keeps the reference's method: a
  combined stable sort, dense ranks from key changes, ``searchsorted``.
* :func:`round_robin_ids` is elementwise index arithmetic (the reference's
  is an XLA iota), not a hand kernel.

The wrapper takes its plain version only for CPU tensors; on a CUDA tensor
it launches its kernel or raises, and counts each launch in
``range_partition_ids.launches``.
"""
from __future__ import annotations

from array import array

import torch

from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import ptr
from spark_rapids_tpu_torch.ops.segmented import _cols_differ
from spark_rapids_tpu_torch.ops.sort import (SortOrder, chain_sort,
                                             encode_key_operands, key_layout,
                                             packed_width)

__all__ = ["RangeBounds", "range_partition_ids", "range_partition_ids_plain",
           "round_robin_ids", "key_descriptors", "key_field_count"]

#: int64 words of one key descriptor (csrc/sort_key.cuh ``SortKey``)
KEY_WORDS = 8
#: most keys whose descriptors travel in the kernel's parameters
#: (csrc/range_partition.cu ``kParamKeys``); more are read from a device copy
PARAM_KEYS = 32
#: leading words of a bound's row: its top key folded
#: (csrc/range_partition.cu ``kTopWords``)
TOP_WORDS = 2
#: shared memory a block may stage the descriptors and bounds into
#: (csrc/range_partition.cu ``kSharedBytes``); larger bounds stay global
SHARED_BYTES = 48 * 1024
# the kernel library must report the same constants when it is loaded
native.share_limits("range_partition",
                    (KEY_WORDS, PARAM_KEYS, TOP_WORDS, SHARED_BYTES))
_KIND_STRING = 3
_KIND_FLOAT = 1


def key_field_count(kind: int, width: int) -> int:
    """Fields of one key in K1's order (csrc/sort_key.cuh
    ``key_nfields``): the null indicator, then one value field (two for a
    float: the NaN flag and the value; a string: a word per 4 bytes of
    the packed width and the length)."""
    if kind == _KIND_STRING:
        return 2 + width // 4
    return 3 if kind == _KIND_FLOAT else 2


def _key_static(col: DeviceColumn, order: SortOrder,
                width: int | None) -> tuple:
    """(kind, item or None for a string, packed width, asc, nulls_first)
    of a key column at the layout ``width``."""
    kind, item, _bits = key_layout(col, width)
    asc, nf = int(order.ascending), int(order.resolved_nulls_first)
    if kind == _KIND_STRING:
        return kind, None, item, asc, nf
    return kind, item, 0, asc, nf


def key_descriptors(cols: list[DeviceColumn], statics: list) -> list[int]:
    """K11's descriptor words of ``cols`` (:data:`KEY_WORDS` a key, the
    layout of csrc/sort_key.cuh ``SortKey``): data, validity and lengths
    addresses, kind, item (a string's matrix width), packed width, asc,
    nulls_first; ``statics`` from :meth:`RangeBounds.at`.  Raises unless
    every key has the first's rows, on its device, contiguous, of the
    item size the layout names."""
    words = []
    n = cols[0].data.shape[0]
    gdev = cols[0].data.get_device()
    for c, (kind, item, width, asc, nf) in zip(cols, statics):
        d, v = c.data, c.validity
        if d.shape[0] != n or v.shape[0] != n or d.get_device() != gdev \
                or not d.is_contiguous() or not v.is_contiguous():
            raise ValueError(f"range partition key of {d.shape[0]} rows "
                             f"on {d.device}: {n} contiguous rows on "
                             f"{cols[0].data.device} expected")
        if item is None:
            ln = c.lengths
            if ln.dtype is not torch.int32 or not ln.is_contiguous():
                raise ValueError("string key lengths must be contiguous "
                                 "int32")
            words += (d.data_ptr(), v.data_ptr(), ln.data_ptr(), kind,
                      d.shape[1], width, asc, nf)
        else:
            if d.element_size() != item:
                raise ValueError(f"key of {d.dtype}: {item}-byte items "
                                 "expected")
            words += (d.data_ptr(), v.data_ptr(), 0, kind, item, width, asc,
                      nf)
    return words


class RangeBounds:
    """The bound rows of a range partitioning: one column per sort key,
    in key order, ascending under ``orders`` (``orders[i]`` orders
    ``cols[i]``).  Their K1 fields are kept per layout, so they are
    encoded once, not per batch."""

    def __init__(self, cols: list[DeviceColumn], orders: list[SortOrder]):
        self.cols = list(cols)
        self.orders = list(orders)
        self._strings = [c.is_string for c in self.cols]
        self._layouts: dict[tuple, tuple] = {}

    @property
    def count(self) -> int:
        return self.cols[0].capacity

    def widths(self, keys: list[DeviceColumn]) -> tuple:
        """The layout of ``keys`` against the bounds: each string key's
        packed width, the wider of the rows' and the bounds'."""
        if not any(self._strings):
            return (None,) * len(self.cols)
        return tuple(max(packed_width(k), packed_width(b)) if s else None
                     for k, b, s in zip(keys, self.cols, self._strings))

    def at(self, widths: tuple) -> tuple:
        """``(statics, nfields, fields)`` at the layout ``widths``: each
        key's static descriptor part (kind, item or None for a string,
        packed width, asc, nulls_first), the keys' summed field count, and
        int64 ``[count, TOP_WORDS + nfields]``, each bound's top key folded
        into one 128-bit value, then its K1 fields, most significant
        first, encoded by ``srt_range_bound_fields`` on the bounds' CUDA
        device the first time a layout is asked for."""
        got = self._layouts.get(widths)
        if got is None:
            statics = [_key_static(c, o, w) for c, o, w in
                       zip(self.cols, self.orders, widths)]
            nfields = sum(key_field_count(k, w)
                          for k, _i, w, _a, _n in statics)
            lib = native.lib("range_partition")
            dev = self.cols[0].device
            fields = torch.empty((self.count, TOP_WORDS + nfields),
                                 dtype=torch.int64, device=dev)
            if self.count:
                host, keys_dev = _descriptor_table(
                    key_descriptors(self.cols, statics), len(self.cols),
                    dev)
                native.check(lib.srt_range_bound_fields(
                    host.buffer_info()[0], ptr(keys_dev), len(self.cols),
                    nfields, self.count, ptr(fields),
                    native.stream_ptr(dev)), "srt_range_bound_fields")
            got = (statics, nfields, fields)
            self._layouts[widths] = got
        return got


def _descriptor_table(words: list[int], nkeys: int, dev):
    """The descriptor words as a host array for the kernel's parameters,
    and their device copy where there are more than :data:`PARAM_KEYS`
    keys (else None)."""
    host = array("q", words)
    keys_dev = None
    if nkeys > PARAM_KEYS:
        keys_dev = torch.tensor(words, dtype=torch.int64).to(dev)
    return host, keys_dev


def range_partition_ids(keys: list[DeviceColumn],
                        bounds: RangeBounds) -> torch.Tensor:
    """int32 partition id of each row: the number of bounds whose key
    (``keys`` under ``bounds.orders``) is strictly below the row's."""
    if keys[0].device.type == "cpu":
        return range_partition_ids_plain(keys, bounds)
    return _range_partition_cuda(keys, bounds)


range_partition_ids.launches = 0


def _range_partition_cuda(keys: list[DeviceColumn],
                          bounds: RangeBounds) -> torch.Tensor:
    lib = native.lib("range_partition")
    if len(keys) != len(bounds.cols):
        raise ValueError(f"{len(keys)} keys against {len(bounds.cols)} "
                         "bound columns")
    dev = keys[0].data.device
    n = keys[0].data.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    statics, nfields, fields = bounds.at(bounds.widths(keys))
    if fields.get_device() != keys[0].data.get_device():
        raise ValueError(f"bounds on {fields.device}, keys on {dev}")
    host, keys_dev = _descriptor_table(key_descriptors(keys, statics),
                                       len(keys), dev)
    native.check(lib.srt_range_partition(
        host.buffer_info()[0], ptr(keys_dev), len(keys), nfields,
        fields.data_ptr(), bounds.count, n, out.data_ptr(),
        native.stream_ptr(dev)), "srt_range_partition")
    range_partition_ids.launches += 1
    return out


def _stack(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    """Rows of ``a`` then ``b``; string matrices padded to the wider."""
    validity = torch.cat([a.validity, b.validity])
    if not a.is_string:
        return DeviceColumn(torch.cat([a.data, b.data]), validity, a.dtype)
    w = max(a.max_len, b.max_len)
    pad = torch.nn.functional.pad
    return DeviceColumn(torch.cat([pad(a.data, (0, w - a.max_len)),
                                   pad(b.data, (0, w - b.max_len))]),
                        validity, a.dtype,
                        torch.cat([a.lengths, b.lengths]))


def range_partition_ids_plain(keys: list[DeviceColumn],
                              bounds: RangeBounds) -> torch.Tensor:
    """Plain PyTorch version of :func:`range_partition_ids` (any device),
    by the reference's method: dense ranks of rows and bounds from one
    stable sort, then the bound ranks below each row's."""
    n = keys[0].capacity
    nb = bounds.count
    dev = keys[0].device
    comb = [_stack(k, b) for k, b in zip(keys, bounds.cols)]
    operands = []
    for o, c in zip(bounds.orders, comb):
        nf = o.resolved_nulls_first
        operands.append((c.validity if nf else ~c.validity).to(torch.int64))
        operands.extend(encode_key_operands(c, o.ascending))
    order = chain_sort(operands, n + nb, dev)
    differ = torch.zeros(n + nb, dtype=torch.bool, device=dev)
    for c in comb:
        sc = DeviceColumn(c.data[order], c.validity[order], c.dtype,
                          None if c.lengths is None else c.lengths[order])
        differ |= _cols_differ(sc)
    differ[:1] = False
    ranks = torch.empty(n + nb, dtype=torch.int64, device=dev)
    ranks[order] = torch.cumsum(differ.to(torch.int64), 0)
    bound_ranks = torch.sort(ranks[n:]).values
    return torch.searchsorted(bound_ranks, ranks[:n],
                              side="left").to(torch.int32)


def round_robin_ids(num_rows: int, offset: int, num_partitions: int,
                    device) -> torch.Tensor:
    """int32 ``(offset + i) % num_partitions`` for the batch's rows ``i``;
    ``offset`` is the batch's first row in the whole map side."""
    return ((torch.arange(num_rows, dtype=torch.int64, device=device)
             + offset) % num_partitions).to(torch.int32)
