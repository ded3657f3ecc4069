"""Wire codec: columns encoded on the host, decoded on the card (K8).

Port of ``spark_rapids_tpu/columnar/wirecodec.py``.  The host side is a
copy of the reference's encoder: for the same column it chooses the same
encoding and writes the same uint32 words, so either package decodes the
other's stream.  Two differences: the slot count (the reference pads
every batch to a power-of-two capacity and packs ``cap`` slots, the port
packs exactly ``n``, its batches are not padded; the decoded values are
the same and only the trailing zero words differ), and whole doubles
whose FOR base or top at a scale leaves int64 (|v/s| >= 2^63), where the
reference's encoder raises OverflowError and the port skips that scale.

Encodings (chosen per column per batch, host-side):

* ints / dates / timestamps / bools -- frame of reference plus bit
  packing: ``ceil(n*b/32)`` uint32 words where ``b`` is the bucketed
  bit length of ``max - min``; decode ``(bits + min) * div``, with an
  integral divisor (10^6 or 10^3) for aligned timestamps;
* float64 -- when every value is exactly a scaled integer (money in
  cents: ``rint(v/s)*s == v`` for s in {0.01, 1}), the FOR/bit-packed
  integers, decoded ``(bits + base) * s``; NaN, +-inf and -0.0 ship raw;
* strings -- pyarrow dictionary encoding when it pays: the dictionary
  byte matrix plus bit-packed indices;
* validity -- all-valid columns ship nothing, others 1 bit a row.

Device side (kernel family K8, ``csrc/wirecodec.cu``):

* :func:`decode_fixed` (K8a) unpacks one bit-packed stream into a column
  of the port's dtype and its validity, null slots zero; it also decodes
  a validity stream alone and the bit-packed lengths of a string column;
* :func:`decode_dict` (K8b) unpacks a dictionary string column's indices
  and copies each row's dictionary bytes and length.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
PyTorch version (``*_plain``, any device) for a CPU tensor.  The plain
versions compute in int64: PyTorch on the CPU has no shifts on uint32.
"""
from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.ops import native

__all__ = ["bits_needed", "pack_bits_host", "encode_fixed", "encode_lengths",
           "maybe_dict_arrow", "decode_fixed", "decode_fixed_plain",
           "decode_dict", "decode_dict_plain", "packed_words"]

_FAST_BITS = {8: np.uint8, 16: np.uint16, 32: np.uint32}

#: integral divisors probed for int64 columns (timestamp micros that are
#: second- or milli-aligned shrink below the 32-bit FOR window)
_INT_DIVISORS = (1_000_000, 1_000)
#: scales probed for float64 columns (money = cents first, then whole)
_FLOAT_SCALES = (0.01, 1.0)
#: bucketed bit widths: the reference compiles one unpack program per
#: width, so it keeps the width count small; the port keeps the buckets
#: so that both packages write the same words
_BIT_BUCKETS = (1, 2, 4, 8, 12, 16, 20, 24, 28, 32)


def bits_needed(rng: int) -> int:
    """Bucketed bits to hold values in [0, rng]."""
    raw = max(1, int(rng).bit_length())
    for b in _BIT_BUCKETS:
        if raw <= b:
            return b
    return raw


def packed_words(n: int, bits: int) -> int:
    """uint32 words of an ``n``-slot stream of ``bits``-bit values."""
    return (n * bits + 31) // 32


def pack_bits_host(vals: np.ndarray, bits: int) -> np.ndarray:
    """Pack ``vals`` (non-negative, < 2**bits, any int dtype) into a
    little-endian bit stream of ``len(vals)`` slots, returned as uint32
    words: value i occupies bits [i*bits, i*bits + bits).

    The reference's words (its ``pack_bits_host`` with ``cap`` equal to
    ``len(vals)``) for the bucketed widths only, which are all the encoder
    writes.  Where the reference runs its shift/or over blocks of
    lcm(bits, 32) bits, the port fills whole bytes: 1-bit values through
    ``np.packbits``, 2 or 4-bit values a byte at a time, a pair of
    12-28-bit values as bits/4 bytes; 1.8-29x faster per column at those
    widths on the card's host (``bench/host_stage.py``, PERF.md §6)."""
    if bits not in _BIT_BUCKETS:
        raise ValueError(f"{bits} is not a bucketed width {_BIT_BUCKETS}")
    n = vals.shape[0]
    nwords = packed_words(n, bits)
    if bits in _FAST_BITS:
        buf = np.zeros(nwords * (32 // bits), dtype=_FAST_BITS[bits])
        buf[:n] = vals
        return buf.view(np.uint32)
    if bits == 1:
        out = np.zeros(nwords * 4, np.uint8)
        by = np.packbits(vals.astype(np.bool_), bitorder="little")
        out[:by.size] = by
        return out.view(np.uint32)
    if bits < 8:
        per = 8 // bits
        v = np.zeros(nwords * 4 * per, np.uint8)
        v[:n] = vals
        v = v.reshape(-1, per)
        acc = v[:, 0].copy()
        for j in range(1, per):
            acc |= v[:, j] << np.uint8(j * bits)
        return acc.view(np.uint32)
    # 12, 20, 24 or 28 bits: a pair of values is bits/4 whole bytes; build
    # the pairs in uint64 and keep each pair's low bytes
    npairs = (n + 1) // 2
    v = np.zeros(npairs * 2, np.uint64)
    v[:n] = vals
    pairs = v[0::2] | (v[1::2] << np.uint64(bits))
    by = pairs.view(np.uint8).reshape(npairs, 8)[:, :bits // 4]
    by = by.reshape(-1)[:nwords * 4]
    out = np.zeros(nwords * 4, np.uint8)
    out[:by.size] = by
    return out.view(np.uint32)


# ---------------------------------------------------------------------------
# host-side encoding decisions (reference wirecodec.py:132-252)
# ---------------------------------------------------------------------------

def _valid_minmax(data: np.ndarray, validity: np.ndarray | None):
    """(vmin, vmax) over valid slots; None when no valid values."""
    if validity is not None and not validity.all():
        if not validity.any():
            return None
        data = data[validity]
    if data.size == 0:
        return None
    return data.min(), data.max()


def encode_fixed(data: np.ndarray, validity: np.ndarray | None, add_leaf,
                 add_i64):
    """Encode one fixed-width column's data leaf of ``len(data)`` slots.

    ``data`` is the host array with null slots already zeroed.
    ``add_leaf(arr)`` registers a host buffer and returns its leaf index;
    ``add_i64(v)`` registers an int64 decode parameter (the FOR base) and
    returns its index.  Returns the reference's descriptor:
    ``("raw", leaf)``, or ``(kind, leaf, bits, out_dtype, base_param,
    factor)`` with kind ``"bits"`` (factor: an integral divisor) or
    ``"fbits"`` (factor: a float scale)."""
    dt = data.dtype
    out_dtype = dt.str

    def raw():
        return ("raw", add_leaf(data))

    if dt.kind == "b":
        return ("bits", add_leaf(pack_bits_host(data.astype(np.uint8), 1)),
                1, out_dtype, add_i64(0), 1)
    if dt.kind in "iu":
        mm = _valid_minmax(data.astype(np.int64, copy=False), validity)
        if mm is None:
            return ("bits", add_leaf(pack_bits_host(
                np.zeros(data.shape[0], np.uint32), 1)), 1, out_dtype,
                add_i64(0), 1)
        vmin, vmax = int(mm[0]), int(mm[1])
        div = 1
        if dt.itemsize == 8 and vmax - vmin >= (1 << 32):
            for d in _INT_DIVISORS:
                q, r = np.divmod(data.astype(np.int64, copy=False), d)
                if not r.any() and (vmax - vmin) // d < (1 << 32):
                    data, vmin, vmax, div = q, vmin // d, vmax // d, d
                    break
            else:
                return raw()
        rng = vmax - vmin
        if rng >= (1 << 32):
            return raw()
        bits = bits_needed(rng)
        if bits >= dt.itemsize * 8 and div == 1:
            return raw()
        enc = (data.astype(np.int64, copy=False) - vmin).astype(np.uint32)
        if validity is not None and not validity.all():
            enc = np.where(validity, enc, 0)
        return ("bits", add_leaf(pack_bits_host(enc, bits)), bits,
                out_dtype, add_i64(vmin), div)
    if dt.kind == "f" and dt.itemsize == 8:
        v = data
        # -0.0 would come back as +0.0 through the integer path
        zeros = v == 0
        if zeros.any() and np.signbit(v[zeros]).any():
            return raw()
        for scale in _FLOAT_SCALES:
            with np.errstate(invalid="ignore", over="ignore"):
                ints = np.rint(v / scale)
            if not np.isfinite(ints).all():
                break  # NaN/inf present: ship raw
            if not (ints * scale == v).all():
                continue  # not exactly representable at this scale
            mm = _valid_minmax(ints, validity)
            vmin = 0 if mm is None else int(mm[0])
            vmax = 0 if mm is None else int(mm[1])
            if vmin < -(1 << 63) or vmax >= (1 << 63):
                # beyond int64 (|v| >= 2^63 at this scale): the
                # reference's int64 cast below overflows here and raises;
                # the port ships the column raw instead
                continue
            rng = vmax - vmin
            if rng >= (1 << 32):
                continue
            bits = bits_needed(rng)
            if bits > 32:
                continue
            enc = (ints.astype(np.int64) - vmin).astype(np.uint32)
            if validity is not None and not validity.all():
                enc = np.where(validity, enc, 0)
            return ("fbits", add_leaf(pack_bits_host(enc, bits)), bits,
                    out_dtype, add_i64(vmin), scale)
        return raw()
    return raw()


def encode_lengths(lengths: np.ndarray, max_len: int, add_leaf, add_i64):
    """String lengths lie in [0, max_len]: always bit-packable."""
    bits = bits_needed(max(int(max_len), 1))
    return ("bits", add_leaf(pack_bits_host(lengths.astype(np.uint32), bits)),
            bits, "<i4", add_i64(0), 1)


def maybe_dict_arrow(arr, n: int):
    """pyarrow dictionary encoding of a string array: (int32[n] indices
    with nulls -> 0, dictionary pa.Array) when the dictionary is small
    (at most max(256, n/8) entries), else None."""
    if n < 4096:
        return None
    import pyarrow as pa
    try:
        enc = arr.dictionary_encode()
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        return None  # not encodable: the column ships raw
    k = len(enc.dictionary)
    if k == 0 or k > max(256, n // 8):
        return None
    idx = enc.indices
    vals = np.frombuffer(idx.buffers()[1], np.int32, count=len(idx),
                         offset=idx.offset * 4)
    if idx.null_count:
        bitmap = np.frombuffer(idx.buffers()[0], np.uint8,
                               count=(idx.offset + len(idx) + 7) // 8)
        valid = np.unpackbits(bitmap, bitorder="little")[
            idx.offset:idx.offset + len(idx)].astype(np.bool_)
        return np.where(valid, vals, 0).astype(np.int32), enc.dictionary
    return vals.copy(), enc.dictionary


# ---------------------------------------------------------------------------
# device-side decode (K8)
# ---------------------------------------------------------------------------

#: C entry point kinds of csrc/wirecodec.cu srt_decode_fixed
_VALID_ONLY, _INT, _BOOL, _SCALED = 0, 1, 2, 3


def _ptr(t: torch.Tensor | None) -> int | None:
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("K8 operands must be contiguous")
    return t.data_ptr()


def _check_stream(t: torch.Tensor | None, n: int, bits: int, what: str):
    if t is None:
        return
    if t.dtype != torch.int32 or t.dim() != 1:
        raise ValueError(f"{what}: packed words must be int32 [m] (uint32 "
                         f"bits), got {t.dtype}{tuple(t.shape)}")
    if t.numel() < packed_words(n, bits):
        raise ValueError(f"{what}: {t.numel()} words hold fewer than {n} "
                         f"{bits}-bit values")


def _check_base(base: torch.Tensor | None, like: torch.Tensor):
    if base is None:
        return
    if base.dtype != torch.int64 or base.numel() != 1 or \
            base.device != like.device:
        raise ValueError("the FOR base must be one int64 on the words' "
                         "device")


def _unpack_plain(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """int64 [n] of the ``bits``-bit values of a packed word stream."""
    dev = words.device
    w = words.to(torch.int64) & 0xFFFFFFFF
    o = torch.arange(n, dtype=torch.int64, device=dev) * bits
    wi = o >> 5
    sh = o & 31
    lo = w[wi] >> sh
    # the next word's low bits; with sh == 0 they land above bit 31 and
    # the mask drops them
    hi = w[torch.clamp(wi + 1, max=w.numel() - 1)] << (32 - sh)
    return (lo | hi) & ((1 << bits) - 1)


def _validity_plain(vwords: torch.Tensor | None, n: int, dev) -> torch.Tensor:
    if vwords is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    return _unpack_plain(vwords, n, 1) != 0


def decode_fixed(words: torch.Tensor | None, vwords: torch.Tensor | None,
                 n: int, bits: int = 0, base: torch.Tensor | None = None,
                 factor=1, out_dtype: torch.dtype | None = None):
    """K8a: one fixed-width column of ``n`` rows from its packed streams.

    ``words``: int32 [>= ceil(n*bits/32)], the uint32 stream of ``bits``-bit
    values (None: decode the validity alone); ``vwords``: the 1-bit
    validity stream (None: every row valid); ``base``: the int64 FOR
    base, one element (None: 0); ``factor``: an int divisor (value
    ``(bits + base) * factor`` in int64, then cast to ``out_dtype``) or a
    float scale (``out_dtype`` float64: ``(double(bits) + double(base)) *
    factor``, each step rounded); a bool ``out_dtype`` is ``bits != 0``.
    Returns (data [n] or None, bool validity [n]); null slots are zero.

    Replaces the reference's ``_unpack_bits_device`` (wirecodec.py:104),
    ``decode_data`` (:269), ``decode_validity`` (:259) and the zeroing of
    null slots in ``_packed_unpack_cached`` (batch.py:250-262)."""
    like = words if words is not None else vwords
    if like is None:
        raise ValueError("decode_fixed: nothing to decode (no data and "
                         "an all-valid column)")
    if words is not None and not 1 <= bits <= 32:
        raise ValueError(f"decode_fixed: {bits}-bit values")
    if words is not None and out_dtype is None:
        raise ValueError("decode_fixed: out_dtype is required with data")
    if isinstance(factor, float) and out_dtype != torch.float64:
        raise ValueError("decode_fixed: a float scale decodes to float64")
    _check_stream(words, n, bits, "decode_fixed")
    _check_stream(vwords, n, 1, "decode_fixed validity")
    _check_base(base, like)
    if like.device.type == "cpu":
        return decode_fixed_plain(words, vwords, n, bits, base, factor,
                                  out_dtype)
    return _decode_fixed_cuda(words, vwords, n, bits, base, factor,
                              out_dtype)


decode_fixed.launches = 0


def decode_fixed_plain(words, vwords, n: int, bits: int = 0, base=None,
                       factor=1, out_dtype=None):
    """Plain PyTorch version of :func:`decode_fixed` (any device)."""
    dev = (words if words is not None else vwords).device
    valid = _validity_plain(vwords, n, dev)
    if words is None:
        return None, valid
    raw = _unpack_plain(words, n, bits)
    b = torch.zeros((), dtype=torch.int64, device=dev) if base is None \
        else base.reshape(())
    if isinstance(factor, float):
        data = (raw.to(torch.float64) + b.to(torch.float64)) * factor
    elif out_dtype == torch.bool:
        data = raw != 0
    else:
        data = ((raw + b) * int(factor)).to(out_dtype)
    return torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                                  device=dev)), valid


_INT_BYTES = {torch.int8: 1, torch.int16: 2, torch.int32: 4, torch.int64: 8}


def _decode_fixed_cuda(words, vwords, n, bits, base, factor, out_dtype):
    dev = (words if words is not None else vwords).device
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    data = None if words is None else torch.empty(n, dtype=out_dtype,
                                                  device=dev)
    if n == 0:
        return data, valid
    if words is None:
        kind, nbytes = _VALID_ONLY, 1
    elif isinstance(factor, float):
        kind, nbytes = _SCALED, 8
    elif out_dtype == torch.bool:
        kind, nbytes = _BOOL, 1
    elif out_dtype in _INT_BYTES:
        kind, nbytes = _INT, _INT_BYTES[out_dtype]
    else:
        raise ValueError(f"decode_fixed: no K8a output of type {out_dtype}")
    native.check(native.lib("wirecodec").srt_decode_fixed(
        _ptr(words), bits, _ptr(base),
        int(factor) if kind == _INT else 1,
        float(factor) if kind == _SCALED else 1.0, kind, nbytes,
        _ptr(vwords), _ptr(data), _ptr(valid), n, native.stream_ptr(dev)),
        "srt_decode_fixed")
    decode_fixed.launches += 1
    return data, valid


def decode_dict(words: torch.Tensor, vwords: torch.Tensor | None, n: int,
                bits: int, base: torch.Tensor | None,
                dict_data: torch.Tensor, dict_lengths: torch.Tensor):
    """K8b: a dictionary string column of ``n`` rows.

    ``words``: the ``bits``-bit packed indices, FOR ``base`` (one int64;
    None: 0); ``vwords``: the 1-bit validity stream (None: all valid);
    ``dict_data``: uint8 [k, W] dictionary rows, W a power of two >= 4;
    ``dict_lengths``: int32 [k].  Returns (uint8 [n, W], int32 lengths
    [n], bool validity [n]); a null row has zero bytes and length 0.

    Replaces the ``"dict"`` branch of the reference's
    ``_packed_unpack_cached`` (batch.py:263-269)."""
    if not 1 <= bits <= 32:
        raise ValueError(f"decode_dict: {bits}-bit indices")
    if dict_data.dtype != torch.uint8 or dict_data.dim() != 2:
        raise ValueError("decode_dict: the dictionary must be uint8 [k, W]")
    w = dict_data.shape[1]
    if w < 4 or w & (w - 1):
        raise ValueError(f"decode_dict: width {w} is not a power of two "
                         ">= 4")
    if dict_lengths.dtype != torch.int32 or \
            dict_lengths.shape != dict_data.shape[:1]:
        raise ValueError("decode_dict: dictionary lengths must be int32 [k]")
    _check_stream(words, n, bits, "decode_dict")
    _check_stream(vwords, n, 1, "decode_dict validity")
    _check_base(base, words)
    if words.device.type == "cpu":
        return decode_dict_plain(words, vwords, n, bits, base, dict_data,
                                 dict_lengths)
    return _decode_dict_cuda(words, vwords, n, bits, base, dict_data,
                             dict_lengths)


decode_dict.launches = 0


def decode_dict_plain(words, vwords, n: int, bits: int, base, dict_data,
                      dict_lengths):
    """Plain PyTorch version of :func:`decode_dict` (any device)."""
    dev = words.device
    valid = _validity_plain(vwords, n, dev)
    idx = _unpack_plain(words, n, bits)
    if base is not None:
        idx = idx + base.reshape(())
    idx = torch.where(valid, idx, torch.zeros((), dtype=torch.int64,
                                              device=dev))
    data = torch.where(valid[:, None], dict_data[idx],
                       torch.zeros((), dtype=torch.uint8, device=dev))
    lengths = torch.where(valid, dict_lengths[idx],
                          torch.zeros((), dtype=torch.int32, device=dev))
    return data, lengths, valid


def _decode_dict_cuda(words, vwords, n, bits, base, dict_data, dict_lengths):
    dev = words.device
    w = dict_data.shape[1]
    data = torch.empty((n, w), dtype=torch.uint8, device=dev)
    lengths = torch.empty(n, dtype=torch.int32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return data, lengths, valid
    if dict_data.data_ptr() % 16:
        raise ValueError("decode_dict: the dictionary must be 16-byte "
                         "aligned")
    native.check(native.lib("wirecodec").srt_decode_dict(
        _ptr(words), bits, _ptr(base), _ptr(vwords), _ptr(dict_data),
        _ptr(dict_lengths), w, _ptr(data), _ptr(lengths), _ptr(valid), n,
        native.stream_ptr(dev)), "srt_decode_dict")
    decode_dict.launches += 1
    return data, lengths, valid
