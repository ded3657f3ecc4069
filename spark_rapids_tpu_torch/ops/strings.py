"""String kernels: Spark ``substring`` (K13a), literal matching (K13b),
concatenation (K13c), ASCII case mapping (K13d) and hex of a long (K13i).

Port of the device branches of ``spark_rapids_tpu/expr/strings.py``:
``_char_starts`` (:29) with ``Substring._device`` (:174), the byte
comparisons of ``StartsWith`` (:294), ``EndsWith`` (:310), ``Contains``
(:329) and the ``equals`` shape of ``Like`` (``predicates.py:58``
``_string_eq``), ``_concat2_device`` (:252) as ``Concat`` (:235) and
``ConcatWs`` (:484) fold it, and ``Upper._device`` (:63) and
``Lower._device`` (:76), and ``Hex`` (:756-803).  Strings are the column
contract's byte
matrices: uint8 ``[n, W]`` (W a power of two >= 4) with int32 lengths
and bool validity.

* K13a, ``csrc/string_substr.cu``: one thread per row of up to 32 bytes,
  a group of ``min(W / 4, 32)`` lanes per wider row, counts the row's
  character starts (a byte is a start when ``(b & 0xC0) != 0x80``),
  resolves ``pos`` and ``len`` as Spark's
  ``UTF8String.substringSQL`` does, in 64-bit arithmetic, finds the byte
  offsets of the first and the past-the-end character, and writes the
  bytes between them to the front of the output row with zeros after
  them (equality, ``In``, sort words and group keys compare whole padded
  rows).
* K13b, ``csrc/string_match.cu``: one thread per row matches a needle --
  one row broadcast to every row (a literal) or a column -- at the row's
  start (prefix), end (suffix), any offset (contains) or as the whole
  row (equals).  An empty needle matches every valid row but in equals
  mode, where it matches the empty string.
* K13c, ``csrc/string_concat.cu``: up to 8 pieces (columns, or one-row
  literals read by every row) laid end to end, in Concat mode (null where
  any piece is) or ConcatWs mode (null pieces skipped, a separator
  between two non-null pieces, never null).  The output width is
  ``round_string_width`` of the pieces' widths plus the separators', so
  no length is read back to the host.  One thread per output row of up
  to 32 bytes, a lane per 16-byte vector of a wider row; each lane
  builds whole output words from two funnel-shifted source words per
  piece.
* K13d, ``csrc/string_case.cu``: a flat pass of 16-byte vectors over the
  padded matrix mapping ``a-z`` to ``A-Z`` (or back), four bytes a word
  at a time; bytes >= 0x80 and the zero tail pass unchanged, and the
  lengths and validity are the input's (not copied).
* K13i, ``csrc/string_hex.cu``: one thread per int64 row writes its
  upper-case hex digits (two's complement, leading zeros dropped, "0"
  for 0) as one 16-byte W 16 row with zeros after the digits; null rows
  are zero with length 0.

The reference computes ``start + len`` in int32, so ``substring('hello',
2, 2147483647)`` wraps to ``''`` there (ROADMAP.md Queue 3); both
versions here give Spark's ``'ello'``.

Beside each kernel is its plain PyTorch version.  A wrapper takes it only
for a tensor on the CPU; on a CUDA tensor it launches its kernel or
raises.  Each wrapper counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.column import round_string_width
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.kernels import ptr

__all__ = ["substring", "substring_plain", "string_match",
           "string_match_plain", "literal_needle", "MATCH_MODES", "concat",
           "concat_plain", "concat_width", "case_map", "case_map_plain",
           "hex_string", "hex_string_plain", "MAX_PIECES"]

#: mode codes of csrc/string_match.cu
MATCH_MODES = {"prefix": 0, "suffix": 1, "contains": 2, "equals": 3}

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _check_strings(data, lengths, validity, what: str) -> None:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"{what}: strings must be uint8 [n, W], got "
                         f"{data.dtype}{tuple(data.shape)}")
    n, w = data.shape
    if w < 4 or w % 4:
        raise ValueError(f"{what}: string width {w} is not a multiple of 4")
    if lengths.shape != (n,) or validity.shape != (n,):
        raise ValueError(f"{what}: lengths and validity must be [{n}]")


def _int_operand(v, n: int, dev):
    """An int64 [n] tensor and its validity for a scalar or a column."""
    if isinstance(v, tuple):
        data, valid = v
        return data.to(torch.int64), valid
    return (torch.full((n,), int(v), dtype=torch.int64, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# K13a: substring
# ---------------------------------------------------------------------------

def substring(data: torch.Tensor, lengths: torch.Tensor,
              validity: torch.Tensor, pos, length):
    """Spark ``substring(str, pos, len)`` of every row, by character.

    ``pos`` and ``length`` are each a python int (a literal) or a pair
    (integer tensor [n], bool validity [n]).  Returns (uint8 [n, W] with
    zeros after each result, int32 lengths, bool validity); the result is
    null where the string, ``pos`` or ``length`` is."""
    _check_strings(data, lengths, validity, "substring")
    if data.device.type == "cpu":
        return substring_plain(data, lengths, validity, pos, length)
    return _substring_cuda(data, lengths, validity, pos, length)


substring.launches = 0


def substring_plain(data: torch.Tensor, lengths: torch.Tensor,
                    validity: torch.Tensor, pos, length):
    """Plain PyTorch version of :func:`substring` (any device)."""
    n, w = data.shape
    dev = data.device
    j = torch.arange(w, device=dev)
    starts = ((data & 0xC0) != 0x80) & (j[None, :] < lengths.long()[:, None])
    nchars = starts.sum(1)
    p, p_ok = _int_operand(pos, n, dev)
    ln, l_ok = _int_operand(length, n, dev)
    start = torch.where(p > 0, p - 1, torch.where(p < 0, nchars + p, 0))
    # start + len, saturated at the int64 limits (torch wraps)
    end = torch.where((ln > 0) & (start > _I64_MAX - ln), _I64_MAX,
                      torch.where((ln < 0) & (start < _I64_MIN - ln),
                                  _I64_MIN, start + ln))
    start = start.clamp(min=0)
    valid = validity & p_ok & l_ok
    first = torch.minimum(start, nchars)
    last = torch.minimum(end, nchars)
    empty = ~valid | (start >= end) | (first >= last)
    counts = torch.cumsum(starts.to(torch.int64), 1)

    def byte_of(k):
        hit = starts & (counts == (k + 1)[:, None])
        return torch.where(hit.any(1), hit.to(torch.uint8).argmax(1),
                           lengths.long())

    sb = torch.where(empty, 0, byte_of(first))
    new_len = torch.where(empty, 0, byte_of(last) - sb)
    idx = (sb[:, None] + j[None, :]).clamp(max=w - 1)
    out = torch.gather(data, 1, idx)
    out = torch.where(j[None, :] < new_len[:, None], out,
                      torch.zeros((), dtype=torch.uint8, device=dev))
    return out, new_len.to(torch.int32), valid


def _substring_cuda(data, lengths, validity, pos, length):
    n, w = data.shape
    dev = data.device
    out = torch.empty((n, w), dtype=torch.uint8, device=dev)
    out_len = torch.empty(n, dtype=torch.int32, device=dev)
    out_valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, out_len, out_valid
    lib = native.lib("string_substr")
    data = data.contiguous()
    if data.data_ptr() % 16:
        data = data.clone()  # the kernel reads rows as aligned words
    keep = []  # contiguous operands stay alive until the launch is queued

    def operand(v):
        if isinstance(v, tuple):
            d = v[0].to(torch.int64).contiguous()
            m = v[1].contiguous()
            if d.shape != (n,) or m.shape != (n,):
                raise ValueError(f"substring operand must be [{n}]")
            keep.extend((d, m))
            return ptr(d), ptr(m), 0
        return None, None, int(v)

    pos_p, pos_v, pos_s = operand(pos)
    len_p, len_v, len_s = operand(length)
    lengths = lengths.to(torch.int32).contiguous()
    validity = validity.contiguous()
    native.check(lib.srt_substring(
        ptr(data), ptr(lengths), ptr(validity), n, w, pos_p, pos_v, pos_s,
        len_p, len_v, len_s, ptr(out), ptr(out_len), ptr(out_valid),
        native.stream_ptr(dev)), "srt_substring")
    substring.launches += 1
    return out, out_len, out_valid


# ---------------------------------------------------------------------------
# K13b: literal match
# ---------------------------------------------------------------------------

def _check_match(mode, data, lengths, validity, needle, needle_lengths,
                 needle_validity) -> None:
    if mode not in MATCH_MODES:
        raise ValueError(f"string match mode {mode!r}")
    _check_strings(data, lengths, validity, "string_match")
    _check_strings(needle, needle_lengths, needle_validity,
                   "string_match needle")
    if needle.shape[0] not in (1, data.shape[0]):
        raise ValueError(f"needle rows {needle.shape[0]}: 1 or "
                         f"{data.shape[0]}")


def literal_needle(s: str, device):
    """(uint8 [1, W], int32 [1], bool [1]) of one string: a literal
    needle, matched against every row."""
    bs = s.encode("utf-8")
    row = np.zeros((1, round_string_width(max(len(bs), 1))), dtype=np.uint8)
    row[0, :len(bs)] = np.frombuffer(bs, dtype=np.uint8)
    return (torch.from_numpy(row).to(device),
            torch.tensor([len(bs)], dtype=torch.int32, device=device),
            torch.ones(1, dtype=torch.bool, device=device))


def string_match(mode: str, data: torch.Tensor, lengths: torch.Tensor,
                 validity: torch.Tensor, needle: torch.Tensor,
                 needle_lengths: torch.Tensor,
                 needle_validity: torch.Tensor):
    """Match ``needle`` against every row: ``mode`` is prefix, suffix,
    contains or equals.  ``needle`` is uint8 [1, Wb] (one row for every
    row: a literal) or [n, Wb] (a column), with its lengths and validity.
    Returns (bool match [n], bool validity [n]); invalid rows are false."""
    if data.device.type == "cpu":
        return string_match_plain(mode, data, lengths, validity, needle,
                                  needle_lengths, needle_validity)
    return _string_match_cuda(mode, data, lengths, validity, needle,
                              needle_lengths, needle_validity)


string_match.launches = 0


def string_match_plain(mode: str, data: torch.Tensor, lengths: torch.Tensor,
                       validity: torch.Tensor, needle: torch.Tensor,
                       needle_lengths: torch.Tensor,
                       needle_validity: torch.Tensor):
    """Plain PyTorch version of :func:`string_match` (any device)."""
    _check_match(mode, data, lengths, validity, needle, needle_lengths,
                 needle_validity)
    n, wa = data.shape
    dev = data.device
    la = lengths.long()
    lb = needle_lengths.long().expand(n)
    valid = validity & needle_validity.expand(n)
    # a needle longer than the row never matches, so only the first
    # wa needle bytes are ever compared
    wb = min(needle.shape[1], wa)
    b = needle[:, :wb].expand(n, wb)
    j = torch.arange(wb, device=dev)
    within = j[None, :] < lb[:, None]

    def at(offset):
        """Row bytes [offset, offset + wb) (offset [n]), clipped."""
        idx = (offset[:, None] + j[None, :]).clamp(0, wa - 1)
        return torch.gather(data, 1, idx)

    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    if mode == "prefix":
        match = (~within | (at(zero) == b)).all(1) & (la >= lb)
    elif mode == "suffix":
        match = (~within | (at(la - lb) == b)).all(1) & (la >= lb)
    elif mode == "equals":
        match = (~within | (at(zero) == b)).all(1) & (la == lb)
    else:
        match = torch.zeros(n, dtype=torch.bool, device=dev)
        for s in range(wa + 1):
            hit = (~within | (at(zero + s) == b)).all(1) & (s + lb <= la)
            match |= hit
    return match & valid, valid


def _string_match_cuda(mode, data, lengths, validity, needle,
                       needle_lengths, needle_validity):
    _check_match(mode, data, lengths, validity, needle, needle_lengths,
                 needle_validity)
    n, wa = data.shape
    dev = data.device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    out_valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, out_valid
    if needle.device != dev:
        raise ValueError(f"needle on {needle.device}, strings on {dev}")
    lib = native.lib("string_match")
    data = data.contiguous()
    needle = needle.contiguous()
    if data.data_ptr() % 16:
        data = data.clone()  # prefix and equals compare aligned words
    if needle.data_ptr() % 16:
        needle = needle.clone()
    lengths = lengths.to(torch.int32).contiguous()
    needle_lengths = needle_lengths.to(torch.int32).contiguous()
    validity = validity.contiguous()
    needle_validity = needle_validity.contiguous()
    native.check(lib.srt_string_match(
        MATCH_MODES[mode], ptr(data), ptr(lengths), ptr(validity), n, wa,
        ptr(needle), ptr(needle_lengths), ptr(needle_validity),
        1 if needle.shape[0] > 1 else 0, needle.shape[1], ptr(out),
        ptr(out_valid), native.stream_ptr(dev)), "srt_string_match")
    string_match.launches += 1
    return out, out_valid


# ---------------------------------------------------------------------------
# K13c: concat / concat_ws
# ---------------------------------------------------------------------------

#: pieces one K13c launch takes (csrc/string_concat.cu kMaxPieces)
MAX_PIECES = 8


def _check_pieces(pieces, sep):
    if not pieces:
        raise ValueError("concat: no pieces")
    n = next((p[0].shape[0] for p in pieces if p[0].shape[0] != 1), 1)
    for data, lengths, validity in pieces:
        _check_strings(data, lengths, validity, "concat piece")
        if data.shape[0] not in (1, n):
            raise ValueError(f"concat piece rows {data.shape[0]}: 1 or {n}")
    if sep is not None and len(pieces) > MAX_PIECES:
        raise ValueError(f"concat_ws over {len(pieces)} pieces: at most "
                         f"{MAX_PIECES}")
    return n


def _sep_bytes(sep) -> bytes | None:
    return None if sep is None else sep.encode("utf-8")


def concat_width(pieces, sep=None) -> int:
    """Output width of :func:`concat`: the pieces' widths and the
    separators' bytes, rounded up by ``round_string_width``."""
    w = sum(p[0].shape[1] for p in pieces)
    sb = _sep_bytes(sep)
    if sb is not None:
        w += (len(pieces) - 1) * len(sb)
    return round_string_width(w)


def concat(pieces, sep=None):
    """Concatenate string pieces row by row.

    ``pieces`` is a list of (uint8 [m, W], int32 [m], bool [m]) with m the
    row count n or 1 (a literal, read by every row).  ``sep`` None is
    Spark ``concat``: the result is null where any piece is.  ``sep`` a
    str is ``concat_ws``: null pieces are skipped, ``sep`` goes between
    two non-null pieces, and the result is never null.  Returns (uint8
    [n, concat_width], int32 lengths, bool validity) with zeros after each
    result."""
    n = _check_pieces(pieces, sep)
    if pieces[0][0].device.type == "cpu":
        return concat_plain(pieces, sep)
    if sep is None and len(pieces) > MAX_PIECES:
        # concat is associative: fold the first MAX_PIECES into one piece
        head = concat(pieces[:MAX_PIECES])
        return concat([head] + list(pieces[MAX_PIECES:]))
    return _concat_cuda(pieces, sep, n)


concat.launches = 0


def _concat2(da, la, db, lb):
    """``_concat2_device``: row a's bytes, then row b's, zeros after."""
    n, wa = da.shape
    wb = db.shape[1]
    w = round_string_width(wa + wb)
    j = torch.arange(w, device=da.device)[None, :]
    la, lb = la.long()[:, None], lb.long()[:, None]
    av = torch.gather(da, 1, j.clamp(0, wa - 1).expand(n, w))
    bv = torch.gather(db, 1, (j - la).clamp(0, wb - 1))
    out = torch.where(j < la, av, bv)
    new_len = la + lb
    out = torch.where(j < new_len, out, torch.zeros((), dtype=torch.uint8,
                                                    device=da.device))
    return out, new_len[:, 0].to(torch.int32)


def concat_plain(pieces, sep=None):
    """Plain PyTorch version of :func:`concat` (any device): the
    reference's pairwise fold, each step cut to the widths folded so far
    (no row is longer, and the rounded widths would otherwise double with
    every step), then to :func:`concat_width`."""
    n = _check_pieces(pieces, sep)
    dev = pieces[0][0].device
    full = [(d.expand(n, -1), ln.expand(n), v.expand(n))
            for d, ln, v in pieces]
    sb = _sep_bytes(sep)

    def step(data, lengths, d, ln, bound):
        data, lengths = _concat2(data, lengths, d, ln)
        return data[:, :round_string_width(bound)], lengths

    if sb is None:
        validity = full[0][2]
        data, lengths = full[0][0], full[0][1]
        bound = data.shape[1]
        for d, ln, v in full[1:]:
            validity = validity & v
            bound += d.shape[1]
            data, lengths = step(data, lengths, d, ln, bound)
        data = torch.where(validity[:, None], data,
                           torch.zeros((), dtype=torch.uint8, device=dev))
        lengths = torch.where(validity, lengths, 0).to(torch.int32)
    else:
        sd, sl, _sv = literal_needle(sep, dev)
        sd = sd.expand(n, -1)
        data = torch.zeros((n, 4), dtype=torch.uint8, device=dev)
        lengths = torch.zeros(n, dtype=torch.int32, device=dev)
        have_any = torch.zeros(n, dtype=torch.bool, device=dev)
        bound = 0
        for i, (d, ln, v) in enumerate(full):
            if i:
                bound += len(sb)
                data, lengths = step(data, lengths, sd,
                                     torch.where(have_any & v, sl, 0),
                                     bound)
            bound += d.shape[1]
            data, lengths = step(data, lengths, d, torch.where(v, ln, 0),
                                 bound)
            have_any = have_any | v
        validity = torch.ones(n, dtype=torch.bool, device=dev)
    w = concat_width(pieces, sep)
    if data.shape[1] < w:
        data = torch.nn.functional.pad(data, (0, w - data.shape[1]))
    return data[:, :w].contiguous(), lengths, validity.clone()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _concat_cuda(pieces, sep, n: int):
    dev = pieces[0][0].device
    w = concat_width(pieces, sep)
    out = torch.empty((n, w), dtype=torch.uint8, device=dev)
    out_len = torch.empty(n, dtype=torch.int32, device=dev)
    out_valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, out_len, out_valid
    lib = native.lib("string_concat")
    keep = []  # the operands stay alive until the launch is queued
    for d, ln, v in pieces:
        if d.device != dev:
            raise ValueError(f"concat piece on {d.device}, first on {dev}")
        keep.append((_aligned(d), ln.to(torch.int32).contiguous(),
                     v.contiguous()))
    k = len(keep)
    ptrs = ctypes.c_void_p * k
    datas = ptrs(*[ptr(d) for d, _l, _v in keep])
    lens = ptrs(*[ptr(ln) for _d, ln, _v in keep])
    valids = ptrs(*[ptr(v) for _d, _l, v in keep])
    widths = (ctypes.c_int * k)(*[d.shape[1] for d, _l, _v in keep])
    rows = (ctypes.c_int * k)(*[int(d.shape[0] == n) for d, _l, _v in keep])
    sb = _sep_bytes(sep)
    sep_row = None if sb is None else literal_needle(sep, dev)[0]
    native.check(lib.srt_concat(
        k, datas, widths, lens, valids, rows, n,
        None if sep_row is None else ptr(sep_row),
        0 if sep_row is None else sep_row.shape[1], len(sb or b""),
        int(sb is not None), w, ptr(out), ptr(out_len), ptr(out_valid),
        native.stream_ptr(dev)), "srt_concat")
    concat.launches += 1
    return out, out_len, out_valid


# ---------------------------------------------------------------------------
# K13d: ASCII upper / lower
# ---------------------------------------------------------------------------

def case_map(data: torch.Tensor, lengths: torch.Tensor,
             validity: torch.Tensor, upper: bool):
    """ASCII ``upper`` (a-z to A-Z) or lower (A-Z to a-z) of every row;
    other bytes, UTF-8 sequences among them, pass unchanged.  Returns
    (uint8 [n, W], lengths, validity): the lengths and validity are the
    input's own tensors."""
    _check_strings(data, lengths, validity, "case_map")
    if data.device.type == "cpu":
        return case_map_plain(data, lengths, validity, upper)
    return _case_map_cuda(data, lengths, validity, upper)


case_map.launches = 0


def case_map_plain(data: torch.Tensor, lengths: torch.Tensor,
                   validity: torch.Tensor, upper: bool):
    """Plain PyTorch version of :func:`case_map` (any device)."""
    lo, hi, delta = (97, 122, -32) if upper else (65, 90, 32)
    hit = (data >= lo) & (data <= hi)
    return (torch.where(hit, data + delta, data).to(torch.uint8), lengths,
            validity)


def _case_map_cuda(data, lengths, validity, upper):
    n, w = data.shape
    out = torch.empty((n, w), dtype=torch.uint8, device=data.device)
    if n == 0:
        return out, lengths, validity
    lib = native.lib("string_case")
    data = _aligned(data)  # the kernel reads 16-byte vectors
    native.check(lib.srt_case_map(
        ptr(data), ptr(out), n * w, 1 if upper else 0,
        native.stream_ptr(data.device)), "srt_case_map")
    case_map.launches += 1
    return out, lengths, validity


# ---------------------------------------------------------------------------
# K13i: hex of a long
# ---------------------------------------------------------------------------

def hex_string(data: torch.Tensor, validity: torch.Tensor):
    """Spark ``hex`` of every int64 row: the two's complement bits as
    upper-case hex digits, most significant first, leading zeros dropped
    (``0`` gives ``"0"``, ``-1`` sixteen ``F``).  Returns (uint8 [n, 16]
    with zeros after the digits, int32 lengths, validity); null rows are
    zero with length 0, and the validity is the input's own tensor."""
    if data.dtype != torch.int64 or data.dim() != 1 or \
            validity.shape != data.shape:
        raise ValueError(f"hex_string: int64 [n] data and bool [n] validity "
                         f"expected, got {data.dtype}{tuple(data.shape)}")
    if data.device.type == "cpu":
        return hex_string_plain(data, validity)
    return _hex_cuda(data, validity)


hex_string.launches = 0


def hex_string_plain(data: torch.Tensor, validity: torch.Tensor):
    """Plain PyTorch version of :func:`hex_string` (any device)."""
    dev = data.device
    shifts = torch.arange(60, -1, -4, dtype=torch.int64, device=dev)
    nib = (data[:, None] >> shifts[None, :]) & 0xF
    chars = torch.where(nib < 10, nib + 48, nib + 55)
    nz = (nib != 0).to(torch.int8)
    first = torch.where(nz.any(1), nz.argmax(1),
                        torch.full((), 15, dtype=torch.int64, device=dev))
    lengths = torch.where(validity, 16 - first, 0).to(torch.int32)
    j = torch.arange(16, dtype=torch.int64, device=dev)[None, :]
    src = (first[:, None] + j).clamp(max=15)
    out = torch.gather(chars, 1, src)
    out = torch.where(j < lengths[:, None].to(torch.int64), out, 0)
    return out.to(torch.uint8), lengths, validity


def _hex_cuda(data, validity):
    n = data.shape[0]
    dev = data.device
    out = torch.empty((n, 16), dtype=torch.uint8, device=dev)
    out_len = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out, out_len, validity
    native.check(native.lib("string_hex").srt_hex(
        ptr(data.contiguous()), ptr(validity.contiguous()), ptr(out),
        ptr(out_len), n, native.stream_ptr(dev)), "srt_hex")
    hex_string.launches += 1
    return out, out_len, validity
