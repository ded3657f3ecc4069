"""K13 string functions of the PyTorch/CUDA port against the JAX package.

Each expression is evaluated on the same seeded byte matrices by the
reference's device branch (``spark_rapids_tpu/expr/strings.py``, run
eagerly on jax.numpy under ``JAX_PLATFORMS=cpu``, as the JAX package's
own tests run it) and by the port's (``spark_rapids_tpu_torch/expr/
strings.py`` over the plain versions of ``ops/strings.py`` on the CPU).
Rows hold ASCII, 2-, 3- and 4-byte UTF-8 characters, NUL bytes and lone
continuation bytes, empty and null strings, at widths 4 to 256; ``pos``
and ``len`` run over [-W-2, W+2] and [-2, W+2] plus 2^31-1, as literals
and as columns with nulls; needles are literals and columns, empty and
wider than the column.  Everything compares exactly: data (the zero tail
included), lengths and validity.

One case is held against Spark instead: the reference computes ``start
+ len`` in int32 and wraps, so ``substring('hello', 2, 2147483647)`` is
``''`` there and ``'ello'`` in Spark and the port (ROADMAP.md Queue 3).
On the card, ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
CUDA kernels against these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expr import conditional as JCond
from spark_rapids_tpu.expr import core as JC
from spark_rapids_tpu.expr import strings as JS
from spark_rapids_tpu.expr import predicates as JP
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.expr import conditional as PCond
from spark_rapids_tpu_torch.expr import core as PC
from spark_rapids_tpu_torch.expr import predicates as PP
from spark_rapids_tpu_torch.expr import strings as PS
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops import strings as OS

CPU = torch.device("cpu")
N = 600
WIDTHS = [4, 8, 16, 32, 64, 256]
INT32_MAX = 2 ** 31 - 1

#: the pieces rows are built from: ASCII, NUL, 2/3/4-byte characters and
#: a lone continuation byte (not a character start)
_PIECES = [b"a", b"b", b"Z", b" ", b"\x00", "é".encode(), "€".encode(),
           "😀".encode(), b"\x80"]


def _rows(rng, n: int, w: int, null_p: float = 0.1):
    """uint8 [n, w], int32 lengths, bool validity of seeded strings of at
    most w bytes (empty and null rows included)."""
    data = np.zeros((n, w), np.uint8)
    lengths = np.zeros(n, np.int32)
    valid = rng.random(n) >= null_p
    for i in range(n):
        if not valid[i]:
            continue
        cap = int(rng.integers(0, w + 1))
        bs = b""
        while True:
            p = _PIECES[int(rng.integers(0, len(_PIECES)))]
            if len(bs) + len(p) > cap:
                break
            bs += p
        data[i, :len(bs)] = np.frombuffer(bs, np.uint8)
        lengths[i] = len(bs)
    return data, lengths, valid


def _ints(rng, n: int, lo: int, hi: int, extra=(), null_p: float = 0.1):
    vals = rng.integers(lo, hi + 1, n)
    if extra:
        pick = rng.random(n) < 0.1
        vals[pick] = rng.choice(np.array(extra, np.int64), pick.sum())
    return vals.astype(np.int32), rng.random(n) >= null_p


def _jval(data, valid, dtype, lengths=None):
    return JC.Val(jnp.asarray(data), jnp.asarray(valid),
                  None if lengths is None else jnp.asarray(lengths), dtype)


def _pval(data, valid, dtype, lengths=None):
    return PC.Val(torch.from_numpy(np.ascontiguousarray(data)),
                  torch.from_numpy(np.ascontiguousarray(valid)),
                  None if lengths is None else torch.from_numpy(lengths),
                  dtype)


def _jctx(n):
    return JC.EvalCtx(jnp, True, n, jnp.ones(n, dtype=bool))


def _pctx(n):
    return PC.EvalCtx(CPU, n)


def _j(v):
    out = [np.asarray(jax.device_get(v.data)),
           np.asarray(jax.device_get(v.validity))]
    if v.lengths is not None:
        out.append(np.asarray(jax.device_get(v.lengths)))
    return out


def _p(v):
    out = [v.data.numpy(), v.validity.numpy()]
    if v.lengths is not None:
        out.append(v.lengths.numpy())
    return out


def _assert_same(got, want, rows=None):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if rows is not None:
            g, w = g[rows], w[rows]
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        assert np.array_equal(g, w)


def _spark_substring(bs: bytes, pos: int, ln: int) -> bytes:
    """UTF8String.substringSQL over raw bytes (a byte is a character start
    unless it is a continuation byte), in Python's unbounded ints."""
    starts = [j for j, b in enumerate(bs) if (b & 0xC0) != 0x80]
    n = len(starts)
    start = pos - 1 if pos > 0 else (n + pos if pos < 0 else 0)
    end = min(start + ln, 2 ** 63 - 1)
    start = max(start, 0)
    if start >= end or start >= n:
        return b""
    sb = starts[start]
    eb = starts[end] if end < n else len(bs)
    return bs[sb:eb]


def _overflows(lengths_chars, pos, ln):
    """Rows where the reference's int32 start + len wraps."""
    pos = pos.astype(np.int64)
    start = np.where(pos > 0, pos - 1, np.where(pos < 0,
                                                lengths_chars + pos, 0))
    return np.maximum(start, 0) + np.maximum(ln.astype(np.int64), 0) \
        > INT32_MAX


def _nchars(data, lengths):
    j = np.arange(data.shape[1])[None, :]
    return (((data & 0xC0) != 0x80) & (j < lengths[:, None])).sum(1)


# ---------------------------------------------------------------------------
# K13a: Substring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WIDTHS)
def test_substring_columns_match_jax(w):
    rng = np.random.default_rng(w)
    data, lengths, valid = _rows(rng, N, w)
    pos, pv = _ints(rng, N, -w - 2, w + 2)
    ln, lv = _ints(rng, N, -2, w + 2, extra=(INT32_MAX,))
    s, i = JT.StringType(), JT.IntegerType()
    jexpr = JS.Substring(JC.BoundReference(0, s), JC.BoundReference(1, i),
                         JC.BoundReference(2, i))
    ps, pi = PT.StringType(), PT.IntegerType()
    pexpr = PS.Substring(PC.BoundReference(0, ps), PC.BoundReference(1, pi),
                         PC.BoundReference(2, pi))
    want = jexpr.eval([_jval(data, valid, s, lengths), _jval(pos, pv, i),
                       _jval(ln, lv, i)], _jctx(N))
    got = pexpr.eval([_pval(data, valid, ps, lengths), _pval(pos, pv, pi),
                      _pval(ln, lv, pi)], _pctx(N))
    ok = ~_overflows(_nchars(data, lengths), pos, ln)
    assert (~ok).sum() > 0 and ok.sum() > N // 2
    _assert_same(_p(got), _j(want), ok)
    # the zero tail: nothing after each result's length
    out, _v, out_len = _p(got)
    assert not (out * (np.arange(w)[None, :] >= out_len[:, None])).any()


_LITERALS = [(1, 2), (1, 5), (0, 3), (2, INT32_MAX), (3, 2), (-1, 1),
             (-3, 2), (-2, INT32_MAX), (5, -1), (-10, 3)]


@pytest.mark.parametrize("w", [4, 16, 64])
def test_substring_literals_match_jax(w):
    rng = np.random.default_rng(100 + w)
    data, lengths, valid = _rows(rng, N, w)
    nchars = _nchars(data, lengths)
    s = JT.StringType()
    ps = PT.StringType()
    cases = _LITERALS + [(-w - 2, w + 2), (w + 2, 1), (w // 2, w)]
    for pos, ln in cases:
        jexpr = JS.Substring(JC.BoundReference(0, s),
                             JC.Literal(pos, JT.IntegerType()),
                             JC.Literal(ln, JT.IntegerType()))
        pexpr = PS.Substring(PC.BoundReference(0, ps),
                             PC.Literal(pos, PT.IntegerType()),
                             PC.Literal(ln, PT.IntegerType()))
        want = jexpr.eval([_jval(data, valid, s, lengths)], _jctx(N))
        got = pexpr.eval([_pval(data, valid, ps, lengths)], _pctx(N))
        ok = ~_overflows(nchars, np.full(N, pos), np.full(N, ln))
        _assert_same(_p(got), _j(want), ok)


def test_substring_against_spark_where_the_reference_wraps():
    """The reference's int32 start + len wraps (``'hello', 2, 2^31-1`` is
    '' there); the port gives Spark's answer, by character."""
    rng = np.random.default_rng(7)
    w = 32
    data, lengths, valid = _rows(rng, N, w)
    pos, pv = _ints(rng, N, -w - 2, w + 2, null_p=0.0)
    ln = np.full(N, INT32_MAX, np.int32)
    out, out_len, out_valid = OS.substring(
        torch.from_numpy(data), torch.from_numpy(lengths),
        torch.from_numpy(valid), (torch.from_numpy(pos),
                                  torch.from_numpy(pv)), INT32_MAX)
    wraps = _overflows(_nchars(data, lengths), pos, ln) & valid
    assert wraps.sum() > 50
    for i in range(N):
        want = _spark_substring(bytes(data[i, :lengths[i]]), int(pos[i]),
                                INT32_MAX) if valid[i] else b""
        got = bytes(out[i, :out_len[i]].tolist())
        assert bool(out_valid[i]) == bool(valid[i])
        assert got == want, (i, bytes(data[i, :lengths[i]]), pos[i])
    # the reference's device branch returns '' on the same input
    hello = np.zeros((1, 8), np.uint8)
    hello[0, :5] = np.frombuffer(b"hello", np.uint8)
    s = JT.StringType()
    jv = JS.Substring(JC.BoundReference(0, s), JC.Literal(2, JT.IntegerType()),
                      JC.Literal(INT32_MAX, JT.IntegerType())).eval(
        [_jval(hello, np.ones(1, bool), s, np.array([5], np.int32))],
        _jctx(1))
    assert int(np.asarray(jax.device_get(jv.lengths))[0]) == 0
    got = OS.substring(torch.from_numpy(hello), torch.tensor([5]).int(),
                       torch.ones(1, dtype=torch.bool), 2, INT32_MAX)
    assert bytes(got[0][0, :got[1][0]].tolist()) == b"ello"


def test_substring_method_and_spark_examples():
    """``Expression.substr`` builds Substring with literal operands; Spark's
    documented examples (positive, negative and zero positions)."""
    words = ["Spark SQL", "héllo", ""]
    w = 16
    data = np.zeros((3, w), np.uint8)
    for i, s in enumerate(words):
        bs = s.encode()
        data[i, :len(bs)] = np.frombuffer(bs, np.uint8)
    lengths = np.array([len(s.encode()) for s in words], np.int32)
    ps = PT.StringType()
    for (p, ln), want in {(5, 1): ["k", "o", ""], (-3, 2): ["SQ", "ll", ""],
                          (0, 2): ["Sp", "hé", ""]}.items():
        e = PC.BoundReference(0, ps).substr(p, ln)
        assert isinstance(e, PS.Substring)
        v = e.eval([_pval(data, np.ones(3, bool), ps, lengths)], _pctx(3))
        got = [bytes(v.data[i, :v.lengths[i]].tolist()).decode()
               for i in range(3)]
        assert got == want


# ---------------------------------------------------------------------------
# K13b: StartsWith / EndsWith / Contains / Like
# ---------------------------------------------------------------------------

_PREDICATES = [(JS.StartsWith, PS.StartsWith), (JS.EndsWith, PS.EndsWith),
               (JS.Contains, PS.Contains)]
_NEEDLES = ["", "a", "é", "a€", "😀a", "\x00", "ab" * 40]


# the reference's Contains slides the needle over all W offsets eagerly;
# W 64 runs prefix and suffix here, contains with needle columns below
@pytest.mark.parametrize("w,k", [(4, 0), (4, 1), (4, 2), (16, 0), (16, 1),
                                 (16, 2), (64, 0), (64, 1)])
def test_match_literal_needles_match_jax(w, k):
    rng = np.random.default_rng(200 + w)
    data, lengths, valid = _rows(rng, N, w)
    jcls, pcls = _PREDICATES[k]
    s, ps = JT.StringType(), PT.StringType()
    for needle in _NEEDLES:
        jexpr = jcls(JC.BoundReference(0, s), JC.Literal(needle, s))
        pexpr = pcls(PC.BoundReference(0, ps), PC.Literal(needle, ps))
        want = jexpr.eval([_jval(data, valid, s, lengths)], _jctx(N))
        got = pexpr.eval([_pval(data, valid, ps, lengths)], _pctx(N))
        _assert_same(_p(got), _j(want))
        if needle == "":
            assert np.array_equal(got.data.numpy(), valid)


@pytest.mark.parametrize("wa,wb", [(8, 8), (16, 4), (4, 32), (64, 16)])
@pytest.mark.parametrize("k", range(3))
def test_match_column_needles_match_jax(wa, wb, k):
    rng = np.random.default_rng(300 + wa * wb)
    data, lengths, valid = _rows(rng, N, wa)
    ndata, nlengths, nvalid = _rows(rng, N, wb)
    # half the needles are the row's own prefix, suffix or middle piece,
    # so that every mode matches often
    for i in range(0, N, 2):
        if lengths[i] and wb >= lengths[i]:
            lo = int(rng.integers(0, lengths[i]))
            hi = int(rng.integers(lo, lengths[i] + 1))
            if k == 0:
                lo = 0
            elif k == 1:
                hi = lengths[i]
            ndata[i] = 0
            ndata[i, :hi - lo] = data[i, lo:hi]
            nlengths[i] = hi - lo
    jcls, pcls = _PREDICATES[k]
    s, ps = JT.StringType(), PT.StringType()
    jexpr = jcls(JC.BoundReference(0, s), JC.BoundReference(1, s))
    pexpr = pcls(PC.BoundReference(0, ps), PC.BoundReference(1, ps))
    want = jexpr.eval([_jval(data, valid, s, lengths),
                       _jval(ndata, nvalid, s, nlengths)], _jctx(N))
    got = pexpr.eval([_pval(data, valid, ps, lengths),
                      _pval(ndata, nvalid, ps, nlengths)], _pctx(N))
    _assert_same(_p(got), _j(want))
    assert got.data.sum() > N // 8


_LIKE_SIMPLE = ["PROMO%", "%a", "%é%", "ab", "a", "", "%", "%%", "%%a%%",
                "😀%"]
_LIKE_GENERAL = ["a%b", "a_c", "_", "a\\%", "%a%b%"]


@pytest.mark.parametrize("w", [8, 32])
def test_like_shapes_match_jax(w):
    rng = np.random.default_rng(400 + w)
    data, lengths, valid = _rows(rng, N, w)
    # rows that begin with PROMO, as TPC-H q14's p_type does
    promo = np.frombuffer(b"PROMO", np.uint8)
    for i in range(0, N, 5):
        if valid[i] and w >= 5:
            data[i, :5] = promo
            lengths[i] = max(lengths[i], 5)
    s, ps = JT.StringType(), PT.StringType()
    for pattern in _LIKE_SIMPLE:
        jl = JS.Like(JC.BoundReference(0, s), pattern)
        pl = PC.BoundReference(0, ps).like(pattern)
        assert pl._simple_shape() == jl._simple_shape()
        want = jl.eval([_jval(data, valid, s, lengths)], _jctx(N))
        got = pl.eval([_pval(data, valid, ps, lengths)], _pctx(N))
        _assert_same(_p(got), _j(want))
    assert PS.Like(None, "%")._simple_shape() == ("prefix", "")
    assert PS.Like(None, "%%")._simple_shape() == ("contains", "")
    assert PS.Like(None, "")._simple_shape() == ("equals", "")


@pytest.mark.parametrize("pattern", _LIKE_GENERAL)
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_general_like_raises_on_every_device(pattern, device):
    ps = PT.StringType()
    pl = PS.Like(PC.BoundReference(0, ps), pattern)
    assert pl._simple_shape() is None
    assert JS.Like(None, pattern)._simple_shape() is None
    dev = torch.device(device)
    v = PC.Val(torch.zeros((3, 8), dtype=torch.uint8, device=dev),
               torch.ones(3, dtype=torch.bool, device=dev),
               torch.zeros(3, dtype=torch.int32, device=dev), ps)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        pl.eval([v], PC.EvalCtx(dev, 3))


def test_string_methods_build_the_expressions():
    ps = PT.StringType()
    ref = PC.BoundReference(0, ps)
    assert isinstance(ref.startswith("a"), PS.StartsWith)
    assert isinstance(ref.endswith("a"), PS.EndsWith)
    assert isinstance(ref.contains("a"), PS.Contains)
    assert isinstance(ref.like("a%"), PS.Like)
    # two LIKEs over one column stay apart where expressions are keyed
    # by their text (the aggregate's distinct functions)
    assert repr(ref.like("a%")) != repr(ref.like("b%"))


# ---------------------------------------------------------------------------
# the wrappers: plain version on the CPU only, the kernel or an error off it
# ---------------------------------------------------------------------------

def _meta_strings(n=4, w=8):
    meta = torch.device("meta")
    return (torch.zeros((n, w), dtype=torch.uint8, device=meta),
            torch.zeros(n, dtype=torch.int32, device=meta),
            torch.ones(n, dtype=torch.bool, device=meta))


def test_wrappers_do_not_fall_back_off_the_cpu(monkeypatch):
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel")

    monkeypatch.setattr(native, "lib", no_kernel)
    data, lengths, valid = _meta_strings()
    with pytest.raises(RuntimeError, match="no string_substr kernel"):
        OS.substring(data, lengths, valid, 1, 2)
    needle = _meta_strings(1, 4)
    with pytest.raises(RuntimeError, match="no string_match kernel"):
        OS.string_match("prefix", data, lengths, valid, *needle)


def test_wrappers_run_the_plain_versions_on_the_cpu(monkeypatch):
    def no_kernel(name):
        raise AssertionError(f"{name} kernel built on the CPU")

    monkeypatch.setattr(native, "lib", no_kernel)
    rng = np.random.default_rng(5)
    data, lengths, valid = (torch.from_numpy(x) for x in _rows(rng, 50, 16))
    before = (OS.substring.launches, OS.string_match.launches)
    got = OS.substring(data, lengths, valid, 2, 3)
    want = OS.substring_plain(data, lengths, valid, 2, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    needle = (data[:1].clone(), lengths[:1].clone(),
              torch.ones(1, dtype=torch.bool))
    for mode in OS.MATCH_MODES:
        got = OS.string_match(mode, data, lengths, valid, *needle)
        want = OS.string_match_plain(mode, data, lengths, valid, *needle)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (OS.substring.launches, OS.string_match.launches) == before


def test_wrappers_check_their_operands():
    data = torch.zeros((3, 6), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 4"):
        OS.substring(data, torch.zeros(3, dtype=torch.int32),
                     torch.ones(3, dtype=torch.bool), 1, 1)
    data = torch.zeros((3, 8), dtype=torch.uint8)
    lv = (torch.zeros(3, dtype=torch.int32), torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="mode"):
        OS.string_match("regex", data, *lv, data[:1], *[t[:1] for t in lv])
    with pytest.raises(ValueError, match="needle rows"):
        OS.string_match("prefix", data, *lv, data[:2], *[t[:2] for t in lv])


# ---------------------------------------------------------------------------
# If / CaseWhen
# ---------------------------------------------------------------------------

def _cond_inputs(rng, n):
    pred, pv = rng.random(n) < 0.5, rng.random(n) >= 0.2
    pred2, pv2 = rng.random(n) < 0.3, rng.random(n) >= 0.2
    x = np.round(rng.normal(size=n) * 10, 2)
    xv = rng.random(n) >= 0.1
    y = rng.integers(-5, 5, n).astype(np.int32)
    yv = rng.random(n) >= 0.1
    sa = _rows(rng, n, 8)
    sb = _rows(rng, n, 32)
    return pred, pv, pred2, pv2, x, xv, y, yv, sa, sb


def _cond_vals(mk, T, inp):
    pred, pv, pred2, pv2, x, xv, y, yv, sa, sb = inp
    return [mk(pred & pv, pv, T.BooleanType()),
            mk(pred2 & pv2, pv2, T.BooleanType()),
            mk(np.where(xv, x, 0.0), xv, T.DoubleType()),
            mk(np.where(yv, y, 0), yv, T.IntegerType()),
            mk(sa[0], sa[2], T.StringType(), sa[1]),
            mk(sb[0], sb[2], T.StringType(), sb[1])]


def _cond_exprs(C, E, T):
    b, d, i, s = (T.BooleanType(), T.DoubleType(), T.IntegerType(),
                  T.StringType())
    R = C.BoundReference
    p, p2, x, y, sa, sb = (R(0, b), R(1, b), R(2, d), R(3, i), R(4, s),
                           R(5, s))
    return [
        E.If(p, x, y).coerced(),                       # int branch widened
        E.If(p, sa, sb),                               # strings, W 8 and 32
        E.If(p, C.Literal(1.5, d), C.Literal(None, T.NullType())).coerced(),
        E.CaseWhen([(p, x), (p2, y)]).coerced(),       # no else: null
        E.CaseWhen([(p, sb), (p2, sa)], C.Literal("zz", s)).coerced(),
        E.CaseWhen([(p2, y)], x).coerced(),
    ]


def test_if_and_case_when_match_jax():
    rng = np.random.default_rng(11)
    inp = _cond_inputs(rng, N)
    jvals = _cond_vals(_jval, JT, inp)
    pvals = _cond_vals(_pval, PT, inp)
    for je, pe in zip(_cond_exprs(JC, JCond, JT),
                      _cond_exprs(PC, PCond, PT)):
        assert type(pe.dtype).__name__ == type(je.dtype).__name__
        want = je.eval(jvals, _jctx(N))
        got = pe.eval(pvals, _pctx(N))
        _assert_same(_p(got), _j(want))


def test_if_takes_the_false_branch_on_a_null_predicate():
    b, d = PT.BooleanType(), PT.DoubleType()
    R = PC.BoundReference
    e = PCond.If(R(0, b), PC.Literal(1.0, d), PC.Literal(2.0, d))
    v = e.eval([PC.Val(torch.tensor([True, True, False]),
                       torch.tensor([True, False, True]), None, b)],
               _pctx(3))
    assert v.data.tolist() == [1.0, 2.0, 2.0]
    assert v.validity.all()
    # the string equality of In and EqualTo sees a substring's zero tail
    s = PT.StringType()
    data = np.zeros((2, 16), np.uint8)
    for i, t in enumerate([b"13-555-0101", b"31-555-0102"]):
        data[i, :len(t)] = np.frombuffer(t, np.uint8)
    code = PS.Substring(R(0, s), PC.Literal(1, PT.LongType()),
                        PC.Literal(2, PT.LongType()))
    pred = PP.In(code, [PC.Literal("13", s), PC.Literal("17", s)])
    got = pred.eval([_pval(data, np.ones(2, bool), s,
                           np.array([11, 11], np.int32))], _pctx(2))
    assert got.data.tolist() == [True, False]
    jcode = JS.Substring(JC.BoundReference(0, JT.StringType()),
                         JC.Literal(1, JT.LongType()),
                         JC.Literal(2, JT.LongType()))
    jpred = JP.In(jcode, [JC.Literal("13", JT.StringType()),
                          JC.Literal("17", JT.StringType())])
    want = jpred.eval([_jval(data, np.ones(2, bool), JT.StringType(),
                             np.array([11, 11], np.int32))], _jctx(2))
    assert got.data.tolist() == np.asarray(want.data).tolist()


# ---------------------------------------------------------------------------
# K13c: Concat / ConcatWs, K13d: Upper / Lower
# ---------------------------------------------------------------------------

def _values(v):
    """(row bytes up to each length or None, lengths) of a string Val
    from either package: the values, whatever the matrix width."""
    data, valid, lengths = (np.asarray(x) for x in (
        _j(v) if isinstance(v, JC.Val) else _p(v)))
    rows = [bytes(data[i, :lengths[i]]) if valid[i] else None
            for i in range(len(valid))]
    return rows, lengths


def _assert_zero_tail(v):
    data, _valid, lengths = _p(v)
    assert not (data * (np.arange(data.shape[1])[None, :]
                        >= lengths[:, None])).any()


_CONCAT_CASES = [
    # (piece widths; a str is a literal piece, None a null literal)
    [16],
    [8, 32],
    [4, ", ", 64],
    [16, "", 8, "é-", 4],
    [256, 4, 128],
    [8, None, 16],
    ["ab", 16, "😀"],
]


@pytest.mark.parametrize("case", range(len(_CONCAT_CASES)))
@pytest.mark.parametrize("ws", [False, True])
def test_concat_matches_jax(case, ws):
    rng = np.random.default_rng(500 + case)
    spec = _CONCAT_CASES[case]
    s, ps = JT.StringType(), PT.StringType()
    jkids, pkids, jvals, pvals = [], [], [], []
    for item in spec:
        if isinstance(item, int):
            data, lengths, valid = _rows(rng, N, item)
            k = len(jvals)
            jkids.append(JC.BoundReference(k, s))
            pkids.append(PC.BoundReference(k, ps))
            jvals.append(_jval(data, valid, s, lengths))
            pvals.append(_pval(data, valid, ps, lengths))
        else:
            jkids.append(JC.Literal(item, s))
            pkids.append(PC.Literal(item, ps))
    if ws:
        je, pe = JS.ConcatWs("|é", *jkids), PS.ConcatWs("|é", *pkids)
    else:
        je, pe = JS.Concat(*jkids), PS.Concat(*pkids)
    want = je.eval(jvals, _jctx(N))
    got = pe.eval(pvals, _pctx(N))
    assert _values(got)[0] == _values(want)[0]
    assert np.array_equal(_values(got)[1], _values(want)[1])
    _assert_zero_tail(got)
    nulls = sum(r is None for r in _values(got)[0])
    if ws:
        assert nulls == 0 and not pe.nullable
    else:
        assert nulls > 0 or len(jvals) == 0


def test_concat_of_literals_fills_every_row():
    ps = PT.StringType()
    e = PS.Concat(PC.Literal("ab", ps), PC.Literal("c", ps))
    v = e.eval([], _pctx(5))
    assert _values(v)[0] == [b"abc"] * 5
    v = PS.ConcatWs(",", PC.Literal(None, ps), PC.Literal("x", ps)).eval(
        [], _pctx(0))
    assert v.data.shape[0] == 0


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("upper", [True, False])
def test_upper_lower_match_jax(w, upper):
    rng = np.random.default_rng(600 + w)
    data, lengths, valid = _rows(rng, N, w)
    # ASCII letters of both cases and the bytes next to their ranges
    letters = np.frombuffer(b"aAzZ@[`{mM", np.uint8)
    for i in range(0, N, 3):
        if valid[i] and lengths[i]:
            j = int(rng.integers(0, lengths[i]))
            if data[i, j] < 0x80:
                data[i, j] = letters[int(rng.integers(0, len(letters)))]
    s, ps = JT.StringType(), PT.StringType()
    jcls, pcls = (JS.Upper, PS.Upper) if upper else (JS.Lower, PS.Lower)
    want = jcls(JC.BoundReference(0, s)).eval(
        [_jval(data, valid, s, lengths)], _jctx(N))
    got = pcls(PC.BoundReference(0, ps)).eval(
        [_pval(data, valid, ps, lengths)], _pctx(N))
    _assert_same(_p(got), _j(want))
    changed = (got.data.numpy() != data).sum()
    assert changed > 0
    # multi-byte UTF-8 passes through: é stays é in both packages
    e = np.zeros((1, 4), np.uint8)
    e[0, :3] = np.frombuffer("aé".encode(), np.uint8)
    got = pcls(PC.BoundReference(0, ps)).eval(
        [_pval(e, np.ones(1, bool), ps, np.array([3], np.int32))], _pctx(1))
    assert bytes(got.data[0, :3].tolist()).decode() == \
        ("Aé" if upper else "aé")


def test_concat_and_case_map_do_not_fall_back_off_the_cpu(monkeypatch):
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel")

    monkeypatch.setattr(native, "lib", no_kernel)
    data, lengths, valid = _meta_strings()
    lit = _meta_strings(1, 4)
    for sep in (None, ", "):
        with pytest.raises(RuntimeError, match="no string_concat kernel"):
            OS.concat([(data, lengths, valid), lit], sep)
    for upper in (True, False):
        with pytest.raises(RuntimeError, match="no string_case kernel"):
            OS.case_map(data, lengths, valid, upper)


def test_concat_and_case_map_run_the_plain_versions_on_the_cpu(
        monkeypatch):
    def no_kernel(name):
        raise AssertionError(f"{name} kernel built on the CPU")

    monkeypatch.setattr(native, "lib", no_kernel)
    rng = np.random.default_rng(6)
    a = tuple(torch.from_numpy(x) for x in _rows(rng, 50, 16))
    b = tuple(torch.from_numpy(x) for x in _rows(rng, 50, 8))
    lit = OS.literal_needle(", ", CPU)
    before = (OS.concat.launches, OS.case_map.launches)
    for sep in (None, "-"):
        got = OS.concat([a, lit, b], sep)
        want = OS.concat_plain([a, lit, b], sep)
        assert got[0].shape == (50, OS.concat_width([a, lit, b], sep))
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    for upper in (True, False):
        got = OS.case_map(*a, upper)
        want = OS.case_map_plain(*a, upper)
        assert torch.equal(got[0], want[0])
        assert got[1] is a[1] and got[2] is a[2]  # shared, not copied
    assert (OS.concat.launches, OS.case_map.launches) == before


def test_concat_checks_its_pieces():
    a = (torch.zeros((3, 8), dtype=torch.uint8),
         torch.zeros(3, dtype=torch.int32), torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="no pieces"):
        OS.concat([])
    with pytest.raises(ValueError, match="piece rows"):
        OS.concat([a, tuple(t[:2] for t in a)])
    with pytest.raises(ValueError, match="at most 8"):
        OS.concat([a] * 9, ",")
    # concat (no separator) of more than 8 pieces folds
    got = OS.concat([a] * 9)
    assert got[0].shape == (3, 128) and got[2].all()
