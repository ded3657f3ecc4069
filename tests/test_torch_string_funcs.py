"""K13e-h string functions of the PyTorch/CUDA port against the JAX
package: the trims, Length, StringLocate and SubstringIndex.

Each expression is evaluated on the same seeded byte matrices by the
reference's device branch (``spark_rapids_tpu/expr/strings.py``, run
eagerly on jax.numpy under ``JAX_PLATFORMS=cpu``, as the JAX package's
own tests run it) and by the port's (``spark_rapids_tpu_torch/expr/
strings.py`` over the plain versions of ``ops/strings.py`` on the CPU).
Rows hold ASCII, 2-, 3- and 4-byte UTF-8 characters, NUL bytes, lone
continuation bytes, commas, slashes and runs of spaces, empty and null
strings, and rows of spaces only, at widths 4 to 256.  StringLocate runs
literal and column needles, empty ones and ones wider than the column,
with ``start`` in [-1, W+2]; SubstringIndex runs ``count`` in [-4, 4] over
the delimiters ``,``, ``/``, space and NUL.  Everything compares exactly:
data (the zero tail included), lengths and validity.  Both string paths
of ``bench/string_queries.py`` run through ``TorchSession(device="cpu")``
and the reference's ``TpuSession`` on the same mortgage files.

On the card, ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
CUDA kernels against these plain versions.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.bench import mortgage as jm
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import conditional as JCond
from spark_rapids_tpu.expr import core as JC
from spark_rapids_tpu.expr import strings as JS
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench import mortgage_gen as pgen
from spark_rapids_tpu_torch.bench import string_queries as SQ
from spark_rapids_tpu_torch.expr import core as PC
from spark_rapids_tpu_torch.expr import strings as PS
from spark_rapids_tpu_torch.ops import strings as OS

CPU = torch.device("cpu")
N = 500
WIDTHS = [4, 8, 16, 64, 256]

#: the pieces rows are built from: ASCII, NUL, 2/3/4-byte characters, a
#: lone continuation byte (not a character start), the delimiters and
#: runs of spaces
_PIECES = [b"a", b"b", b"Z", b" ", b"  ", b"\x00", "é".encode(),
           "€".encode(), "😀".encode(), b"\x80", b",", b"/"]


def _rows(rng, n: int, w: int, null_p: float = 0.1):
    """uint8 [n, w], int32 lengths, bool validity of seeded strings of at
    most w bytes: empty and null rows, a tenth of the rows spaces only,
    a tenth padded with spaces at both ends."""
    data = np.zeros((n, w), np.uint8)
    lengths = np.zeros(n, np.int32)
    valid = rng.random(n) >= null_p
    kind = rng.integers(0, 10, n)
    for i in range(n):
        if not valid[i]:
            continue
        cap = int(rng.integers(0, w + 1))
        if kind[i] == 0:
            bs = b" " * cap
        else:
            bs = b""
            while True:
                p = _PIECES[int(rng.integers(0, len(_PIECES)))]
                if len(bs) + len(p) > cap:
                    break
                bs += p
            if kind[i] == 1 and len(bs) + 2 <= w:
                bs = b" " + bs + b" "
        data[i, :len(bs)] = np.frombuffer(bs, np.uint8)
        lengths[i] = len(bs)
    return data, lengths, valid


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


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        assert np.array_equal(g, w)


def _both(jexpr, pexpr, cols, n=N):
    """Evaluate the reference's and the port's expression over the same
    string columns ``cols`` [(data, lengths, valid)]."""
    s, ps = JT.StringType(), PT.StringType()
    want = jexpr.eval([_jval(d, v, s, ln) for d, ln, v in cols], _jctx(n))
    got = pexpr.eval([_pval(d, v, ps, ln) for d, ln, v in cols], _pctx(n))
    return _p(got), _j(want)


def _ref(i, t=None):
    return JC.BoundReference(i, t or JT.StringType())


def _pref(i, t=None):
    return PC.BoundReference(i, t or PT.StringType())


# ---------------------------------------------------------------------------
# K13e, K13f: trims and Length
# ---------------------------------------------------------------------------

_TRIMS = [(JS.StringTrim, PS.StringTrim), (JS.StringTrimLeft,
                                           PS.StringTrimLeft),
          (JS.StringTrimRight, PS.StringTrimRight)]


@pytest.mark.parametrize("w", WIDTHS)
def test_trims_and_length_match_jax(w):
    rng = np.random.default_rng(w)
    rows = _rows(rng, N, w)
    for jcls, pcls in _TRIMS:
        got, want = _both(jcls(_ref(0)), pcls(_pref(0)), [rows])
        _assert_same(got, want)
        # the zero tail: nothing after each result's length
        out, _v, out_len = got
        assert not (out * (np.arange(w)[None, :] >= out_len[:, None])).any()
    got, want = _both(JS.Length(_ref(0)), PS.Length(_pref(0)), [rows])
    _assert_same(got, want)


def test_trims_of_spaces_only_and_python_strip():
    """Rows of spaces only trim to '', and each trim equals Python's
    strip/lstrip/rstrip of ' ' on the row's bytes."""
    rng = np.random.default_rng(5)
    data, lengths, valid = _rows(rng, N, 32, null_p=0.0)
    assert ((data == 32).sum(1) == lengths).sum() > 20
    t = [torch.from_numpy(a) for a in (data, lengths, valid)]
    for left, right, fn in ((True, True, bytes.strip),
                            (True, False, bytes.lstrip),
                            (False, True, bytes.rstrip)):
        out, ln, _v = OS.trim(*t, left, right)
        for i in range(N):
            want = fn(bytes(data[i, :lengths[i]]), b" ")
            assert bytes(out[i, :ln[i]].tolist()) == want


# ---------------------------------------------------------------------------
# K13g: StringLocate
# ---------------------------------------------------------------------------

_NEEDLES = ["", "a", "é", " a", "😀", "\x00", ",", "ab" * 40]


@pytest.mark.parametrize("w", [4, 16, 64])
def test_locate_literal_needles_match_jax(w):
    rng = np.random.default_rng(200 + w)
    rows = _rows(rng, N, w)
    s, ps = JT.StringType(), PT.StringType()
    for needle in _NEEDLES:
        for start in (-1, 0, 2, w // 2, w + 2):
            jexpr = JS.StringLocate(JC.Literal(needle, s), _ref(0), start)
            pexpr = PS.StringLocate(PC.Literal(needle, ps), _pref(0), start)
            got, want = _both(jexpr, pexpr, [rows])
            _assert_same(got, want)


@pytest.mark.parametrize("wa,wb", [(8, 8), (16, 4), (4, 32), (64, 16)])
def test_locate_column_needles_match_jax(wa, wb):
    rng = np.random.default_rng(300 + wa * wb)
    data, lengths, valid = _rows(rng, N, wa)
    ndata, nlengths, nvalid = _rows(rng, N, wb)
    # half the needles are a piece of the row itself, so that most match
    for i in range(0, N, 2):
        if lengths[i] and wb >= lengths[i]:
            lo = int(rng.integers(0, lengths[i]))
            hi = int(rng.integers(lo, lengths[i] + 1))
            ndata[i] = 0
            ndata[i, :hi - lo] = data[i, lo:hi]
            nlengths[i] = hi - lo
    for start in (-1, 1, 2, 3, wa + 2):
        got, want = _both(JS.StringLocate(_ref(0), _ref(1), start),
                          PS.StringLocate(_pref(0), _pref(1), start),
                          [(ndata, nlengths, nvalid),
                           (data, lengths, valid)])
        _assert_same(got, want)
        if start == 1:
            assert (got[0] > 0).sum() > N // 8


def test_locate_examples():
    """The reference's (and Spark's) answers on a few rows, and the
    empty-needle rule the reference follows: ``start`` while ``start -
    1`` is at most the character count (Spark's UTF8String.indexOf gives
    0 for an empty needle from any start, so Spark returns 1)."""
    words = ["WELLS FARGO BANK, N.A.", "héllo, w", "", "aaa"]
    w = 32
    data = np.zeros((4, w), np.uint8)
    for i, t in enumerate(words):
        bs = t.encode()
        data[i, :len(bs)] = np.frombuffer(bs, np.uint8)
    lengths = np.array([len(t.encode()) for t in words], np.int32)
    t = [torch.from_numpy(data), torch.from_numpy(lengths),
         torch.ones(4, dtype=torch.bool)]
    for needle, start, want in ((",", 1, [17, 6, 0, 0]),
                                ("BANK", 1, [13, 0, 0, 0]),
                                ("a", 2, [0, 0, 0, 2]),
                                ("l", 4, [0, 4, 0, 0]),
                                ("", 1, [1, 1, 1, 1]),
                                ("", 4, [4, 4, 0, 4]),
                                ("", 6, [6, 6, 0, 0]),
                                ("a", 0, [0, 0, 0, 0])):
        got, valid = OS.locate(*t, *OS.literal_needle(needle, CPU), start)
        assert got.tolist() == want, (needle, start)
        assert valid.all()


# ---------------------------------------------------------------------------
# K13h: SubstringIndex
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [4, 16, 64, 256])
@pytest.mark.parametrize("delim", [",", "/", " ", "\x00"])
def test_substring_index_matches_jax(w, delim):
    rng = np.random.default_rng(400 + w + ord(delim))
    rows = _rows(rng, N, w)
    for count in range(-4, 5):
        got, want = _both(JS.SubstringIndex(_ref(0), delim, count),
                          PS.SubstringIndex(_pref(0), delim, count), [rows])
        _assert_same(got, want)


def test_substring_index_against_python():
    """Each count equals Python's split and join on the row's bytes
    (Spark's substring_index), counts past the delimiters included."""
    rng = np.random.default_rng(9)
    data, lengths, valid = _rows(rng, N, 64)
    t = [torch.from_numpy(a) for a in (data, lengths, valid)]
    for count in (-70, -3, -1, 0, 1, 2, 70):
        out, ln, v = OS.substring_index(*t, ord(","), count)
        assert torch.equal(v, t[2])
        for i in range(N):
            parts = bytes(data[i, :lengths[i]]).split(b",")
            want = b"" if count == 0 else b",".join(
                parts[:count] if count > 0 else parts[count:])
            assert bytes(out[i, :ln[i]].tolist()) == want, (i, count)


@pytest.mark.parametrize("delim", ["é", ", ", "ab", ""])
def test_substring_index_wide_delimiter_raises(delim):
    rng = np.random.default_rng(1)
    d, ln, v = _rows(rng, 8, 16)
    e = PS.SubstringIndex(_pref(0), delim, 1)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        e.eval([_pval(d, v, PT.StringType(), ln)], _pctx(8))
    # the reference does not run it on its device either
    assert not JS.SubstringIndex(_ref(0), delim, 1).device_supported


# ---------------------------------------------------------------------------
# the two paths of bench/string_queries.py against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mortgage_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mortgage") / "sf005")
    assert pgen.generate_mortgage(d, sf=0.05, seed=11)
    return d


def _reference_read(session, d: str, table: str, columns):
    """The reference's per-file CSV scans of ``table`` over ``columns``,
    each with its literal quarter, unioned (its mortgage readers'
    ``_read_with_quarter`` with the columns the port's readers name)."""
    schema = jm.perf_schema() if table == "perf" else jm.acq_schema()
    prefix = "Performance_" if table == "perf" else "Acquisition_"
    dfs = [session.read_csv(p, schema=schema, header=False, delimiter="|",
                            columns=columns)
           .with_column("quarter", JC.lit(jm._quarter_of(p)))
           for p in sorted(glob.glob(os.path.join(d, table, prefix + "*")))]
    out = dfs[0]
    for df in dfs[1:]:
        out = out.union(df)
    return out


def _reference_path(name: str, session, d: str):
    """The path built with the reference's expressions over the
    reference's CSV scans."""
    col, lit = JC.col, JC.lit
    if name == "loan_period_span":
        p = col("monthly_reporting_period")
        period = JS.Concat(JS.SubstringIndex(p, "/", -1), lit("-"),
                           JS.SubstringIndex(p, "/", 1))
        per_loan = _reference_read(
            session, d, "perf", ["loan_id", "monthly_reporting_period"]) \
            .with_column("period", period) \
            .group_by("quarter", "loan_id").agg(
                JA.Min(col("period")).alias("first_period"),
                JA.Max(col("period")).alias("last_period"))
        return per_loan.group_by("quarter", "first_period").agg(
            JA.CountStar().alias("loans"),
            JA.Min(col("last_period")).alias("min_last_period"),
            JA.Max(col("last_period")).alias("max_last_period")) \
            .order_by(("quarter", True), ("first_period", True))
    name_ = col("seller_name")
    return _reference_read(session, d, "acq",
                           ["seller_name", "property_state"]) \
        .with_column("base", JS.StringTrimRight(
            JS.SubstringIndex(name_, ",", 1))) \
        .with_column("form", JS.StringTrim(
            JS.SubstringIndex(name_, ",", -1))) \
        .with_column("name_len", JS.Length(col("base"))) \
        .with_column("is_bank", JCond.If(
            JS.StringLocate(lit("BANK"), name_) > lit(0), lit(1), lit(0))) \
        .with_column("comma_at", JS.StringLocate(lit(","), name_, 2)) \
        .group_by("property_state", "form").agg(
            JA.CountStar().alias("sellers"),
            JA.Min(col("base")).alias("min_base"),
            JA.Max(col("base")).alias("max_base"),
            JA.Max(col("name_len")).alias("max_name_len"),
            JA.Sum(col("is_bank")).alias("banks"),
            JA.Max(col("comma_at")).alias("max_comma_at")) \
        .order_by(("property_state", True), ("form", True))


@pytest.mark.parametrize("name", sorted(SQ.STRING_PATHS))
def test_string_paths_match_jax(mortgage_dir, name):
    build, _table = SQ.STRING_PATHS[name]
    got = build(TorchSession(device="cpu"), mortgage_dir).collect()
    want = _reference_path(name, TpuSession({}), mortgage_dir).collect()
    assert got == want
    if name == "loan_period_span":
        # a loan without performance rows has no period
        assert len(got) >= 8 and 40 < sum(r[2] for r in got) <= 50
        assert all(r[1] <= r[3] <= r[4] for r in got)
    else:
        assert 40 < sum(r[2] for r in got) <= 50
        assert {r[1] for r in got} >= {"N.A.", "INC.", "OTHER"}
