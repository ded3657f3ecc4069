"""K12 window kernels of the PyTorch/CUDA port against the JAX package's
``spark_rapids_tpu/ops/window.py``, function by function.

Both packages get the same seeded leaves: the reference sorts the batch by
(partition keys ascending nulls first, order keys) and the port receives
the sorted reference leaves (``ColumnBatch.from_leaves``), so both see the
same rows in the same order; the reference's outputs are compared over
its first ``num_rows`` rows (it pads to a power-of-two capacity).

Integers match exactly.  Float64 frame sums and averages match within
rtol 1e-12 plus 8 ulps of the batch's sum of magnitudes: both packages
difference prefix sums over the whole batch, and the two cumsums round
differently.  The reference's prefix sums run through NaN and +-inf,
which turns every later frame's difference into NaN; the port counts the
non-finite values apart (Spark's sum), so sums over special values are
held against a row-by-row numpy evaluation instead.  Min/max compare
exactly, NaN equal to NaN.  On the card, ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the CUDA kernels against these plain versions.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu.ops import sort as jsort
from spark_rapids_tpu.ops import window as JW
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.ops import window as PW

CPU = torch.device("cpu")
N = 1500

# columns: 0 p:int32  1 s:string  2 l:int64  3 d:double (finite, -0.0)
#          4 x:double (NaN, +-inf, -0.0, 1e300)  5 dt:date  6 b:bool
#          7 nul:int32 (all null)  8 h:int16
#          9 y:double (finite, with NaN, +-inf, -0.0: the sums over special
#            values; magnitudes 1e16 apart would lose the smaller ones in
#            any whole-batch prefix difference)


def _record_batch(rng, n: int) -> pa.RecordBatch:
    def nulls(p=0.1):
        return rng.random(n) < p

    words = np.array(["", "a", "ab", "b", "héllo", "a longer word"],
                     dtype=object)
    d = np.round(rng.normal(size=n) * 100, 2)
    d[rng.random(n) < 0.05] = -0.0
    return pa.RecordBatch.from_arrays([
        pa.array(rng.integers(0, 40, n).astype(np.int32), mask=nulls(0.05)),
        pa.array(list(words[rng.integers(0, len(words), n)]),
                 type=pa.string(), mask=nulls(0.05)),
        pa.array(rng.integers(-10**12, 10**12, n), mask=nulls()),
        pa.array(d, mask=nulls()),
        pa.array(rng.choice([-2.5, -0.0, 0.0, 1.0, np.nan, np.inf, -np.inf,
                             1e300, -1e300], n), mask=nulls()),
        pa.array(rng.integers(0, 30, n).astype(np.int32),
                 mask=nulls()).cast(pa.date32()),
        pa.array(rng.random(n) < 0.5, mask=nulls()),
        pa.array(np.zeros(n, np.int32), mask=np.ones(n, bool)),
        pa.array(rng.integers(-300, 300, n).astype(np.int16), mask=nulls()),
        pa.array(np.where(rng.random(n) < 0.1,
                          rng.choice([np.nan, np.inf, -np.inf, -0.0], n), d),
                 mask=nulls()),
    ], names=["p", "s", "l", "d", "x", "dt", "b", "nul", "h", "y"])


_BATCHES = {}


def _sorted_pair(seed: int, part, order):
    """(reference sorted batch, port batch of the same rows, n)."""
    key = (seed, tuple(part), tuple(order))
    if key not in _BATCHES:
        rb = _record_batch(np.random.default_rng(seed), N)
        jb = JBatch.from_arrow(rb)
        orders = [jsort.SortOrder(i, True, True) for i in part] + \
            [jsort.SortOrder(i, True, None) for i in order]
        jsb = jsort.sort_batch(jb, orders) if orders else jb
        n = int(jax.device_get(jsb.num_rows))
        leaves = jax.device_get([(c.data, c.validity, c.lengths)
                                 for c in jsb.columns])
        _BATCHES[key] = (jsb, PBatch.from_leaves(rb.schema, leaves, n, CPU),
                         n)
    return _BATCHES[key]


def _np(x, n):
    return np.asarray(jax.device_get(x))[:n]


_KEYS = [((0,), (3,)), ((1,), (2, 5)), ((), (1,)), ((0, 1), ()), ((), ()),
         ((7,), (4,)), ((0,), (6,))]


@pytest.mark.parametrize("part,order", _KEYS)
def test_sorted_segments_and_ranking_match_jax(part, order):
    jsb, psb, n = _sorted_pair(5, part, order)
    jseg = JW.sorted_segments(jsb, part, order)
    pseg = PW.sorted_segments(psb, part, order)
    for f in ("seg_start", "seg_end", "peer_start", "peer_end", "seg_id"):
        assert np.array_equal(getattr(pseg, f).numpy(),
                              _np(getattr(jseg, f), n)), f
    for jf, pf in ((JW.row_number, PW.row_number), (JW.rank, PW.rank),
                   (JW.dense_rank, PW.dense_rank)):
        assert np.array_equal(pf(pseg).numpy(), _np(jf(jseg), n))


_FRAMES = [("rows", None, 0), ("rows", None, None), ("rows", -3, 2),
           ("rows", 2, 5), ("rows", None, 3), ("rows", -2, None),
           ("rows", 0, 0), ("rows", -5000, 4000), ("range", None, 0),
           ("range", 0, 0), ("range", 0, None), ("range", None, None)]

#: (op, value columns) compared with the reference
_AGGS = [("sum", (0, 2, 3, 8, 7)), ("count", (1, 4, 7)),
         ("avg", (0, 2, 3, 7)), ("min", (0, 2, 4, 5, 6, 7, 8)),
         ("max", (0, 2, 4, 5, 6, 7, 8))]


def _close_f64(got, want, x):
    atol = 8 * np.finfo(np.float64).eps * float(np.nansum(np.abs(
        np.where(np.isfinite(x), x, 0.0))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=atol)


@pytest.mark.parametrize("frame", _FRAMES)
@pytest.mark.parametrize("op,cols", _AGGS)
def test_frame_aggregates_match_jax(op, cols, frame):
    part, order = (0,), (5,)
    jsb, psb, n = _sorted_pair(11, part, order)
    jseg = JW.sorted_segments(jsb, part, order)
    pseg = PW.sorted_segments(psb, part, order)
    fr_j = JW.WindowFrame(*frame)
    fr_p = PW.WindowFrame(*frame)
    for ci in cols:
        jd, jv, jt = JW.running_or_bounded_agg(op, jsb.columns[ci], jseg,
                                               fr_j)
        pd, pv, pt = PW.running_or_bounded_agg(op, psb.columns[ci], pseg,
                                               fr_p)
        jv = _np(jv, n)
        assert pt.name == jt.name, (op, ci)
        assert np.array_equal(pv.numpy(), jv), (op, ci)
        got, want = pd.numpy()[jv], _np(jd, n)[jv]
        assert not pd.numpy()[~jv].any(), "null slots hold zeros"
        if got.dtype.kind == "f":
            if op in ("min", "max"):
                np.testing.assert_array_equal(got, want)
            else:
                _close_f64(got, want, psb.columns[ci].data.double().numpy())
        else:
            assert np.array_equal(got, want), (op, ci)


def _spark_frame_sum(x, valid, lo, hi, avg: bool):
    """Spark's sum/avg of each row's frame, row by row (None = null)."""
    out = []
    for a, b in zip(lo, hi):
        vals = [float(x[j]) for j in range(a, b + 1) if valid[j]]
        if not vals:
            out.append(None)
            continue
        s = math.fsum(vals) if all(math.isfinite(v) for v in vals) \
            else sum(vals)
        out.append(s / len(vals) if avg else s)
    return out


@pytest.mark.parametrize("frame", [("rows", None, 0), ("rows", -3, 2),
                                   ("range", 0, None), ("rows", 2, 5)])
@pytest.mark.parametrize("op", ["sum", "avg"])
def test_frame_sums_over_special_values(op, frame):
    """NaN and +-inf inside a frame give Spark's NaN/inf; outside it they
    do not touch its sum (the reference's whole-batch prefix differences
    would turn every later frame into NaN)."""
    part, order = (0,), (5,)
    _jsb, psb, n = _sorted_pair(13, part, order)
    seg = PW.sorted_segments(psb, part, order)
    col = psb.columns[9]
    fr = PW.WindowFrame(*frame)
    data, valid, _t = PW.running_or_bounded_agg(op, col, seg, fr)
    lo, hi = PW._frame_edges(seg, fr)
    want = _spark_frame_sum(col.data.numpy(), col.validity.numpy(),
                            lo.numpy(), hi.numpy(), op == "avg")
    finite = 0
    for i, w in enumerate(want):
        assert bool(valid[i]) == (w is not None), i
        if w is None:
            continue
        g = float(data[i])
        finite += math.isfinite(w)
        assert (math.isnan(g) and math.isnan(w)) or g == w or \
            math.isclose(g, w, rel_tol=1e-12, abs_tol=1e-9), (i, g, w)
    assert finite > n // 10


_LEAD = [(2, 1), (2, -1), (3, 3), (1, -2), (1, 1), (5, -1)]


@pytest.mark.parametrize("with_default", [False, True])
@pytest.mark.parametrize("ci,offset", _LEAD)
def test_lead_lag_matches_jax(ci, offset, with_default):
    part, order = (0,), (2,)
    jsb, psb, n = _sorted_pair(17, part, order)
    jseg = JW.sorted_segments(jsb, part, order)
    pseg = PW.sorted_segments(psb, part, order)
    jcol, pcol = jsb.columns[ci], psb.columns[ci]
    cap = jsb.capacity
    jdef, pdef = (None,) * 3, (None,) * 3
    if with_default:
        if pcol.is_string:
            word = "a default longer than any row of the column"
            bs = np.frombuffer(word.encode(), np.uint8)
            row = np.zeros(64, np.uint8)
            row[:len(bs)] = bs
            jdef = (jnp.broadcast_to(jnp.asarray(row), (cap, 64)),
                    jnp.ones(cap, jnp.bool_), jnp.full(cap, len(bs),
                                                       jnp.int32))
            pdef = (torch.from_numpy(row).expand(n, 64),
                    torch.ones(n, dtype=torch.bool),
                    torch.full((n,), len(bs), dtype=torch.int32))
        else:
            v = 7 if pcol.data.dtype != torch.float64 else 7.5
            jdef = (jnp.full(cap, v, jcol.data.dtype),
                    jnp.ones(cap, jnp.bool_), None)
            pdef = (torch.full((n,), v, dtype=pcol.data.dtype),
                    torch.ones(n, dtype=torch.bool), None)
    jd, jv, jl = JW.lead_lag(jcol, jseg, offset, *jdef)
    pd, pv, pl = PW.lead_lag(pcol, pseg, offset, *pdef)
    jv = _np(jv, n)
    assert np.array_equal(pv.numpy(), jv)
    want = _np(jd, n)
    if pcol.is_string:
        w = want.shape[1]
        got = torch.nn.functional.pad(pd, (0, max(0, w - pd.shape[1])))
        assert np.array_equal(got.numpy()[:, :w][jv], want[jv])
        assert np.array_equal(pl.numpy()[jv], _np(jl, n)[jv])
    else:
        np.testing.assert_array_equal(pd.numpy()[jv], want[jv])


def test_window_agg_rejects_string_min_max():
    part, order = (0,), (5,)
    _jsb, psb, _n = _sorted_pair(11, part, order)
    seg = PW.sorted_segments(psb, part, order)
    with pytest.raises(NotImplementedError, match="strings"):
        PW.running_or_bounded_agg("max", psb.columns[1], seg,
                                  PW.WindowFrame("rows", None, 0))


def test_empty_batch():
    rb = _record_batch(np.random.default_rng(1), 0)
    pb = PBatch.from_arrow(rb, CPU)
    seg = PW.sorted_segments(pb, (0,), (5,))
    assert seg.seg_start.numel() == 0
    data, valid, _t = PW.running_or_bounded_agg(
        "sum", pb.columns[3], seg, PW.WindowFrame("rows", None, 0))
    assert data.numel() == 0 and valid.numel() == 0
