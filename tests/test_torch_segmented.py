"""K4 segmented aggregation of the PyTorch/CUDA port against the JAX
package's ``sorted_group_by``, for every AggSpec op.

Both packages get the same seeded leaves (``ColumnBatch.from_leaves``).
Integers, booleans, dates and strings must match exactly; float64 results
within rtol=1e-12 (both sum the same values in row order on the CPU), with
NaN equal to NaN.  The CUDA kernel is held against the plain version by
the ``cuda``-marked test and chip_smoke.py on the card.
"""
import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu.ops import segmented as jsg
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops import segmented as psg

CPU = torch.device("cpu")

# value columns: 2 l:int64  3 d:double  4 dt:date  5 b:bool  6 t:string
_OPS = [("sum", 2), ("sum", 3), ("count", 3), ("count", 6),
        ("count_star", 0), ("min", 2), ("max", 2), ("min", 3), ("max", 3),
        ("min", 4), ("max", 4), ("min", 5), ("max", 5), ("min", 6),
        ("max", 6), ("avg", 2), ("avg", 3), ("first", 3), ("last", 3),
        ("first_non_null", 3), ("last_non_null", 3), ("first", 6),
        ("last_non_null", 6)]


def _record_batch(rng, n: int) -> pa.RecordBatch:
    def nulls(p=0.12):
        return rng.random(n) < p

    keys = np.array(["x", "y", "", "zz"], dtype=object)
    text = np.array(["", "a", "ab", "b", "abc", "zzz"], dtype=object)
    return pa.RecordBatch.from_arrays([
        pa.array(list(keys[rng.integers(0, 4, n)]), type=pa.string(),
                 mask=nulls(0.05)),
        pa.array(rng.integers(0, 3, n).astype(np.int32), mask=nulls(0.05)),
        pa.array(rng.integers(-10**12, 10**12, n), mask=nulls()),
        pa.array(rng.choice([-1.25, -0.0, 0.0, 3.5, np.nan, 1e300, -7.0],
                            n) * rng.random(n), mask=nulls()),
        pa.array(rng.integers(0, 40000, n).astype(np.int32),
                 mask=nulls()).cast(pa.date32()),
        pa.array(rng.random(n) < 0.5, mask=nulls()),
        pa.array(list(text[rng.integers(0, len(text), n)]), type=pa.string(),
                 mask=nulls()),
    ], names=["k", "g", "l", "d", "dt", "b", "t"])


def _run_both(rb, key_indices, specs):
    jb = JBatch.from_arrow(rb)
    n = int(jax.device_get(jb.num_rows))
    leaves = jax.device_get([(c.data, c.validity, c.lengths)
                             for c in jb.columns])
    pb = PBatch.from_leaves(rb.schema, leaves, n, CPU)
    jout = jsg.sorted_group_by(jb, key_indices,
                               [jsg.AggSpec(o, c, p) for o, c, p in specs])
    pout = psg.sorted_group_by(pb, key_indices,
                               [psg.AggSpec(o, c, p) for o, c, p in specs])
    g = int(jax.device_get(jout.num_rows))
    jcols = jax.device_get([(c.data, c.validity, c.lengths)
                            for c in jout.columns])
    return g, jout, jcols, pout


def _assert_col(pc, jc, g, what):
    jd, jv, jl = (None if a is None else np.asarray(a)[:g] for a in jc)
    np.testing.assert_array_equal(pc.validity.numpy(), jv, err_msg=what)
    pd = pc.data.numpy()
    if pd.dtype.kind == "f":
        np.testing.assert_allclose(pd, jd, rtol=1e-12, atol=0.0,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(pd, jd, err_msg=what)
    if jl is not None:
        np.testing.assert_array_equal(pc.lengths.numpy(), jl, err_msg=what)


@pytest.fixture(scope="module")
def grouped():
    rng = np.random.default_rng(2026)
    return _run_both(_record_batch(rng, 900), [0, 1],
                     [(o, c, None) for o, c in _OPS])


@pytest.fixture(scope="module")
def grand():
    rng = np.random.default_rng(7)
    return _run_both(_record_batch(rng, 500), [],
                     [(o, c, None) for o, c in _OPS])


@pytest.mark.parametrize("i", range(len(_OPS)),
                         ids=[f"{o}-{c}" for o, c in _OPS])
def test_grouped_op_matches_jax(grouped, i):
    g, jout, jcols, pout = grouped
    assert pout.num_rows == g
    assert pout.schema.names == jout.schema.names
    _assert_col(pout.columns[2 + i], jcols[2 + i], g, str(_OPS[i]))


def test_grouped_keys_match_jax(grouped):
    g, _jout, jcols, pout = grouped
    assert g > 8  # nulls form their own groups
    for k in range(2):
        _assert_col(pout.columns[k], jcols[k], g, f"key {k}")


@pytest.mark.parametrize("i", range(len(_OPS)),
                         ids=[f"{o}-{c}" for o, c in _OPS])
def test_grand_aggregate_op_matches_jax(grand, i):
    g, _jout, jcols, pout = grand
    assert pout.num_rows == g == 1
    _assert_col(pout.columns[i], jcols[i], 1, str(_OPS[i]))


def test_percentile_matches_jax():
    rng = np.random.default_rng(3)
    specs = [("percentile", 3, 0.0), ("percentile", 3, 0.5),
             ("percentile", 3, 0.9), ("count", 3, None)]
    g, _jout, jcols, pout = _run_both(_record_batch(rng, 400), [1], specs)
    assert pout.num_rows == g
    for i in range(len(specs)):
        _assert_col(pout.columns[1 + i], jcols[1 + i], g, str(specs[i]))


def test_empty_grand_aggregate_matches_jax():
    rng = np.random.default_rng(4)
    specs = [("count_star", 0, None), ("sum", 3, None), ("count", 2, None),
             ("min", 6, None), ("avg", 2, None)]
    g, _jout, jcols, pout = _run_both(_record_batch(rng, 0), [], specs)
    assert pout.num_rows == g == 1
    for i in range(len(specs)):
        _assert_col(pout.columns[i], jcols[i], 1, str(specs[i]))


def test_cuda_path_refuses_uncovered_ops():
    """Every op of the reference has a CUDA path -- string min/max runs
    K4s, percentile K4p -- and an op outside them raises."""
    rng = np.random.default_rng(8)
    pb = PBatch.from_arrow(_record_batch(rng, 10), CPU)
    psg._check_cuda_covered(pb, [psg.AggSpec("min", 6),
                                 psg.AggSpec("max", 6),
                                 psg.AggSpec("min", 3),
                                 psg.AggSpec("first", 6),
                                 psg.AggSpec("percentile", 3, 0.5)])
    with pytest.raises(NotImplementedError, match="aggregate op median"):
        psg._check_cuda_covered(pb, [psg.AggSpec("median", 3)])


def _string_minmax_batch(rng, n: int, w: int) -> pa.RecordBatch:
    """Groups of every size -- one giant group (a third of the rows),
    one-row groups, all-null groups -- over strings of up to ``w`` bytes:
    NUL-tail ties ('ab', 'ab\\0', 'ab\\0\\0'), 2- and 4-byte characters,
    empty strings, nulls, and long rows that differ only in their last
    byte, so that rows compare over more than one word."""
    g = np.concatenate([np.zeros(n // 3, np.int32),
                        rng.integers(1, 40, n - n // 3 - 60).astype(np.int32),
                        np.arange(100, 160, dtype=np.int32)])  # one-row
    pool = ["", "a", "ab", "ab\x00", "ab\x00\x00", "b", "\x00", "é", "e",
            "😀", "zz", "Z"]
    pool += ["x" * (w - 1) + c for c in "ab"] + ["x" * (w - 2) + "\x00"]
    vals = np.array(pool, dtype=object)[rng.integers(0, len(pool), n)]
    null = rng.random(n) < 0.15
    null |= (g == 7) | (g == 130)                             # all null
    perm = rng.permutation(n)
    return pa.RecordBatch.from_arrays(
        [pa.array(g[perm]), pa.array(list(vals[perm]), type=pa.string(),
                                     mask=null[perm])], names=["g", "s"])


@pytest.mark.parametrize("w", [4, 16, 64])
@pytest.mark.parametrize("keys", [[0], []], ids=["grouped", "grand"])
def test_string_min_max_fuzz_matches_jax(keys, w):
    rng = np.random.default_rng(w + len(keys))
    specs = [("min", 1, None), ("max", 1, None), ("count", 1, None)]
    g, _jout, jcols, pout = _run_both(_string_minmax_batch(rng, 700, w),
                                      keys, specs)
    assert pout.num_rows == g
    assert pout.columns[len(keys)].data.shape[1] == w
    for i in range(len(keys) + len(specs)):
        _assert_col(pout.columns[i], jcols[i], g, f"column {i}")
    if keys:  # the all-null groups are null
        gk = pout.columns[0].data.numpy()
        for k in (7, 130):
            assert not pout.columns[1].validity.numpy()[gk == k].any()


def test_segment_string_min_max_plain_wrapper():
    """K4s's plain version from the boundary pass's flags and starts
    equals the aggregate's string min/max."""
    rng = np.random.default_rng(12)
    pb = PBatch.from_arrow(_string_minmax_batch(rng, 500, 16), CPU)
    sb = psg.sort_batch(pb, [psg.SortOrder(0, True, True)])
    keys = sb.columns[0].data
    flags = torch.ones(sb.num_rows, dtype=torch.uint8)
    flags[1:] = (keys[1:] != keys[:-1]).to(torch.uint8)
    starts = torch.nonzero(flags).squeeze(1).to(torch.int32)
    _k, aggs, g = psg.segment_aggregate(sb, [0], [psg.AggSpec("min", 1),
                                                  psg.AggSpec("max", 1)])
    assert g == starts.numel()
    for is_max, want in ((False, aggs[0]), (True, aggs[1])):
        before = psg.segment_string_min_max.launches
        got = psg.segment_string_min_max(sb.columns[1], flags, starts,
                                         is_max)
        assert psg.segment_string_min_max.launches == before  # the CPU
        for a, b in ((got.data, want.data), (got.validity, want.validity),
                     (got.lengths, want.lengths)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="over"):
        psg.segment_string_min_max(sb.columns[0], flags, starts, False)


def _percentile_batch(rng, n: int) -> pa.RecordBatch:
    """Groups of every size: one giant group, one-row groups, all-null
    groups; values with NaN, +-inf, -0.0, ties and nulls."""
    g = np.concatenate([np.zeros(n // 3, np.int32),
                        rng.integers(1, 40, n - n // 3 - 60).astype(np.int32),
                        np.arange(100, 160, dtype=np.int32)])  # one-row
    v = rng.choice([-2.5, -0.0, 0.0, 1.0, 1.0, 7.25, np.nan, np.inf,
                    -np.inf, 3.0], n) + np.where(rng.random(n) < 0.5,
                                                 rng.random(n), 0.0)
    null = rng.random(n) < 0.15
    null |= (g == 7) | (g == 130)                             # all null
    perm = rng.permutation(n)
    return pa.RecordBatch.from_arrays(
        [pa.array(g[perm]), pa.array(v[perm], mask=null[perm])],
        names=["g", "v"])


_QS = [0.0, 0.25, 0.5, 0.9, 0.99, 1.0]


@pytest.mark.parametrize("keys", [[0], []], ids=["grouped", "grand"])
def test_percentile_fuzz_matches_jax(keys):
    """Every q in [0, 1] over fuzzed groups, against the reference's
    sorted_group_by: validity exactly, values exactly (NaN equal to NaN;
    inf - inf interpolates to NaN in both), the valid counts beside."""
    rng = np.random.default_rng(31)
    specs = [("percentile", 1, q) for q in _QS] + [("count", 1, None)]
    g, _jout, jcols, pout = _run_both(_percentile_batch(rng, 3000), keys,
                                      specs)
    assert pout.num_rows == g and g == (len(np.unique(
        _percentile_batch(np.random.default_rng(31), 3000)
        .column(0).to_numpy())) if keys else 1)
    k = len(keys)
    for i, spec in enumerate(specs):
        jd, jv, _jl = (None if a is None else np.asarray(a)[:g]
                       for a in jcols[k + i])
        pc = pout.columns[k + i]
        np.testing.assert_array_equal(pc.validity.numpy(), jv,
                                      err_msg=str(spec))
        np.testing.assert_array_equal(pc.data.numpy(), jd, err_msg=str(spec))
    if keys:
        valid = pout.columns[1].validity.numpy()
        assert not valid.all() and valid.any()  # all-null groups are null
        assert np.isnan(pout.columns[4].data.numpy()).any()


def test_segment_percentile_wrapper(monkeypatch):
    """K4p's wrapper: the plain version on the CPU (no launch counted),
    the kernel or an error elsewhere, q checked; interpolation by hand."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel")

    monkeypatch.setattr(native, "lib", no_kernel)
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="no segmented kernel"):
        psg.segment_percentile(
            torch.zeros(4, dtype=torch.float64, device=meta),
            torch.zeros(1, dtype=torch.int32, device=meta),
            torch.ones(1, dtype=torch.int64, device=meta), [0.5])
    vals = torch.tensor([1.0, 2.0, 4.0, 10.0, 5.0, np.inf, np.inf],
                        dtype=torch.float64)
    starts = torch.tensor([0, 4, 4, 5], dtype=torch.int32)
    counts = torch.tensor([4, 1, 0, 2])
    before = psg.segment_percentile.launches
    data, valid = psg.segment_percentile(vals, starts, counts, [0.0, 0.5, 1.0])
    assert psg.segment_percentile.launches == before
    assert valid.tolist() == [[True, True, False, True]] * 3
    assert data[:, 0].tolist() == [1.0, 3.0, 10.0]
    assert data[:, 1].tolist() == [5.0, 5.0, 5.0]
    assert data[:, 2].tolist() == [0.0, 0.0, 0.0]
    assert torch.isnan(data[:, 3]).all()  # inf + (inf - inf) * frac
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        psg.segment_percentile(vals, starts, counts, [1.5])
