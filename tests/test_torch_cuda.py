"""The port's CUDA kernels held against their plain PyTorch versions on the
card.  Every test is marked ``cuda`` and skips without a CUDA device.

The module imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.bench import tpch_gen
from spark_rapids_tpu_torch.bench.tpch_queries import q1
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import segmented as G
from spark_rapids_tpu_torch.ops import sort as S

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _record_batch(rng, n: int, null_p: float = 0.1) -> pa.RecordBatch:
    """Strings, ints, longs, doubles (NaN, -0.0), dates and bools, with
    nulls; few distinct keys so groups and ties are large."""
    def nulls():
        return rng.random(n) < null_p

    words = np.array(["", "a", "ab", "abc", "b", "ba", "zz", "a\x00",
                      "abcdefgh", "abcdefgi", "longer string here"],
                     dtype=object)
    return pa.RecordBatch.from_arrays([
        pa.array(list(words[rng.integers(0, len(words), n)]),
                 type=pa.string(), mask=nulls()),
        pa.array(rng.integers(-4, 4, n).astype(np.int32), mask=nulls()),
        pa.array(rng.integers(-3, 3, n) * (2 ** 40), mask=nulls()),
        pa.array(rng.choice([-2.5, -0.0, 0.0, 1.0, np.nan, np.inf, -1e300],
                            n), mask=nulls()),
        pa.array(rng.integers(0, 5, n).astype(np.int32),
                 mask=nulls()).cast(pa.date32()),
        pa.array(rng.random(n) < 0.5, mask=nulls()),
        pa.array(rng.integers(-100, 100, n).astype(np.int16), mask=nulls()),
    ], names=["s", "i", "l", "d", "dt", "b", "h"])


def _same(a, b):
    assert torch.equal(a.validity, b.validity)
    assert a.data.shape == b.data.shape
    if a.data.dtype.is_floating_point:
        torch.testing.assert_close(a.data, b.data, rtol=0.0, atol=0.0,
                                   equal_nan=True)
    else:
        assert torch.equal(a.data, b.data)
    if a.lengths is not None:
        assert torch.equal(a.lengths, b.lengths)


@pytest.mark.parametrize("p_keep", [0.0, 0.3, 1.0])
def test_compact_matches_plain(dev, p_keep):
    rng = np.random.default_rng(23)
    pb = ColumnBatch.from_arrow(_record_batch(rng, 10_007), dev)
    keep = torch.from_numpy(rng.random(10_007) < p_keep).to(dev)
    before = K.compact.launches
    got, want = K.compact(pb, keep), K.compact_plain(pb, keep)
    assert K.compact.launches == before + 1
    assert got.num_rows == want.num_rows
    for a, b in zip(got.columns, want.columns):
        _same(a, b)


def test_gather_matches_plain(dev):
    rng = np.random.default_rng(29)
    pb = ColumnBatch.from_arrow(_record_batch(rng, 10_000), dev)
    perm = torch.from_numpy(rng.integers(-1, 10_000, 5000)
                            .astype(np.int32)).to(dev)
    before = K.gather_columns.launches
    for a, b in zip(K.gather_columns(pb.columns, perm),
                    K.gather_plain(pb.columns, perm)):
        _same(a, b)
    assert K.gather_columns.launches == before + 1


def _gather_cols(g, n: int, dev, offset: int = 0):
    """Every fixed width (int8..int64, f32, f64, bool), strings at W 1-64
    (NUL tails, nulls; row-offset slices misalign them by ``offset``
    rows), an int64 array column; null slots zeroed."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    n1 = n + offset
    cols = []
    for dt, tt in ((torch.int8, T.ByteType()), (torch.int16, T.ShortType()),
                   (torch.int32, T.IntegerType()), (torch.int64, T.LongType()),
                   (torch.float32, T.FloatType()),
                   (torch.float64, T.DoubleType())):
        v = torch.rand(n, generator=g, device=dev) < 0.9
        x = torch.randint(-100, 100, (n,), generator=g, device=dev).to(dt)
        cols.append(_int_key(x, v, tt))
    v = torch.rand(n, generator=g, device=dev) < 0.9
    cols.append(_int_key(torch.rand(n, generator=g, device=dev) < 0.5, v,
                         T.BooleanType()))
    for w in (1, 3, 4, 8, 12, 13, 16, 17, 32, 33, 64):
        v = torch.rand(n1, generator=g, device=dev) < 0.9
        lens = torch.randint(0, w + 1, (n1,), generator=g, device=dev,
                             dtype=torch.int32)
        mat = torch.randint(0, 256, (n1, w), generator=g, device=dev,
                            dtype=torch.uint8)
        mat[torch.arange(w, device=dev)[None, :] >= lens[:, None]] = 0
        mat[~v] = 0
        lens = torch.where(v, lens, 0)
        cols.append(DeviceColumn(mat[offset:], v[offset:], T.StringType(),
                                 lens[offset:]))
    v = torch.rand(n, generator=g, device=dev) < 0.9
    lens = torch.where(v, torch.randint(0, 4, (n,), generator=g, device=dev,
                                        dtype=torch.int32), 0)
    arr = torch.randint(-2 ** 40, 2 ** 40, (n, 3), generator=g, device=dev)
    arr[torch.arange(3, device=dev)[None, :] >= lens[:, None]] = 0
    cols.append(DeviceColumn(arr, v, T.ArrayType(T.LongType()), lens))
    return cols


@pytest.mark.parametrize("m", [1, 7, 2047, 2048, 2049, 4095, 4097,
                               (1 << 22) + 1])
def test_gather_one_launch_matches_plain(dev, m):
    """K3 at its tile and run edges over every column kind, aligned and
    misaligned string matrices, indices with negatives, a source without
    rows, and a permutation that starts 4 bytes into its allocation (no
    16-byte index loads): one launch a call, equal to the plain
    version."""
    g = torch.Generator(device=dev)
    g.manual_seed(m)
    n = 5000
    for offset in (0, 1):
        cols = _gather_cols(g, n, dev, offset)
        idx = torch.randint(-2, n, (m + 1,), generator=g, device=dev,
                            dtype=torch.int32)
        for perm in (idx[:m], idx[1:]):
            before = K.gather_columns.launches
            got = K.gather_columns(cols, perm)
            assert K.gather_columns.launches == before + 1
            for a, b in zip(got, K.gather_plain(cols, perm)):
                _same(a, b)
    empty = [type(c)(c.data[:0], c.validity[:0], c.dtype,
                     None if c.lengths is None else c.lengths[:0])
             for c in cols]
    perm = torch.full((m,), -1, dtype=torch.int32, device=dev)
    for a, b in zip(K.gather_columns(empty, perm),
                    K.gather_plain(empty, perm)):
        _same(a, b)


def test_gather_long_table_and_zero_rows(dev):
    """More columns than the kernel's parameters hold (the table is read
    from a device copy) in one launch; a 0-row perm launches nothing."""
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    base = _gather_cols(g, 3000, dev)
    cols = base * (K.GATHER_PARAM_WORDS // K.GATHER_COL_WORDS // len(base)
                   + 1)
    assert len(cols) * K.GATHER_COL_WORDS > K.GATHER_PARAM_WORDS
    perm = torch.randint(-1, 3000, (10_001,), generator=g, device=dev,
                         dtype=torch.int32)
    before = K.gather_columns.launches
    got = K.gather_columns(cols, perm)
    assert K.gather_columns.launches == before + 1
    for a, b in zip(got, K.gather_plain(cols, perm)):
        _same(a, b)
    out = K.gather_columns(base, perm[:0])
    assert K.gather_columns.launches == before + 1
    assert [o.capacity for o in out] == [0] * len(base)


@pytest.mark.parametrize("keys", [
    [(0, True, None), (3, False, None)],
    [(2, False, True), (5, True, False), (4, True, None), (1, False, None)],
    [(6, True, False), (0, False, True)],
])
def test_radix_sort_matches_plain(dev, keys):
    rng = np.random.default_rng(13)
    pb = ColumnBatch.from_arrow(_record_batch(rng, 50_000), dev)
    orders = [S.SortOrder(i, a, nf) for i, a, nf in keys]
    assert torch.equal(S.sort_permutation(pb, orders),
                       S.sort_permutation_plain(pb, orders))


def test_segment_aggregate_matches_plain(dev):
    rng = np.random.default_rng(21)
    pb = ColumnBatch.from_arrow(_record_batch(rng, 100_000), dev)
    sb = S.sort_batch(pb, [S.SortOrder(0, True, True),
                           S.SortOrder(1, True, True)])
    specs = [G.AggSpec(op, c) for op, c in [
        ("sum", 2), ("sum", 3), ("sum", 6), ("count", 3), ("count_star", 0),
        ("min", 2), ("max", 2), ("min", 3), ("max", 3), ("min", 4),
        ("max", 5), ("min", 6), ("avg", 2), ("avg", 3), ("first", 3),
        ("last", 0), ("first_non_null", 3), ("last_non_null", 0)]]
    gk, ga, g = G.segment_aggregate(sb, [0, 1], specs)
    wk, wa, wg = G.segment_aggregate_plain(sb, [0, 1], specs)
    assert g == wg
    for a, b in zip(gk, wk):
        _same(a, b)
    for spec, a, b in zip(specs, ga, wa):
        assert torch.equal(a.validity, b.validity), spec
        if a.data.dtype.is_floating_point and spec.op in ("sum", "avg"):
            # sums in another order: tile tree vs index_add_
            torch.testing.assert_close(a.data, b.data, rtol=1e-9, atol=0.0,
                                       equal_nan=True)
        else:
            _same(a, b)


def test_grand_aggregate_and_empty_input(dev):
    rng = np.random.default_rng(2)
    pb = ColumnBatch.from_arrow(_record_batch(rng, 5000), dev)
    specs = [G.AggSpec("sum", 3), G.AggSpec("count_star", 0),
             G.AggSpec("max", 3), G.AggSpec("first", 0)]
    for batch in (pb, K.slice_rows(pb, 0, 0)):
        gk, ga, g = G.segment_aggregate(batch, [], specs)
        wk, wa, wg = G.segment_aggregate_plain(batch, [], specs)
        assert g == wg == 1
        for spec, a, b in zip(specs, ga, wa):
            assert torch.equal(a.validity, b.validity), spec
            torch.testing.assert_close(a.data, b.data, rtol=1e-9, atol=0.0,
                                       equal_nan=True)


def test_uncovered_ops_raise_on_cuda(dev):
    """An op outside the reference's raises on the card; string min/max
    runs K4s and equals the plain version."""
    rng = np.random.default_rng(3)
    pb = ColumnBatch.from_arrow(_record_batch(rng, 100), dev)
    with pytest.raises(NotImplementedError, match="aggregate op median"):
        G.segment_aggregate(pb, [1], [G.AggSpec("median", 2)])
    sb = S.sort_batch(pb, [S.SortOrder(1, True, True)])
    specs = [G.AggSpec("min", 0), G.AggSpec("max", 0)]
    before = G.segment_string_min_max.launches
    gk, ga, g = G.segment_aggregate(sb, [1], specs)
    assert G.segment_string_min_max.launches == before + 2
    wk, wa, wg = G.segment_aggregate_plain(sb, [1], specs)
    assert g == wg
    for a, b in zip(gk + ga, wk + wa):
        _same(a, b)


def _k4s_batch(dev, rng, n: int, w: int, groups: int):
    """n rows sorted by an int key of ``groups`` groups (0: one group per
    row), strings of up to w bytes drawn from a pool with NUL-tail ties
    and rows that differ only in their last byte; a tenth null, groups 3
    and 5 all null."""
    key = np.sort(rng.integers(0, groups, n)) if groups else np.arange(n)
    pool = ["", "a", "ab", "ab\x00", "ab\x00\x00", "b", "é", "😀", "zz"]
    pool += ["x" * (w - 1) + c for c in "ab"] + ["x" * (w - 2) + "\x00"]
    vals = np.array(pool, dtype=object)[rng.integers(0, len(pool), n)]
    null = (rng.random(n) < 0.1) | (key == 3) | (key == 5)
    rb = pa.RecordBatch.from_arrays(
        [pa.array(key.astype(np.int32)),
         pa.array(list(vals), type=pa.string(), mask=null)],
        names=["k", "s"])
    return ColumnBatch.from_arrow(rb, dev)


@pytest.mark.parametrize("w", [4, 16, 64])
@pytest.mark.parametrize("groups", [1, 40, 0])
def test_segment_string_min_max_matches_plain(dev, groups, w):
    """K4s on one giant segment, ~40 segments and one-row segments, both
    ends, against its plain version; also through the aggregate."""
    rng = np.random.default_rng(w + groups)
    pb = _k4s_batch(dev, rng, 200_003, w, groups)
    keys = pb.columns[0].data
    flags = torch.ones(pb.num_rows, dtype=torch.uint8, device=dev)
    flags[1:] = (keys[1:] != keys[:-1]).to(torch.uint8)
    starts = torch.nonzero(flags).squeeze(1).to(torch.int32)
    col = pb.columns[1]
    for is_max in (False, True):
        before = G.segment_string_min_max.launches
        got = G.segment_string_min_max(col, flags, starts, is_max)
        assert G.segment_string_min_max.launches == before + 1
        _same(got, G.segment_string_min_max_plain(col, flags, starts,
                                                  is_max))
    specs = [G.AggSpec("min", 1), G.AggSpec("max", 1)]
    for k in ([0], []):
        gk, ga, g = G.segment_aggregate(pb, k, specs)
        wk, wa, wg = G.segment_aggregate_plain(pb, k, specs)
        assert g == wg
        for a, b in zip(gk + ga, wk + wa):
            _same(a, b)


def test_q1_on_cuda_matches_cpu(dev, tmp_path):
    d = str(tmp_path / "tpch")
    tpch_gen.generate_tpch(d, sf=0.01, tables=("lineitem",))
    got = q1(TorchSession(), d).collect()
    want = q1(TorchSession(device="cpu"), d).collect()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[9] == w[9]
        assert g[2:9] == pytest.approx(w[2:9], rel=1e-9)
    assert os.path.isdir(os.path.join(d, "lineitem"))


# ---------------------------------------------------------------------------
# join kernels K5-K7
# ---------------------------------------------------------------------------

def _join_side(rng, n: int, pool: int, dtype=np.int32) -> pa.RecordBatch:
    """An integral key (with nulls and the dtype max), a string key, a
    double key (NaN, -0.0) and a payload."""
    null = rng.random(n) < 0.08
    k = rng.integers(0, pool, n).astype(dtype)
    k[rng.random(n) < 0.05] = np.iinfo(dtype).max
    words = np.array(["", "a", "ab", "zz", "a\x00", "longer string"],
                     dtype=object)
    return pa.RecordBatch.from_arrays([
        pa.array(k, mask=null),
        pa.array(list(words[rng.integers(0, len(words), n)]),
                 type=pa.string(), mask=rng.random(n) < 0.05),
        pa.array(rng.choice([-0.0, 0.0, 1.5, np.nan], n),
                 mask=rng.random(n) < 0.05),
        pa.array(np.arange(n, dtype=np.int64)),
    ], names=["k", "s", "d", "row"])


def _assert_tensors_equal(got, want):
    for a, b in zip(got, want):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert torch.equal(a.to(b.dtype), b)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.int16])
@pytest.mark.parametrize("jt", ["inner", "left", "semi", "anti"])
def test_fast_probe_and_expand_match_plain(dev, jt, dtype):
    from spark_rapids_tpu_torch.ops import join as J
    rng = np.random.default_rng(41)
    lb = ColumnBatch.from_arrow(_join_side(rng, 50_000, 300, dtype), dev)
    rb = ColumnBatch.from_arrow(_join_side(rng, 3_000, 300, dtype), dev)
    before = (J.build_prepare_fast.launches, J.join_search.launches,
              J.join_indices_from_probe.launches)
    prep = J.build_prepare_fast(rb, 0)
    _assert_tensors_equal(prep, J.build_prepare_fast_plain(rb, 0))
    arrays, total = J.probe_fast(lb, 0, *prep, jt, layout=prep.layout)
    want, wtotal = J.probe_fast_plain(lb, 0, *prep, jt)
    _assert_tensors_equal(arrays, want)
    assert int(total.item()) == int(wtotal.item()) > 0
    n = int(total.item())
    _assert_tensors_equal(J.join_indices_from_probe(lb.num_rows, arrays, jt,
                                                    n),
                          J.join_indices_plain(lb.num_rows, want, jt, n))
    assert (J.build_prepare_fast.launches, J.join_search.launches,
            J.join_indices_from_probe.launches) == tuple(
                b + 1 for b in before)


@pytest.mark.parametrize("keys", [[1], [2], [0, 1], [1, 2, 0]])
@pytest.mark.parametrize("jt", ["inner", "left", "semi", "anti", "full",
                                "cross"])
def test_rank_probe_and_expand_match_plain(dev, jt, keys):
    from spark_rapids_tpu_torch.ops import join as J
    rng = np.random.default_rng(43)
    lb = ColumnBatch.from_arrow(_join_side(rng, 20_000, 50), dev)
    rb = ColumnBatch.from_arrow(_join_side(rng, 700, 50), dev)
    k = [] if jt == "cross" else keys
    if k:
        # one ids launch over K1's words: no K4 flags, no K3 gather
        before = (J._key_ids.launches, G._segment_flags.launches,
                  K.gather_columns.launches, S.sort_permutation.launches)
        _assert_tensors_equal(J._key_ids(lb, rb, k, k),
                              J.key_ids_plain(lb, rb, k, k))
        assert (J._key_ids.launches, G._segment_flags.launches,
                K.gather_columns.launches, S.sort_permutation.launches) == (
            before[0] + 1, before[1], before[2], before[3] + 1)
    if jt == "cross":
        lb = K.slice_rows(lb, 0, 500)
    arrays, total = J.join_probe(lb, rb, k, k, jt)
    want, wtotal = J.join_probe_plain(lb, rb, k, k, jt)
    _assert_tensors_equal(arrays, want)
    n = int(total.item())
    assert n == int(wtotal.item()) > 0
    li, ri = J.join_indices_from_probe(lb.num_rows, arrays, jt, n)
    _assert_tensors_equal((li, ri),
                          J.join_indices_plain(lb.num_rows, want, jt, n))
    m = J.matched_build_rows(ri, rb.num_rows)
    assert torch.equal(m, J.matched_build_rows_plain(
        ri, torch.zeros(rb.num_rows, dtype=torch.bool, device=dev)))


def _ids_like_plain(lb, rb, keys):
    """K6 against its plain version: one ids launch and one K1 sort a
    call, no K4 flags, no K3 gather."""
    from spark_rapids_tpu_torch.ops import join as J
    before = (J._key_ids.launches, S.sort_permutation.launches,
              G._segment_flags.launches, K.gather_columns.launches)
    got = J._key_ids(lb, rb, keys, keys)
    assert (J._key_ids.launches, S.sort_permutation.launches,
            G._segment_flags.launches, K.gather_columns.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    _assert_tensors_equal(got, J.key_ids_plain(lb, rb, keys, keys))
    return got


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, (1 << 22) + 1])
def test_key_ids_tile_edges_match_plain(dev, n):
    """K6's tiles of 4096 sorted rows: one row, one short of a tile, one
    tile, one over, and 2^22 + 1 rows (1025 tiles, the look-back over
    many) of an int64 key with nulls and ties, split into a left and a
    right side; and at 2^22 + 1 rows two keys (int32, W 13 string), whose
    words are two 64-bit words."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    cl = n - n // 3
    valid = torch.rand(n, generator=g, device=dev) < 0.95
    x = torch.randint(-(1 << 20), 1 << 20, (n,), generator=g, device=dev)
    cols = [_int_key(x * 7919, valid, T.LongType())]
    if n > 1 << 22:
        lens = torch.randint(0, 14, (n,), generator=g, device=dev,
                             dtype=torch.int32)
        mat = torch.randint(97, 99, (n, 13), generator=g, device=dev,
                            dtype=torch.uint8)
        mat[torch.arange(13, device=dev)[None, :] >= lens[:, None]] = 0
        v2 = torch.rand(n, generator=g, device=dev) < 0.97
        mat[~v2] = 0
        cols += [_int_key(torch.randint(-3, 3, (n,), generator=g, device=dev,
                                        dtype=torch.int32), valid,
                          T.IntegerType()),
                 DeviceColumn(mat, v2, T.StringType(),
                              torch.where(v2, lens, 0))]
    full = ColumnBatch(cols, n, None, dev)
    lb, rb = K.slice_rows(full, 0, cl), K.slice_rows(full, cl, n)
    keys = list(range(len(cols)))
    lid, rid = _ids_like_plain(lb, rb, keys)
    if n > 1:
        assert int(lid.max()) == 2 ** 31 - 1 or bool(valid[:cl].all())
    _ids_like_plain(rb, lb, keys[::-1])


@pytest.mark.parametrize("seed", range(4))
def test_key_ids_fuzzed_sides_match_plain(dev, seed):
    """K6 over fuzzed join sides: an integral key (nulls, the dtype's
    max), a string key and a double key (NaN, -0.0), alone and together,
    each side alone empty too."""
    rng = np.random.default_rng(100 + seed)
    dtype = (np.int32, np.int64, np.int16, np.int8)[seed]
    lb = ColumnBatch.from_arrow(_join_side(rng, 30_000 + seed, 60, dtype),
                                dev)
    rb = ColumnBatch.from_arrow(_join_side(rng, 9_000, 60, dtype), dev)
    for keys in ([0], [1], [2], [0, 1, 2], [2, 0]):
        _ids_like_plain(lb, rb, keys)
        _ids_like_plain(K.slice_rows(lb, 0, 0), rb, keys)
        _ids_like_plain(lb, K.slice_rows(rb, 0, 0), keys)


def test_tpcds_queries_on_cuda_match_cpu(dev, tmp_path):
    from spark_rapids_tpu_torch.bench import tpcds_gen
    from spark_rapids_tpu_torch.bench.tpcds_queries import TPCDS_QUERIES
    from spark_rapids_tpu_torch.ops import join as J
    d = str(tmp_path / "tpcds")
    tpcds_gen.generate_tpcds(d, sf=0.1, rows_per_file=1 << 40)
    for name, (q, _tables) in TPCDS_QUERIES.items():
        before = (J.join_search.launches, J._key_ids.launches,
                  J.join_indices_from_probe.launches)
        got = q(TorchSession(), d).collect()
        want = q(TorchSession(device="cpu"), d).collect()
        if name in ("q24", "q84"):
            # no store in market 8 below SF1; no address in Edgewood
            assert got == want == [], name
            continue
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            # double sums: tile tree on the card, row order on the CPU
            assert g == pytest.approx(w, rel=1e-9), name
        after = (J.join_search.launches, J._key_ids.launches,
                 J.join_indices_from_probe.launches)
        assert after[0] > before[0] and after[2] > before[2], name
        if name == "q6":
            assert len(got) == 51 and after[1] > before[1]


# ---------------------------------------------------------------------------
# shuffle kernels K9 (murmur3 partition ids) and K10 (partition grouping)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys", [[0], [1], [2], [3], [4], [5], [6],
                                  [1, 0], [0, 2, 3, 5, 6, 4, 1]])
@pytest.mark.parametrize("num_parts", [1, 8, 200])
def test_partition_ids_match_plain(dev, keys, num_parts):
    from spark_rapids_tpu_torch.ops import partition as P
    rng = np.random.default_rng(47)
    pb = ColumnBatch.from_arrow(_record_batch(rng, 30_011), dev)
    before = P.partition_ids_for_keys.launches
    got = P.partition_ids_for_keys(pb, keys, num_parts)
    assert P.partition_ids_for_keys.launches == before + 1
    want = P.partition_ids_plain([pb.columns[k] for k in keys],
                                 pb.num_rows, num_parts)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_murmur3_columns_match_plain(dev):
    """Hash bits (the Murmur3Hash expression), more keys than one launch
    folds, and Spark's constants."""
    from spark_rapids_tpu_torch.ops import partition as P
    rng = np.random.default_rng(53)
    pb = ColumnBatch.from_arrow(_record_batch(rng, 9_001), dev)
    cols = list(pb.columns) * 3  # 21 keys: two chained launches
    got = P.murmur3_columns(cols, pb.num_rows, dev)
    want = P.to_int32(P._hash_plain(cols, pb.num_rows, dev, 42))
    assert torch.equal(got, want)
    for arr, spark in ((pa.array([1], type=pa.int32()), -559580957),
                       (pa.array([1], type=pa.int64()), -1712319331),
                       (pa.array(["abc"]), 1322437556)):
        one = ColumnBatch.from_arrow(
            pa.RecordBatch.from_arrays([arr], names=["k"]), dev)
        assert int(P.murmur3_columns(one.columns, 1, dev)[0]) == spark


@pytest.mark.parametrize("num_parts", [1, 8, 200, 5000])
@pytest.mark.parametrize("shape", ["uniform", "skewed", "empty"])
def test_group_by_part_matches_plain(dev, num_parts, shape):
    from spark_rapids_tpu_torch.ops import partition as P
    rng = np.random.default_rng(59)
    n = 0 if shape == "empty" else 70_001
    pb = ColumnBatch.from_arrow(_record_batch(rng, n), dev)
    ids = rng.integers(0, num_parts, n)
    if shape == "skewed":
        ids[rng.random(n) < 0.9] = num_parts - 1
    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    before = P.group_by_part.launches
    got, counts, starts = P.group_by_part(pb, ids, num_parts)
    assert P.group_by_part.launches == before + 1
    want, wcounts, wstarts = P.group_by_part_plain(pb, ids, num_parts)
    assert torch.equal(counts, wcounts) and torch.equal(starts, wstarts)
    for a, b in zip(got.columns, want.columns):
        _same(a, b)


def _probe_arrays(rng, cl: int, cr: int, jt: str, shape: str, dev):
    """Probe arrays of ``cl`` stream rows against ``cr`` build rows with
    the offsets K5 writes, drawn directly: ``fuzz`` (most rows without a
    match, the rest 1-20), ``zeros`` (stretches of rows without output
    longer than a block's share), ``giant`` (one row matching 2^16 build
    rows), ``unmatched`` (nothing matches: for full outer every build row
    is in the tail).  Returns (ProbeArrays, total)."""
    from spark_rapids_tpu_torch.ops import join as J
    if jt == "cross":
        cnt = np.full(cl, cr, np.int64)
        start = np.zeros(cl, np.int64)
        perm = np.arange(cr)
    else:
        cnt = np.where(rng.random(cl) < 0.6, 0, rng.integers(1, 21, cl))
        if shape == "zeros":
            cnt[rng.random(cl) < 0.9995] = 0
        elif shape == "giant" and cl:
            cnt[rng.integers(0, cl)] = 1 << 16
        elif shape == "unmatched":
            cnt[:] = 0
        cnt = np.minimum(cnt, cr)
        start = (rng.random(cl) * (cr - cnt + 1)).astype(np.int64)
        perm = rng.permutation(cr)
    out = {"inner": cnt, "cross": cnt, "left": np.maximum(cnt, 1),
           "full": np.maximum(cnt, 1), "semi": (cnt > 0).astype(np.int64),
           "anti": (cnt == 0).astype(np.int64)}[jt]
    unmatched = None
    if jt == "full":
        unmatched = (np.ones(cr, np.int64) if shape == "unmatched"
                     else (rng.random(cr) < 0.3).astype(np.int64))

    def on(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    def offsets(c):
        return on(np.concatenate([[0], np.cumsum(c)]))
    arrays = J.ProbeArrays(
        (on(start), on(cnt), on(perm), on(out),
         None if unmatched is None else on(unmatched)), offsets(out),
        None if unmatched is None else offsets(unmatched))
    total = int(out.sum()) + (0 if unmatched is None else
                              int(unmatched.sum()))
    return arrays, total


_EXPAND_TYPES = ["inner", "left", "semi", "anti", "full", "cross"]


def _expand_like_plain(arrays, cl: int, jt: str, total: int):
    """One K7 call against its plain version: one launch a call, every
    slot written (the output starts as a pattern no slot holds)."""
    from spark_rapids_tpu_torch.ops import join as J
    before = J.join_indices_from_probe.launches
    got = J.join_indices_from_probe(cl, arrays, jt, total)
    assert J.join_indices_from_probe.launches == before + 1
    want = J.join_indices_plain(cl, arrays, jt, total)
    assert got[0].shape == (total,) and got[1].shape == (total,)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("cl", [0, 1, 4095, 4096, 4097, (1 << 16) + 1,
                                (1 << 20) + 1])
@pytest.mark.parametrize("jt", _EXPAND_TYPES)
def test_expand_merge_path_edges_match_plain(dev, jt, cl):
    """K7's merge-path expansion at stream sizes around its block shares
    and tiles, every join type; the full-outer tail in the same launch."""
    rng = np.random.default_rng(cl + len(jt))
    cr = 3 if jt == "cross" else 5_000
    arrays, total = _probe_arrays(rng, cl, cr, jt, "fuzz", dev)
    # a stale output pattern in the allocator: each slot must be written
    junk = torch.full((2 * total + 4096,), -7, dtype=torch.int32,
                      device=dev)
    del junk
    _expand_like_plain(arrays, cl, jt, total)


@pytest.mark.parametrize("shape", ["zeros", "giant", "unmatched"])
@pytest.mark.parametrize("jt", _EXPAND_TYPES[:5])
def test_expand_skew_and_empty_stretches_match_plain(dev, jt, shape):
    """Rows without output over many blocks' shares, one row of 2^16
    slots spread over 32 blocks, and a full outer join whose build rows
    are all unmatched."""
    rng = np.random.default_rng(len(shape) * 7 + len(jt))
    cl = (1 << 18) + 3
    arrays, total = _probe_arrays(rng, cl, 1 << 17, jt, shape, dev)
    _expand_like_plain(arrays, cl, jt, total)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 65_537])
def test_k7_offsets_scan_matches_cumsum(dev, n):
    """K7's own offsets scan (K14's emit offsets): one launch with the
    look-back, its status left zero."""
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.ops import native
    rng = np.random.default_rng(n)
    c = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32)).to(dev)
    before = J._offsets_cuda.launches
    for _ in range(2):
        got = J._offsets_cuda(native.lib("join_expand"), c,
                              native.stream_ptr(dev))
        want = torch.cat([c.new_zeros(1, dtype=torch.int64),
                          torch.cumsum(c.to(torch.int64), 0)])
        assert torch.equal(got.to(torch.int64), want)
    assert J._offsets_cuda.launches == before + 2
    assert all(not s.any() for s in J._SCAN_STATUS.values())


def _order_like_plain(ids, num_parts: int):
    from spark_rapids_tpu_torch.ops import partition as P
    want = P._order_plain(ids, num_parts)
    for _ in range(2):  # the second call on the scratch the first left
        before = P.group_by_part.launches
        got = P.partition_order(ids, num_parts)
        assert P.group_by_part.launches == before + 1
        for a, b in zip(got, want):
            assert a.dtype == torch.int32 and torch.equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, (1 << 20) + 1])
@pytest.mark.parametrize("num_parts", [1, 8, 200, 255, 256, 5000, None])
def test_group_order_edges_match_plain(dev, num_parts, n):
    """K10's onesweep order, stable, with ids outside [0, P), at the tile
    edges, one pass up to 255 partitions and two past it, up to
    MAX_PARTS (None)."""
    from spark_rapids_tpu_torch.ops import partition as P
    parts = P.MAX_PARTS if num_parts is None else num_parts
    rng = np.random.default_rng(n + parts)
    ids = rng.integers(-2, parts + 2, n).astype(np.int32)
    ids[rng.random(n) < 0.01] = np.iinfo(np.int32).min
    _order_like_plain(torch.from_numpy(ids).to(dev), parts)


@pytest.mark.parametrize("num_parts", [1, 8, 300])
def test_group_order_one_bucket_matches_plain(dev, num_parts):
    """Every row in one partition, then every row outside [0, P)."""
    n = (1 << 20) + 17
    for v in (num_parts - 1, num_parts):
        _order_like_plain(torch.full((n,), v, dtype=torch.int32,
                                     device=dev), num_parts)


def test_exchange_paths_on_cuda_match_cpu(dev, tmp_path):
    """q6 in a multi-file layout with the adaptive layer on (map side
    coalesced: K9/K10 do not run) and off (they run), and the
    repartition query (they run once per map batch)."""
    from spark_rapids_tpu_torch.bench import tpcds_gen
    from spark_rapids_tpu_torch.bench.tpcds_queries import (TPCDS_QUERIES,
                                                            top_customers)
    from spark_rapids_tpu_torch.ops import partition as P
    d = str(tmp_path / "tpcds")
    tpcds_gen.generate_tpcds(d, sf=0.1, rows_per_file=1 << 15)
    q6 = TPCDS_QUERIES["q6"][0]
    cases = [("q6 aqe on", q6, {}, False),
             ("q6 aqe off", q6, {"spark.sql.adaptive.enabled": False}, True),
             ("top_customers", top_customers, {}, True)]
    for what, q, conf, runs in cases:
        before = (P.partition_ids_for_keys.launches, P.group_by_part.launches)
        got = q(TorchSession(conf), d).collect()
        after = (P.partition_ids_for_keys.launches, P.group_by_part.launches)
        assert got == q(TorchSession(conf, device="cpu"), d).collect(), what
        ran = [a - b for a, b in zip(after, before)]
        assert (ran[0] > 0 and ran[1] > 0) if runs else ran == [0, 0], what


# ---------------------------------------------------------------------------
# K12: window segment extents (K12a) and frame aggregates (K12b)
# ---------------------------------------------------------------------------

def _window_batch(dev, rng, n: int, part, order):
    """A seeded batch sorted by (part keys ascending nulls first, order
    keys), on ``dev``, plus a column of finite doubles with NaN, +-inf and
    -0.0 mixed in (sum inputs: the huge magnitudes of ``d`` would make any
    two summation orders disagree)."""
    from spark_rapids_tpu_torch.ops.sort import SortOrder, sort_batch
    rb = _record_batch(rng, n)
    x = np.round(rng.normal(size=n) * 100, 2)
    x[rng.random(n) < 0.01] = np.nan
    x[rng.random(n) < 0.005] = np.inf
    x[rng.random(n) < 0.005] = -np.inf
    x[rng.random(n) < 0.01] = -0.0
    rb = pa.RecordBatch.from_arrays(
        list(rb.columns) + [pa.array(x, mask=rng.random(n) < 0.1)],
        names=rb.schema.names + ["x"])
    pb = ColumnBatch.from_arrow(rb, dev)
    orders = [SortOrder(i, True, True) for i in part] + \
        [SortOrder(i, True, None) for i in order]
    return sort_batch(pb, orders) if orders else pb


_SEG_KEYS = [((0,), (3,)), ((1,), (4, 2)), ((), (3,)), ((1, 6), ()),
             ((), ())]


@pytest.mark.parametrize("part,order", _SEG_KEYS)
def test_window_segments_match_plain(dev, part, order):
    from spark_rapids_tpu_torch.ops import window as W
    rng = np.random.default_rng(61)
    sb = _window_batch(dev, rng, 70_001, part, order)
    flags = W._boundary_flags(sb, part, order)
    before = W.sorted_segments.launches
    got = W.sorted_segments(sb, part, order)
    assert W.sorted_segments.launches == before + 1
    want = W.segment_extents_plain(*flags)
    for f in ("seg_start", "seg_end", "peer_start", "peer_end", "seg_id",
              "order_rank"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


_FRAMES = [("rows", None, 0), ("rows", None, None), ("rows", -3, 2),
           ("rows", 2, 5), ("rows", None, 3), ("rows", -2, None),
           ("rows", None, -1), ("range", None, 0), ("range", 0, 0),
           ("range", 0, None), ("range", None, None)]


def _assert_window_agg(got, want, x=None):
    (gd, gv, gt), (wd, wv, wt) = got, want
    assert gt == wt and torch.equal(gv, wv)
    if gd.dtype.is_floating_point:
        # the kernel folds each partition on its own, the plain version
        # differences prefix sums over the whole batch: both round, the
        # latter by up to a few ulps of the running total
        atol = 0.0 if x is None else \
            8 * torch.finfo(torch.float64).eps * float(
                torch.nan_to_num(x.abs(), posinf=0.0).sum())
        torch.testing.assert_close(gd, wd, rtol=1e-9, atol=atol,
                                   equal_nan=True)
    else:
        assert torch.equal(gd, wd)


@pytest.mark.parametrize("frame", _FRAMES)
@pytest.mark.parametrize("op", ["sum", "count", "avg", "min", "max"])
def test_window_agg_matches_plain(dev, op, frame):
    from spark_rapids_tpu_torch.ops import window as W
    rng = np.random.default_rng(67)
    part, order = (1,), (4,)
    sb = _window_batch(dev, rng, 50_003, part, order)
    seg = W.sorted_segments(sb, part, order)
    fr = W.WindowFrame(*frame)
    cols = {"sum": (1, 2, 7), "count": (0, 3), "avg": (2, 7),
            "min": (1, 2, 3, 4, 5, 6), "max": (1, 2, 3, 4, 5, 6)}[op]
    for ci in cols:
        c = sb.columns[ci]
        # min/max with a bounded lower edge go to K12c, the rest to K12b
        k12c = op in ("min", "max") and fr.lower is not None
        before = (W.running_or_bounded_agg.launches,
                  W.frame_min_max.launches)
        got = W.running_or_bounded_agg(op, c, seg, fr)
        assert (W.running_or_bounded_agg.launches,
                W.frame_min_max.launches) == \
            (before[0] + (not k12c), before[1] + k12c)
        want = W.running_or_bounded_agg_plain(op, c, seg, fr)
        _assert_window_agg(got, want,
                           c.data if c.dtype.fractional else None)


# K12c: min/max over frames with a bounded lower edge
_K12C_FRAMES = [("rows", -6, 0), ("rows", -3, 3), ("rows", 2, 5),
                ("rows", -1, -1), ("rows", -100_000, 100_000),
                ("range", 0, 0), ("range", 0, None)]


@pytest.mark.parametrize("frame", _K12C_FRAMES)
@pytest.mark.parametrize("op", ["min", "max"])
def test_frame_min_max_matches_plain(dev, op, frame):
    """Every value type K12c takes (int16/32/64 and dates, f32, f64 with
    NaN/+-inf/-0.0, bools), with empty frames and one wider than any
    partition: exactly the plain version, NaN bit for bit."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import window as W
    rng = np.random.default_rng(73)
    part, order = (1,), (4,)
    sb = _window_batch(dev, rng, 40_009, part, order)
    seg = W.sorted_segments(sb, part, order)
    lo, hi = W._frame_edges(seg, W.WindowFrame(*frame))
    x = sb.columns[3]
    f32 = DeviceColumn(x.data.float(), x.validity, T.FloatType())
    for c in [sb.columns[i] for i in (1, 2, 3, 4, 5, 6, 7)] + [f32]:
        before = W.frame_min_max.launches
        gd, gv = W.frame_min_max(op, c, lo, hi)
        assert W.frame_min_max.launches == before + 1
        wd, wv = W.frame_min_max_plain(op, c, lo, hi)
        assert torch.equal(gv, wv) and gd.dtype == wd.dtype
        if gd.dtype.is_floating_point:
            gd, wd = (t.view(torch.int32 if t.dtype == torch.float32
                             else torch.int64) for t in (gd, wd))
        assert torch.equal(gd, wd), (c.dtype, frame)
    empty = K.slice_rows(sb, 0, 0).columns[3]
    gd, gv = W.frame_min_max(op, empty, lo[:0], hi[:0])
    assert gd.numel() == 0 and gv.numel() == 0


def test_window_ranking_and_lead_lag_on_cuda(dev):
    """row_number/rank/dense_rank and lead/lag (K3's gather) on the card
    against the same functions over CPU copies of the same rows."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import window as W
    rng = np.random.default_rng(71)
    sb = _window_batch(dev, rng, 30_011, (1,), (4,))
    seg = W.sorted_segments(sb, (1,), (4,))
    cpu_seg = W.SegmentInfo(*[t.cpu() for t in vars(seg).values()])
    for fn in (W.row_number, W.rank, W.dense_rank):
        assert torch.equal(fn(seg).cpu(), fn(cpu_seg))
    for ci in (0, 3):  # a string and a double column
        c = sb.columns[ci]
        cc = DeviceColumn(c.data.cpu(), c.validity.cpu(), c.dtype,
                          None if c.lengths is None else c.lengths.cpu())
        for off in (-2, 1):
            before = K.gather_columns.launches
            got = W.lead_lag(c, seg, off)
            assert K.gather_columns.launches == before + 1
            for a, b in zip(got, W.lead_lag(cc, cpu_seg, off)):
                assert (a is None) == (b is None)
                if a is not None:
                    torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0,
                                               equal_nan=True)


def test_window_queries_on_cuda_match_cpu(dev, tmp_path):
    """q51 and q63 at sf0.1 in a multi-file layout: the window path runs
    K12a and K12b and returns the CPU rows."""
    import math
    from spark_rapids_tpu_torch.bench import tpcds_gen
    from spark_rapids_tpu_torch.bench.tpcds_queries import TPCDS_QUERIES
    from spark_rapids_tpu_torch.ops import window as W
    d = str(tmp_path / "tpcds")
    tpcds_gen.generate_tpcds(d, sf=0.1, rows_per_file=1 << 15)
    for name in ("q51", "q63"):
        q = TPCDS_QUERIES[name][0]
        before = (W.sorted_segments.launches,
                  W.running_or_bounded_agg.launches)
        got = q(TorchSession(), d).collect()
        assert W.sorted_segments.launches > before[0], name
        assert W.running_or_bounded_agg.launches > before[1], name
        want = q(TorchSession(device="cpu"), d).collect()
        assert len(got) == len(want) == 100, name
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, float):
                    assert math.isclose(a, b, rel_tol=1e-9), (name, g, w)
                else:
                    assert a == b, (name, g, w)


# ---------------------------------------------------------------------------
# K11: range-partition ids; the round-robin, range and moving-window paths
# ---------------------------------------------------------------------------

_K11_CASES = [([0], [True], [True]), ([3], [False], [True]),
              ([3, 1], [True, False], [False, True]),
              ([5, 2, 0], [False, True, True], [True, False, False]),
              ([6, 4], [True, False], [False, False])]


@pytest.mark.parametrize("parts", [1, 2, 8, 200, 1024])
@pytest.mark.parametrize("case", range(len(_K11_CASES)))
def test_range_partition_ids_match_plain(dev, case, parts):
    """Bounds from a sorted wider batch (strings up to W 32) against rows
    of a narrower one (W 16 when the rows hold no long string), every key
    type, both directions and null orders; bounds tie where the keys have
    few values."""
    from spark_rapids_tpu_torch.ops import range_partition as RP
    from spark_rapids_tpu_torch.ops.sort import SortOrder, sort_permutation
    keys, asc, nf = _K11_CASES[case]
    rng = np.random.default_rng(79 + case)
    wide = ColumnBatch.from_arrow(_record_batch(rng, 20_000), dev)
    rb = _record_batch(rng, 30_011)
    short = pa.array([None if v is None or len(v) > 12 else v
                      for v in rb.column(0).to_pylist()], pa.string())
    narrow = ColumnBatch.from_arrow(pa.RecordBatch.from_arrays(
        [short] + list(rb.columns[1:]), names=rb.schema.names), dev)
    orders = [SortOrder(i, a, f) for i, (a, f) in enumerate(zip(asc, nf))]
    wk = [wide.columns[k] for k in keys]
    kb = ColumnBatch(wk, wide.num_rows, None, dev)
    perm = sort_permutation(kb, orders)
    pos = torch.clamp(torch.arange(1, parts, device=dev) * wide.num_rows
                      // parts, 0, wide.num_rows - 1)
    bounds = RP.RangeBounds(K.gather_columns(wk, perm[pos]), orders)
    rows = [narrow.columns[k] for k in keys]
    for batch_rows in (rows, [K.slice_rows(narrow, 0, 0).columns[k]
                              for k in keys]):
        before = RP.range_partition_ids.launches
        got = RP.range_partition_ids(batch_rows, bounds)
        assert RP.range_partition_ids.launches == \
            before + (batch_rows[0].capacity > 0)
        want = RP.range_partition_ids_plain(batch_rows, bounds)
        assert torch.equal(got, want), (keys, parts)
        if got.numel():
            assert int(got.min()) >= 0 and int(got.max()) <= parts - 1


def test_partition_paths_on_cuda_match_cpu(dev, tmp_path):
    """top_customers_rr, both range sorts and moving_extrema at sf0.1 in a
    multi-file layout on the card against the CPU: K10 under the
    round-robin exchange, K11 under the range ones, K12c on the moving
    windows (and no K12b)."""
    import math
    from spark_rapids_tpu_torch.bench import tpcds_gen
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.ops import partition as P
    from spark_rapids_tpu_torch.ops import range_partition as RP
    from spark_rapids_tpu_torch.ops import window as W
    d = str(tmp_path / "tpcds")
    tpcds_gen.generate_tpcds(d, sf=0.1, rows_per_file=1 << 15,
                             tables=("date_dim", "customer", "store_sales"))
    pin = {"spark.sql.adaptive.advisoryPartitionSizeInBytes": 0}

    def same(got, want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, float):
                    assert math.isclose(a, b, rel_tol=1e-9), (g, w)
                else:
                    assert a == b, (g, w)

    before = P.group_by_part.launches
    same(Q.top_customers_rr(TorchSession(), d).collect(),
         Q.top_customers_rr(TorchSession(device="cpu"), d).collect())
    assert P.group_by_part.launches - before >= 9
    for build in (Q.range_sort_store_sales, Q.range_sort_customer_names):
        before = RP.range_partition_ids.launches
        gs, cs = TorchSession(pin), TorchSession(pin, device="cpu")
        got = [[r for b in bs for r in b.to_rows()]
               for bs in Q.partition_batches(gs, build(gs, d))]
        want = [[r for b in bs for r in b.to_rows()]
                for bs in Q.partition_batches(cs, build(cs, d))]
        assert RP.range_partition_ids.launches > before
        assert got == want
    before = (W.frame_min_max.launches, W.running_or_bounded_agg.launches)
    same(Q.moving_extrema(TorchSession(), d).collect(),
         Q.moving_extrema(TorchSession(device="cpu"), d).collect())
    assert W.frame_min_max.launches - before[0] >= 3
    assert W.running_or_bounded_agg.launches == before[1]


# ---------------------------------------------------------------------------
# string kernels K13a (substring) and K13b (literal match)
# ---------------------------------------------------------------------------

_PIECES = [b"a", b"Z", b" ", b"\x00", "é".encode(), "€".encode(),
           "😀".encode(), b"\x80"]


def _string_rows(rng, n: int, w: int):
    """uint8 [n, w], int32 lengths, bool validity of seeded strings (ASCII,
    NUL, 2/3/4-byte characters, lone continuation bytes; empty and null
    rows)."""
    data = np.zeros((n, w), np.uint8)
    lengths = np.zeros(n, np.int32)
    valid = rng.random(n) >= 0.1
    for i in np.nonzero(valid)[0]:
        cap, bs = int(rng.integers(0, w + 1)), b""
        while True:
            p = _PIECES[int(rng.integers(0, len(_PIECES)))]
            if len(bs) + len(p) > cap:
                break
            bs += p
        data[i, :len(bs)] = np.frombuffer(bs, np.uint8)
        lengths[i] = len(bs)
    return data, lengths, valid


def _on(dev, *arrays):
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def _same_tuple(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("w", [4, 8, 12, 16, 32, 64, 128, 256])
def test_substring_matches_plain(dev, w):
    from spark_rapids_tpu_torch.ops import strings as STR
    rng = np.random.default_rng(w)
    n = 3001
    s = _on(dev, *_string_rows(rng, n, w))
    pos = _on(dev, rng.integers(-w - 2, w + 3, n), rng.random(n) >= 0.1)
    ln = rng.integers(-2, w + 3, n)
    ln[rng.random(n) < 0.1] = 2 ** 31 - 1
    ln = _on(dev, ln.astype(np.int32), rng.random(n) >= 0.1)
    cases = [(1, 2), (0, 3), (-1, 1), (-3, 2), (3, -1), (w + 2, 1),
             (-w - 2, w + 2), (2, 2 ** 31 - 1), (pos, ln), (pos, 4),
             (1, ln)]
    for p, l in cases:
        before = STR.substring.launches
        got = STR.substring(*s, p, l)
        assert STR.substring.launches == before + 1
        _same_tuple(got, STR.substring_plain(*s, p, l))
    # a row slice (offset base) and an empty batch
    _same_tuple(STR.substring(*(t[7:] for t in s), 2, 3),
                STR.substring_plain(*(t[7:] for t in s), 2, 3))
    out = STR.substring(*(t[:0] for t in s), 1, 1)
    assert out[0].shape == (0, w)


@pytest.mark.parametrize("mode", ["prefix", "suffix", "contains", "equals"])
@pytest.mark.parametrize("w", [4, 16, 64, 256])
def test_string_match_matches_plain(dev, mode, w):
    from spark_rapids_tpu_torch.ops import strings as STR
    rng = np.random.default_rng(w + 7)
    n = 2003
    s = _on(dev, *_string_rows(rng, n, w))
    needles = [STR.literal_needle(t, dev)
               for t in ["", "a", "é", "€a", "😀", "\x00", "x" * (w + 4)]]
    # needle columns: pieces of each row, and rows of another width
    pos = _on(dev, rng.integers(1, w + 1, n), np.ones(n, bool))
    ln = _on(dev, rng.integers(0, w // 2 + 1, n), rng.random(n) >= 0.1)
    needles.append(STR.substring_plain(*s, pos, ln))
    needles.append(_on(dev, *_string_rows(rng, n, 2 * w)))
    for nd in needles:
        before = STR.string_match.launches
        got = STR.string_match(mode, *s, *nd)
        assert STR.string_match.launches == before + 1
        _same_tuple(got, STR.string_match_plain(mode, *s, *nd))


def test_string_queries_on_cuda_match_cpu(dev, tmp_path):
    """q14 and q22 at SF0.01, q15 at sf0.1 in a multi-file layout: K13a
    runs on q15 and q22, K13b on q14, and the rows are the CPU's."""
    import math
    from spark_rapids_tpu_torch.bench import tpcds_gen
    from spark_rapids_tpu_torch.bench.tpcds_queries import TPCDS_QUERIES
    from spark_rapids_tpu_torch.bench.tpch_queries import q14, q22
    from spark_rapids_tpu_torch.ops import strings as STR
    tdir, ddir = str(tmp_path / "tpch"), str(tmp_path / "tpcds")
    tpch_gen.generate_tpch(tdir, sf=0.01)
    q15, tables = TPCDS_QUERIES["q15"]
    tpcds_gen.generate_tpcds(ddir, sf=0.1, tables=tables,
                             rows_per_file=1 << 15)
    for name, q, d, counter in (("q14", q14, tdir, STR.string_match),
                                ("q22", q22, tdir, STR.substring),
                                ("q15", q15, ddir, STR.substring)):
        before = counter.launches
        got = q(TorchSession(), d).collect()
        assert counter.launches > before, name
        want = q(TorchSession(device="cpu"), d).collect()
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, float):
                    assert math.isclose(a, b, rel_tol=1e-9), (name, g, w)
                else:
                    assert a == b, (name, g, w)


# ---------------------------------------------------------------------------
# string kernels K13e-h (trims, length, locate, substring_index)
# ---------------------------------------------------------------------------

def _spaced_rows(rng, n: int, w: int):
    """_string_rows with commas, slashes and runs of spaces, a tenth of
    the rows spaces only and a tenth padded with spaces at both ends."""
    data, lengths, valid = _string_rows(rng, n, w)
    extra = np.array([32, 32, 44, 47], np.uint8)
    swap = (rng.random((n, w)) < 0.3) & \
        (np.arange(w)[None, :] < lengths[:, None])
    data = np.where(swap, extra[rng.integers(0, 4, (n, w))], data)
    spaces = (rng.random(n) < 0.1)[:, None] & \
        (np.arange(w)[None, :] < lengths[:, None])
    data = np.where(spaces, 32, data).astype(np.uint8)
    pad = (rng.random(n) < 0.1) & (lengths >= 2)
    data[pad, 0] = 32
    data[pad, lengths[pad] - 1] = 32
    return data, lengths, valid


@pytest.mark.parametrize("w", [4, 8, 12, 16, 32, 64, 128, 256])
def test_trim_length_and_substring_index_match_plain(dev, w):
    from spark_rapids_tpu_torch.ops import strings as STR
    rng = np.random.default_rng(500 + w)
    s = _on(dev, *_spaced_rows(rng, 3001, w))
    for left, right in ((True, True), (True, False), (False, True)):
        before = STR.trim.launches
        got = STR.trim(*s, left, right)
        assert STR.trim.launches == before + 1
        _same_tuple(got, STR.trim_plain(*s, left, right))
    before = STR.char_length.launches
    got = STR.char_length(*s)
    assert STR.char_length.launches == before + 1
    assert torch.equal(got, STR.char_length_plain(*s))
    for delim in (44, 47, 32, 0):
        for count in range(-4, 5):
            before = STR.substring_index.launches
            got = STR.substring_index(*s, delim, count)
            assert STR.substring_index.launches == before + 1
            _same_tuple(got, STR.substring_index_plain(*s, delim, count))
    # a row slice (offset base) and an empty batch
    _same_tuple(STR.trim(*(t[7:] for t in s)),
                STR.trim_plain(*(t[7:] for t in s)))
    assert STR.trim(*(t[:0] for t in s))[0].shape == (0, w)


@pytest.mark.parametrize("w", [4, 12, 16, 64, 256])
def test_locate_matches_plain(dev, w):
    from spark_rapids_tpu_torch.ops import strings as STR
    rng = np.random.default_rng(600 + w)
    n = 2003
    s = _on(dev, *_spaced_rows(rng, n, w))
    needles = [STR.literal_needle(t, dev)
               for t in ["", "a", "é", " a", "😀", "\x00", ",", "\x80",
                         "x" * (w + 4)]]
    pos = _on(dev, rng.integers(1, w + 1, n), np.ones(n, bool))
    ln = _on(dev, rng.integers(0, w // 2 + 1, n), rng.random(n) >= 0.1)
    needles.append(STR.substring_plain(*s, pos, ln))
    needles.append(_on(dev, *_string_rows(rng, n, 2 * w)))
    for nd in needles:
        for start in (-1, 0, 1, 2, 3, w // 2, w + 1, w + 2, 2 ** 40):
            before = STR.locate.launches
            got = STR.locate(*s, *nd, start)
            assert STR.locate.launches == before + 1
            _same_tuple(got, STR.locate_plain(*s, *nd, start))


def test_string_paths_on_cuda_match_cpu(dev, tmp_path):
    """loan_period_span and seller_legal_forms at mortgage sf 0.2 through
    TorchSession() on the card and on the CPU; K13e-h and K4s launch."""
    from spark_rapids_tpu_torch.bench import mortgage_gen
    from spark_rapids_tpu_torch.bench import string_queries as SQ
    from spark_rapids_tpu_torch.ops import strings as STR
    d = str(tmp_path / "mortgage")
    mortgage_gen.generate_mortgage(d, sf=0.2, seed=11)
    for name, counters in (
            ("loan_period_span", (STR.substring_index, STR.concat,
                                  G.segment_string_min_max)),
            ("seller_legal_forms", (STR.substring_index, STR.trim,
                                    STR.char_length, STR.locate,
                                    G.segment_string_min_max))):
        build, _table = SQ.STRING_PATHS[name]
        before = [c.launches for c in counters]
        got = build(TorchSession(), d).collect()
        assert all(c.launches > b for c, b in zip(counters, before)), name
        want = build(TorchSession(device="cpu"), d).collect()
        assert got == want and got


# ---------------------------------------------------------------------------
# string kernels K13c (concat) and K13d (ASCII case map)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws", [False, True])
@pytest.mark.parametrize("widths", [[16], [4, 8], [16, "lit", 16],
                                    [4, 8, 16, 32, 64, 128, 256, "lit"],
                                    [256, 256], ["lit", 8, "null"]])
def test_concat_matches_plain(dev, widths, ws):
    from spark_rapids_tpu_torch.ops import strings as STR
    rng = np.random.default_rng(len(widths) * 10 + ws)
    n = 3001
    pieces = []
    for w in widths:
        if w == "lit":
            pieces.append(STR.literal_needle(", é", dev))
        elif w == "null":
            d, ln, v = STR.literal_needle("x", dev)
            pieces.append((d, ln, ~v))
        else:
            pieces.append(_on(dev, *_string_rows(rng, n, w)))
    sep = "|é" if ws else None
    before = STR.concat.launches
    got = STR.concat(pieces, sep)
    assert STR.concat.launches == before + 1
    _same_tuple(got, STR.concat_plain(pieces, sep))
    # a row slice (offset base) and an empty batch
    cut = [p if p[0].shape[0] == 1 else tuple(t[7:] for t in p)
           for p in pieces]
    _same_tuple(STR.concat(cut, sep), STR.concat_plain(cut, sep))
    if any(p[0].shape[0] > 1 for p in pieces):
        empty = [p if p[0].shape[0] == 1 else tuple(t[:0] for t in p)
                 for p in pieces]
        assert STR.concat(empty, sep)[0].shape[0] == 0


@pytest.mark.parametrize("w", [4, 8, 16, 32, 256])
@pytest.mark.parametrize("upper", [True, False])
def test_case_map_matches_plain(dev, w, upper):
    from spark_rapids_tpu_torch.ops import strings as STR
    rng = np.random.default_rng(w)
    # odd row counts leave a tail shorter than one 16-byte vector
    for n in (2001, 1, 3):
        data, lengths, valid = _string_rows(rng, n, w)
        data[:, :2] = np.frombuffer(b"aZ", np.uint8)[None, :] * \
            (np.arange(w)[:2] < lengths[:, None])
        s = _on(dev, data, lengths, valid)
        before = STR.case_map.launches
        got = STR.case_map(*s, upper)
        assert STR.case_map.launches == before + 1
        _same_tuple(got, STR.case_map_plain(*s, upper))
        assert got[1] is s[1] and got[2] is s[2]
    s = _on(dev, *_string_rows(rng, 99, w))
    _same_tuple(STR.case_map(*(t[3:] for t in s), upper),
                STR.case_map_plain(*(t[3:] for t in s), upper))


def test_q24_and_q84_on_cuda_match_cpu(dev, tmp_path):
    """q24 at SF1 (3 stores in market 8: rows) and q84_all_cities at
    sf0.1: K13d runs on q24, K13c on q84_all_cities, and the rows are the
    CPU's."""
    import math
    from spark_rapids_tpu_torch.bench import tpcds_gen
    from spark_rapids_tpu_torch.bench.tpcds_queries import TPCDS_QUERIES
    from spark_rapids_tpu_torch.ops import strings as STR
    for name, sf, counter in (("q24", 1, STR.case_map),
                              ("q84_all_cities", 0.1, STR.concat)):
        q, tables = TPCDS_QUERIES[name]
        d = str(tmp_path / f"sf{sf}")
        tpcds_gen.generate_tpcds(d, sf=sf, tables=tables,
                                 rows_per_file=1 << 40)
        before = counter.launches
        got = q(TorchSession(), d).collect()
        assert counter.launches > before, name
        want = q(TorchSession(device="cpu"), d).collect()
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, float):
                    assert math.isclose(a, b, rel_tol=1e-9), (name, g, w)
                else:
                    assert a == b, (name, g, w)


# ---------------------------------------------------------------------------
# the mortgage kernels: K13i (hex) and K4p (percentile pick)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 257, 100_003])
def test_hex_string_matches_plain(dev, n):
    from spark_rapids_tpu_torch.ops import strings as STR
    rng = np.random.default_rng(n)
    shift = rng.integers(0, 64, n)
    v = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64) >> shift
    v[:min(n, 4)] = [0, -1, 2 ** 63 - 1, -2 ** 63][:min(n, 4)]
    valid = rng.random(n) >= 0.1
    data = torch.from_numpy(np.where(valid, v, 0)).to(dev)
    ok = torch.from_numpy(valid).to(dev)
    before = STR.hex_string.launches
    got = STR.hex_string(data, ok)
    assert STR.hex_string.launches == before + 1
    _same_tuple(got, STR.hex_string_plain(data, ok))
    # an int32 hash cast to long: negative ones sign-extend
    h = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n)).to(dev)
    _same_tuple(STR.hex_string(h, ok), STR.hex_string_plain(h, ok))


@pytest.mark.parametrize("shape", ["giant", "singles", "mixed"])
def test_segment_percentile_matches_plain(dev, shape):
    """Exact: NaN, +-inf, -0.0, ties, empty segments, q 0 and 1."""
    from spark_rapids_tpu_torch.ops import segmented as SG
    rng = np.random.default_rng(len(shape))
    if shape == "giant":
        counts = np.array([200_001])
    elif shape == "singles":
        counts = np.ones(200_001, np.int64)
    else:
        counts = rng.integers(0, 9, 40_000)
    n = int(counts.sum())
    seg = np.repeat(np.arange(len(counts)), counts)
    starts = np.cumsum(counts) - counts
    vals = rng.choice([-2.5, -0.0, 0.0, 1.0, np.nan, np.inf, -np.inf, 3.0],
                      n) + rng.random(n) * (rng.random(n) < 0.5)
    vals = vals[np.lexsort((vals, seg))]  # each segment ascending, NaN last
    # fewer valid values than rows in some segments (nulls sort last)
    valid = np.maximum(counts - (rng.random(len(counts)) < 0.3), 0)
    args = (torch.from_numpy(vals).to(dev),
            torch.from_numpy(starts.astype(np.int32)).to(dev),
            torch.from_numpy(valid.astype(np.int64)).to(dev),
            [0.0, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0])
    before = SG.segment_percentile.launches
    got = SG.segment_percentile(*args)
    assert SG.segment_percentile.launches == before + 1
    want = SG.segment_percentile_plain(*args)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=0.0, atol=0.0,
                               equal_nan=True)
    assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))


def test_mortgage_jobs_on_cuda_match_cpu(dev, tmp_path):
    """The three jobs at sf 2 (2,000 loans): K13i and K9's hash mode run
    on percentiles and agg_join, K4p on percentiles, K6 on agg_join; the
    rows are the CPU's."""
    import math
    from spark_rapids_tpu_torch.bench import mortgage as M
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.ops import partition as P
    from spark_rapids_tpu_torch.ops import segmented as SG
    from spark_rapids_tpu_torch.ops import strings as STR
    d = str(tmp_path / "sf2")
    M.generate_mortgage(d, sf=2, seed=7)
    need = {"percentiles": (STR.hex_string, SG.segment_percentile,
                            P.murmur3_columns),
            "agg_join": (STR.hex_string, P.murmur3_columns, J._key_ids),
            "simple_agg": (SG.segment_aggregate,)}
    for job, counters in need.items():
        before = [c.launches for c in counters]
        got = M.MORTGAGE_QUERIES[job](TorchSession(), d).collect()
        assert all(c.launches > b for c, b in zip(counters, before)), job
        want = M.MORTGAGE_QUERIES[job](TorchSession(device="cpu"),
                                       d).collect()
        assert len(got) == len(want) > 0, job
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, float):
                    assert math.isclose(a, b, rel_tol=1e-9), (job, g, w)
                else:
                    assert a == b, (job, g, w)


@pytest.mark.parametrize("keys", [[1], [0, 1], []])
def test_sorted_group_by_percentile_matches_cpu(dev, keys):
    """K1's value sort, K4's valid counts and K4p against the whole CPU
    path: every q over one column rides one K4p launch."""
    rng = np.random.default_rng(len(keys) + 40)
    rb = _record_batch(rng, 50_000)
    specs = [G.AggSpec("percentile", 3, q) for q in (0.0, 0.5, 0.9, 1.0)] \
        + [G.AggSpec("min", 3), G.AggSpec("count", 3)]
    before = G.segment_percentile.launches
    got = G.sorted_group_by(ColumnBatch.from_arrow(rb, dev), keys, specs)
    assert G.segment_percentile.launches == before + 1
    want = G.sorted_group_by(ColumnBatch.from_arrow(rb, "cpu"), keys, specs)
    assert got.num_rows == want.num_rows
    for a, b in zip(got.columns, want.columns):
        _same(type(a)(a.data.cpu(), a.validity.cpu(), a.dtype,
                      None if a.lengths is None else a.lengths.cpu()), b)


_K8_OUT = [(torch.int8, 4), (torch.int16, 12), (torch.int32, 28),
           (torch.int64, 32), (torch.int64, 20), (torch.int32, 1),
           (torch.bool, 1), (torch.float64, 16), (torch.float64, 32),
           (None, 1)]


@pytest.mark.parametrize("out,bits", _K8_OUT)
@pytest.mark.parametrize("nulls", ["none", "some", "all"])
def test_decode_fixed_matches_plain(dev, out, bits, nulls):
    """K8a against its plain version on random words: every output kind
    (None: the validity alone), straddling widths, FOR bases near the
    int64 limits, divisors and scales; exact, doubles bit for bit."""
    from spark_rapids_tpu_torch.columnar import wirecodec as WC
    g = torch.Generator(device=dev).manual_seed(bits + len(nulls))
    n = 100_003
    words = torch.randint(-2**31, 2**31, (WC.packed_words(n, bits),),
                          generator=g, dtype=torch.int32, device=dev)
    vwords = None
    if nulls != "none":
        vwords = torch.randint(-2**31, 2**31, (WC.packed_words(n, 1),),
                               generator=g, dtype=torch.int32, device=dev)
        if nulls == "all":
            vwords.zero_()
    if out is None:
        before = WC.decode_fixed.launches
        _d, got = WC.decode_fixed(None, vwords if vwords is not None
                                  else words, n)
        assert WC.decode_fixed.launches == before + 1
        _d, want = WC.decode_fixed_plain(None, vwords if vwords is not None
                                         else words, n)
        assert torch.equal(got, want)
        return
    for base, factor in ((0, 1), (-2**63, 1), (2**63 - 2**32, 1),
                         (-7, 1_000_000), (123, 1_000), (-2**40, 0.01),
                         (2**52, 1.0)):
        if isinstance(factor, float) != (out == torch.float64):
            continue
        b = torch.tensor([base], dtype=torch.int64, device=dev)
        got = WC.decode_fixed(words, vwords, n, bits, b, factor, out)
        want = WC.decode_fixed_plain(words, vwords, n, bits, b, factor, out)
        assert torch.equal(got[1], want[1])
        if out == torch.float64:
            assert torch.equal(got[0].view(torch.int64),
                               want[0].view(torch.int64))
        else:
            assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("w", [4, 8, 16, 32, 64, 256])
@pytest.mark.parametrize("bits", [1, 4, 12])
def test_decode_dict_matches_plain(dev, w, bits):
    """K8b against its plain version: dictionaries of base + 2^bits rows
    (every index valid), nulls, widths 4 to 256."""
    from spark_rapids_tpu_torch.columnar import wirecodec as WC
    g = torch.Generator(device=dev).manual_seed(w + bits)
    n, base = 70_001, 5
    k = base + (1 << bits)
    words = torch.randint(-2**31, 2**31, (WC.packed_words(n, bits),),
                          generator=g, dtype=torch.int32, device=dev)
    vwords = torch.randint(-2**31, 2**31, (WC.packed_words(n, 1),),
                           generator=g, dtype=torch.int32, device=dev)
    lens = torch.randint(0, w + 1, (k,), generator=g, dtype=torch.int32,
                         device=dev)
    mat = torch.randint(0, 256, (k, w), generator=g, dtype=torch.int32,
                        device=dev).to(torch.uint8)
    mat = torch.where(torch.arange(w, device=dev)[None, :] < lens[:, None],
                      mat, 0).to(torch.uint8)
    b = torch.tensor([base], dtype=torch.int64, device=dev)
    before = WC.decode_dict.launches
    for v in (vwords, None):
        got = WC.decode_dict(words, v, n, bits, b, mat, lens)
        want = WC.decode_dict_plain(words, v, n, bits, b, mat, lens)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert WC.decode_dict.launches == before + 2


def test_from_arrow_codec_on_cuda_matches_cpu(dev):
    """One copy and K8 on the card give the CPU's leaves, codec on and
    off, for every column kind of the test batch."""
    from spark_rapids_tpu_torch.columnar import wirecodec as WC
    rng = np.random.default_rng(80)
    rb = _record_batch(rng, 50_000)
    before = WC.decode_fixed.launches, WC.decode_dict.launches
    for codec in (True, False):
        got = ColumnBatch.from_arrow(rb, dev, codec=codec)
        want = ColumnBatch.from_arrow(rb, "cpu", codec=codec)
        for a, b in zip(got.columns, want.columns):
            _same(type(a)(a.data.cpu(), a.validity.cpu(), a.dtype,
                          None if a.lengths is None else a.lengths.cpu()), b)
    assert WC.decode_fixed.launches > before[0]
    assert WC.decode_dict.launches > before[1]


# ---------------------------------------------------------------------------
# K14: explode of split strings and of arrays
# ---------------------------------------------------------------------------

_DELIM = 0x20
#: bytes besides the delimiter: NUL, ASCII, ',' and the bytes of 2-, 3-
#: and 4-byte UTF-8 sequences
_OTHER = [0, ord("a"), ord("b"), ord(","), 0xC3, 0xA9, 0xE2, 0x82, 0xAC,
          0xF0, 0x9F, 0x98, 0x80]


def _split_stress(n: int, w: int, seed: int, dev, null_p: float = 0.1):
    """Seeded strings [n, w] on ``dev``: per row a delimiter share of 0,
    5%, 30% or 100% (leading, trailing and consecutive delimiters come
    with it), lengths 0..w with a tenth at w, NULs and UTF-8 bytes,
    nulls; zero past each length."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev)

    other = torch.tensor(_OTHER, dtype=torch.uint8, device=dev)
    share = torch.tensor([0, 13, 77, 256], device=dev)[ints(4, (n,))]
    data = torch.where(ints(256, (n, w)) < share[:, None],
                       torch.tensor(_DELIM, dtype=torch.uint8, device=dev),
                       other[ints(len(_OTHER), (n, w))])
    lengths = ints(w + 1, (n,))
    lengths = torch.where(ints(10, (n,)) == 0, w, lengths)
    valid = ints(1000, (n,)) >= int(null_p * 1000)
    lengths = torch.where(valid, lengths, 0).to(torch.int32)
    inside = torch.arange(w, device=dev)[None, :] < lengths[:, None]
    return torch.where(inside, data, 0).to(torch.uint8), lengths, valid


def _split_both(data, lengths, valid, outer, out_w=None):
    from spark_rapids_tpu_torch.columnar.column import round_string_width
    from spark_rapids_tpu_torch.ops import generate as GE
    got = GE.split_counts(data, lengths, valid, _DELIM, outer)
    want = GE.split_counts_plain(data, lengths, valid, _DELIM, outer)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    emit, total, widest = got
    w = out_w or round_string_width(widest)
    a = GE.split_emit(data, lengths, valid, _DELIM, outer, emit, total, w)
    b = GE.split_emit_plain(data, lengths, valid, _DELIM, outer, emit,
                            total, w)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    return total


@pytest.mark.parametrize("w", [4, 8, 12, 16, 20, 64, 256])
@pytest.mark.parametrize("outer", [False, True])
def test_split_explode_matches_plain(dev, w, outer):
    from spark_rapids_tpu_torch.ops import generate as GE
    data, lengths, valid = _split_stress(4099, w, 140 + w, dev)
    before = GE.split_counts.launches, GE.split_emit.launches
    assert _split_both(data, lengths, valid, outer) > 0
    # the input's own width, and a narrower width below it
    _split_both(data, lengths, valid, outer, out_w=w)
    assert GE.split_counts.launches == before[0] + 2
    assert GE.split_emit.launches == before[1] + 2


def test_split_explode_all_null(dev):
    from spark_rapids_tpu_torch.ops import generate as GE
    data, lengths, valid = _split_stress(1000, 16, 7, dev, null_p=1.0)
    emit, total, widest = GE.split_counts(data, lengths, valid, _DELIM,
                                          False)
    assert total == 0 and widest == 0 and not bool(emit.any())
    assert _split_both(data, lengths, valid, True) == 1000


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.int64,
                                   torch.float32, torch.float64, torch.bool])
@pytest.mark.parametrize("w", [1, 4, 16, 64])
@pytest.mark.parametrize("outer", [False, True])
def test_array_explode_matches_plain(dev, dtype, w, outer):
    from spark_rapids_tpu_torch.ops import generate as GE
    g = torch.Generator(device=dev).manual_seed(w)
    n = 5003
    if dtype.is_floating_point:
        vals = torch.tensor([0.0, -0.0, 1.5, float("nan"), float("inf")],
                            dtype=dtype, device=dev)
        data = vals[torch.randint(0, 5, (n, w), generator=g, device=dev)]
    elif dtype == torch.bool:
        data = torch.randint(0, 2, (n, w), generator=g, device=dev) > 0
    else:
        data = torch.randint(-100, 100, (n, w), generator=g,
                             device=dev).to(dtype)
    lengths = torch.randint(0, w + 1, (n,), generator=g,
                            device=dev).to(torch.int32)
    valid = torch.randint(0, 8, (n,), generator=g, device=dev) > 0
    lengths = torch.where(valid, lengths, 0)
    inside = torch.arange(w, device=dev)[None, :] < lengths[:, None]
    data = torch.where(inside, data, torch.zeros((), dtype=dtype,
                                                 device=dev))
    emit, total = GE.array_counts(lengths, valid, outer)
    before = GE.array_emit.launches
    got = GE.array_emit(data, lengths, valid, outer, emit, total)
    want = GE.array_emit_plain(data, lengths, valid, outer, emit, total)
    assert GE.array_emit.launches == before + 1
    # bit for bit: -0.0 and NaN included
    assert torch.equal(got[0].view(torch.uint8), want[0].view(torch.uint8))
    for x, y in zip(got[1:], want[1:]):
        assert torch.equal(x, y)


def test_generate_paths_on_cuda_match_cpu(dev, tmp_path):
    """review_words and basket_items at sf 0.05 through TorchSession() on
    the card and on the CPU; K14a/K14b launch on the first, K14c on the
    second, once per scan batch."""
    from spark_rapids_tpu_torch.bench import generate_queries as GQ
    from spark_rapids_tpu_torch.ops import generate as GE
    for name, counters in (("review_words", (GE.split_counts,
                                             GE.split_emit)),
                           ("basket_items", (GE.array_emit,))):
        build, prepare, _fact = GQ.GENERATE_PATHS[name]
        data_dir = prepare(str(tmp_path), 0.05)
        before = [c.launches for c in counters]
        got = build(TorchSession(), data_dir).collect()
        assert [c.launches - b for c, b in zip(counters, before)] == \
            [1] * len(counters)
        want = build(TorchSession(device="cpu"), data_dir).collect()
        assert got == want and got


def test_mesh_pack_and_unpack_match_their_plain_versions(dev):
    """K15a and K15b on the card against their plain versions: sources of
    uneven rows (one empty), string widths that differ by source."""
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    from spark_rapids_tpu_torch.ops.partition import partition_order
    from spark_rapids_tpu_torch.parallel.mesh_shuffle import count_matrix
    rng = np.random.default_rng(15)
    p = 5
    sources = [ColumnBatch.from_arrow(_record_batch(rng, n), dev)
               for n in (3000, 0, 17, 40000)]
    orders = []
    for b in sources:
        ids = torch.tensor(rng.integers(0, p, b.num_rows), dtype=torch.int32,
                           device=dev)
        orders.append(partition_order(ids, p)[:2] if b.num_rows else
                      (torch.empty(0, dtype=torch.int32, device=dev),
                       torch.zeros(p, dtype=torch.int32, device=dev)))
    matrix = count_matrix([c for _p, c in orders])
    packs = []
    for s, (b, (perm, _c)) in enumerate(zip(sources, orders)):
        buf, layout = ME.mesh_pack(b.columns, perm, matrix[s])
        assert torch.equal(buf, ME.mesh_pack_plain(b.columns, perm,
                                                   matrix[s]))
        packs.append((buf, layout))
    for d in range(p):
        segs = [ME.section_columns(buf[sec[d]:sec[d + 1]],
                                   sources[s].columns, matrix[s][d],
                                   blocks[d], sec[d])
                for s, (buf, (sec, blocks)) in enumerate(packs)]
        counts = [matrix[s][d] for s in range(len(sources))]
        got = ME.mesh_unpack(segs, counts)
        want = ME.mesh_unpack_plain(segs, counts)
        for g, w in zip(got, want):
            assert torch.equal(g.data.contiguous().view(torch.uint8),
                               w.data.contiguous().view(torch.uint8))
            assert torch.equal(g.validity, w.validity)
            if w.lengths is not None:
                assert torch.equal(g.lengths, w.lengths)


def test_mesh_queries_on_the_card_match_the_cpu(dev, monkeypatch):
    """A grouped aggregate, a join and a TopN over 8 virtual slots on the
    card return the CPU's rows."""
    monkeypatch.setenv("SRT_VIRTUAL_DEVICES", "8")
    from spark_rapids_tpu_torch.expr.aggregates import CountStar, Sum
    from spark_rapids_tpu_torch.expr.core import col
    rng = np.random.default_rng(8)
    n = 50000
    data = {"k": rng.integers(0, 300, n).astype(np.int32),
            "v": rng.integers(-99, 99, n).astype(np.int64)}
    schema = T.Schema([T.StructField("k", T.IntegerType()),
                       T.StructField("v", T.LongType())])
    dim = {"k": np.arange(0, 300, 3, dtype=np.int32),
           "name": [f"n{i % 7}" for i in range(100)]}
    dschema = T.Schema([T.StructField("k", T.IntegerType()),
                        T.StructField("name", T.StringType())])
    conf = {"spark.rapids.tpu.mesh.deviceCount": 8}
    out = []
    for device in (dev, "cpu"):
        s = TorchSession(conf, device=device)
        f = s.from_pydict(data, schema, partitions=4, rows_per_batch=8192)
        d = s.from_pydict(dim, dschema)
        out.append(f.join(d, on="k").group_by("name")
                   .agg(Sum(col("v")).alias("sv"), CountStar().alias("c"))
                   .order_by(("sv", False), ("name", True)).limit(5)
                   .collect())
    assert out[0] == out[1] and len(out[0]) == 5


def test_range_partition_many_keys_and_global_bounds(dev):
    """K11 where its descriptors leave the kernel's parameters (40 keys)
    and where the bounds' fields leave shared memory (P 1024 over three
    keys, strings narrower in the rows than in the bounds), and rows that
    tie with the bounds on every key but the last."""
    from spark_rapids_tpu_torch.ops import range_partition as RP
    from spark_rapids_tpu_torch.ops.sort import SortOrder, sort_permutation
    rng = np.random.default_rng(13)
    wide = ColumnBatch.from_arrow(_record_batch(rng, 30_000), dev)
    rb = _record_batch(rng, 20_003)
    short = pa.array([None if v is None or len(v) > 4 else v
                      for v in rb.column(0).to_pylist()], pa.string())
    narrow = ColumnBatch.from_arrow(pa.RecordBatch.from_arrays(
        [short] + list(rb.columns[1:]), names=rb.schema.names), dev)

    def check(keys, orders, parts):
        wk = [wide.columns[k] for k in keys]
        perm = sort_permutation(ColumnBatch(wk, wide.num_rows, None, dev),
                                orders)
        pos = torch.clamp(torch.arange(1, parts, device=dev)
                          * wide.num_rows // parts, 0, wide.num_rows - 1)
        bounds = RP.RangeBounds(K.gather_columns(wk, perm[pos]), orders)
        rows = [narrow.columns[k] for k in keys]
        before = RP.range_partition_ids.launches
        got = RP.range_partition_ids(rows, bounds)
        assert RP.range_partition_ids.launches == before + 1
        assert torch.equal(got, RP.range_partition_ids_plain(rows, bounds))
        return bounds, rows

    keys = [5, 1, 6, 4, 2] * 8
    orders = [SortOrder(i, i % 3 != 0, i % 2 == 0) for i in range(40)]
    assert len(keys) > RP.PARAM_KEYS
    check(keys, orders, 8)
    orders = [SortOrder(0, True, False), SortOrder(1, False, True),
              SortOrder(2, True, True)]
    bounds, rows = check([0, 3, 1], orders, 1024)
    assert bounds.at(bounds.widths(rows))[2].numel() * 8 > RP.SHARED_BYTES
    check([5, 1, 2], [SortOrder(i, i != 1, True) for i in range(3)], 8)


def test_mesh_unpack_of_shard_slices_matches_plain(dev):
    """K15b over an all-gather's shard columns: slices at odd row offsets
    (unaligned sources and destinations), 0-row shards, one-row shards
    (spans under 16 bytes), a source whose strings are narrower than the
    others', and 4096 shards, whose span table leaves the kernel's
    parameters."""
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    rng = np.random.default_rng(16)
    wide = ColumnBatch.from_arrow(_record_batch(rng, 60_001), dev)
    rb = _record_batch(rng, 999)
    short = pa.array([None if v is None or len(v) > 3 else v
                      for v in rb.column(0).to_pylist()], pa.string())
    narrow = ColumnBatch.from_arrow(pa.RecordBatch.from_arrays(
        [short] + list(rb.columns[1:]), names=rb.schema.names), dev)
    assert narrow.columns[0].max_len < wide.columns[0].max_len
    cuts = [0, 1, 1, 2, 7, 33_333, 33_334, 60_001]
    shards = [K.slice_rows(wide, lo, hi) for lo, hi in zip(cuts, cuts[1:])]
    shards.insert(3, narrow)
    for group in (shards, [K.slice_rows(wide, i * 14, i * 14 + (i % 29))
                           for i in range(4096)]):
        segs = [b.columns for b in group]
        counts = [b.num_rows for b in group]
        before = ME.mesh_unpack.launches
        got = ME.mesh_unpack(segs, counts)
        assert ME.mesh_unpack.launches == before + 1
        for g, w in zip(got, ME.mesh_unpack_plain(segs, counts)):
            assert torch.equal(g.data.contiguous().view(torch.uint8),
                               w.data.contiguous().view(torch.uint8))
            assert torch.equal(g.validity, w.validity)
            if w.lengths is not None:
                assert torch.equal(g.lengths, w.lengths)


def _int_key(x, valid, dt):
    """A key column of ``x`` on the card, null rows zeroed."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    return DeviceColumn(torch.where(valid, x, torch.zeros_like(x)), valid, dt)


def _sorted_like_plain(monkeypatch, batch, orders):
    """K1 against its plain version; returns the plan the wrapper used."""
    plans = []
    real = S.sort_plan

    def spy(*args, **kw):
        plans.append(real(*args, **kw))
        return plans[-1]
    monkeypatch.setattr(S, "sort_plan", spy)
    before = S.sort_permutation.launches
    got = S.sort_permutation(batch, orders)
    assert S.sort_permutation.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, S.sort_permutation_plain(batch, orders))
    assert len(plans) == 1
    return plans[0]


@pytest.mark.parametrize("n", [4095, 4096, 4097, (1 << 24) + 7])
def test_radix_sort_tile_edges_match_plain(dev, monkeypatch, n):
    """K1's tiles of 4096 rows: one short of a tile, one tile, one over,
    and a partial last tile after 4096 full ones; nulls last in both
    directions."""
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    valid = torch.rand(n, generator=g, device=dev) < 0.9
    cols = [_int_key(torch.randint(-1000, 1000, (n,), generator=g,
                                   device=dev, dtype=torch.int32), valid,
                     T.IntegerType()),
            _int_key(torch.randint(0, 4, (n,), generator=g, device=dev),
                     torch.ones(n, dtype=torch.bool, device=dev),
                     T.LongType())]
    batch = ColumnBatch(cols, n, None, dev)
    plan = _sorted_like_plain(monkeypatch, batch,
                              [S.SortOrder(1, False), S.SortOrder(0, True,
                                                                  False)])
    # every bit of the int (negative and positive values), its null
    # indicator and two bits of the long: one 64-bit word, five passes
    assert plan.words == (35,) and plan.wide


@pytest.mark.parametrize("digits", range(1, 10))
def test_radix_sort_digit_counts_match_plain(dev, monkeypatch, digits):
    """One to nine varying 8-bit digits: a long below 2^(8d - 1) (one
    word, d passes, the last one 7 bits wide), and at nine a full-range
    long under a bool, 65 bits: two 64-bit words."""
    n = 300_007
    g = torch.Generator(device=dev)
    g.manual_seed(digits)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    if digits < 9:
        hi = 1 << (8 * digits - 1)
        x = torch.randint(0, hi // 2, (n,), generator=g, device=dev) * 2 \
            + torch.randint(0, 2, (n,), generator=g, device=dev)
        x[0], x[1] = 0, hi - 1  # every bit varies
        cols = [_int_key(x, ones, T.LongType())]
        orders = [S.SortOrder(0, digits % 2 == 0)]
    else:
        x = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g,
                          device=dev) * 2 + torch.randint(
                              0, 2, (n,), generator=g, device=dev)
        b = torch.rand(n, generator=g, device=dev) < 0.5
        cols = [_int_key(b, ones, T.BooleanType()),
                _int_key(x, ones, T.LongType())]
        orders = [S.SortOrder(0, False), S.SortOrder(1, True)]
    plan = _sorted_like_plain(monkeypatch, ColumnBatch(cols, n, None, dev),
                              orders)
    assert sum(len(p) for p in plan.passes) == digits
    if digits == 9:
        assert plan.wide and plan.words == (64, 1)


def test_radix_sort_wide_mixed_keys_match_plain(dev, monkeypatch):
    """A double with NaN, -0.0 and nulls, a W 13 string and a long over
    100 varying bits: three words, later words read through the
    permutation so far."""
    rng = np.random.default_rng(41)
    pb = ColumnBatch.from_arrow(_record_batch(rng, 200_000), dev)
    orders = [S.SortOrder(3, False, None), S.SortOrder(0, True, False),
              S.SortOrder(2, True, None), S.SortOrder(6, False, True)]
    plan = _sorted_like_plain(monkeypatch, pb, orders)
    assert plan.wide and len(plan.words) >= 2


def test_radix_sort_keeps_ties_stable(dev, monkeypatch):
    """2^22 rows of one key among 100,000 others: equal keys keep their
    input order."""
    n = (1 << 22) + 100_000
    g = torch.Generator(device=dev)
    g.manual_seed(22)
    x = torch.full((n,), 5, dtype=torch.int32, device=dev)
    other = torch.randperm(n, generator=g, device=dev)[:100_000]
    x[other] = torch.randint(-50, 50, (100_000,), generator=g, device=dev,
                             dtype=torch.int32)
    cols = [_int_key(x, torch.ones(n, dtype=torch.bool, device=dev),
                     T.IntegerType())]
    _sorted_like_plain(monkeypatch, ColumnBatch(cols, n, None, dev),
                       [S.SortOrder(0, False)])


def test_sort_batch_on_cuda_matches_cpu(dev):
    """sort_batch end to end: K1 then K3's gather, every column."""
    rng = np.random.default_rng(44)
    rb = _record_batch(rng, 70_001)
    orders = [S.SortOrder(0, False, None), S.SortOrder(4, True, False),
              S.SortOrder(3, True, True)]
    got = S.sort_batch(ColumnBatch.from_arrow(rb, dev), orders)
    want = S.sort_batch(ColumnBatch.from_arrow(rb, torch.device("cpu")),
                        orders)
    for a, b in zip(got.to(torch.device("cpu")).columns, want.columns):
        _same(a, b)


def test_pack_keys_limbs_on_cuda(dev):
    """pack_keys keeps every bit: an int32 key ascending with nulls first
    packs as (valid << 32) | (x ^ 2^31) in one limb."""
    n = 10_001
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    valid = torch.rand(n, generator=g, device=dev) < 0.8
    col = _int_key(torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                                 device=dev, dtype=torch.int32), valid,
                   T.IntegerType())
    limbs = S.pack_keys([col], [S.SortOrder(0, True, True)])
    want = (valid.to(torch.int64) << 32) | \
        ((col.data.to(torch.int64) & 0xFFFFFFFF) ^ (1 << 31))
    assert limbs.shape == (1, n) and torch.equal(limbs[0], want)


@pytest.mark.parametrize("p", [1, 8, 4096])
def test_mesh_pack_matches_plain_at_mesh_sizes(dev, p):
    """K15a at P 1, 8 and 4096 (whose table leaves the kernel's
    parameters) over an int64 column, a W 16 and a W 13 string, nulls,
    K10's order; a 4-byte offset slice so that the data is not 16-byte
    aligned."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import mesh_exchange as ME
    from spark_rapids_tpu_torch.ops.partition import partition_order
    n = 300_001
    g = torch.Generator(device=dev)
    g.manual_seed(p)

    def string(w):
        lens = torch.randint(0, w + 1, (n + 1,), generator=g, device=dev,
                             dtype=torch.int32)
        data = torch.randint(1, 256, (n + 1, w), generator=g, device=dev,
                             dtype=torch.uint8)
        data[torch.arange(w, device=dev)[None, :] >= lens[:, None]] = 0
        return DeviceColumn(data[1:], torch.ones(n, dtype=torch.bool,
                                                 device=dev),
                            T.StringType(), lens[1:])

    valid = torch.rand(n + 1, generator=g, device=dev) < 0.9
    longs = torch.randint(-2 ** 62, 2 ** 62, (n + 1,), generator=g,
                          device=dev)
    cols = [DeviceColumn(torch.where(valid, longs, 0)[1:], valid[1:],
                         T.LongType()), string(16), string(13)]
    ids = torch.randint(0, p, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    perm, counts = partition_order(ids, p)[:2]
    counts = [int(c) for c in counts.tolist()]
    before = ME.mesh_pack.launches
    buf, _layout = ME.mesh_pack(cols, perm, counts)
    assert ME.mesh_pack.launches == before + 1
    assert torch.equal(buf, ME.mesh_pack_plain(cols, perm, counts))


# ---------------------------------------------------------------------------
# K4 in three launches a call, K8a in one launch a batch
# ---------------------------------------------------------------------------

_K4_SPECS = [("sum", 1), ("sum", 2), ("avg", 2), ("avg", 1), ("sum", 2),
             ("count", 2), ("count_star", 0), ("min", 1), ("max", 2),
             ("min", 3), ("max", 3), ("first", 2), ("last", 1),
             ("first_non_null", 2), ("last_non_null", 3), ("count", 3)]


def _k4_batch(dev, n: int, groups: int, seed: int):
    """n rows sorted by an int64 key of about ``groups`` groups (n: every
    row its own), an int32, a double (NaN, -0.0, nulls) and a bool
    column."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    rng = np.random.default_rng(seed)
    key = np.sort(rng.integers(0, groups, n)) if groups < n else \
        np.arange(n)

    def col(x, null_p, dt):
        v = rng.random(n) >= null_p
        t = torch.from_numpy(np.where(v, x, np.zeros((), x.dtype)))
        return DeviceColumn(t.to(dev), torch.from_numpy(v).to(dev), dt)
    return ColumnBatch([
        col(key.astype(np.int64), 0.0, T.LongType()),
        col(rng.integers(-1000, 1000, n).astype(np.int32), 0.1,
            T.IntegerType()),
        col(rng.choice([1.5, -0.0, 0.0, np.nan, 2.25, -3e10], n)
            * rng.random(n), 0.1, T.DoubleType()),
        col(rng.random(n) < 0.5, 0.2, T.BooleanType())], n, None, dev)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, (1 << 20) + 1])
@pytest.mark.parametrize("shape", ["one", "third", "each"])
def test_segment_aggregate_three_launches_match_plain(dev, n, shape):
    """K4 at its tile edges with one group, ~n/3 groups and a group a
    row: keys, every covered op, duplicates (a sum beside its avg),
    against the plain version; double sums within rtol 1e-9 and with the
    same bits on a second run; a boundary pass a call."""
    groups = {"one": 1, "third": max(n // 3, 1), "each": n}[shape]
    sb = _k4_batch(dev, n, groups, n + len(shape))
    specs = [G.AggSpec(o, c) for o, c in _K4_SPECS]
    before = G._segment_flags.launches, G.segment_aggregate.launches
    gk, ga, g = G.segment_aggregate(sb, [0], specs)
    assert (G._segment_flags.launches, G.segment_aggregate.launches) == \
        (before[0] + 1, before[1] + 1)
    again = G.segment_aggregate(sb, [0], specs)[1]
    wk, wa, wg = G.segment_aggregate_plain(sb, [0], specs)
    assert g == wg
    _same(gk[0], wk[0])
    for spec, a, b, c in zip(specs, ga, wa, again):
        assert torch.equal(a.validity, b.validity), spec
        if a.data.dtype == torch.float64 and spec.op in ("sum", "avg"):
            torch.testing.assert_close(a.data, b.data, rtol=1e-9, atol=0.0,
                                       equal_nan=True)
            assert torch.equal(a.data.view(torch.int64),
                               c.data.view(torch.int64)), spec
        else:
            _same(a, b)
    # the grand aggregate: no boundary pass
    before = G._segment_flags.launches
    _gk, ga, g = G.segment_aggregate(sb, [], specs)
    assert G._segment_flags.launches == before and g == 1
    for spec, a, b in zip(specs, ga, G.segment_aggregate_plain(sb, [],
                                                               specs)[1]):
        assert torch.equal(a.validity, b.validity), spec
        torch.testing.assert_close(a.data, b.data, rtol=1e-9, atol=0.0,
                                   equal_nan=True)


_K8_EDGES = [1, 4095, 4096, 4097, (1 << 20) + 1]


@pytest.mark.parametrize("n", _K8_EDGES)
def test_decode_batch_every_kind_and_width_matches_plain(dev, n):
    """K8a in one launch over every kind and width of a batch (int8-int64
    at each bit bucket they take, bool, doubles at both scales, validity
    alone, all-valid and all-null validity), exact against the plain
    version, doubles bit for bit."""
    from spark_rapids_tpu_torch.columnar import wirecodec as WC
    g = torch.Generator(device=dev).manual_seed(n)

    def words(bits):
        return torch.randint(-2**31, 2**31, (WC.packed_words(n, bits),),
                             generator=g, dtype=torch.int32, device=dev)
    vpatterns = [None, words(1), torch.zeros_like(words(1))]
    streams = []
    for i, bits in enumerate((1, 2, 4, 8, 12, 16, 20, 24, 28, 32)):
        v = vpatterns[i % 3]
        for out, base, factor in ((torch.int64, -2**63, 1),
                                  (torch.int64, 2**40, 1_000_000),
                                  (torch.float64, -2**40, 0.01),
                                  (torch.float64, 2**52, 1.0)):
            b = torch.tensor([base], dtype=torch.int64, device=dev)
            streams.append((words(bits), v, bits, b, factor, out))
        if bits <= 28:
            streams.append((words(bits), v, bits, None, 1, torch.int32))
        if bits <= 12:
            streams.append((words(bits), v, bits, None, 1, torch.int16))
        if bits <= 4:
            streams.append((words(bits), v, bits, None, 1, torch.int8))
    streams.append((words(1), vpatterns[1], 1, None, 1, torch.bool))
    streams.append((None, vpatterns[1], 0, None, 1, None))
    streams.append((None, vpatterns[2], 0, None, 1, None))
    before = WC.decode_fixed.launches
    got = WC.decode_jobs([WC.k8a_job(
        0 if w is None else w.data_ptr(), 0 if v is None else v.data_ptr(),
        0 if b is None else b.data_ptr(), bits, factor, out)
        for w, v, bits, b, factor, out in streams], n, dev)
    assert WC.decode_fixed.launches == before + 1
    for s, (d, v) in zip(streams, got):
        wd, wv = WC.decode_fixed_plain(s[0], s[1], n, *s[2:])
        assert torch.equal(v, wv)
        if d is None:
            assert wd is None
            continue
        assert d.dtype == wd.dtype
        if d.dtype == torch.float64:
            d, wd = d.view(torch.int64), wd.view(torch.int64)
        assert torch.equal(d, wd), s[2:]


def test_packed_batch_decodes_in_one_launch(dev):
    """A scan batch on the card: one K8a launch for every encoded stream,
    equal to the plain per-column decode and to the raw upload."""
    from spark_rapids_tpu_torch.columnar import wirecodec as WC
    rng = np.random.default_rng(81)
    rb = _record_batch(rng, 70_001)
    packed = ColumnBatch.stage_arrow(rb, dev, codec=True)
    buf = packed.buf.to(dev)
    before = WC.decode_fixed.launches
    got = packed.decode(buf)
    assert WC.decode_fixed.launches == before + 1
    for a, b in zip(got, packed.decode(buf, plain=True)):
        _same(a, b)
    for a, b in zip(got, ColumnBatch.from_arrow(rb, dev, codec=False)
                    .columns):
        _same(a, b)


# ---------------------------------------------------------------------------
# K2 as two launches a call, K5 over its search layout with K7's offsets
# ---------------------------------------------------------------------------

def _compact_batch(dev, rng, n: int):
    """_record_batch's columns (a wide string: the chunk path) and an
    int8 and a narrow string column (one load a row)."""
    rb = _record_batch(rng, n)
    narrow = np.array(["", "a", "ab", "abc"], dtype=object)
    rb = pa.RecordBatch.from_arrays(
        list(rb.columns) + [
            pa.array(rng.integers(-100, 100, n).astype(np.int8),
                     mask=rng.random(n) < 0.1),
            pa.array(list(narrow[rng.integers(0, 4, n)]), type=pa.string(),
                     mask=rng.random(n) < 0.1)],
        names=list(rb.schema.names) + ["b8", "s4"])
    return ColumnBatch.from_arrow(rb, dev)


@pytest.mark.parametrize("share", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, (1 << 20) + 1])
def test_compact_two_launches_match_plain(dev, n, share):
    """K2 at its tile edges and past the column split (2^20 + 1 rows: 257
    tiles), every keep share: exact against the plain version, one count
    a call, the status left zero, a second call on the same status the
    same."""
    rng = np.random.default_rng(n + int(share * 100))
    pb = _compact_batch(dev, rng, n)
    keep = torch.from_numpy(rng.random(n) < share).to(dev)
    before = K.compact.launches
    got, want = K.compact(pb, keep), K.compact_plain(pb, keep)
    assert K.compact.launches == before + (1 if n else 0)
    assert got.num_rows == want.num_rows == int(keep.sum())
    for a, b in zip(got.columns, want.columns):
        _same(a, b)
    again = K.compact(pb, keep)
    for a, b in zip(again.columns, want.columns):
        _same(a, b)
    assert all(int(s.abs().sum()) == 0 for s in K._STATUS.values())


def test_compact_long_table_and_split_groups(dev):
    """A table past the large parameter struct (a device copy) and a call
    of one group a tile (past the split's 264 tiles)."""
    rng = np.random.default_rng(8)
    ncols = K.COMPACT_PARAM_WORDS // K.GATHER_COL_WORDS + 1
    n = 5000
    rb = pa.RecordBatch.from_arrays(
        [pa.array(rng.integers(0, 99, n).astype(np.int16),
                  mask=rng.random(n) < 0.1) for _ in range(ncols)],
        names=[f"c{i}" for i in range(ncols)])
    pb = ColumnBatch.from_arrow(rb, dev)
    keep = torch.from_numpy(rng.random(n) < 0.4).to(dev)
    for a, b in zip(K.compact(pb, keep).columns,
                    K.compact_plain(pb, keep).columns):
        _same(a, b)
    n = 300 * 4096 + 7
    pb = _compact_batch(dev, rng, n)
    keep = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    for a, b in zip(K.compact(pb, keep).columns,
                    K.compact_plain(pb, keep).columns):
        _same(a, b)


def _probe_case(dev, J, lb, rb, jts):
    """K5 over its layout, K7 over its offsets, against the plain
    versions: the offsets the exclusive sum of out_cnt, no K7 scan, the
    status left zero."""
    before = (J.build_prepare_fast.launches, J._offsets_cuda.launches)
    prep = J.build_prepare_fast(rb, 0)
    assert isinstance(prep, J.PreparedBuild) and prep.layout is not None
    _assert_tensors_equal(prep, J.build_prepare_fast_plain(rb, 0))
    for jt in jts:
        want, wtotal = J.probe_fast_plain(lb, 0, *prep, jt)
        arrays, total = J.probe_fast(lb, 0, *prep, jt, layout=prep.layout)
        _assert_tensors_equal(arrays, want)
        assert int(total.item()) == int(wtotal.item())
        oc = arrays[3].to(torch.int64)
        assert torch.equal(arrays.offsets.to(torch.int64), torch.cat(
            [oc.new_zeros(1), torch.cumsum(oc, 0)]))
        n = int(total.item())
        if n:
            _assert_tensors_equal(
                J.join_indices_from_probe(lb.num_rows, arrays, jt, n),
                J.join_indices_plain(lb.num_rows, want, jt, n))
    assert (J.build_prepare_fast.launches, J._offsets_cuda.launches) == (
        before[0] + 1, before[1])
    assert all(int(s.abs().sum()) == 0 for s in J._STATUS.values())


def _int_side(dev, keys, null_p, rng):
    return ColumnBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array(keys, mask=rng.random(len(keys)) < null_p)],
        names=["k"]), dev)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64])
def test_probe_layout_levels_match_plain(dev, dtype):
    """Build sizes on both sides of each level of the layout (the stage's
    capacity, one past, F times it, one past), the dtype's max a genuine
    key, nulls on both sides, 2 x 4096 + 1 stream rows."""
    from spark_rapids_tpu_torch.ops import join as J
    item = np.dtype(dtype).itemsize
    cap, f = J.STAGE_BYTES // item, J.NODE_BYTES // item
    info = np.iinfo(dtype)
    rng = np.random.default_rng(item)
    for nb in (cap, cap + 1, cap * f, cap * f + 1):
        hi = min(int(info.max), 4 * nb)
        keys = rng.integers(int(info.min), hi, nb).astype(dtype)
        keys[rng.random(nb) < 0.02] = info.max
        rb = _int_side(dev, keys, 0.01, rng)
        probe = np.concatenate([rng.choice(keys, 6000), rng.integers(
            int(info.min), hi, 2193)]).astype(dtype)
        probe[:5] = info.max
        lb = _int_side(dev, probe, 0.04, rng)
        jts = ("semi", "anti") if item == 1 and nb > cap * 2 else (
            "inner", "left", "semi", "anti")
        _probe_case(dev, J, lb, rb, jts)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, (1 << 20) + 1])
def test_probe_stream_edges_and_4096_matches(dev, n):
    """Stream batches at the tile's edges against a build where one key
    matches 4096 rows, an empty build and a one-row build; repeated calls
    on one status array."""
    from spark_rapids_tpu_torch.ops import join as J
    rng = np.random.default_rng(n)
    bkeys = np.concatenate([np.full(4096, 7), np.arange(20_000, 529_000),
                            [2 ** 31 - 1]]).astype(np.int32)
    lk = rng.choice(np.array([7, 8, 20_001, 528_999, 2 ** 31 - 1, -5],
                             np.int32), n,
                    p=[0.002, 0.2, 0.3, 0.3, 0.1, 0.098])
    lk[0] = 7
    lb = _int_side(dev, lk, 0.1, rng)
    jts = ("inner", "left", "semi", "anti")
    _probe_case(dev, J, lb, _int_side(dev, rng.permutation(bkeys), 0.0,
                                      rng), jts)
    for nb in (0, 1):
        _probe_case(dev, J, lb, _int_side(dev, np.full(nb, 7, np.int32),
                                          0.0, rng), jts)


@pytest.mark.parametrize("nr", [700, 70_000])
@pytest.mark.parametrize("jt", ["inner", "left", "semi", "anti", "full"])
def test_k5_paths_run_no_k7_scan(dev, jt, nr):
    """The rank path (K6 -> K1 -> K3 -> K5, its sorted ids' layout staged
    whole or, past the search's shared memory, its levels built for the
    call) writes the offsets too, full outer's anti search the tail's: K7
    scans nothing on any K5 path."""
    from spark_rapids_tpu_torch.ops import join as J
    rng = np.random.default_rng(47)
    nl = 20_000
    lb = ColumnBatch.from_arrow(_join_side(rng, nl, 500), dev)
    rb = ColumnBatch.from_arrow(_join_side(rng, nr, 500), dev)
    cap = J.STAGE_BYTES // 4
    levels = J.rank_layout.launches + (nr > cap) + (jt == "full" and nl > cap)
    before = (J._offsets_cuda.launches, J.join_search.launches,
              J.join_indices_from_probe.launches)
    arrays, total = J.join_probe(lb, rb, [1, 0], [1, 0], jt)
    want, wtotal = J.join_probe_plain(lb, rb, [1, 0], [1, 0], jt)
    _assert_tensors_equal(arrays, want)
    n = int(total.item())
    assert n == int(wtotal.item()) > 0
    _assert_tensors_equal(J.join_indices_from_probe(lb.num_rows, arrays, jt,
                                                    n),
                          J.join_indices_plain(lb.num_rows, want, jt, n))
    assert (J._offsets_cuda.launches, J.join_search.launches,
            J.join_indices_from_probe.launches) == (
        before[0], before[1] + (2 if jt == "full" else 1), before[2] + 1)
    assert J.rank_layout.launches == levels


def test_k5_k7_refuse_a_missing_layout_or_offsets(dev):
    """On the card K5's search needs the sorted keys' layout and K7 the
    offsets K5 wrote: without them each raises, and nothing launches."""
    from spark_rapids_tpu_torch.ops import join as J
    rng = np.random.default_rng(3)
    lb = _int_side(dev, rng.integers(0, 60, 700).astype(np.int32), 0.0, rng)
    rb = _int_side(dev, rng.integers(0, 50, 300).astype(np.int32), 0.0, rng)
    prep = J.build_prepare_fast(rb, 0)
    before = (J.join_search.launches, J.join_indices_from_probe.launches,
              J._offsets_cuda.launches)
    with pytest.raises(ValueError, match="search layout"):
        J.probe_fast(lb, 0, *prep, "inner")
    want, wtotal = J.probe_fast_plain(lb, 0, *prep, "inner")
    with pytest.raises(ValueError, match="offsets K5's search wrote"):
        J.join_indices_from_probe(lb.num_rows, want, "inner",
                                  int(wtotal.item()))
    assert (J.join_search.launches, J.join_indices_from_probe.launches,
            J._offsets_cuda.launches) == before
