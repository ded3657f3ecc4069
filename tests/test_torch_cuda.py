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
    for a, b in zip(K.gather_columns(pb.columns, perm),
                    K.gather_plain(pb.columns, perm)):
        _same(a, b)


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
    rng = np.random.default_rng(3)
    pb = ColumnBatch.from_arrow(_record_batch(rng, 100), dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        G.segment_aggregate(pb, [1], [G.AggSpec("min", 0)])


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
    arrays, total = J.probe_fast(lb, 0, *prep, jt)
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
        before = (J._key_ids.launches, J._segment_flags.launches)
        _assert_tensors_equal(J._key_ids(lb, rb, k, k),
                              J.key_ids_plain(lb, rb, k, k))
        assert (J._key_ids.launches, J._segment_flags.launches) == (
            before[0] + 1, before[1] + len(k))
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
