"""Murmur3 partition ids (K9) of the PyTorch/CUDA port, held against the
JAX package bit for bit.

numpy-seeded batches reach ``spark_rapids_tpu.expr.hashing.murmur3_val``
-- its numpy host path (the reference's Spark-exact oracle) and its device
path (as ``parallel/mesh_shuffle.py`` ``partition_ids_for_keys`` runs it)
-- and the port's ``ops/partition.py`` over identical leaves
(``ColumnBatch.from_leaves``).  Every key type, nulls, NaN / -0.0 / +-inf,
subnormal doubles, empty strings, multi-byte UTF-8, all-null and empty
batches and composite keys; plus Spark's own constants.

Two reference paths fail here, and the oracle takes, per key column, the
one that holds: XLA on the CPU flushes subnormal doubles to zero, so the
device path hashes ``-5e-324`` as ``0.0`` (the port and the host path
hash its bits, as Spark does: ``test_subnormal_doubles_keep_their_bits``);
and the host string path raises OverflowError under NumPy 2 for a tail
byte >= 128 (``np.uint32`` of a negative int), so strings come from the
device path.  On the CPU the port's wrappers run their plain versions; ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
hold the CUDA kernel against them on the card.
"""
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu.expr.core import EvalCtx as JEvalCtx
from spark_rapids_tpu.expr.core import Val as JVal
from spark_rapids_tpu.expr.hashing import murmur3_val as j_murmur3_val
from spark_rapids_tpu.host.batch import HostBatch
from spark_rapids_tpu.parallel.mesh_shuffle import \
    partition_ids_for_keys as j_partition_ids
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.expr.core import bind, col, eval_device
from spark_rapids_tpu_torch.expr.hashing import Murmur3Hash
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops import partition as pp

CPU = torch.device("cpu")

#: strings with multi-byte UTF-8 in block and tail positions, bytes >= 128
#: as the 1st/2nd/3rd tail byte, embedded NUL, the empty string
_WORDS = np.array(["", "a", "ab", "abc", "abcd", "abcde", "é", "aé", "abé",
                   "abcé", "日本語", "😀", "x😀", "héllo wörld", "a\x00b",
                   "\xff\xfe", "a longer string key, 31 bytes.."],
                  dtype=object)

_COLS = ["i8", "i16", "i32", "i64", "date", "ts", "f32", "f64", "bool",
         "str"]


def _record_batch(rng, n: int, null_p: float) -> pa.RecordBatch:
    def nulls():
        return rng.random(n) < null_p

    f64 = rng.choice([0.0, -0.0, 1.5, -2.25, np.nan, np.inf, -np.inf,
                      1e300, -5e-324, 3.0], n)
    f32 = rng.choice(np.array([0.0, -0.0, 1.5, np.nan, np.inf, -np.inf,
                               -7.25, 3.4e38], dtype=np.float32), n)
    i32 = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    i32[rng.random(n) < 0.2] = 1
    return pa.RecordBatch.from_arrays([
        pa.array(rng.integers(-128, 128, n).astype(np.int8), mask=nulls()),
        pa.array(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16),
                 mask=nulls()),
        pa.array(i32, mask=nulls()),
        pa.array(rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64),
                 mask=nulls()),
        pa.array(rng.integers(-1000, 30000, n).astype(np.int32),
                 mask=nulls()).cast(pa.date32()),
        pa.array(rng.integers(-2 ** 50, 2 ** 50, n, dtype=np.int64),
                 mask=nulls()).cast(pa.timestamp("us")),
        pa.array(f32, type=pa.float32(), mask=nulls()),
        pa.array(f64, mask=nulls()),
        pa.array(rng.random(n) < 0.5, mask=nulls()),
        pa.array(list(_WORDS[rng.integers(0, len(_WORDS), n)]),
                 type=pa.string(), mask=nulls()),
    ], names=_COLS)


def _pair(rb):
    """(JAX batch, port batch) over the same leaves."""
    jb = JBatch.from_arrow(rb)
    n = int(jax.device_get(jb.num_rows))
    leaves = jax.device_get([(c.data, c.validity, c.lengths)
                             for c in jb.columns])
    return jb, PBatch.from_leaves(rb.schema, leaves, n, CPU)


def _jax_hash(jb, keys) -> np.ndarray:
    """The reference's running uint32 hash over ``keys`` (device path)."""
    cap = jb.capacity
    ctx = JEvalCtx(jnp, True, cap, jb.row_mask())
    h = jnp.full(cap, 42, dtype=jnp.uint32)
    for k in keys:
        c = jb.columns[k]
        h = j_murmur3_val(JVal(c.data, c.validity, c.lengths, c.dtype), h,
                          ctx)
    return np.asarray(jax.device_get(h)).astype(np.uint32)


def _oracle_hash(rb, jb, keys) -> np.ndarray:
    """The reference's running hash, each key column through the path
    that is exact here: strings through the device path, every other type
    through the numpy host path."""
    hb = HostBatch.from_arrow(rb)
    n = rb.num_rows
    hctx = JEvalCtx(np, False, n, np.ones(n, np.bool_))
    dctx = JEvalCtx(jnp, True, jb.capacity, jb.row_mask())
    h = np.full(n, 42, dtype=np.uint32)
    for k in keys:
        if pa.types.is_string(rb.column(k).type):
            c = jb.columns[k]
            seed = np.zeros(jb.capacity, np.uint32)
            seed[:n] = h
            h = np.asarray(jax.device_get(j_murmur3_val(
                JVal(c.data, c.validity, c.lengths, c.dtype),
                jnp.asarray(seed), dctx)))[:n]
        else:
            c = hb.columns[k]
            with np.errstate(over="ignore"):
                h = j_murmur3_val(JVal(c.data, c.validity, None, c.dtype),
                                  h, hctx)
    return np.asarray(h).astype(np.uint32)


def _subnormal_rows(rb, keys) -> np.ndarray:
    """Rows where a double key is a nonzero subnormal."""
    out = np.zeros(rb.num_rows, dtype=np.bool_)
    for k in keys:
        if pa.types.is_float64(rb.column(k).type):
            v = rb.column(k).fill_null(0.0).to_numpy()
            out |= (v != 0) & (np.abs(v) < np.finfo(np.float64).tiny)
    return out


def _port_hash(pb, keys) -> np.ndarray:
    cols = [pb.columns[k] for k in keys]
    h = pp.murmur3_columns(cols, pb.num_rows, CPU)
    return h.numpy().view(np.uint32)


_KEY_SETS = {name: [i] for i, name in enumerate(_COLS)}
_KEY_SETS.update({"i32+str": [2, 9], "str+i64+f64+bool": [9, 3, 7, 8],
                  "date+ts+f32+i8+i16": [4, 5, 6, 0, 1],
                  "all": list(range(len(_COLS)))})


@pytest.mark.parametrize("keys", list(_KEY_SETS))
@pytest.mark.parametrize("null_p", [0.0, 0.2, 1.0])
def test_murmur3_matches_jax(keys, null_p):
    rng = np.random.default_rng(len(keys) * 31 + int(null_p * 10))
    rb = _record_batch(rng, 301, null_p)
    jb, pb = _pair(rb)
    k = _KEY_SETS[keys]
    got = _port_hash(pb, k)
    np.testing.assert_array_equal(got, _oracle_hash(rb, jb, k))
    sub = _subnormal_rows(rb, k)
    np.testing.assert_array_equal(got[~sub],
                                  _jax_hash(jb, k)[:pb.num_rows][~sub])


@pytest.mark.parametrize("keys", ["i32", "str", "f64", "i32+str", "all"])
@pytest.mark.parametrize("num_parts", [1, 7, 8, 200])
def test_partition_ids_match_jax(keys, num_parts):
    rng = np.random.default_rng(num_parts + len(keys))
    rb = _record_batch(rng, 517, 0.1)
    jb, pb = _pair(rb)
    k = _KEY_SETS[keys]
    want = np.asarray(jax.device_get(j_partition_ids(jb, k, num_parts)))
    got = pp.partition_ids_for_keys(pb, k, num_parts)
    assert got.dtype == torch.int32
    sub = _subnormal_rows(rb, k)
    np.testing.assert_array_equal(got.numpy()[~sub],
                                  want[:pb.num_rows][~sub])
    h = _oracle_hash(rb, jb, k).view(np.int32).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(),
                                  ((h % num_parts) + num_parts) % num_parts)
    assert got.min() >= 0 and got.max() < num_parts


def test_partition_ids_of_an_empty_batch():
    rng = np.random.default_rng(3)
    jb, pb = _pair(_record_batch(rng, 0, 0.0))
    got = pp.partition_ids_for_keys(pb, [2, 9], 8)
    assert got.shape == (0,) and got.dtype == torch.int32
    assert _port_hash(pb, [9]).shape == (0,)


def test_null_keys_land_in_pmod_of_the_seed():
    """A null key passes the seed through: every all-null row lands in
    partition pmod(42, 8) = 2 (the repartition path's null customers)."""
    rng = np.random.default_rng(5)
    _jb, pb = _pair(_record_batch(rng, 64, 1.0))
    for keys in ([2], [9], [2, 9, 7]):
        assert (pp.partition_ids_for_keys(pb, keys, 8) == 2).all()


def _one_col(arr: pa.Array):
    return _pair(pa.RecordBatch.from_arrays([arr], names=["k"]))[1]


def test_spark_constants():
    """Spark: hash(1) = -559580957, hash(1L) = -1712319331,
    hash('abc') = 1322437556 (Murmur3Hash, seed 42)."""
    for arr, want in ((pa.array([1], type=pa.int32()), -559580957),
                      (pa.array([1], type=pa.int64()), -1712319331),
                      (pa.array(["abc"]), 1322437556)):
        pb = _one_col(arr)
        assert int(pp.murmur3_columns(pb.columns, 1, CPU)[0]) == want


def test_float_specials_hash_canonically():
    """-0.0 hashes as 0.0; every NaN bit pattern as the canonical NaN."""
    neg_nan64 = np.array([0xFFF8000000000001], dtype=np.uint64) \
        .view(np.float64)[0]
    pb = _one_col(pa.array([0.0, -0.0, np.nan, neg_nan64]))
    h = pp.murmur3_columns(pb.columns, 4, CPU).tolist()
    assert h[0] == h[1] and h[2] == h[3] and h[0] != h[2]
    nan32 = np.array([0xFFC00001], dtype=np.uint32).view(np.float32)[0]
    pb = _one_col(pa.array(np.array([0.0, -0.0, np.nan, nan32],
                                    dtype=np.float32)))
    h = pp.murmur3_columns(pb.columns, 4, CPU).tolist()
    assert h[0] == h[1] and h[2] == h[3] and h[0] != h[2]


def test_subnormal_doubles_keep_their_bits():
    """The port hashes a subnormal double by its bits, as Spark and the
    reference's host path do; the reference's device path on XLA's CPU
    backend flushes it to zero and hashes 0.0."""
    rb = pa.RecordBatch.from_arrays([pa.array([-5e-324, 0.0, 2.2e-308])],
                                    names=["k"])
    jb, pb = _pair(rb)
    got = _port_hash(pb, [0])
    np.testing.assert_array_equal(got, _oracle_hash(rb, jb, [0]))
    assert got[0] != got[1]
    dev = _jax_hash(jb, [0])
    assert dev[0] == dev[1] == got[1]  # the reference's flush to 0.0


def test_murmur3_expression_matches_jax():
    rng = np.random.default_rng(11)
    rb = _record_batch(rng, 129, 0.15)
    jb, pb = _pair(rb)
    e = bind(Murmur3Hash(col("i32"), col("str"), col("f64")), pb.schema)
    assert isinstance(e.dtype, PT.IntegerType) and not e.nullable
    got = eval_device(e, pb)
    assert got.validity.all()
    np.testing.assert_array_equal(got.data.numpy().view(np.uint32),
                                  _oracle_hash(rb, jb, [2, 9, 7]))


def test_more_keys_than_one_launch_takes():
    """Keys past the kernel's 16 per launch chain through the running
    hash: the plain version folds them in the same order."""
    rng = np.random.default_rng(13)
    rb = _record_batch(rng, 77, 0.1)
    jb, pb = _pair(rb)
    keys = list(range(len(_COLS))) * 2
    np.testing.assert_array_equal(_port_hash(pb, keys),
                                  _oracle_hash(rb, jb, keys))


def test_hash_wrappers_do_not_fall_back(monkeypatch):
    """Off the CPU the K9 wrappers launch their kernel or raise."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel")

    monkeypatch.setattr(native, "lib", no_kernel)
    meta = torch.device("meta")
    rb = pa.RecordBatch.from_arrays([pa.array([1, 2, 3], type=pa.int32())],
                                    names=["k"])
    pb = _one_col(rb.column(0))
    mcols = [type(c)(c.data.to(meta), c.validity.to(meta), c.dtype)
             for c in pb.columns]
    mb = PBatch(mcols, 3, pb.schema, meta)
    with pytest.raises(RuntimeError, match="no hash_partition kernel"):
        pp.partition_ids_for_keys(mb, [0], 8)
    with pytest.raises(RuntimeError, match="no hash_partition kernel"):
        pp.murmur3_columns(mcols, 3, meta)


def test_unsupported_key_type_raises():
    with pytest.raises(TypeError, match="murmur3"):
        pp._kind(PT.ArrayType(PT.IntegerType()))


def test_dates_and_timestamps_hash_as_their_integers():
    """date -> hashInt(days), timestamp -> hashLong(micros), as Spark."""
    d = _one_col(pa.array([dt.date(1970, 1, 2)]))
    i = _one_col(pa.array([1], type=pa.int32()))
    assert pp.murmur3_columns(d.columns, 1, CPU).tolist() == \
        pp.murmur3_columns(i.columns, 1, CPU).tolist()
    t = _one_col(pa.array([1], type=pa.int64()).cast(pa.timestamp("us")))
    lng = _one_col(pa.array([1], type=pa.int64()))
    assert pp.murmur3_columns(t.columns, 1, CPU).tolist() == \
        pp.murmur3_columns(lng.columns, 1, CPU).tolist() == [-1712319331]
