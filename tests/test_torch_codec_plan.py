"""The host side of K8a (the scan's fixed-width decode) of the PyTorch/CUDA
port, on the CPU.

On the card ``PackedBatch.decode`` makes one launch of
``srt_decode_batch`` (``csrc/wirecodec.cu``) for every bit-packed stream of
a scan batch: ``PackedBatch.k8a_jobs`` lists them by device address (a
column's data, a string column's lengths, a raw leaf's validity stream
or, where it ships none, its ones), ``wirecodec.decode_outputs`` carves
every output from one allocation and ``wirecodec.decode_table`` writes
``DECODE_JOB_WORDS`` words a job.  Here a few lines of numpy execute that table on CPU tensors as
the kernel's blocks do -- (job, row tile) pairs, a thread's 4 consecutive
rows, their validity bits from one word -- standing in for the library
under ``decode_cuda`` itself.  The columns must equal the plain per-column
decode, which must equal the JAX package's own codec round trip (doubles
bit for bit, null slots zero), every output element written once.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu_torch.columnar import wirecodec as wc
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.ops import native

CPU = torch.device("cpu")
BUCKETS = (1, 2, 4, 8, 12, 16, 20, 24, 28, 32)
ROWS = 4  # a thread's rows
THREADS = wc.DECODE_TILE // ROWS


def _mem(addr: int, count: int, dtype) -> np.ndarray:
    dt = np.dtype(dtype)
    if count == 0:
        return np.zeros(0, dt)
    raw = np.ctypeslib.as_array(
        ctypes.cast(addr, ctypes.POINTER(ctypes.c_uint8)),
        shape=(count * dt.itemsize,))
    return raw.view(dt)


_OUT = {(wc._INT, 1): np.int8, (wc._INT, 2): np.int16,
        (wc._INT, 4): np.int32, (wc._INT, 8): np.int64,
        (wc._BOOL, 1): np.uint8, (wc._SCALED, 8): np.float64}


class FakeWirecodec:
    """srt_decode_batch executed in numpy on CPU memory: block b is job
    b // tiles, row tile b % tiles; its thread t decodes rows r0 .. r0 + 3,
    r0 = (tile * 256 + t) * 4."""

    def __init__(self):
        self.launches = []
        self.writes = {}

    def _put(self, addr, n, dtype, rows, values):
        _mem(addr, n, dtype)[rows] = values
        w = self.writes.setdefault(addr, np.zeros(n, np.int64))
        w[rows] += 1

    def srt_decode_batch(self, words, nwords, njobs, words_dev, n, stream):
        assert nwords == wc.DECODE_JOB_WORDS * njobs and n >= 1
        assert (words_dev is not None) == (nwords > wc.DECODE_PARAM_WORDS)
        tab = [int(x) for x in _mem(words_dev or words, nwords, np.int64)]
        self.launches.append(njobs)
        tiles = -(-n // wc.DECODE_TILE)
        for b in range(tiles * njobs):
            job, tile = divmod(b, tiles)
            wp, vp, bp, dp, op, factor, kw = tab[7 * job:7 * job + 7]
            bits, kind, ob = kw & 0xFF, (kw >> 8) & 0xFF, (kw >> 16) & 0xFF
            r0 = (tile * THREADS + np.arange(THREADS)) * ROWS
            r0 = r0[r0 < n]
            rows = (r0[:, None] + np.arange(ROWS)).reshape(-1)
            rows = rows[rows < n]
            if rows.size == 0:
                continue
            if vp:  # a thread's 4 bits lie in one validity word
                vw = _mem(vp, -(-n // 32), np.uint32)
                ok = (vw[rows >> 5] >> (rows & 31)) & 1 == 1
                assert ((rows >> 5) == ((rows & ~3) >> 5)).all()
            else:
                ok = np.ones(rows.size, bool)
            self._put(op, n, np.uint8, rows, ok)
            if kind == wc._VALID_ONLY:
                assert dp == 0 and wp == 0
                continue
            w = _mem(wp, -(-n * bits // 32), np.uint32).astype(np.uint64)
            o = rows.astype(np.uint64) * np.uint64(bits)
            wi = (o >> np.uint64(5)).astype(np.int64)
            sh = o & np.uint64(31)
            straddle = sh + np.uint64(bits) > np.uint64(32)
            hi = np.where(straddle, w[np.minimum(wi + 1, w.size - 1)], 0)
            raw = ((w[wi] | (hi << np.uint64(32))) >> sh) & \
                np.uint64((1 << bits) - 1)
            base = int(_mem(bp, 1, np.int64)[0]) if bp else 0
            if kind == wc._INT:
                x = (raw + np.uint64(base % 2 ** 64)) * \
                    np.uint64(factor % 2 ** 64)
                val = x.view(np.int64).astype(_OUT[(kind, ob)])
            elif kind == wc._BOOL:
                val = (raw != 0).astype(np.uint8)
            else:
                scale = np.array([factor], np.int64).view(np.float64)[0]
                val = (raw.astype(np.float64) + np.float64(base)) * scale
            val = np.where(ok, val, val.dtype.type(0))
            self._put(dp, n, _OUT[(kind, ob)], rows, val)
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeWirecodec()
    monkeypatch.setattr(native, "lib", lambda name: lib)
    monkeypatch.setattr(native, "stream_ptr", lambda dev: 0)
    return lib


def _bits_width(rng, n, bits, dtype, null_p):
    """Integers whose FOR range needs exactly ``bits`` bits."""
    lo = -(1 << 20)
    vals = lo + rng.integers(0, 1 << bits, n, dtype=np.int64)
    vals[0], vals[1] = lo, lo + (1 << bits) - 1
    return pa.array(vals.astype(dtype), mask=rng.random(n) < null_p)


def _columns(rng, n: int) -> dict:
    """One column a case: every bit bucket (int64 at 1..32 bits), int8 to
    int32, bools, dates, timestamps by 10^6, money in cents and whole
    doubles, raw doubles (NaN, -0.0) with nulls (a validity stream
    alone), all-valid and all-null columns, strings (bit-packed lengths)
    and a dictionary string column (K8b's own launch)."""
    cols = {f"b{b}": _bits_width(rng, n, b, np.int64, 0.1) for b in BUCKETS}
    cols.update({
        "i8": pa.array(rng.integers(-128, 0, n).astype(np.int8),
                       mask=rng.random(n) < 0.2),
        "i16": pa.array(rng.integers(-30000, -29000, n).astype(np.int16)),
        "i32": _bits_width(rng, n, 24, np.int32, 0.3),
        "bool": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "date": pa.array(rng.integers(8036, 10591, n).astype(np.int32),
                         mask=rng.random(n) < 0.05).cast(pa.date32()),
        "ts": pa.array(rng.integers(1_500_000_000, 1_600_000_000, n)
                       * 1_000_000, type=pa.timestamp("us")),
        "cents": pa.array(np.round(rng.random(n) * 1e4, 2),
                          mask=rng.random(n) < 0.1),
        "whole": pa.array(rng.integers(-10**9, 10**9, n).astype(np.float64)),
        "raw_f64": pa.array(rng.choice([np.nan, -0.0, 1.5, np.inf], n),
                            mask=rng.random(n) < 0.3),
        "all_null": pa.array(np.zeros(n, np.int32), mask=np.ones(n, bool)),
        "all_valid_raw": pa.array(rng.integers(-2**62, 2**62, n)),
        "str": pa.array([None if rng.random() < 0.1 else "x" * int(k)
                         for k in rng.integers(0, 20, n)], type=pa.string()),
        "dict": pa.array([["ab", "c", "héllo", ""][int(k)]
                          for k in rng.integers(0, 4, n)], type=pa.string()),
    })
    return cols


def _same_leaves(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        for x, y in ((a.data, b.data), (a.validity, b.validity),
                     (a.lengths, b.lengths)):
            assert (x is None) == (y is None), what
            if x is None:
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
            xa, ya = x.numpy(), y.numpy()
            if xa.dtype.kind == "f":
                xa, ya = xa.view(np.int64), ya.view(np.int64)
            np.testing.assert_array_equal(xa, ya, err_msg=f"{what} col {i}")


def _decode_both(fake, rb):
    packed = PBatch.stage_arrow(rb, CPU, codec=True)
    buf = packed.buf
    before = wc.decode_fixed.launches
    got = packed.decode_cuda(buf)
    jobs = packed.k8a_jobs(buf)
    assert wc.decode_fixed.launches == before + (1 if jobs else 0)
    assert fake.launches == ([len(jobs)] if jobs else [])
    for addr, count in fake.writes.items():
        assert (count == 1).all(), f"an output at {addr} written {count}"
    _same_leaves(got, packed.decode(buf, plain=True), "decode_cuda")
    return packed, got


@pytest.mark.parametrize("n", [1025, 1031, 4096, 4099])
def test_one_launch_decodes_the_batch_like_the_reference(fake, n):
    """Every encoded stream of the batch in one launch, equal to the plain
    per-column decode and to the reference's own codec round trip (its
    leaves over the first n rows), at row counts on and off the 4-row
    runs and 1024-row tiles."""
    rng = np.random.default_rng(n)
    cols = _columns(rng, n)
    rb = pa.RecordBatch.from_arrays(list(cols.values()), names=list(cols))
    packed, got = _decode_both(fake, rb)
    kinds = {(j[0] == 0, j[1] == 0) for _i, j in packed.k8a_jobs(packed.buf)}
    # data streams, with and without validity words; validity alone, from
    # a stream and as ones
    assert kinds == {(False, False), (False, True), (True, False),
                     (True, True)}
    ref = JBatch.from_arrow(rb, codec=True)
    for i, (p, j) in enumerate(zip(got, ref.columns)):
        jv = np.asarray(j.validity)[:n]
        np.testing.assert_array_equal(p.validity.numpy(), jv)
        jd = np.asarray(j.data)[:n]
        pd = p.data.numpy()
        if pd.ndim == 2:  # strings: compare inside the lengths
            jl = np.asarray(j.lengths)[:n]
            np.testing.assert_array_equal(p.lengths.numpy(), jl)
            w = min(pd.shape[1], jd.shape[1])
            mask = np.arange(w)[None, :] < jl[:, None]
            np.testing.assert_array_equal(np.where(mask, pd[:, :w], 0),
                                          np.where(mask, jd[:, :w], 0))
            continue
        jd = np.where(jv, jd, jd.dtype.type(0))
        if pd.dtype.kind == "f":
            pd, jd = pd.view(np.int64), jd.astype(pd.dtype).view(np.int64)
        np.testing.assert_array_equal(pd, jd.astype(pd.dtype),
                                      err_msg=rb.schema.names[i])


def test_table_longer_than_the_parameters(fake):
    """600 encoded columns: 600 jobs, past the large parameter table, go
    as a device copy in one launch."""
    rng = np.random.default_rng(2)
    n = 1500
    arrays = [_bits_width(rng, n, BUCKETS[i % len(BUCKETS)], np.int64, 0.2)
              for i in range(600)]
    rb = pa.RecordBatch.from_arrays(arrays,
                                    names=[f"c{i}" for i in range(600)])
    packed, _got = _decode_both(fake, rb)
    assert fake.launches == [600]
    assert wc.DECODE_JOB_WORDS * 600 > wc.DECODE_PARAM_WORDS


def test_raw_all_valid_columns_get_their_ones_in_the_launch(fake):
    """A batch of raw all-valid columns: one launch writes their
    validity (no fill a column); a dictionary column alone needs none."""
    rng = np.random.default_rng(3)
    rb = pa.RecordBatch.from_arrays(
        [pa.array(rng.integers(-2**62, 2**62, 2000)),
         pa.array(rng.standard_normal(2000))], names=["x", "y"])
    _packed, got = _decode_both(fake, rb)
    assert fake.launches == [2]
    assert all(bool(c.validity.all()) for c in got)
    fake.launches.clear()
    rb = pa.RecordBatch.from_arrays(
        [pa.array([["ab", "c"][int(k)] for k in rng.integers(0, 2, 5000)])],
        names=["d"])
    _decode_both(fake, rb)
    assert fake.launches == []


def test_one_stream_is_a_one_job_table(fake):
    """``decode_fixed``'s CUDA branch: one ``k8a_job`` of a stream's
    tensors through ``decode_jobs``, one launch, equal to the plain
    decode."""
    rng = np.random.default_rng(4)
    n = 3001
    vals = rng.integers(0, 1 << 12, n)
    words = torch.from_numpy(wc.pack_bits_host(vals, 12).view(np.int32))
    v = rng.random(n) < 0.8
    vw = torch.from_numpy(wc.pack_bits_host(v.astype(np.uint8), 1)
                          .view(np.int32))
    base = torch.tensor([-7], dtype=torch.int64)
    before = wc.decode_fixed.launches
    got = wc.decode_jobs([wc.k8a_job(words.data_ptr(), vw.data_ptr(),
                                     base.data_ptr(), 12, 1000,
                                     torch.int64)], n, CPU)[0]
    assert wc.decode_fixed.launches == before + 1
    want = wc.decode_fixed_plain(words, vw, n, 12, base, 1000, torch.int64)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert fake.launches == [1]


def _cuda_int(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([\w *]+);", src)
    assert m, name
    return eval(m.group(1), {}, {"kBlock": 256, "kDecodeRows": ROWS})


def test_wirecodec_limits_match_the_cuda_source():
    src = (Path(native.CSRC) / "wirecodec.cu").read_text()
    assert _cuda_int(src, "kDecodeRows") == ROWS
    assert _cuda_int(src, "kBlock") == THREADS
    want = tuple(_cuda_int(src, k) for k in (
        "kDecodeJobWords", "kDecodeTile", "kDecodeSmallWords",
        "kDecodeLargeWords"))
    assert native._LIMITS["wirecodec"] == want
