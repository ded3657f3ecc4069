"""K8, the scan's wire codec, of the PyTorch/CUDA port held against the JAX
package's (``spark_rapids_tpu/columnar/wirecodec.py`` and the codec branch
of ``ColumnBatch.from_arrow``).

Both directions of the wire format are held, exactly:

* the port's encoder chooses the reference's descriptor for every column
  and writes the reference's words (over the first ``ceil(n*bits/32)``:
  the reference packs a power-of-two capacity, the port ``n`` slots);
* the port's plain decode of the reference's words gives the values of
  the reference's own codec round trip, doubles bit for bit;
* the port's ``from_arrow`` gives the same leaves with the codec on and
  off, and q1 at SF0.01 (one 60k-row lineitem batch, so both packages
  encode) gives the reference's rows.

The cases are those of ``tests/test_wirecodec.py``: every bit bucket
(including the straddling 12, 20, 24 and 28), int8 to int64 with negative
bases, timestamps divisible by 10^6 and 10^3, money in cents and whole
doubles, NaN, +-inf and -0.0 (raw), bools and partial validity, all-null,
empty and one-row columns, dictionary strings with multi-byte UTF-8 and
NULs, and high-cardinality strings (raw).  The kernels themselves are
checked against these plain versions on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu.bench import tpch_gen as jgen
from spark_rapids_tpu.bench.tpch_queries import q1 as jq1
from spark_rapids_tpu.columnar import wirecodec as rw
from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench.tpch_queries import q1 as pq1
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.columnar import wirecodec as pw
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch

CPU = torch.device("cpu")
BUCKETS = (1, 2, 4, 8, 12, 16, 20, 24, 28, 32)


def _cap(n: int) -> int:
    """The reference's capacity of an n-row batch."""
    c = 8
    while c < n:
        c <<= 1
    return c


def _ints(rng, n, lo, hi, dtype, null_p=0.1):
    vals = rng.integers(lo, hi, size=n, dtype=np.int64).astype(dtype)
    return pa.array(vals, mask=rng.random(n) < null_p)


def _fixed_cases():
    """name -> pa.Array of one fixed-width column."""
    rng = np.random.default_rng(1)
    n = 2000
    secs = rng.integers(1_500_000_000, 1_600_000_000, size=4096)
    ms = 1_500_000_000_000 + rng.integers(0, 1 << 31, size=4096)
    cases = {
        # the reference's test_int_columns
        "i32_small": _ints(rng, n, 0, 100, np.int32),
        "i32_neg": _ints(rng, n, -5, 300000, np.int32),
        "i64_small": _ints(rng, n, 0, 17, np.int64),
        "i64_neg_base": _ints(rng, n, -2**40, -2**40 + 1000, np.int64),
        "i8_full": _ints(rng, n, -128, 127, np.int8),
        "i64_wide_raw": _ints(rng, n, -2**62, 2**62, np.int64),
        "i8_neg_base": _ints(rng, n, -128, -120, np.int8),
        "i16_neg_base": _ints(rng, n, -30000, -29000, np.int16),
        "i32_min_base": _ints(rng, n, -2**31, -2**31 + 70000, np.int32),
        "i64_max_top": _ints(rng, n, 2**63 - 2**31, 2**63 - 1, np.int64),
        "i64_min_base": _ints(rng, n, -2**63, -2**63 + 2**27, np.int64),
        "date": pa.array(rng.integers(8036, 10591, n).astype(np.int32),
                         mask=rng.random(n) < 0.05).cast(pa.date32()),
        # timestamps whose micros are second / milli aligned: range over
        # 2^32, shrunk by the static divisor
        "ts_seconds": pa.array(secs * 1_000_000, type=pa.int64()),
        "ts_millis": pa.array(ms * 1_000, type=pa.int64()),
        "ts_type": pa.array(secs * 1_000_000, type=pa.timestamp("us")),
        "money_cents": pa.array(rng.integers(0, 3_000_000, 4096) * 0.01),
        "money_neg": pa.array(rng.integers(-500_000, 500_000, 4096) * 0.01,
                              mask=rng.random(4096) < 0.2),
        # whole doubles: cents would need more than 32 bits, units do not
        "whole_doubles": pa.array(
            rng.integers(-10**9, 10**9, 4096).astype(np.float64)),
        "doubles_arbitrary": pa.array(np.array([1.23456789, np.pi,
                                                -0.125] * 700)),
        "doubles_nan": pa.array(np.array([1.0, np.nan, 2.0] * 700)),
        "doubles_inf": pa.array(np.array([np.inf, -np.inf, 0.0] * 700)),
        "doubles_negzero": pa.array(np.array([-0.0, 1.0, 2.0] * 700)),
        "bool": pa.array(rng.random(5000) < 0.5,
                         mask=rng.random(5000) < 0.3),
        "bool_all_valid": pa.array(rng.random(3000) < 0.5),
        "all_null_i32": pa.array([None] * 100, type=pa.int32()),
        "all_null_f64": pa.array([None] * 3000, type=pa.float64()),
        "empty_i64": pa.array([], type=pa.int64()),
        "one_row_i64": pa.array([42], type=pa.int64()),
        "one_row_f64": pa.array([12.5]),
    }
    # every bit bucket: a range of exactly 2^b - 1 above a base
    for b in BUCKETS:
        base = -(1 << 40) + 17
        vals = base + rng.integers(0, 1 << b, size=3001, dtype=np.int64)
        vals[0], vals[1] = base, base + (1 << b) - 1
        cases[f"bucket{b}"] = pa.array(vals, mask=rng.random(3001) < 0.1)
    # nulls at the edges of the 1-bit validity words
    mask = np.zeros(4096, np.bool_)
    mask[0::32] = mask[31::32] = mask[32:64] = True
    cases["nulls_at_word_edges"] = pa.array(
        rng.integers(0, 1000, 4096).astype(np.int32), mask=mask)
    return cases


FIXED = _fixed_cases()


def _host_leaves(arr):
    """(data with nulls zeroed, validity) as both packages' builders see
    them."""
    dt = PT.from_arrow(arr.type)
    validity = PT.arrow_validity_numpy(arr)
    data = PT.arrow_fixed_to_numpy(arr, dt)
    if not validity.all():
        data = np.where(validity, data, data.dtype.type(0))
    return data, validity


def _encode(mod, data, validity, cap=None):
    """(descriptor, leaves, i64 params) of one package's encode_fixed."""
    leaves, params = [], []

    def add_leaf(a):
        leaves.append(np.asarray(a))
        return len(leaves) - 1

    def add_i64(v):
        params.append(int(v))
        return len(params) - 1

    if cap is None:
        desc = mod.encode_fixed(data, validity, add_leaf, add_i64)
    else:
        desc = mod.encode_fixed(data, validity, cap, add_leaf, add_i64)
    return desc, leaves, params


def _same_words(port_leaf, ref_leaf, n, bits):
    k = pw.packed_words(n, bits)
    assert port_leaf.dtype == np.uint32 and port_leaf.size == k
    np.testing.assert_array_equal(port_leaf, ref_leaf[:k])
    assert not ref_leaf[k:].any()


def _words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _bits_of(a: np.ndarray) -> np.ndarray:
    """Values as raw bits (doubles by their 64-bit pattern)."""
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


@pytest.mark.parametrize("bits", BUCKETS)
def test_pack_bits_matches_reference(bits):
    """The port's packer writes the reference's words for every bucketed
    width (all the encoder writes) and ragged length, and its plain
    unpack reads them back."""
    rng = np.random.default_rng(bits)
    for n in (0, 1, 7, 31, 32, 33, 1000, 4097):
        vals = rng.integers(0, 1 << bits, n, dtype=np.uint64)
        got = pw.pack_bits_host(vals, bits)
        want = rw.pack_bits_host(vals, bits, _cap(n))
        _same_words(got, want, n, bits)
        if n:
            back = pw._unpack_plain(_words(want), n, bits)
            np.testing.assert_array_equal(back.numpy(),
                                          vals.astype(np.int64))


@pytest.mark.parametrize("bits", sorted(set(range(0, 34)) - set(BUCKETS)))
def test_pack_bits_refuses_other_widths(bits):
    with pytest.raises(ValueError):
        pw.pack_bits_host(np.zeros(5, np.uint32), bits)


def test_bits_needed_matches_reference():
    for r in [0, 1, 2, 3, 4, 15, 16, 255, 256, 4095, 4096, 2**20 - 1,
              2**24, 2**28 - 1, 2**28, 2**32 - 1]:
        assert pw.bits_needed(r) == rw.bits_needed(r), r


@pytest.mark.parametrize("case", sorted(FIXED))
def test_encode_fixed_matches_reference(case):
    """Same descriptor, FOR base and divisor/scale, same words (or the
    same raw leaf) as the reference's encoder."""
    data, validity = _host_leaves(FIXED[case])
    n = data.shape[0]
    pdesc, pleaves, pparams = _encode(pw, data, validity)
    rdesc, rleaves, rparams = _encode(rw, data, validity, _cap(n))
    assert pdesc == rdesc
    assert pparams == rparams
    assert len(pleaves) == len(rleaves) == 1
    if rdesc[0] == "raw":
        np.testing.assert_array_equal(_bits_of(pleaves[0]),
                                      _bits_of(rleaves[0][:n]))
    else:
        _same_words(pleaves[0], rleaves[0], n, rdesc[2])


_EXPECTED_KIND = {"i64_wide_raw": "raw", "i8_full": "raw",
                  "doubles_arbitrary": "raw", "doubles_nan": "raw",
                  "doubles_inf": "raw", "doubles_negzero": "raw",
                  "money_cents": "fbits", "money_neg": "fbits",
                  "whole_doubles": "fbits", "ts_seconds": "bits",
                  "ts_millis": "bits", "bucket12": "bits",
                  "bucket28": "bits"}


@pytest.mark.parametrize("case", sorted(_EXPECTED_KIND))
def test_encoding_choices(case):
    """The reference's choices on the cases that decide them: NaN, inf
    and -0.0 ship raw, cents and whole doubles scaled, aligned timestamps
    with their divisor."""
    data, validity = _host_leaves(FIXED[case])
    desc, _l, _p = _encode(pw, data, validity)
    assert desc[0] == _EXPECTED_KIND[case]
    if case == "ts_seconds":
        assert desc[5] == 1_000_000
    if case == "ts_millis":
        assert desc[5] == 1_000
    if case == "money_cents":
        assert desc[5] == 0.01
    if case == "whole_doubles":
        assert desc[5] == 1.0


def _ref_column(arr) -> pa.Array:
    """The reference's own codec round trip of one column."""
    rb = pa.record_batch([arr], names=["c"])
    return JBatch.from_arrow(rb, codec=True).to_arrow().column(0)


@pytest.mark.parametrize("case", sorted(FIXED))
def test_plain_decode_of_reference_words(case):
    """The port's plain K8a decode of the reference's words and validity
    stream equals the reference's decode on JAX's CPU, doubles bit for
    bit, null slots zero."""
    arr = FIXED[case]
    data, validity = _host_leaves(arr)
    n = data.shape[0]
    cap = _cap(n)
    desc, leaves, params = _encode(rw, data, validity, cap)
    vw = None if validity.all() else _words(
        rw.pack_bits_host(validity.astype(np.uint8), 1, cap))
    ref = _ref_column(arr)
    want_valid = np.asarray(ref.is_valid())
    if desc[0] == "raw":
        got_data = torch.from_numpy(leaves[0][:n].copy())
        got_valid = pw.decode_fixed(None, vw, n)[1] if vw is not None \
            else torch.ones(n, dtype=torch.bool)
    else:
        _kind, _li, bits, dt, pbase, factor = desc
        got_data, got_valid = pw.decode_fixed(
            _words(leaves[0]), vw, n, bits,
            torch.tensor([params[pbase]], dtype=torch.int64), factor,
            PB._NP_TO_TORCH[np.dtype(dt).str])
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    want = PT.arrow_fixed_to_numpy(ref, PT.from_arrow(arr.type))
    want = np.where(want_valid, want, want.dtype.type(0))
    got = got_data.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(_bits_of(got), _bits_of(want))


@pytest.mark.parametrize("max_len", [0, 1, 3, 15, 16, 255, 256, 4096])
def test_encode_lengths_matches_reference(max_len):
    rng = np.random.default_rng(max_len)
    n = 3000
    lens = rng.integers(0, max_len + 1, n).astype(np.int32)
    pl, rl = [], []
    pdesc = pw.encode_lengths(lens, max_len,
                              lambda a: pl.append(a) or 0,
                              lambda v: 0)
    rdesc = rw.encode_lengths(lens, _cap(n), max_len,
                              lambda a: rl.append(a) or 0, lambda v: 0)
    assert pdesc == rdesc
    _same_words(pl[0], rl[0], n, rdesc[2])
    got, valid = pw.decode_fixed(_words(rl[0]), None, n, rdesc[2],
                                 torch.zeros(1, dtype=torch.int64), 1,
                                 torch.int32)
    assert valid.all()
    np.testing.assert_array_equal(got.numpy(), lens)


def _string_cases():
    rng = np.random.default_rng(5)
    cats = ["Books", "Electronics", "Home & Garden", "Música", "",
            "a\x00b", "日本語テキスト", "😀 emoji"]
    vals = [cats[i] for i in rng.integers(0, len(cats), size=8192)]
    vals[17] = None
    wide = [("x" * int(k)) + "é" for k in rng.integers(100, 250, 40)]
    return {
        "dict_utf8_nul": pa.array(vals, type=pa.string()),
        "dict_wide": pa.array([wide[i] for i in
                               rng.integers(0, len(wide), 6000)]),
        "dict_with_nulls": pa.array(
            ["R", "A", "N", None][i] for i in rng.integers(0, 4, 5000)),
        "dict_one_value": pa.array(["1998-01-01"] * 4096),
        "high_cardinality": pa.array([f"unique-{i}" for i in range(8192)]),
        "small_n": pa.array(["ab", "cd", None] * 1000),
    }


STRINGS = _string_cases()


@pytest.mark.parametrize("case", sorted(STRINGS))
def test_maybe_dict_matches_reference(case):
    """Same choice, same indices (nulls -> 0), same dictionary."""
    arr = STRINGS[case]
    got = pw.maybe_dict_arrow(arr, len(arr))
    want = rw.maybe_dict_arrow(arr, len(arr))
    assert (got is None) == (want is None)
    if case in ("high_cardinality", "small_n"):
        assert got is None
        return
    assert got is not None
    assert got[0].dtype == want[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].equals(want[1])


@pytest.mark.parametrize("case", sorted(set(STRINGS) - {"high_cardinality",
                                                        "small_n"}))
def test_plain_dict_decode_of_reference_words(case):
    """The port's plain K8b decode of the reference's bit-packed indices
    and dictionary equals the reference's codec round trip."""
    arr = STRINGS[case]
    n = len(arr)
    cap = _cap(n)
    idx, dictionary = rw.maybe_dict_arrow(arr, n)
    validity = PT.arrow_validity_numpy(arr)
    idx = np.where(validity, idx, 0).astype(np.int32)
    desc, leaves, params = _encode(rw, idx, validity, cap)
    assert desc[0] == "bits"
    vw = None if validity.all() else _words(
        rw.pack_bits_host(validity.astype(np.uint8), 1, cap))
    dm, dlens = PB.strings_to_matrix(dictionary)
    data, lengths, valid = pw.decode_dict(
        _words(leaves[0]), vw, n, desc[2],
        torch.tensor([params[desc[4]]], dtype=torch.int64),
        torch.from_numpy(dm), torch.from_numpy(dlens))
    ref = _ref_column(arr)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref.is_valid()))
    got = [None if not v else bytes(r[:ln]).decode()
           for r, ln, v in zip(data.numpy(), lengths.numpy(), valid.numpy())]
    assert got == ref.to_pylist()
    # a null row: zero bytes, length 0
    assert not data.numpy()[~valid.numpy()].any()
    assert not lengths.numpy()[~valid.numpy()].any()


def _record_batches():
    rng = np.random.default_rng(6)
    n = 4096
    return {
        "mixed": pa.record_batch([
            pa.array(rng.integers(0, 2**17, n, dtype=np.int64)),
            pa.array((rng.integers(0, 10**6, n) * 0.01)),
            pa.array(rng.random(n)),
            pa.array(["ab", "cd", "ef", None] * (n // 4), type=pa.string()),
            pa.array(rng.random(n) < 0.5),
        ], names=["k", "price", "noise", "tag", "flag"]),
        "fixed": pa.record_batch(
            [FIXED[c] for c in ("money_neg", "money_cents", "whole_doubles",
                                "ts_seconds", "ts_type",
                                "nulls_at_word_edges")],
            names=["a", "b", "c", "d", "e", "f"]),
        "strings": pa.record_batch([
            STRINGS["dict_utf8_nul"],
            pa.array([f"unique-{i}" if i % 7 else None
                      for i in range(8192)]),
            pa.array(rng.integers(0, 2**40, 8192), type=pa.int64())],
            names=["cat", "uniq", "big"]),
        "short": pa.record_batch([
            pa.array(["x", "yy", None, "zzz"] * 1500),
            pa.array(np.arange(6000, dtype=np.int16))],
            names=["d", "h"]),
        "tiny": pa.record_batch([pa.array([1, None, 3], type=pa.int32())],
                                names=["t"]),
    }


BATCHES = _record_batches()


@pytest.mark.parametrize("vals,kind", [
    ([1e19] * 3000, "raw"),
    ([2.0**63] * 3000, "raw"),
    ([-2.0**64] * 3000, "raw"),
    ([2.0**63, 2.0**63 + 2048] * 1500, "raw"),
    # cents would put the base below int64; whole units hold it at -2^63
    ([-2.0**63, -2.0**63 + 2048, -2.0**63 + 4096] * 1000, "fbits")])
def test_whole_doubles_beyond_int64(vals, kind):
    """A scale at which the FOR base or top leaves int64 (|v/s| >= 2^63)
    is skipped, and the column comes back bit for bit.  The reference's
    encoder raises OverflowError on every one of these columns under
    NumPy 2 (its int64 cast of that base); the port diverges there and
    only there."""
    arr = pa.array(np.array(vals))
    data, validity = _host_leaves(arr)
    desc, _l, params = _encode(pw, data, validity)
    assert desc[0] == kind
    if kind == "fbits":
        assert desc[5] == 1.0 and params[desc[4]] == -(1 << 63)
    rb = pa.record_batch([arr], names=["x"])
    got = PBatch.from_arrow(rb, CPU, codec=True).columns[0].data.numpy()
    np.testing.assert_array_equal(_bits_of(got), _bits_of(np.array(vals)))


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_from_arrow_codec_on_equals_off(case):
    """``from_arrow(codec=True)`` equals ``codec=False`` leaf for leaf,
    both equal the input, and the reference's codec round trip gives the
    same rows; with the codec on the buffer is smaller where a column
    encodes."""
    rb = BATCHES[case]
    on = PBatch.from_arrow(rb, CPU, codec=True)
    off = PBatch.from_arrow(rb, CPU, codec=False)
    for a, b in zip(on.columns, off.columns):
        assert a.data.dtype == b.data.dtype and a.data.shape == b.data.shape
        np.testing.assert_array_equal(_bits_of(a.data.numpy()),
                                      _bits_of(b.data.numpy()))
        np.testing.assert_array_equal(a.validity.numpy(), b.validity.numpy())
        assert (a.lengths is None) == (b.lengths is None)
        if a.lengths is not None:
            np.testing.assert_array_equal(a.lengths.numpy(),
                                          b.lengths.numpy())
    assert on.to_rows() == off.to_rows()
    assert [dict(zip(rb.schema.names, r)) for r in on.to_rows()] == \
        rb.to_pylist()
    ref = JBatch.from_arrow(rb, codec=True).to_arrow()
    assert on.to_arrow().to_pylist() == ref.to_pylist()
    if case != "tiny":
        assert (PBatch.stage_arrow(rb, CPU, codec=True).nbytes
                < PBatch.stage_arrow(rb, CPU, codec=False).nbytes)


def test_codec_default_follows_the_reference(monkeypatch):
    """On by default above 1024 rows, off at or below; SRT_WIRE_CODEC=0
    (read at import, as in the reference) turns it off."""
    big = pa.record_batch([pa.array(np.arange(1025, dtype=np.int64))],
                          names=["x"])
    small = pa.record_batch([pa.array(np.arange(1024, dtype=np.int64))],
                            names=["x"])
    assert PBatch.stage_arrow(big, CPU).col_specs[0][1][0] == "bits"
    assert PBatch.stage_arrow(small, CPU).col_specs[0][1][0] == "raw"
    assert PBatch.stage_arrow(small, CPU, codec=True) \
        .col_specs[0][1][0] == "bits"
    monkeypatch.setattr(PB, "_CODEC_DEFAULT", False)
    assert PBatch.stage_arrow(big, CPU).col_specs[0][1][0] == "raw"
    assert PBatch.stage_arrow(big, CPU, codec=True) \
        .col_specs[0][1][0] == "bits"


def test_packed_leaves_are_aligned_views():
    """Every leaf starts on a 16-byte boundary of the one buffer; raw
    leaves come back as views into it, with no copy."""
    rb = BATCHES["mixed"]
    packed = PBatch.stage_arrow(rb, CPU, codec=True)
    assert all(off % 16 == 0 for off, _nb, _d, _s in packed.layout)
    batch = packed.to(CPU)
    noise = batch.columns[2].data
    assert packed.col_specs[2][1][0] == "raw"
    assert noise.untyped_storage().data_ptr() == \
        packed.buf.untyped_storage().data_ptr()


def test_decode_wrappers_check_their_inputs():
    w = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        pw.decode_fixed(None, None, 10)
    with pytest.raises(ValueError):
        pw.decode_fixed(w, None, 1000, 12, None, 1, torch.int32)
    with pytest.raises(ValueError):
        pw.decode_fixed(w, None, 4, 33, None, 1, torch.int64)
    with pytest.raises(ValueError):
        pw.decode_fixed(w, None, 4, 8, None, 0.01, torch.int64)
    with pytest.raises(ValueError):
        pw.decode_dict(w, None, 4, 8, None,
                       torch.zeros((3, 12), dtype=torch.uint8),
                       torch.zeros(3, dtype=torch.int32))


def test_decode_wrappers_do_not_fall_back_off_the_cpu():
    """On a non-CPU tensor the wrappers launch their kernel or raise; they
    never take the plain version (here: a meta tensor, no kernel)."""
    w = torch.zeros(4, dtype=torch.int32, device="meta")
    before = (pw.decode_fixed.launches, pw.decode_dict.launches)
    with pytest.raises(Exception):
        pw.decode_fixed(w, None, 4, 8, None, 1, torch.int32)
    with pytest.raises(Exception):
        pw.decode_dict(w, None, 4, 8, None,
                       torch.zeros((3, 16), dtype=torch.uint8, device="meta"),
                       torch.zeros(3, dtype=torch.int32, device="meta"))
    assert (pw.decode_fixed.launches, pw.decode_dict.launches) == before


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_codec") / "sf001")
    jgen.generate_tpch(d, sf=0.01, tables=("lineitem",))
    return d


def test_q1_with_the_codec_matches_jax(tpch_dir):
    """q1 at SF0.01: one 60,175-row lineitem batch, so both packages
    encode it (fbits, bits, raw and dictionary strings); equal rows, and
    the port's scan sent fewer bytes than its raw leaves."""
    want = jq1(TpuSession(), tpch_dir).collect()
    session = TorchSession(device="cpu")
    df = pq1(session, tpch_dir)
    got = df.collect()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[9] == w[9]
        for a, b in zip(g[2:9], w[2:9]):
            assert a == pytest.approx(b, rel=1e-9, abs=0.0)
    from spark_rapids_tpu_torch.exec.core import ExecCtx
    from spark_rapids_tpu_torch.io import FileScanExec
    node = df._prepared()
    stack = [node]
    while not isinstance(node, FileScanExec):
        node = stack.pop()
        stack.extend(node.children)
    ctx = ExecCtx(device=session.device, conf=session.conf)
    node.stats.reset()
    batches = list(node.execute(ctx))
    stats = node.stats.as_dict()
    assert stats["batches"] == len(batches) == 1
    assert 0 < stats["sent_bytes"] < stats["raw_bytes"] / 3
    assert stats["decode_s"] > 0 and stats["encode_s"] > 0


def test_scan_stats_add_is_atomic():
    """Several scan partitions' prefetch threads add to one node's
    ScanStats: no update is lost under a short switch interval."""
    import sys
    import threading

    from spark_rapids_tpu_torch.io.scan import ScanStats

    class Packed:
        raw_bytes, nbytes = 3, 1

    stats = ScanStats()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            stats.add(0.5, 0.25, Packed) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = stats.as_dict()
    assert got == {"batches": 32000, "decode_s": 16000.0,
                   "encode_s": 8000.0, "raw_bytes": 96000,
                   "sent_bytes": 32000}
