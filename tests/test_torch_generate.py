"""Array columns and the Generate exec of the PyTorch/CUDA port against the
JAX package, on the CPU.

The same parquet goes through ``TpuSession`` and
``TorchSession(device="cpu")`` (the port has no ``from_pydict`` yet):
explode and posexplode, outer or not, over split strings and over arrays
of every element type the K14 stress covers; ``Size``, ``GetArrayItem``
and ``ArrayContains``; arrays refused as sort, group and join keys; the
reference's own shapes (``tests/test_arrays.py``,
``tests/test_expand_generate.py``); the K14 plain versions against a
direct Python split and a numpy flatten; the array round trip through
parquet, ``from_arrow`` and ``to_arrow``, codec on and off; the port's
``product_reviews`` against the reference generator's files; and the
``review_words`` and ``basket_items`` paths at sf 0.05 against the
reference's rows.  Rows compare exactly (NaN equal to NaN).
"""
import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import TpuSession
from spark_rapids_tpu.bench.tpcxbb_gen import generate_tpcxbb
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.expr import collections as JCL
from spark_rapids_tpu.expr.core import col as jcol
from spark_rapids_tpu.expr.core import lit as jlit
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.bench import generate_queries as GQ
from spark_rapids_tpu_torch.bench.tpcxbb_gen import generate_product_reviews
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr import collections as PCL
from spark_rapids_tpu_torch.expr.core import col as pcol
from spark_rapids_tpu_torch.expr.core import lit as plit
from spark_rapids_tpu_torch.ops import generate as GE
from spark_rapids_tpu_torch.ops import kernels as K

#: element types of the array columns, by arrow type
_ELEMS = {"i8": pa.int8(), "i32": pa.int32(), "i64": pa.int64(),
          "f32": pa.float32(), "f64": pa.float64(), "b": pa.bool_()}


def _key(v):
    """A value comparable with NaN (NaN equal to NaN, also in lists)."""
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if isinstance(v, list):
        return [_key(x) for x in v]
    return v


def _rows(rows):
    return [tuple(_key(v) for v in r) for r in rows]


def _strings(rng, n: int) -> list:
    """Strings for split on ',': nulls, empty strings, delimiters only,
    leading, trailing and consecutive delimiters, multi-byte UTF-8, NUL."""
    pieces = ["a", "bc", "", "é", "日本", "\U0001F600", "x\x00y", " ",
              "longer piece"]
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.1:
            out.append(None)
        elif r < 0.15:
            out.append("")
        elif r < 0.2:
            out.append("," * int(rng.integers(1, 6)))
        else:
            k = int(rng.integers(1, 7))
            out.append(",".join(pieces[int(i)] for i in
                                rng.integers(0, len(pieces), k)))
    return out


def _arrays(rng, n: int, kind: str) -> list:
    """Array rows: nulls, empty arrays, 1 to 20 elements; NaN and -0.0
    among the floats."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.1:
            out.append(None)
            continue
        k = 0 if r < 0.2 else int(rng.integers(1, 21))
        if kind == "b":
            out.append([bool(x) for x in rng.random(k) < 0.5])
        elif kind.startswith("f"):
            vals = [0.0, -0.0, 1.5, -2.25, float("nan"), float("inf")]
            out.append([vals[int(i)] for i in rng.integers(0, 6, k)])
        else:
            lo, hi = (-128, 128) if kind == "i8" else (-1000, 1000)
            big = (1 << 40) if kind == "i64" else 1
            out.append([int(x) * big for x in rng.integers(lo, hi, k)])
    return out


@pytest.fixture(scope="module")
def fuzz_dir(tmp_path_factory):
    """Two parquet files of seeded rows (string widths and array widths
    differ between them)."""
    d = tmp_path_factory.mktemp("generate")
    rng = np.random.default_rng(2026)
    for f, n in enumerate((300, 157)):
        cols = {"k": pa.array(np.arange(n, dtype=np.int32) + 1000 * f),
                "s": pa.array(_strings(rng, n), type=pa.string())}
        for kind, at in _ELEMS.items():
            cols[f"a_{kind}"] = pa.array(_arrays(rng, n, kind),
                                         type=pa.list_(at))
        idx = rng.integers(-2, 12, n).astype(np.int32)
        cols["idx"] = pa.array(idx, mask=rng.random(n) < 0.1)
        pq.write_table(pa.table(cols), str(d / f"part-{f}.parquet"))
    return str(d)


@pytest.fixture(scope="module")
def sessions():
    return TpuSession({}), TorchSession(device="cpu")


@pytest.mark.parametrize("pos,outer", [(False, False), (True, False),
                                       (False, True), (True, True)])
@pytest.mark.parametrize("delim", [",", " "])
def test_explode_split_matches_jax(fuzz_dir, sessions, pos, outer, delim):
    js, ps = sessions
    want = js.read_parquet(fuzz_dir, columns=["k", "s"]).explode_split(
        "s", delim, output_name="w", pos=pos, outer=outer)
    got = ps.read_parquet(fuzz_dir, columns=["k", "s"]).explode_split(
        "s", delim, output_name="w", pos=pos, outer=outer)
    assert got.schema.names == ["k", "s"] + (["pos"] if pos else []) + \
        ["w"]
    assert _rows(got.collect()) == _rows(want.collect())
    kind = ("posexplode" if pos else "explode") + ("_outer" if outer
                                                   else "")
    assert f"GenerateExec[{kind}]" in got.explain()


@pytest.mark.parametrize("kind,pos,outer", [
    ("i32", False, False), ("i32", True, False), ("i32", False, True),
    ("i32", True, True), ("f64", False, False), ("f64", True, True),
    ("i8", True, True), ("i64", True, False), ("f32", False, True),
    ("b", True, True)])
def test_explode_array_matches_jax(fuzz_dir, sessions, kind, pos, outer):
    js, ps = sessions
    cols = ["k", f"a_{kind}"]
    want = js.read_parquet(fuzz_dir, columns=cols).explode(
        f"a_{kind}", output_name="e", pos=pos, outer=outer)
    got = ps.read_parquet(fuzz_dir, columns=cols).explode(
        f"a_{kind}", output_name="e", pos=pos, outer=outer)
    assert _rows(got.collect()) == _rows(want.collect())


def test_collection_expressions_match_jax(fuzz_dir, sessions):
    """Size (-1 for null), GetArrayItem (literal and column indices,
    null and out of range) and ArrayContains over every element type."""
    js, ps = sessions

    def query(s, M, col, lit):
        exprs = [col("k")]
        for kind in ("i32", "f64", "b", "i64"):
            a = col(f"a_{kind}")
            exprs += [M.Size(a).alias(f"n_{kind}"),
                      M.GetArrayItem(a, lit(0)).alias(f"g0_{kind}"),
                      M.GetArrayItem(a, col("idx")).alias(f"gi_{kind}")]
        exprs += [
            M.ArrayContains(col("a_i32"), lit(7)).alias("c_i32"),
            M.ArrayContains(col("a_i64"), col("k")).alias("c_i64"),
            M.ArrayContains(col("a_f64"), lit(1.5)).alias("c_f64"),
            M.ArrayContains(col("a_b"), lit(True)).alias("c_b")]
        return s.read_parquet(fuzz_dir).select(*exprs).collect()

    got = query(ps, PCL, pcol, plit)
    assert _rows(got) == _rows(query(js, JCL, jcol, jlit))
    assert any(r[1] == -1 for r in got) and any(r[1] == 0 for r in got)


def test_maps_and_array_keys_refused(fuzz_dir, sessions):
    _js, ps = sessions
    df = ps.read_parquet(fuzz_dir)
    with pytest.raises(ValueError, match="array"):
        df.order_by(("a_i32", True)).collect()
    with pytest.raises(ValueError, match="array"):
        df.group_by("a_i32").agg(PA.CountStar().alias("c")).collect()
    with pytest.raises(ValueError, match="array"):
        df.join(df.select(pcol("a_i32").alias("b")),
                on=[("a_i32", "b")]).collect()
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        df.select(PCL.GetMapValue(pcol("a_i32"), plit(1)).alias("m")) \
            .collect()
    rb = pa.record_batch([pa.array([{"a": 1}], pa.map_(pa.string(),
                                                      pa.int32()))],
                         names=["m"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        ColumnBatch.from_arrow(rb, "cpu")


def _same_lists(got, want):
    """Equal list arrays: element type, rows (NaN equal to NaN) and the
    elements' bits (-0.0 kept)."""
    assert got.type.value_type == want.type.value_type
    assert _key(got.to_pylist()) == _key(want.to_pylist())
    g, w = got.flatten(), want.flatten()
    if pa.types.is_floating(g.type):
        assert np.array_equal(g.to_numpy().view(np.uint8),
                              w.to_numpy().view(np.uint8))


@pytest.mark.parametrize("codec", [True, False])
def test_array_roundtrip_through_parquet(fuzz_dir, codec):
    """parquet -> from_arrow -> to_arrow gives the file's list columns
    (the codec encodes the lengths of batches above 1024 rows)."""
    table = pq.read_table(os.path.join(fuzz_dir, "part-0.parquet"))
    big = pa.concat_tables([table] * 4)  # 1200 rows: the codec's side
    for t in (table, big):
        rb = t.combine_chunks().to_batches()[0]
        back = ColumnBatch.from_arrow(rb, "cpu", codec=codec).to_arrow()
        for name in [f"a_{k}" for k in _ELEMS]:
            _same_lists(back.column(name), rb.column(name))
    sliced = big.slice(333, 500).combine_chunks().to_batches()[0]
    b = ColumnBatch.from_arrow(sliced, "cpu", codec=codec)
    _same_lists(b.to_arrow().column("a_f64"), sliced.column("a_f64"))
    assert b.columns[2].data.shape[1] == 32  # 20 elements at most


def test_element_nulls_refused():
    rb = pa.record_batch([pa.array([[1, None], [2]], pa.list_(pa.int32()))],
                         names=["a"])
    with pytest.raises(ValueError, match="null elements"):
        ColumnBatch.from_arrow(rb, "cpu")


def test_array_rows_move_by_their_bytes():
    """K2, K3 and concat over array columns: rows move whole, a narrower
    element matrix is zero-padded to the widest."""
    a = ColumnBatch.from_arrow(pa.record_batch(
        [pa.array([[1.5, 2.0], None, [3.0]], pa.list_(pa.float64()))],
        names=["a"]), "cpu")
    b = ColumnBatch.from_arrow(pa.record_batch(
        [pa.array([[True] * 9, []], pa.list_(pa.bool_()))], names=["a"]),
        "cpu")
    keep = K.compact(a, torch.tensor([True, False, True]))
    assert keep.to_rows() == [([1.5, 2.0],), ([3.0],)]
    assert K.take(a, torch.tensor([2, -1, 0], dtype=torch.int32)) \
        .to_rows() == [([3.0],), (None,), ([1.5, 2.0],)]
    c = K.concat_batches([b, ColumnBatch.from_arrow(pa.record_batch(
        [pa.array([[False]], pa.list_(pa.bool_()))], names=["a"]), "cpu")])
    assert c.columns[0].data.shape == (3, 16)
    assert c.to_rows() == [([True] * 9,), ([],), ([False],)]


# -- the K14 plain versions against Python and numpy -----------------------

def _byte_rows(rng, n: int, w: int):
    """Byte strings of up to w bytes over {',', NUL, 'a', 0xC3, 0xA9}
    (valid or not as UTF-8: the split is by byte), nulls, rows of w."""
    alphabet = np.array([44, 44, 0, 97, 0xC3, 0xA9], np.uint8)
    rows, valid = [], rng.random(n) >= 0.15
    for i in range(n):
        k = w if rng.random() < 0.1 else int(rng.integers(0, w + 1))
        rows.append(bytes(alphabet[rng.integers(0, 6, k)]) if valid[i]
                    else b"")
    data = np.zeros((n, w), np.uint8)
    for i, r in enumerate(rows):
        data[i, :len(r)] = np.frombuffer(r, np.uint8)
    return rows, valid, data


@pytest.mark.parametrize("w", [4, 16, 64])
@pytest.mark.parametrize("outer", [False, True])
def test_split_plain_matches_python(w, outer):
    rng = np.random.default_rng(w)
    rows, valid, data = _byte_rows(rng, 400, w)
    lengths = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    v = torch.from_numpy(valid)
    emit, total, widest = GE.split_counts(torch.from_numpy(data), lengths,
                                          v, 44, outer)
    want = []  # (src, pos, piece) with None for an outer null row
    for i, r in enumerate(rows):
        if valid[i]:
            want += [(i, k, p) for k, p in enumerate(r.split(b","))]
        elif outer:
            want.append((i, None, None))
    assert total == len(want)
    assert widest == max((len(p) for _i, _k, p in want if p is not None),
                         default=0)
    out_w = max(4, -(-widest // 4) * 4)
    pieces, plen, pvalid, src, pos = GE.split_emit(
        torch.from_numpy(data), lengths, v, 44, outer, emit, total, out_w)
    got = [(int(s), int(k) if ok else None,
            bytes(pieces[j, :plen[j]].numpy()) if ok else None)
           for j, (s, k, ok) in enumerate(zip(src, pos, pvalid))]
    assert got == want
    assert not bool(pieces[torch.arange(out_w)[None, :] >=
                           plen[:, None]].any())


@pytest.mark.parametrize("outer", [False, True])
def test_array_plain_matches_numpy(outer):
    rng = np.random.default_rng(5)
    n, w = 300, 8
    lens = rng.integers(0, w + 1, n).astype(np.int32)
    valid = rng.random(n) >= 0.2
    lens[~valid] = 0
    data = np.where(np.arange(w)[None, :] < lens[:, None],
                    rng.integers(-50, 50, (n, w)), 0).astype(np.int64)
    emit, total = GE.array_counts(torch.from_numpy(lens),
                                  torch.from_numpy(valid), outer)
    elem, evalid, src, pos = GE.array_emit(
        torch.from_numpy(data), torch.from_numpy(lens),
        torch.from_numpy(valid), outer, emit, total)
    keep = lens > 0 if not outer else np.ones(n, bool)
    want_src = np.repeat(np.arange(n), np.where(keep, np.maximum(lens, 1),
                                                0))
    flat = data[np.arange(w)[None, :] < lens[:, None]]
    assert np.array_equal(src.numpy(), want_src)
    assert np.array_equal(elem[evalid].numpy(), flat)
    assert int(evalid.sum()) == int(lens.sum())
    assert not bool(pos[~evalid].any())


def test_multi_byte_delimiter_refused(fuzz_dir, sessions):
    with pytest.raises(ValueError, match="single-byte"):
        sessions[1].read_parquet(fuzz_dir).explode_split("s", "é")


def test_total_above_int32_raises():
    x = torch.zeros((1, 4), dtype=torch.uint8)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        GE.split_emit(x, one, one > 0, 44, False, one, 1 << 31, 4)
    with pytest.raises(ValueError, match="int32"):
        GE.array_emit(x, one, one > 0, False, one, 1 << 31)


# -- the reference's own shapes ----------------------------------------------

def _tags(tmp_path, ids, tags, name="t"):
    p = str(tmp_path / f"{name}.parquet")
    pq.write_table(pa.table({"id": pa.array(ids, pa.int32()),
                             "tags": pa.array(tags, pa.string())}), p)
    return p


def test_reference_generate_shapes(tmp_path, sessions):
    """tests/test_expand_generate.py:94-132 and tests/test_arrays.py:
    82-97 (their in-memory frames written to parquet)."""
    js, ps = sessions
    cases = [
        (_tags(tmp_path, [1, 2, 3, 4], ["a,b,c", "", None, "xy"], "s"),
         lambda d: d.explode_split("tags", ",", output_name="tag")),
        (_tags(tmp_path, [1, 2], ["a,b", None], "po"),
         lambda d: d.explode_split("tags", ",", output_name="tag", pos=True,
                                   outer=True)),
    ]
    results = []
    for path, q in cases:
        results.append(q(ps.read_parquet(path)).collect())
        assert results[-1] == q(js.read_parquet(path)).collect()
    assert (2, "", "") in results[0]               # split("") -> [""]
    assert not any(r[0] == 3 for r in results[0])  # null -> no rows
    assert (2, None, None, None) in results[1]     # outer keeps it
    agg = _tags(tmp_path, [1, 2, 3], ["a,b", "b,c,b", "a"], "agg")

    def count(d, A):
        return sorted(d.explode_split("tags", ",", output_name="tag")
                      .group_by("tag").agg(A.CountStar().alias("cnt"))
                      .collect())

    assert count(ps.read_parquet(agg), PA) == \
        count(js.read_parquet(agg), JA) == [("a", 2), ("b", 3), ("c", 1)]
    rng = np.random.default_rng(21)
    arr = str(tmp_path / "arr.parquet")
    pq.write_table(pa.table({
        "k": pa.array(range(40), pa.int32()),
        "a": pa.array([None if i % 9 == 4 else
                       [int(x) for x in rng.integers(-5, 20, i % 6)]
                       for i in range(40)], pa.list_(pa.int32()))}), arr)
    for outer, pos in [(False, False), (True, True)]:
        got = ps.read_parquet(arr).explode("a", output_name="e", pos=pos,
                                           outer=outer).collect()
        assert got == js.read_parquet(arr).explode(
            "a", output_name="e", pos=pos, outer=outer).collect()


# -- the generator and the paths ---------------------------------------------

def test_product_reviews_equal_reference(tmp_path):
    generate_tpcxbb(str(tmp_path / "ref"), sf=0.01, seed=42)
    assert generate_product_reviews(str(tmp_path / "port"), sf=0.01,
                                    seed=42) == 2700
    ref = sorted(os.listdir(tmp_path / "ref" / "product_reviews"))
    port = [f for f in sorted(os.listdir(tmp_path / "port" /
                                         "product_reviews"))
            if not f.startswith("_")]
    assert ref == port
    for f in ref:
        assert pq.read_table(tmp_path / "port" / "product_reviews" / f) \
            .equals(pq.read_table(tmp_path / "ref" / "product_reviews" / f))


def _jax_review_words(s, data_dir):
    return s.read_parquet(
        os.path.join(data_dir, "product_reviews"),
        columns=["pr_review_rating", "pr_review_content"]) \
        .explode_split("pr_review_content", " ", output_name="word",
                       pos=True) \
        .group_by("word").agg(
            JA.CountStar().alias("n"),
            JA.Average(jcol("pr_review_rating")).alias("avg_rating"),
            JA.Min(jcol("pos")).alias("min_pos"),
            JA.Max(jcol("pos")).alias("max_pos")) \
        .order_by(("n", False), ("word", True))


def _jax_basket_items(s, data_dir):
    item = s.read_parquet(os.path.join(data_dir, "item"),
                          columns=["i_item_sk", "i_category"])
    return s.read_parquet(os.path.join(data_dir, "store_baskets")) \
        .where(JCL.Size(jcol("items")) >= jlit(2)) \
        .explode("items", output_name="item_sk", pos=True) \
        .join(item, on=[("item_sk", "i_item_sk")]) \
        .group_by("i_category").agg(
            JA.CountStar().alias("n"), JA.Sum(jcol("pos")).alias("pos_sum"),
            JA.Max(jcol("pos")).alias("max_pos")) \
        .order_by(("i_category", True))


@pytest.mark.parametrize("path,reference", [
    ("review_words", _jax_review_words), ("basket_items", _jax_basket_items)])
def test_generate_paths_match_jax(tmp_path_factory, sessions, path,
                                  reference):
    js, ps = sessions
    build, prepare, _fact = GQ.GENERATE_PATHS[path]
    data_dir = prepare(str(tmp_path_factory.mktemp(path)), 0.05)
    got = build(ps, data_dir).collect()
    assert got == reference(js, data_dir).collect()
    assert len(got) == (34 if path == "review_words" else 11)
    assert "GenerateExec[posexplode]" in build(ps, data_dir).explain()


def test_baskets_hold_every_sale(tmp_path):
    """store_baskets: one row per ticket, the ticket's items in file
    order, the first row's customer."""
    data_dir = GQ.prepare_basket_items(str(tmp_path), 0.01)
    ss = pq.read_table(os.path.join(data_dir, "store_sales"),
                       columns=["ss_ticket_number", "ss_customer_sk",
                                "ss_item_sk"]).to_pylist()
    want = {}
    for r in ss:
        t = want.setdefault(r["ss_ticket_number"],
                            [r["ss_customer_sk"], []])
        t[1].append(r["ss_item_sk"])
    got = pq.read_table(os.path.join(data_dir, "store_baskets"))
    assert got.schema.field("items").type == pa.list_(pa.int32())
    assert got.column("ticket").to_pylist() == sorted(want)
    assert [[r["customer"], r["items"]] for r in got.to_pylist()] == \
        [want[t] for t in sorted(want)]
    assert T.Schema.from_arrow(got.schema).fields[2].data_type == \
        T.ArrayType(T.IntegerType())
