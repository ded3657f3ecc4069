"""The design of K6 (the join's dense key ids) of the PyTorch/CUDA port,
on the CPU.

On the card ``ops/join.py`` ``_key_ids`` sorts both sides' keys once with
K1 (``ops/sort.py`` ``sort_words``), behind a leading key that is the
rows' validity (rows with a null key last), and keeps K1's packed words:
of the validity key only its null indicator, of every other key all its
varying bits but its null indicator.  One kernel (``csrc/join_ids.cu``)
then flags each sorted row whose words differ from the row before it,
counts the flags within a tile and across tiles, and writes each row's
count as its id (INT32_MAX / INT32_MAX - 1 for a left / right row with a
null key).  Here the numpy model of K1's key fields from
``test_torch_sort_plan.py`` feeds the same plan functions, the words are
built from the plan's segments and sorted digit by digit, and the flags
are counted tile by tile as the kernel's threads do: the ids must equal
the plain version's and the JAX package's ``_key_ids``.
"""
import zlib

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu.ops import join as jj
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PBatch
from spark_rapids_tpu_torch.ops import join as pj
from spark_rapids_tpu_torch.ops.kernels import slice_rows
from spark_rapids_tpu_torch.ops import sort as ps
from test_torch_sort_plan import _array, _lsd, _model_fields, _words

CPU = torch.device("cpu")
U64 = np.uint64
I32MAX = 2 ** 31 - 1


def _side(rng, kinds, n: int, null_p: float, widths):
    """One join side: a column of each kind (test_torch_sort_plan's
    kinds; ``nanpay`` a double with NaN payloads of both signs, -0.0 and
    +-inf), strings at this side's widths."""
    arrays, sw = [], {}
    for i, k in enumerate(kinds):
        name = f"c{i}"
        if k == "nanpay":
            bits = np.array([0x7FF8000000000000, 0x7FF0000000000001,
                             0xFFF8000000000123, 0xFFFFFFFFFFFFFFFF,
                             0x8000000000000000, 0, 0x7FF0000000000000,
                             0xFFF0000000000000, 0x3FF8000000000000],
                            dtype=U64).view(np.float64)
            arrays.append(pa.array(bits[rng.integers(0, len(bits), n)],
                                   mask=rng.random(n) < null_p))
            continue
        if k.startswith("s"):
            _base, _, rest = k.partition(":")
            k = f"s{widths}" + (f":{rest}" if rest else "")
            sw[name] = widths
        arr, _extra = _array(rng, k, n, null_p)
        arrays.append(arr)
    rb = pa.RecordBatch.from_arrays(
        arrays, names=[f"c{i}" for i in range(len(kinds))])
    jb = JBatch.from_arrow(rb, string_widths=sw)
    leaves = jax.device_get([(c.data, c.validity, c.lengths)
                             for c in jb.columns])
    return jb, PBatch.from_leaves(rb.schema, leaves, n, CPU)


def _model_ids(pl, pr, keys, tile: int = 64, items: int = 4):
    """K6 as the card runs it, in numpy: the plan of the sort_words call
    (every field's varying bits over all rows, the dropped fields kept
    out), the words, their LSD sort, then the ids kernel over tiles of
    ``tile`` sorted rows, ``items`` consecutive rows a thread: each
    thread's flags, an exclusive scan of the thread counts in the tile,
    the tile prefix from the earlier tiles' totals."""
    cols, valid = pj._combined(pl, pr, keys, keys)
    cl, n = pl.num_rows, valid.numel()
    kcols, orders, drop = pj.ids_sort_keys(cols, valid)
    assert drop == [(0, 1)] + [(k, 0) for k in range(1, len(kcols))]
    fields, field_bits = [], []
    for c, o in zip(kcols, orders):
        w = ps.packed_width(c) if c.is_string else None
        kind, item, _bits = ps.key_layout(c, w)
        fields.append(_model_fields(c, kind, item, o.ascending,
                                    o.resolved_nulls_first))
        field_bits.append(ps.key_field_bits(kind, item))
    masks = [[int(np.bitwise_or.reduce(f) ^ np.bitwise_and.reduce(f))
              if (k, g) not in drop else 0
              for g, f in enumerate(fs)] for k, fs in enumerate(fields)]
    plan = ps.sort_plan(field_bits, masks)
    words = _words(fields, plan, n)
    order = _lsd(words, plan, n)
    differ = np.zeros(n, bool)
    for w in words:  # each sorted row against the row before it
        ws = w[order]
        differ[1:] |= ws[1:] != ws[:-1]
    # a row's validity as the kernel reads it: the validity key's null
    # indicator, the top word's highest bit, where it varies; else the
    # plan's OR of that field, the same in every row
    at = [(w, dst) for k, f, _s, _n, w, dst in plan.segments
          if (k, f) == (0, 0)]
    assert [dst for _w, dst in at] == [pj.ids_valid_bit(plan)] * len(at)
    if at:
        assert at == [(len(plan.words) - 1, plan.words[-1] - 1)]
        top = words[-1][order]
        sorted_valid = (top >> U64(at[0][1])) & U64(1) == 0
    else:
        inv_or = int(np.bitwise_or.reduce(fields[0][0])) if n else 0
        sorted_valid = np.full(n, inv_or == 0)
    np.testing.assert_array_equal(sorted_valid, valid.numpy()[order])
    ids_sorted = np.zeros(n, np.int64)
    prefix = 0
    for t0 in range(0, n, tile):
        flags = differ[t0:t0 + tile]
        counts = [int(flags[i:i + items].sum())
                  for i in range(0, len(flags), items)]
        excl = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for th, lo in enumerate(range(0, len(flags), items)):
            run = prefix + excl[th]
            for k in range(lo, min(lo + items, len(flags))):
                run += int(flags[k])
                ids_sorted[t0 + k] = run
        prefix += sum(counts)
    ids = np.empty(n, np.int64)
    ids[order] = ids_sorted
    v = valid.numpy()
    ids = np.where(v, ids, np.where(np.arange(n) < cl, I32MAX, I32MAX - 1))
    return ids[:cl].astype(np.int32), ids[cl:].astype(np.int32), plan


def _check(kinds, nl, nr, null_p=0.15, wl=13, wr=64, keys=None):
    rng = np.random.default_rng(zlib.crc32(repr((kinds, nl, nr, null_p))
                                           .encode()))
    jl, pl = _side(rng, kinds, nl, null_p, wl)
    jr, pr = _side(rng, kinds, nr, null_p, wr)
    k = list(range(len(kinds))) if keys is None else keys
    mlid, mrid, plan = _model_ids(pl, pr, k)
    plid, prid = pj.key_ids_plain(pl, pr, k, k)
    np.testing.assert_array_equal(plid.numpy(), mlid)
    np.testing.assert_array_equal(prid.numpy(), mrid)
    jlid, jrid = jj._key_ids(jl, jr, k, k)
    np.testing.assert_array_equal(np.asarray(jax.device_get(jlid))[:nl],
                                  mlid)
    np.testing.assert_array_equal(np.asarray(jax.device_get(jrid))[:nr],
                                  mrid)
    return plan


_CASES = [
    # (key kinds, left rows, right rows, null share)
    (["int32"], 301, 157, 0.15),
    (["nanpay", "int16"], 240, 90, 0.1),
    (["s8", "float"], 200, 120, 0.15),
    (["bool", "date", "s8"], 230, 100, 0.1),
    # every row equal: no bit varies, K1 runs no pass (the ids kernel's
    # constant branch)
    (["int64:const", "s8:const"], 40, 20, 0.0),
    # an empty left side and one row
    (["double", "s8"], 0, 1, 0.0),
    # every key null in every row
    (["nanpay", "s8", "int64"], 150, 60, 1.0),
]


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_k6_model_matches_plain_and_jax(case):
    """Ints, doubles with NaN payloads of both signs, -0.0 and +-inf,
    floats, bools, dates, strings with NUL tails at W 13 on the left and
    64 on the right, nulls, constant and all-null columns, one to three
    keys, an empty side, one row: K6's words, flags and tile counts give
    the plain version's and the JAX package's ids."""
    kinds, nl, nr, null_p = _CASES[case]
    plan = _check(kinds, nl, nr, null_p)
    if null_p == 1.0 or nl + nr <= 1 or kinds[0].endswith(":const"):
        assert plan.bits == 0


def test_k6_model_drops_the_null_indicators():
    """One nullable int64 key over 2^33-spaced values: the validity key
    keeps one bit and the key its value bits but no null indicator, so
    the words hold one bit more than the values need, not three."""
    rng = np.random.default_rng(9)
    n = 400
    vals = (rng.integers(-500, 500, n) * (1 << 33)).astype(np.int64)
    mask = rng.random(n) < 0.1
    rb = pa.RecordBatch.from_arrays([pa.array(vals, mask=mask)],
                                    names=["c0"])
    jb = JBatch.from_arrow(rb)
    leaves = jax.device_get([(c.data, c.validity, c.lengths)
                             for c in jb.columns])
    pb = PBatch.from_leaves(rb.schema, leaves, n, CPU)
    pl, pr = slice_rows(pb, 0, n // 2), slice_rows(pb, n // 2, n)
    lid, rid, plan = _model_ids(pl, pr, [0])
    for got, want in zip((lid, rid), pj.key_ids_plain(pl, pr, [0], [0])):
        np.testing.assert_array_equal(got, want.numpy())
    # the plan kernel reads every row, null slots (zero) too
    u = np.where(mask, 0, vals).view(U64) ^ U64(1 << 63)
    value_bits = bin(int(np.bitwise_or.reduce(u) ^ np.bitwise_and.reduce(u))
                     ).count("1")
    assert plan.bits == value_bits + 1 <= 32
    assert not plan.wide


def test_ids_limits_match_the_cuda_source():
    """The tile ``ops/join.py`` shares with csrc/join_ids.cu is the one
    ``srt_join_ids_limits`` reports (on the card the loader compares
    them)."""
    import re
    from pathlib import Path

    from spark_rapids_tpu_torch.ops import native
    src = (Path(native.CSRC) / "join_ids.cu").read_text()
    assert re.search(r"\bint srt_join_ids_limits\(", src)
    known = {}
    for name in ("kIdsThreads", "kIdsItems", "kIdsTile"):
        m = re.search(rf"constexpr [\w ]+ {name} = ([\w *]+);", src)
        known[name] = eval(m.group(1), {}, dict(known))
    assert native._LIMITS["join_ids"] == (known["kIdsTile"],) \
        == (pj.IDS_TILE,)
