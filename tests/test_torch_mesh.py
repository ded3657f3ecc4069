"""The mesh shuffle (K15) of the PyTorch/CUDA port against the JAX package.

The reference runs ``exchange_local_checked`` and ``make_hash_exchange``
under ``shard_map`` over ``make_mesh(P)`` on the virtual 8-device CPU mesh
(``tests/conftest.py``); the port runs the same shards through
``parallel/mesh_shuffle.py`` over ``SRT_VIRTUAL_DEVICES=8`` CPU slots,
whose K15a/K15b wrappers take their plain versions on the CPU.  Every
destination's rows must equal the reference's, in order; doubles compare
bit for bit (the exchange moves them, it does no arithmetic), distributed
aggregates within rtol 1e-9 (per-shard sums are added in another order).
"""
import math
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnBatch as JBatch
from spark_rapids_tpu.exec.mesh_exec import _pad_widths as j_pad_widths
from spark_rapids_tpu.ops.segmented import AggSpec as JAggSpec
from spark_rapids_tpu.parallel import mesh as jmesh
from spark_rapids_tpu.parallel import mesh_shuffle as jms
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.ops import mesh_exchange as ME
from spark_rapids_tpu_torch.ops.partition import partition_order
from spark_rapids_tpu_torch.ops.segmented import AggSpec
from spark_rapids_tpu_torch.parallel import mesh as pmesh
from spark_rapids_tpu_torch.parallel import mesh_shuffle as pms

CPU = torch.device("cpu")
DOUBLE_RTOL = 1e-9


@pytest.fixture(autouse=True)
def _virtual_devices(monkeypatch):
    monkeypatch.setenv("SRT_VIRTUAL_DEVICES", "8")


def _key(v):
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    return v


def _rows(rb) -> list:
    return [tuple(_key(v) for v in r.values()) for r in rb.to_pylist()]


def _shard_table(rng, n: int, w: int, dst, null_p: float = 0.2):
    """One shard's rows: a destination column, then int, double (NaN,
    -0.0, +-inf), string (up to ``w`` bytes) and bool, with nulls."""
    vals = rng.normal(size=n) * 1e3
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf])
    pick = rng.random(n) < 0.2
    vals[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
    words = ["".join(chr(97 + int(c)) for c in
                     rng.integers(0, 26, int(rng.integers(0, w + 1))))
             for _ in range(n)]

    def nulls(xs):
        return [None if rng.random() < null_p else x for x in xs]

    return pa.record_batch([
        pa.array(np.asarray(dst, dtype=np.int32), pa.int32()),
        pa.array(nulls(rng.integers(-50, 50, n).tolist()), pa.int64()),
        pa.array(nulls(vals.tolist()), pa.float64()),
        pa.array(nulls(words), pa.string()),
        pa.array(nulls((rng.random(n) < 0.5).tolist()), pa.bool_()),
    ], names=["dst", "i", "d", "s", "b"])


def _shards(rng, p: int, case: str):
    sizes = [int(rng.integers(1, 200)) for _ in range(p)]
    if case == "empty":
        sizes[p // 2] = 0
    tables = []
    for s, n in enumerate(sizes):
        if case == "one":
            dst = np.full(n, p - 1)
        else:
            dst = rng.integers(0, p, n)
        tables.append(_shard_table(rng, n, 4 + 9 * s, dst))
    return tables


def _reference_exchange(tables, p: int, send_capacity=None):
    """Per-destination rows and the overflow flag of the reference's
    ``exchange_local_checked`` under shard_map over make_mesh(p)."""
    cap = max(8, max(t.num_rows for t in tables))
    cap = 1 << (cap - 1).bit_length()
    batches = [JBatch.from_arrow(t, capacity=cap) for t in tables]
    widths = [max(b.columns[i].max_len for b in batches)
              if isinstance(f.data_type, JT.StringType) else None
              for i, f in enumerate(batches[0].schema)]
    batches = [j_pad_widths(b, widths) for b in batches]
    mesh = jmesh.make_mesh(p)
    stacked = jmesh.shard_batches(batches, mesh)

    def step(st):
        b = jmesh.local_view(st)
        part = jnp.where(b.row_mask(), b.columns[0].data, p)
        out, ovf = jms.exchange_local_checked(b, part, p, "data",
                                              send_capacity)
        return jmesh.restack(out), jmesh.restack(ovf)

    from jax.sharding import PartitionSpec as PS
    fn = jax.jit(jmesh.shard_map(step, mesh=mesh, in_specs=PS("data"),
                                 out_specs=(PS("data"), PS("data"))))
    out, ovf = fn(stacked)
    return ([_rows(b.to_arrow()) for b in jmesh.split_shards(out)],
            bool(np.asarray(jax.device_get(ovf)).any()))


def _port_batches(tables):
    return [ColumnBatch.from_arrow(t, CPU) for t in tables]


def _port_exchange(tables, p: int, send_capacity=None):
    mesh = pmesh.make_mesh(p, devices=pmesh.mesh_devices(CPU))
    batches = _port_batches(tables)
    parts = [b.columns[0].data.to(torch.int32) for b in batches]
    out, ovf = pms.exchange_local_checked(batches, parts, mesh,
                                          send_capacity)
    return [_rows(b.to_arrow()) for b in out], ovf


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("case", ["random", "empty", "one"])
def test_exchange_matches_jax(p, case):
    rng = np.random.default_rng(100 * p + len(case))
    tables = _shards(rng, p, case)
    want, want_ovf = _reference_exchange(tables, p)
    got, got_ovf = _port_exchange(tables, p)
    assert got == want
    assert not got_ovf and not want_ovf
    assert sum(len(r) for r in got) == sum(t.num_rows for t in tables)
    if case == "one":
        assert all(not r for r in got[:-1])


@pytest.mark.parametrize("p", [2, 8])
def test_send_capacity_overflow_flag_matches_jax(p):
    rng = np.random.default_rng(7 + p)
    tables = _shards(rng, p, "one")
    cap = 4
    assert max(t.num_rows for t in tables) > cap
    _want, want_ovf = _reference_exchange(tables, p, send_capacity=cap)
    got, got_ovf = _port_exchange(tables, p, send_capacity=cap)
    assert got_ovf is True and want_ovf is True
    # the reference drops what C cannot carry (its exec retries); the
    # port's exact sections carry every row (test_exchange_matches_jax
    # holds the uncapped exchange against the reference's)
    assert got == _port_exchange(tables, p)[0]
    assert sum(len(r) for r in got) == sum(t.num_rows for t in tables)
    small = _shards(np.random.default_rng(3), p, "random")
    small = [t.slice(0, 3) for t in small]
    assert _port_exchange(small, p, cap)[1] is False
    assert _reference_exchange(small, p, cap)[1] is False


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("keys", [["i"], ["d"], ["s"], ["s", "i"]])
def test_hash_exchange_matches_jax(p, keys):
    rng = np.random.default_rng(31 * p + len(keys))
    tables = _shards(rng, p, "empty")
    names = tables[0].schema.names
    kidx = [names.index(k) for k in keys]
    cap = 256
    batches = [JBatch.from_arrow(t, capacity=cap) for t in tables]
    widths = [max(b.columns[i].max_len for b in batches)
              if isinstance(f.data_type, JT.StringType) else None
              for i, f in enumerate(batches[0].schema)]
    batches = [j_pad_widths(b, widths) for b in batches]
    mesh = jmesh.make_mesh(p)
    fn = jms.make_hash_exchange(mesh, batches[0].schema, kidx)
    out = fn(jmesh.shard_batches(batches, mesh))
    want = [_rows(b.to_arrow()) for b in jmesh.split_shards(out)]
    pm = pmesh.make_mesh(p, devices=pmesh.mesh_devices(CPU))
    got = [_rows(b.to_arrow()) for b in pms.make_hash_exchange(
        pm, None, kidx)(_port_batches(tables))]
    assert got == want


def _close(a, b) -> bool:
    if isinstance(a, tuple) and a and a[0] == "f":
        x = struct.unpack("<d", a[1])[0]
        y = struct.unpack("<d", b[1])[0]
        if math.isnan(x) or math.isnan(y):
            return math.isnan(x) and math.isnan(y)
        return x == y or abs(x - y) <= DOUBLE_RTOL * max(abs(x), abs(y))
    return a == b


_OPS = ["sum", "count", "count_star", "min", "max", "first", "last",
        "first_non_null", "last_non_null"]


@pytest.mark.parametrize("keyed", [True, False])
def test_distributed_groupby_matches_jax(keyed):
    rng = np.random.default_rng(5 + keyed)
    p = 8
    tables = []
    for s in range(p):
        n = 0 if s == 3 else int(rng.integers(20, 120))
        tables.append(pa.record_batch([
            pa.array(rng.integers(0, 9, n).astype(np.int32), pa.int32()),
            pa.array([None if rng.random() < 0.2 else int(x)
                      for x in rng.integers(-99, 99, n)], pa.int64()),
            pa.array([None if rng.random() < 0.2 else float(x)
                      for x in rng.normal(size=n)], pa.float64()),
        ], names=["k", "v", "f"]))
    keys = [0] if keyed else []
    specs = [(op, c) for op in _OPS for c in (1, 2)]
    cap = 128
    batches = [JBatch.from_arrow(t, capacity=cap) for t in tables]
    mesh = jmesh.make_mesh(p)
    jfn = jms.make_distributed_groupby(
        mesh, batches[0].schema, keys, [JAggSpec(op, c) for op, c in specs])
    want = [_rows(b.to_arrow()) for b in
            jmesh.split_shards(jfn(jmesh.shard_batches(batches, mesh)))]
    pm = pmesh.make_mesh(p, devices=pmesh.mesh_devices(CPU))
    pfn = pms.make_distributed_groupby(
        pm, None, keys, [AggSpec(op, c) for op, c in specs])
    got = [_rows(b.to_arrow()) for b in pfn(_port_batches(tables))]
    assert [len(r) for r in got] == [len(r) for r in want]
    for gd, wd in zip(got, want):
        for g, w in zip(gd, wd):
            assert all(_close(a, b) for a, b in zip(g, w)), (g, w)
    if not keyed:
        assert [len(r) for r in got] == [1] + [0] * (p - 1)


def test_distributed_groupby_refuses_avg():
    pm = pmesh.make_mesh(2, devices=pmesh.mesh_devices(CPU))
    with pytest.raises(ValueError, match="avg"):
        pms.make_distributed_groupby(pm, None, [0], [AggSpec("avg", 1)])


# ---------------------------------------------------------------------------
# the plain versions of K15a and K15b on their own
# ---------------------------------------------------------------------------

def test_pack_layout_and_sections_round_trip():
    rng = np.random.default_rng(11)
    p = 5
    t = _shard_table(rng, 300, 37, rng.integers(0, p, 300))
    b = ColumnBatch.from_arrow(t, CPU)
    perm, counts, _starts = partition_order(b.columns[0].data, p)
    counts = counts.tolist()
    buf, (sections, blocks) = ME.mesh_pack(b.columns, perm, counts)
    assert buf.numel() == sections[-1]
    assert all(x % 16 == 0 for x in sections)
    for row in blocks:
        for data, lens, valid in row:
            assert data % 16 == 0 and valid % 16 == 0
            assert lens == -1 or lens % 16 == 0
    rows = _rows(t)
    order = perm.tolist()
    at = 0
    for d in range(p):
        cols = ME.section_columns(buf[sections[d]:sections[d + 1]],
                                  b.columns, counts[d], blocks[d],
                                  sections[d])
        sec = ColumnBatch(cols, counts[d], b.schema, CPU)
        assert _rows(sec.to_arrow()) == [rows[i] for i in
                                         order[at:at + counts[d]]]
        assert all(int(x) == d for x in sec.columns[0].data)
        at += counts[d]


def test_unpack_pads_to_the_widest_source_and_keeps_order():
    rng = np.random.default_rng(12)
    tables = [_shard_table(rng, n, w, np.zeros(n))
              for n, w in ((5, 4), (0, 200), (9, 70), (3, 16))]
    batches = _port_batches(tables)
    widths = [b.columns[3].max_len for b in batches]
    assert len(set(widths)) > 1
    cols = ME.mesh_unpack([b.columns for b in batches],
                          [b.num_rows for b in batches])
    assert cols[3].data.shape[1] == max(widths)
    out = ColumnBatch(cols, sum(b.num_rows for b in batches),
                      batches[0].schema, CPU)
    assert _rows(out.to_arrow()) == [r for t in tables for r in _rows(t)]


def test_wrappers_launch_or_raise_off_the_cpu(monkeypatch):
    """Off the CPU the K15 wrappers launch their kernel or raise: they
    never take the plain version."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel")

    monkeypatch.setattr(ME.native, "lib", no_kernel)
    meta = torch.device("meta")
    b = ColumnBatch.from_arrow(_shard_table(np.random.default_rng(1), 3, 4,
                                            [0, 0, 1]), CPU)
    mcols = [type(c)(c.data.to(meta), c.validity.to(meta), c.dtype,
                     None if c.lengths is None else c.lengths.to(meta))
             for c in b.columns]
    with pytest.raises(RuntimeError, match="no mesh_exchange kernel"):
        ME.mesh_pack(mcols, torch.zeros(3, dtype=torch.int32, device=meta),
                     [2, 1])
    with pytest.raises(RuntimeError, match="no mesh_exchange kernel"):
        ME.mesh_unpack([mcols, mcols], [3, 3])


def test_virtual_devices_are_read_when_the_mesh_is_built(monkeypatch):
    assert pmesh.mesh_devices(CPU) == [CPU] * 8
    monkeypatch.delenv("SRT_VIRTUAL_DEVICES")
    assert pmesh.mesh_devices(CPU) == [CPU]
    with pytest.raises(ValueError, match="requested 8"):
        pmesh.make_mesh(8, devices=pmesh.mesh_devices(CPU))
    monkeypatch.setenv("SRT_VIRTUAL_DEVICES", "3")
    m = pmesh.make_mesh(devices=pmesh.mesh_devices(CPU))
    assert m.size == 3 and m.physical() == [CPU]
