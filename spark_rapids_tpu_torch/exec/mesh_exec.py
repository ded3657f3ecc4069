"""Mesh-distributed execs: exchange, aggregation and joins over a mesh
(port of ``spark_rapids_tpu/exec/mesh_exec.py``).

When ``spark.rapids.tpu.mesh.deviceCount`` > 1 the planner lowers a grouped
or grand aggregate to :class:`MeshAggregateExec` (pre-project -> partial
group-by -> all-to-all -> merge -> final projection per slot), a keyed
repartition to :class:`MeshExchangeExec` and a join other than full outer
to :class:`MeshJoinExec` (replicated or partitioned build, picked at run
time).  The reference runs each as one ``shard_map`` program; the port's
mesh is single-controller and eager: one Python loop over the slots
launches each slot's kernels, and the all-to-all is
``parallel/mesh_shuffle.py`` (K10, K15a, one read of the count matrix,
``Tensor.to`` per section, K15b).  The expression layout (pre-projection,
update/merge specs, final projection) is :class:`HashAggregateExec`'s, as
in the reference.

Placement.  The reference keeps each mesh output committed to its device,
and ``place_shards`` keeps a committed batch on its device (device
affinity), spreading only uncommitted batches (scans) by their rows.  Port
batches carry no commitment: with virtual devices every slot may be
``cuda:0``.  :func:`_committed_device` models jax's rule at the plan level
instead -- partition ``pid`` of a mesh exec is committed to its slot (slot
0 once aligned), a per-batch operator (project, filter) keeps its child's
placement, and any other operator over committed input is committed to
slot 0 -- so the port assigns rows to slots as the reference does, and
per-slot outputs compare in order.

Not ported here: mesh regions (``MeshRegionExec``, whole pipelines in one
program; they need ``exec/fused.py``) and ``MeshJoinExec._region_step``
(ROADMAP.md Queue 1 items 8 and 10).  ``MeshSortExec`` is in
``exec/mesh_region.py``.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.conf import MESH_SEND_CAPACITY
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec, _relabel
from spark_rapids_tpu_torch.exec.core import ExecCtx, PlanNode
from spark_rapids_tpu_torch.exec.joins import JoinExec
from spark_rapids_tpu_torch.expr.core import (Expression, bind, eval_device,
                                              output_name)
from spark_rapids_tpu_torch.ops import kernels as dk
from spark_rapids_tpu_torch.ops.join import PreparedBuild, build_prepare_fast
from spark_rapids_tpu_torch.ops.mesh_exchange import mesh_unpack
from spark_rapids_tpu_torch.ops.segmented import sorted_group_by
from spark_rapids_tpu_torch.parallel.mesh import (COUNTERS, Mesh, make_mesh,
                                                  mesh_devices)
from spark_rapids_tpu_torch.parallel.mesh_shuffle import (
    canonicalize, exchange_local, exchange_local_checked,
    partition_ids_for_keys)

__all__ = ["DeviceSliceLost", "MeshSendOverflow", "MeshAggregateExec",
           "MeshExchangeExec", "MeshJoinExec", "all_gather_batch",
           "mesh_for", "place_shards"]


def _committed_device(node: PlanNode, pid: int) -> int | None:
    """The mesh slot that partition ``pid``'s batches of ``node`` are
    committed to, or None (uncommitted: a scan's, or a plan off the
    mesh).  See the module docstring."""
    if isinstance(node, _MeshOutputMixin):
        return 0 if node.align_output else node._slot_of(pid)
    if not node.children:
        return None
    if not node.combines_batches and \
            node.num_partitions(ExecCtx(device="cpu", planning=True)) \
            == node.children[0].num_partitions(
                ExecCtx(device="cpu", planning=True)):
        return _committed_device(node.children[0], pid)
    return 0 if any(_subtree_committed(c) for c in node.children) else None


def _subtree_committed(node: PlanNode) -> bool:
    if isinstance(node, _MeshOutputMixin):
        return True
    return any(_subtree_committed(c) for c in node.children)


def _drain_placed(ctx: ExecCtx, node: PlanNode) -> list:
    """Every batch of ``node``, partition by partition, with the slot it
    is committed to: ``[(slot or None, batch)]``."""
    out = []
    for pid in range(node.num_partitions(ctx)):
        slot = _committed_device(node, pid)
        out.extend((slot, b) for b in node.partition_iter(ctx, pid))
    return out


def _note_a2a_bytes(shards: Sequence[ColumnBatch]) -> None:
    """Bytes one collective may move: in an all-to-all every input row
    crosses at most once, so the shards' bytes bound the traffic."""
    COUNTERS["mesh_all_to_all_bytes"] += float(
        sum(b.device_size_bytes() for b in shards))


class _MeshOutputMixin:
    """Mesh execs yield per-slot batches.  When the planner sees a
    non-mesh consumer above that combines batches (a join's build, a
    sort, an aggregate), it sets ``align_output`` and the exec hands each
    batch to the session's device at the mesh -> single-device boundary;
    every batch that comes from another slot than 0 counts
    ``mesh_gather_fallbacks`` (the plan fell off the mesh)."""

    align_output: bool = False

    def _slot_of(self, pid: int) -> int:
        return pid

    def _aligned(self, ctx: ExecCtx, pid: int, it) -> Iterator:
        if not self.align_output:
            yield from it
            return
        for b in it:
            if self._slot_of(pid) != 0:
                COUNTERS["mesh_gather_fallbacks"] += 1
            yield b.to(ctx.device)


class DeviceSliceLost(RuntimeError):
    """A mesh device died under a collective: the on-mesh outputs are
    lost, but the child lineage is intact, so the exec recomputes on one
    device."""


class MeshSendOverflow(RuntimeError):
    """A bounded send buffer (spark.rapids.tpu.mesh.exchange.
    sendCapacityRows) could not carry a skewed destination's rows.  The
    port's send sections are exact, so this never happens; the counter
    ``mesh_send_overflows`` moves where the reference's retry would."""


def _check_slice_fault(ctx: ExecCtx, op: str, mesh: Mesh) -> None:
    """Injection point ``mesh.slice.lost`` (reference :124-136).  A no-op
    until the port has ``faults.py`` (ROADMAP.md Queue 1 item 6)."""


def _reraise_unless_slice_lost(err: BaseException) -> None:
    """Let a lost slice fall through to the single-device recompute;
    re-raise anything else, every CUDA error included."""
    if isinstance(err, DeviceSliceLost):
        return
    raise err


def all_gather_batch(shards: Sequence[ColumnBatch], mesh: Mesh) -> dict:
    """Every shard's rows on every physical device of the mesh, in slot
    order (K15b over the P shards; slots on one card share one gathered
    batch): ``{device: batch}``."""
    counts = [b.num_rows for b in shards]
    schema = shards[0].schema
    out = {}
    for dev in mesh.physical():
        cols = mesh_unpack([b.to(dev).columns for b in shards], counts)
        out[dev] = ColumnBatch(cols, sum(counts), schema, dev)
    return out


def mesh_for(ctx: ExecCtx, size: int, axis_name: str = "data"):
    """The context's cached 1-D mesh of ``size`` slots, or None when the
    session's device type offers fewer (set SRT_VIRTUAL_DEVICES to lay
    virtual devices over the physical ones)."""
    def build():
        devs = mesh_devices(ctx.device)
        return make_mesh(size, axis_name, devs[:size]) \
            if len(devs) >= size else None
    return ctx.cached(("mesh", size, axis_name), build)


def place_shards(items: Sequence, p: int, devices: Sequence,
                 schema: T.Schema) -> list[ColumnBatch]:
    """Assign ``(slot, batch)`` items to ``p`` shards without a central
    gather (reference :206-281): a batch committed to a slot stays there;
    the others are cut into ~1/p row ranges (at least 1024 rows) and
    dealt, largest first, to the least-loaded shard by rows.  Each shard
    concatenates its batches in that order on ``devices[i]``; string
    columns are padded to the widest W of all the batches, as the
    reference pads them to stack its shards."""
    groups: list[list[ColumnBatch]] = [[] for _ in range(p)]
    loads = [0] * p
    rest = []
    for slot, b in items:
        if slot is not None and slot < p:
            groups[slot].append(b)
            loads[slot] += b.num_rows
        else:
            rest.append((b.num_rows, b))
    total = sum(n for n, _ in rest)
    chunk = max(1024, -(-total // p))
    parts = []
    for n, b in rest:
        if n <= chunk:
            parts.append((n, b))
        else:
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                parts.append((hi - lo, dk.slice_rows(b, lo, hi)))
    for n, b in sorted(parts, key=lambda t: -t[0]):
        i = loads.index(min(loads))
        groups[i].append(b)
        loads[i] += n
    widths = [max((b.columns[ci].max_len for _s, b in items), default=4)
              if isinstance(f.data_type, T.StringType) else None
              for ci, f in enumerate(schema)]
    shards = []
    for g, dev in zip(groups, devices):
        if not g:
            shards.append(_empty_shard(schema, dev, widths))
            continue
        g = [b.to(dev) for b in g]
        s = g[0] if len(g) == 1 else dk.concat_batches(g)
        shards.append(_pad_widths(s, widths))
    return shards


def drain_cached(ctx: ExecCtx, node: PlanNode) -> list:
    """``node``'s placed batches (:func:`_drain_placed`), drained once per
    query, so a size probe, an exchange and a build share them."""
    return ctx.cached(("drained", id(node)),
                      lambda: _drain_placed(ctx, node))


def concat_or_empty(batches: Sequence[ColumnBatch], schema: T.Schema,
                    device) -> ColumnBatch:
    """One batch of ``batches`` (moved to the first one's device), or an
    empty one of ``schema`` on ``device``."""
    if not batches:
        return ColumnBatch.nulls(schema, 0, device)
    if len(batches) == 1:
        return batches[0]
    dev = batches[0].device
    return dk.concat_batches([b.to(dev) for b in batches])


def _empty_shard(schema: T.Schema, device, widths) -> ColumnBatch:
    return _pad_widths(ColumnBatch.nulls(schema, 0, device), widths)


def _pad_widths(b: ColumnBatch, widths) -> ColumnBatch:
    """String columns zero-padded to ``widths`` (None: keep)."""
    cols, changed = [], False
    for c, w in zip(b.columns, widths):
        if w is not None and c.max_len < w:
            cols.append(DeviceColumn(
                torch.nn.functional.pad(c.data, (0, w - c.max_len)),
                c.validity, c.dtype, c.lengths))
            changed = True
        else:
            cols.append(c)
    return ColumnBatch(cols, b.num_rows, b.schema, b.device) if changed \
        else b


def _move(x, dev):
    """Tensors (in tuples, a prepared build with its layout) on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    if isinstance(x, PreparedBuild):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(_move(v, dev) for v in x)
    return x


class MeshAggregateExec(_MeshOutputMixin, PlanNode):
    """Grouped or grand aggregation over the mesh.

    Per slot: pre-project -> partial sorted group-by (K1, K3, K4) -> K9
    ids on the buffer keys -> exchange -> merge group-by -> final
    projection.  A grand aggregate merges every partial row on slot 0;
    every other slot yields a 0-row batch.  With fewer devices than
    ``mesh_size``, or an empty input, a complete-mode
    :class:`HashAggregateExec` runs on the session's device (the
    reference's own single-device path)."""

    def __init__(self, group_exprs: Sequence[Expression],
                 result_exprs: Sequence[Expression], child: PlanNode,
                 mesh_size: int, axis_name: str = "data"):
        super().__init__([child])
        self.mesh_size = mesh_size
        self.axis_name = axis_name
        self._group_exprs = list(group_exprs)
        self._result_exprs = list(result_exprs)
        self._layout = HashAggregateExec(group_exprs, result_exprs, child,
                                         mode="partial")
        self._output_schema = T.Schema(
            [T.StructField(f.name, f.data_type, True)
             for f in HashAggregateExec.final_from_partial(
                 self._layout, child).output_schema])

    @property
    def output_schema(self) -> T.Schema:
        return self._output_schema

    @property
    def bound_exprs(self):
        return self._layout.bound_exprs

    def num_partitions(self, ctx: ExecCtx) -> int:
        return self.mesh_size

    def _complete_exec(self) -> HashAggregateExec:
        return HashAggregateExec(self._group_exprs, self._result_exprs,
                                 self.children[0], mode="complete")

    def _fallback_outputs(self, ctx: ExecCtx):
        out = [list(self._complete_exec().partition_iter(ctx, 0))]
        return out + [[] for _ in range(self.mesh_size - 1)]

    def _outputs(self, ctx: ExecCtx):
        return ctx.cached(("meshagg", id(self)),
                          lambda: self._compute_outputs(ctx))

    def _compute_outputs(self, ctx: ExecCtx):
        items = _drain_placed(ctx, self.children[0])
        mesh = mesh_for(ctx, self.mesh_size, self.axis_name)
        if mesh is not None and items:
            try:
                _check_slice_fault(ctx, "meshagg", mesh)
                shards = place_shards(items, mesh.size, mesh.devices,
                                      self.children[0].output_schema)
                _note_a2a_bytes(shards)
                return [[b] for b in self._run(mesh, shards)]
            except Exception as err:  # noqa: BLE001 - re-raised but a lost slice
                _reraise_unless_slice_lost(err)
        return self._fallback_outputs(ctx)

    def _run(self, mesh: Mesh, shards) -> list[ColumnBatch]:
        L = self._layout
        key_idx = list(range(len(L._group_bound)))
        partials = []
        for b in shards:
            pre = ColumnBatch([eval_device(e, b) for e in L._pre_exprs],
                              b.num_rows, L._pre_schema, b.device)
            partials.append(_relabel(
                sorted_group_by(pre, key_idx, L._update_specs),
                L._buffer_schema))
        if key_idx:
            parts = [partition_ids_for_keys(b, key_idx, mesh.size)
                     for b in partials]
        else:
            # grand aggregate: every partial row merges on slot 0
            parts = [torch.zeros(b.num_rows, dtype=torch.int32,
                                 device=b.device) for b in partials]
        out = []
        for d, ex in enumerate(exchange_local(partials, parts, mesh)):
            merged = _relabel(sorted_group_by(
                _relabel(ex, L._buffer_schema), key_idx, L._merge_specs),
                L._buffer_schema)
            cols = [eval_device(e, merged) for e in L._final_exprs]
            b = ColumnBatch(cols, merged.num_rows, self._output_schema,
                            merged.device)
            if not key_idx and d != 0:
                b = canonicalize(b, 0)
            out.append(b)
        return out

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        yield from self._aligned(ctx, pid, iter(self._outputs(ctx)[pid]))

    def node_desc(self) -> str:
        return (f"MeshAggregateExec[mesh={self.mesh_size}, "
                f"keys={self._layout._group_names}, "
                f"out={self._output_schema.names}]")


class MeshExchangeExec(_MeshOutputMixin, PlanNode):
    """Hash repartition into ``num_partitions`` over the mesh: rows route
    to slot ``pid % mesh_size`` by Spark's murmur3 partition id (K9), and
    each slot then serves its own partitions (reference :514-705).  With
    fewer devices than ``mesh_size`` or an empty input, the in-process
    :class:`ShuffleExchangeExec` runs instead."""

    def __init__(self, keys: Sequence[Expression], child: PlanNode,
                 mesh_size: int, axis_name: str = "data",
                 num_partitions: int | None = None):
        super().__init__([child])
        self.mesh_size = mesh_size
        self.axis_name = axis_name
        self._num_parts = num_partitions or mesh_size
        self._keys = list(keys)
        self._bound = [bind(k, child.output_schema) for k in self._keys]

    @property
    def output_schema(self) -> T.Schema:
        return self.children[0].output_schema

    @property
    def bound_exprs(self):
        return list(self._bound)

    def num_partitions(self, ctx: ExecCtx) -> int:
        return self._num_parts

    def _slot_of(self, pid: int) -> int:
        return pid % self.mesh_size

    def _host_exchange(self):
        from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
        from spark_rapids_tpu_torch.exec.partitioning import HashPartitioning
        return ShuffleExchangeExec(
            HashPartitioning(self._keys, self._num_parts), self.children[0])

    def _partition_ids(self, b: ColumnBatch) -> torch.Tensor:
        """Output partition of every row (K9 over the evaluated keys)."""
        cols = list(b.columns) + [eval_device(k, b) for k in self._bound]
        aug = ColumnBatch(cols, b.num_rows, T.Schema(
            list(b.schema.fields) + [T.StructField(f"_pk{i}", k.dtype, True)
                                     for i, k in enumerate(self._bound)]),
            b.device)
        kidx = list(range(b.num_columns, len(cols)))
        return partition_ids_for_keys(aug, kidx, self._num_parts)

    def _run_exchange(self, ctx: ExecCtx, mesh: Mesh, shards):
        send_cap = ctx.conf.get(MESH_SEND_CAPACITY) or None
        parts = []
        for b in shards:
            pid = self._partition_ids(b)
            parts.append(pid if self._num_parts == mesh.size
                         else torch.remainder(pid, mesh.size))
        result, overflow = exchange_local_checked(shards, parts, mesh,
                                                  send_cap)
        if overflow:
            # the reference retries at worst-case capacity here; the
            # port's exact sections already carried every row
            COUNTERS["mesh_send_overflows"] += 1
        return result

    def _outputs(self, ctx: ExecCtx):
        return ctx.cached(("meshex", id(self)),
                          lambda: self._compute_outputs(ctx))

    def _fallback_outputs(self, ctx: ExecCtx):
        he = self._host_exchange()
        return ("host", [list(he.partition_iter(ctx, pid))
                         for pid in range(self._num_parts)])

    def _compute_outputs(self, ctx: ExecCtx):
        items = drain_cached(ctx, self.children[0])
        mesh = mesh_for(ctx, self.mesh_size, self.axis_name)
        if mesh is not None and items:
            try:
                _check_slice_fault(ctx, "meshex", mesh)
                shards = place_shards(items, mesh.size, mesh.devices,
                                      self.output_schema)
                _note_a2a_bytes(shards)
                return ("mesh", self._run_exchange(ctx, mesh, shards))
            except Exception as err:  # noqa: BLE001 - re-raised but a lost slice
                _reraise_unless_slice_lost(err)
        return self._fallback_outputs(ctx)

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        yield from self._aligned(ctx, pid, self._partition_iter_mesh(ctx,
                                                                     pid))

    def _partition_iter_mesh(self, ctx: ExecCtx, pid: int) -> Iterator:
        kind, out = self._outputs(ctx)
        if kind == "host":
            yield from out[pid]
            return
        shard = out[pid % self.mesh_size]
        if self._num_parts != self.mesh_size:
            # the slot holds every row of partition pid among others:
            # recompute the ids on the slot and keep pid's rows (K9, K2);
            # with one partition per slot the slot's rows are pid's
            shard = dk.compact(shard, self._partition_ids(shard) == pid)
        if shard.num_rows > 0 or self._num_parts == 1:
            yield shard

    def node_desc(self) -> str:
        return (f"MeshExchangeExec[mesh={self.mesh_size}, "
                f"parts={self._num_parts}, "
                f"keys={[output_name(k) for k in self._keys]}]")


class MeshJoinExec(_MeshOutputMixin, JoinExec):
    """Equi-join over the mesh, replicated or partitioned (reference
    :717-964, without the region body ``_region_step``).

    * **replicated build** (GpuBroadcastHashJoinExec's analog): the build
      side is materialized once and handed to every slot (slots that
      share a card share one build: ``.to(d)`` is no copy there); the
      stream side is placed as per-slot shards and each slot probes its
      own.
    * **partitioned** (GpuShuffledHashJoinExec.scala:162's analog): both
      sides hash-exchange on the join keys over the mesh
      (:class:`MeshExchangeExec`), and each slot joins its co-partitioned
      shards.

    The pick is made at run time, from the drained build side's bytes
    against ``spark.rapids.tpu.mesh.join.buildThresholdBytes``.  The port
    counts a batch's exact bytes (the reference its padded capacity), so
    near the threshold the two packages may pick differently.  Full outer
    joins stay in-process."""

    def __init__(self, left: PlanNode, right: PlanNode, left_keys,
                 right_keys, join_type: str, mesh_size: int,
                 condition=None, build_threshold_bytes: int = 128 << 20):
        if join_type == "full":
            raise ValueError("full outer joins stay in-process")
        super().__init__(left, right, left_keys, right_keys, join_type,
                         condition)
        self.mesh_size = mesh_size
        self.axis_name = "data"
        self.build_threshold_bytes = build_threshold_bytes
        if self._swapped:
            left_keys, right_keys = right_keys, left_keys
        self._exchanges = (
            MeshExchangeExec(list(left_keys), self.children[0], mesh_size,
                             num_partitions=mesh_size),
            MeshExchangeExec(list(right_keys), self.children[1], mesh_size,
                             num_partitions=mesh_size))

    def num_partitions(self, ctx: ExecCtx) -> int:
        return self.mesh_size

    def _shard_devices(self, ctx: ExecCtx) -> list:
        devs = mesh_devices(ctx.device)
        # with fewer devices than the mesh, run on one device, as
        # mesh_for's None does for the other mesh execs
        return devs[:1] if len(devs) < self.mesh_size \
            else devs[:self.mesh_size]

    def _mesh_shards(self, ctx: ExecCtx) -> list:
        def make():
            devs = self._shard_devices(ctx)
            child = self.children[0]
            items = drain_cached(ctx, child) or [
                (None, ColumnBatch.nulls(child.output_schema, 0,
                                         ctx.device))]
            return place_shards(items, len(devs), devs, child.output_schema)
        return ctx.cached((id(self), "mesh_stream_shards"), make)

    def _stream_batches(self, ctx: ExecCtx, pid: int) -> Iterator:
        if self._use_partitioned(ctx):
            yield from self._exchanges[0].partition_iter(ctx, pid)
            return
        shards = self._mesh_shards(ctx)
        if pid < len(shards):
            yield shards[pid]

    def _use_partitioned(self, ctx: ExecCtx) -> bool:
        """Partitioned when the drained build side's bytes exceed the
        threshold (0 forces it); counted once per query."""
        def decide() -> bool:
            if self.build_threshold_bytes == 0:
                COUNTERS["mesh_join_partitioned"] += 1
                return True
            nbytes = sum(b.device_size_bytes()
                         for _s, b in drain_cached(ctx, self.children[1]))
            partitioned = nbytes > self.build_threshold_bytes
            if partitioned:
                COUNTERS["mesh_join_partitioned"] += 1
            else:
                COUNTERS["mesh_join_replicated"] += 1
                COUNTERS["mesh_join_broadcast_bytes"] += float(nbytes)
            return partitioned
        return ctx.cached((id(self), "mesh_join_partitioned"), decide)

    def _materialize(self, ctx: ExecCtx, which: int) -> ColumnBatch:
        # the drained list is shared with the size probe
        child = self.children[which]
        return concat_or_empty([b for _s, b in drain_cached(ctx, child)],
                               child.output_schema, ctx.device)

    def _device_build(self, ctx: ExecCtx, pid: int):
        if not self._use_partitioned(ctx):
            rb2, rkeys, prep = self._build(ctx)
            devs = self._shard_devices(ctx)
            d = devs[pid % len(devs)]
            return ctx.cached((id(self), "mesh_build", str(d)),
                              lambda: (rb2.to(d), rkeys, _move(prep, d)))

        def build():
            child = self.children[1]
            rb = concat_or_empty(
                list(self._exchanges[1].partition_iter(ctx, pid)),
                child.output_schema, ctx.device)
            rb2, rkeys = self._augment(rb, self._rkeys_b)
            prep = build_prepare_fast(rb2, rkeys[0]) \
                if self._use_fast_path() else None
            return rb2, rkeys, prep
        return ctx.cached((id(self), "mesh_part_build", pid), build)

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        yield from self._aligned(ctx, pid,
                                 JoinExec.partition_iter(self, ctx, pid))

    def node_desc(self) -> str:
        jt = "right" if self._swapped else self.join_type
        return f"MeshJoinExec[{jt}, mesh={self.mesh_size}]"
