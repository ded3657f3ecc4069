"""The mesh-distributed sort (port of ``spark_rapids_tpu/exec/mesh_region.py``
:70-240, ``MeshSortExec``).

A global sort (or TopN) as a broadcast sort: every slot's rows are
gathered to every device (K15b, ``exec/mesh_exec.py``
:func:`all_gather_batch`), the gathered rows are sorted once (K1) and slot
i keeps its contiguous slice of the total order (K3): rows
``[i * base + min(i, rem), ...)``, so partition order is global order.
With ``limit=n`` slot 0 keeps the first n rows and every other slot is
empty; the ``GlobalLimitExec`` the planner keeps above passes them
through.  Slots on one card share the gathered batch and its sort (the
bytes are the same); each keeps its own slice.

Not ported: ``MeshWindowExec`` and ``MeshRegionExec`` (ROADMAP.md Queue 1
item 10).  The planner raises for a window the reference would run on the
mesh, and plans islands whatever ``spark.rapids.tpu.mesh.regions.enabled``
says (``plan/overrides.py``).
"""
from __future__ import annotations

from typing import Iterator, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.exec.core import ExecCtx, PlanNode
from spark_rapids_tpu_torch.exec.mesh_exec import (_check_slice_fault,
                                                   _drain_placed,
                                                   _MeshOutputMixin,
                                                   _note_a2a_bytes,
                                                   _reraise_unless_slice_lost,
                                                   all_gather_batch,
                                                   mesh_for, place_shards)
from spark_rapids_tpu_torch.exec.sortexec import SortExec, resolve_orders
from spark_rapids_tpu_torch.ops import kernels as dk
from spark_rapids_tpu_torch.ops.sort import sort_permutation

__all__ = ["MeshSortExec"]


class MeshSortExec(_MeshOutputMixin, PlanNode):
    """Global sort / TopN over the mesh as one broadcast sort.  With fewer
    devices than ``mesh_size`` or an empty input, the in-process global
    :class:`SortExec` runs (the reference's own single-device path)."""

    def __init__(self, orders: Sequence, child: PlanNode, mesh_size: int,
                 limit: int | None = None, axis_name: str = "data"):
        super().__init__([child])
        self._orders = resolve_orders(orders, child.output_schema)
        self.mesh_size = mesh_size
        self.limit = limit
        self.axis_name = axis_name

    @property
    def output_schema(self) -> T.Schema:
        return self.children[0].output_schema

    @property
    def output_ordering(self):
        return [self.output_schema.names[o.child_index]
                for o in self._orders]

    def num_partitions(self, ctx: ExecCtx) -> int:
        return self.mesh_size

    def _single_exec(self) -> SortExec:
        return SortExec(list(self._orders), self.children[0],
                        global_sort=True)

    def _slices(self, total: int) -> list[tuple[int, int]]:
        """(start, count) of each slot's rows of the total order."""
        p = self.mesh_size
        if self.limit is not None:
            return [(0, min(self.limit, total))] + [(0, 0)] * (p - 1)
        base, rem = divmod(total, p)
        return [(i * base + min(i, rem), base + (i < rem))
                for i in range(p)]

    def _run(self, mesh, shards) -> list[list[ColumnBatch]]:
        gathered = all_gather_batch(shards, mesh)
        perms = {dev: sort_permutation(gb, self._orders)
                 for dev, gb in gathered.items()}
        out = []
        for (start, cnt), dev in zip(self._slices(
                sum(b.num_rows for b in shards)), mesh.devices):
            gb = gathered[dev]
            if cnt == 0:
                out.append([dk.slice_rows(gb, 0, 0)])
                continue
            out.append([dk.take(gb, perms[dev][start:start + cnt])])
        return out

    def _outputs(self, ctx: ExecCtx):
        return ctx.cached(("meshsort", id(self)),
                          lambda: self._compute_outputs(ctx))

    def _fallback_outputs(self, ctx: ExecCtx):
        out = [list(self._single_exec().partition_iter(ctx, 0))]
        return out + [[] for _ in range(self.mesh_size - 1)]

    def _compute_outputs(self, ctx: ExecCtx):
        items = _drain_placed(ctx, self.children[0])
        mesh = mesh_for(ctx, self.mesh_size, self.axis_name)
        if mesh is not None and items:
            try:
                _check_slice_fault(ctx, "meshsort", mesh)
                shards = place_shards(items, mesh.size, mesh.devices,
                                      self.output_schema)
                _note_a2a_bytes(shards)
                return self._run(mesh, shards)
            except Exception as err:  # noqa: BLE001 - re-raised but a lost slice
                _reraise_unless_slice_lost(err)
        return self._fallback_outputs(ctx)

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        yield from self._aligned(ctx, pid, iter(self._outputs(ctx)[pid]))

    def node_desc(self) -> str:
        lim = f", limit={self.limit}" if self.limit is not None else ""
        return f"MeshSortExec[mesh={self.mesh_size}, {self._orders}{lim}]"
