"""Physical plan node base and execution context.

Port of ``spark_rapids_tpu/exec/core.py``: an operator produces, per
partition, an iterator of device batches.  The port keeps the batching
contracts (``CoalesceGoal``) and the plan introspection, and calls device
functions directly where the reference went through ``ctx.dispatch``.  The
spill catalog, the retry scopes, the concurrent partition drain and the
per-operator metrics wait for later slices (ROADMAP.md Queue 1 items 6 and 9).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.conf import TorchConf

__all__ = ["ExecCtx", "PlanNode", "CoalesceGoal", "TargetSize",
           "RequireSingleBatch", "RequireSingleBatchT", "collect_device",
           "drain_partitions"]


class CoalesceGoal:
    def max_with(self, other: "CoalesceGoal") -> "CoalesceGoal":
        if isinstance(self, RequireSingleBatchT) or \
                isinstance(other, RequireSingleBatchT):
            return RequireSingleBatch
        return self if self.size >= other.size else other

    def satisfies(self, other: "CoalesceGoal") -> bool:
        if isinstance(other, RequireSingleBatchT):
            return isinstance(self, RequireSingleBatchT)
        return True


@dataclass(frozen=True)
class TargetSize(CoalesceGoal):
    size: int


class RequireSingleBatchT(CoalesceGoal):
    def __repr__(self):
        return "RequireSingleBatch"


RequireSingleBatch = RequireSingleBatchT()


@dataclass
class ExecCtx:
    """Execution context: the device the plan runs on, the conf, and a
    per-query cache (a join's prepared build side and an exchange's map
    outputs live there).  ``planning`` marks a context the planner uses to
    ask for partition counts: nothing may execute under it.  ``close()``
    releases every shuffle the query wrote and drops the cache."""
    device: torch.device
    conf: TorchConf = field(default_factory=TorchConf)
    planning: bool = False
    _cache: dict = field(default_factory=dict, repr=False)
    _shuffles: list = field(default_factory=list, repr=False)

    def cached(self, key, build):
        """``build()``'s value, computed once per context."""
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def register_shuffle(self, transport, shuffle_id) -> None:
        """Release ``shuffle_id``'s map outputs at :meth:`close`."""
        self._shuffles.append((transport, shuffle_id))

    def close(self) -> None:
        for transport, shuffle_id in self._shuffles:
            transport.release_shuffle(shuffle_id)
        self._shuffles.clear()
        self._cache.clear()


class PlanNode:
    """Base physical operator: ``partition_iter`` yields the device batches
    of one partition; ``output_schema`` is the operator's output schema."""

    #: True when the operator puts several input batches together (a
    #: concat, a merge, a build side): the planner then hands it mesh
    #: outputs on the session's device (``plan/overrides.py``
    #: ``_align_mesh_outputs``).  Per-batch operators (project, filter,
    #: the global limit) say False and keep their input's placement.
    combines_batches: bool = True

    def __init__(self, children):
        self.children = tuple(children)

    @property
    def output_schema(self) -> T.Schema:
        raise NotImplementedError

    def num_partitions(self, ctx: ExecCtx) -> int:
        if self.children:
            return self.children[0].num_partitions(ctx)
        return 1

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        raise NotImplementedError

    @property
    def output_ordering(self) -> list | None:
        """Column names such that rows equal on any prefix of them are
        contiguous within each emitted batch (None: no guarantee)."""
        return None

    @property
    def bound_exprs(self) -> list:
        """The operator's bound expressions (its plan fingerprint reads
        them, exec/exchange.py)."""
        return []

    @property
    def children_coalesce_goal(self) -> list:
        return [None] * len(self.children)

    @property
    def output_batching(self):
        return None

    def execute(self, ctx: ExecCtx) -> Iterator:
        """All partitions' batches, in partition order."""
        yield from drain_partitions(ctx, self)

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + self.node_desc() + "\n"
        for c in self.children:
            s += c.tree_string(indent + 1)
        return s

    def node_desc(self) -> str:
        return type(self).__name__


def drain_partitions(ctx: ExecCtx, node: PlanNode) -> Iterator:
    """Every partition's batches in partition order (sequentially: the
    reference's worker-pool drain needs the device semaphore and the
    spill catalog, ROADMAP.md Queue 1 item 6)."""
    for pid in range(node.num_partitions(ctx)):
        yield from node.partition_iter(ctx, pid)


def collect_device(plan: PlanNode, ctx: ExecCtx) -> list[tuple]:
    """Run the plan on ``ctx.device``; rows as python tuples (one copy to
    the host per output batch, at the end).  The context is closed at the
    end, so no map output outlives the query."""
    out: list[tuple] = []
    try:
        for b in plan.execute(ctx):
            out.extend(b.to_rows())
    finally:
        ctx.close()
    return out
