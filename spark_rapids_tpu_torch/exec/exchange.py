"""Shuffle exchange and its adaptive reader (port of
``spark_rapids_tpu/exec/exchange.py``: ``plan_fingerprint`` :143,
``ShuffleExchangeExec`` :175-352, ``AdaptiveShuffleReaderExec`` :356-482).

An exchange is a stage barrier.  On its first pull it drains every child
partition (the map side), computes each map batch's partition ids (K9,
K11 or round-robin, through the partitioning; a partitioning that
``needs_prepare`` first sees every map batch, as the reference's
``prepare`` does at :232), groups the rows by partition (K10 + K3) and
hands each partition's rows to the shuffle transport as a view of the
grouped batch; the batch's ``counts`` cross to the host once, to slice.
Reduce partitions are then served from the transport, in map-batch order.

Map-side tiny-input coalescing (reference :264-291): with
``spark.sql.adaptive.enabled`` on, when the whole map side is at or below
``advisoryPartitionSizeInBytes``, every map batch goes whole to partition
0 and neither K9 nor K10 runs.  An exchange that carries
``_no_map_coalesce`` (an explicit ``repartition``) never does this.

Sizes: ``ColumnBatch.device_size_bytes()`` counts the exact bytes of a
batch's leaves (data, validity, string lengths).  The reference counts its
power-of-two padded capacity, so near the advisory threshold the two
packages can decide a coalesce, or an adaptive reader's grouping,
differently.

The map outputs are cached in the ``ExecCtx`` under the exchange's
structural ``shuffle_id`` (:func:`plan_fingerprint`), so a subtree that a
query reaches twice materializes once, and the context releases them when
the query ends.
"""
from __future__ import annotations

import hashlib
from typing import Iterator

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.conf import (ADAPTIVE_ENABLED,
                                         ADVISORY_PARTITION_BYTES,
                                         SKEWED_PARTITION_THRESHOLD)
from spark_rapids_tpu_torch.exec.core import (ExecCtx, PlanNode,
                                              drain_partitions)
from spark_rapids_tpu_torch.exec.partitioning import Partitioning
from spark_rapids_tpu_torch.ops.partition import group_by_part, slice_part

__all__ = ["ShuffleExchangeExec", "AdaptiveShuffleReaderExec",
           "plan_fingerprint"]


def _fp_extra(n: PlanNode) -> str | None:
    """Per-class fingerprint payload for operator parameters that
    node_desc/bound_exprs do not surface.  None marks the class unknown:
    the node then contributes its object identity, so subtrees through it
    never dedup -- a missed reuse, never a wrong one."""
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.exec.basic import (FilterExec,
                                                   GlobalLimitExec,
                                                   LocalLimitExec,
                                                   ProjectExec)
    from spark_rapids_tpu_torch.exec.joins import JoinExec
    from spark_rapids_tpu_torch.exec.sortexec import (CoalesceBatchesExec,
                                                      SortExec)
    if isinstance(n, ShuffleExchangeExec):
        p = n.partitioning
        keys = getattr(p, "_keys", None) or getattr(p, "_orders_raw", ())
        return f"{type(p).__name__}:{p.num_partitions}:{keys!r}"
    if isinstance(n, AdaptiveShuffleReaderExec):
        return f"{n.allow_coalesce}:{n.allow_skew_split}"
    if isinstance(n, (LocalLimitExec, GlobalLimitExec)):
        return str(n._limit)
    if isinstance(n, CoalesceBatchesExec):
        return repr(n._goal)
    if isinstance(n, HashAggregateExec):
        # min(v) and max(v) finals are both plain references, and partial
        # buffer schemas can coincide: the specs tell them apart
        return (f"{n.mode}:{n._update_specs!r}:{n._merge_specs!r}:"
                f"{n._agg_offsets!r}")
    if isinstance(n, (ProjectExec, FilterExec, JoinExec, SortExec)):
        return ""  # desc + bound_exprs + schema carry their parameters
    return None


def plan_fingerprint(node: PlanNode) -> str:
    """Structural identity of a physical subtree: node descriptions, bound
    expressions, output schemas, per-class parameters (:func:`_fp_extra`)
    and the object identity of every leaf (two subtrees match only when
    they read the very same source execs).  Equal fingerprints mean equal
    map output -- the basis of exchange reuse (Spark's ReuseExchange)."""
    h = hashlib.sha1()

    def feed(n: PlanNode):
        h.update(type(n).__name__.encode())
        h.update(n.node_desc().encode())
        h.update(repr(n.output_schema).encode())
        for e in n.bound_exprs:
            h.update(repr(e).encode())
        extra = _fp_extra(n)
        h.update((str(id(n)) if extra is None or not n.children
                  else extra).encode())
        for c in n.children:
            feed(c)

    feed(node)
    return h.hexdigest()


class ShuffleExchangeExec(PlanNode):
    """Repartition the child's output by a Partitioning strategy."""

    def __init__(self, partitioning: Partitioning, child: PlanNode):
        super().__init__([child])
        self.partitioning = partitioning
        partitioning.bind(child.output_schema)
        self._no_map_coalesce = False
        # resolved at first execution: the coalesce pass still rewrites
        # the children while the plan is prepared
        self._shuffle_id = None

    @property
    def shuffle_id(self) -> str:
        if self._shuffle_id is None:
            self._shuffle_id = plan_fingerprint(self)
        return self._shuffle_id

    @property
    def output_schema(self) -> T.Schema:
        return self.children[0].output_schema

    def num_partitions(self, ctx: ExecCtx) -> int:
        return self.partitioning.num_partitions

    def _shuffled(self, ctx: ExecCtx):
        """The transport holding this exchange's map outputs, materialized
        once per context."""
        return ctx.cached(("shuffle", self.shuffle_id),
                          lambda: self._do_shuffle(ctx))

    def _do_shuffle(self, ctx: ExecCtx):
        from spark_rapids_tpu_torch.shuffle import make_transport
        n = self.partitioning.num_partitions
        transport = make_transport(ctx.conf, ctx)
        ctx.register_shuffle(transport, self.shuffle_id)
        batches = drain_partitions(ctx, self.children[0])
        coalesced = False
        if n > 1 and ctx.conf.get(ADAPTIVE_ENABLED) \
                and not self._no_map_coalesce:
            # the decision needs the whole map side's size first
            batches = list(batches)
            coalesced = sum(b.device_size_bytes() for b in batches) \
                <= ctx.conf.get(ADVISORY_PARTITION_BYTES)
        if self.partitioning.needs_prepare and not coalesced and n > 1:
            batches = list(batches)
            self.partitioning.prepare(batches)
        for bi, b in enumerate(batches):
            self._write_map_batch(transport, bi, b, coalesced or n == 1, n)
        return transport

    def _write_map_batch(self, transport, bi: int, b, whole: bool,
                         n: int) -> None:
        """Partition one map batch and hand its pieces to the transport
        (``whole``: the batch goes to partition 0 as it is)."""
        if b.num_rows == 0:
            return
        if whole:
            transport.write_partition(self.shuffle_id, bi, 0, b)
            return
        ids = self.partitioning.device_ids(b, bi)
        grouped, counts, _starts = group_by_part(b, ids, n)
        start = 0
        for p, c in enumerate(counts.tolist()):  # the batch's one sync
            if c:
                transport.write_partition(self.shuffle_id, bi, p,
                                          slice_part(grouped, start, c))
            start += c

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        yield from self.partition_iter_slice(ctx, pid, 0, None)

    def partition_iter_slice(self, ctx: ExecCtx, pid: int, lo: int,
                             hi: int | None) -> Iterator:
        """One reduce partition's batches, restricted to the map-batch
        slice [lo, hi) (an adaptive skew-split group reads its own)."""
        yield from self._shuffled(ctx).fetch_partition(self.shuffle_id, pid,
                                                       lo, hi)

    def node_desc(self) -> str:
        return (f"ShuffleExchangeExec[{type(self.partitioning).__name__}"
                f"({self.partitioning.num_partitions})]")


class AdaptiveShuffleReaderExec(PlanNode):
    """Adaptive shuffle reader: plans the reduce side from the actual
    map-output sizes (reference GpuCustomShuffleReaderExec.scala:131 and
    Spark 3.0's skew reader).

    * adjacent partitions smaller than advisoryPartitionSizeInBytes
      coalesce into one reader group;
    * a partition larger than skewedPartitionThresholdInBytes splits into
      several groups at map-batch granularity, each near the advisory
      size -- only where ``allow_skew_split`` (join sides: per-row
      semantics; between a partial and a final aggregate a split would
      emit a key twice).

    ``allow_coalesce=False`` makes the reader split-only: a user's
    partition count is never reduced (Spark's REPARTITION_BY_NUM).  Each
    group is a list of ``(child_pid, lo, hi)`` map-batch slices."""

    def __init__(self, child: ShuffleExchangeExec,
                 allow_skew_split: bool = False,
                 allow_coalesce: bool = True):
        super().__init__([child])
        if not isinstance(child, ShuffleExchangeExec):
            raise TypeError("an adaptive reader reads a ShuffleExchangeExec")
        self.allow_skew_split = allow_skew_split
        self.allow_coalesce = allow_coalesce
        if not allow_coalesce:
            # the map side must then keep all n partitions non-degenerate
            child._no_map_coalesce = True

    @property
    def output_schema(self) -> T.Schema:
        return self.children[0].output_schema

    def _groups(self, ctx: ExecCtx) -> list[list[tuple]]:
        return ctx.cached(("aqe_groups", id(self)),
                          lambda: self._compute_groups(ctx))

    def _compute_groups(self, ctx: ExecCtx) -> list[list[tuple]]:
        child = self.children[0]
        n = child.num_partitions(ctx)
        shuffled = child._shuffled(ctx)  # stage barrier: the maps run here
        target = ctx.conf.get(ADVISORY_PARTITION_BYTES)
        skew_at = ctx.conf.get(SKEWED_PARTITION_THRESHOLD)
        sizes = shuffled.partition_sizes(child.shuffle_id)
        if not sizes:
            return [[(pid, 0, None)] for pid in range(n)]
        groups: list[list[tuple]] = []
        cur: list[tuple] = []
        cur_bytes = 0

        def flush():
            nonlocal cur, cur_bytes
            if cur:
                groups.append(cur)
            cur, cur_bytes = [], 0

        for pid in range(n):
            sz = sizes.get(pid, 0)
            per_batch = shuffled.batch_sizes(child.shuffle_id, pid) \
                if self.allow_skew_split and sz > skew_at else None
            if per_batch and len(per_batch) > 1:
                flush()
                lo, acc = 0, 0
                for i, bsz in enumerate(per_batch):
                    if acc > 0 and acc + bsz > target:
                        groups.append([(pid, lo, i)])
                        lo, acc = i, 0
                    acc += bsz
                groups.append([(pid, lo, None)])
                continue
            if not self.allow_coalesce:
                groups.append([(pid, 0, None)])
                continue
            if cur and cur_bytes + sz > target:
                flush()
            cur.append((pid, 0, None))
            cur_bytes += sz
        flush()
        return groups

    def num_partitions(self, ctx: ExecCtx) -> int:
        if ctx.planning:
            # grouping is decided after the map side runs; the planner
            # sees the exchange's count
            return self.children[0].num_partitions(ctx)
        return len(self._groups(ctx))

    def partition_iter(self, ctx: ExecCtx, pid: int) -> Iterator:
        for child_pid, lo, hi in self._groups(ctx)[pid]:
            yield from self.children[0].partition_iter_slice(
                ctx, child_pid, lo, hi)

    def node_desc(self) -> str:
        return "AdaptiveShuffleReaderExec" + (
            "[skew-split]" if self.allow_skew_split else "")
