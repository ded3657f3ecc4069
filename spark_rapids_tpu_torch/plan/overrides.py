"""Lowering and planning passes (port of ``spark_rapids_tpu/plan/overrides.py``).

``lower`` (:62) turns the logical plan into physical execs (joins as in
:75-110 without the AQE shuffled-join exchange, which is off by default,
or the mesh; a limit over a sort as :117-137 without the mesh TopN; an
explicit repartition as :178-195; a window as :141-155; a union as
:138-140; a generate as :163-168).  ``_lower_project``
(:479) plans the window expressions of a projection: one ``WindowExec``
per distinct spec, each over a hash exchange on its partition keys where
the child is not already distributed on them (:435), then the final
projection.  ``_lower_aggregate`` (:530) splits a
grouped aggregation over a multi-partition child into partial and final
stages around a hash exchange, read through the adaptive reader when
``spark.sql.adaptive.enabled`` is on (:538-565), and plans a complete
aggregation otherwise.  :class:`TorchOverrides` inserts
``CoalesceBatchesExec`` where an operator's child goal demands it and
renders the explain tree.  Every operator of this slice runs on the
device, so there is no tagging or host fallback (``*`` marks each node).
The mesh and pandas window execs (``MeshWindowExec``,
``WindowInPandasExec``) are not ported: a window always plans a
``WindowExec``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from spark_rapids_tpu_torch.conf import ADAPTIVE_ENABLED, TorchConf
from spark_rapids_tpu_torch.exec import (CoalesceBatchesExec,
                                         CrossJoinExec, FilterExec,
                                         GlobalLimitExec, HashAggregateExec,
                                         JoinExec, ProjectExec, SortExec,
                                         UnionExec, WindowExec)
from spark_rapids_tpu_torch.exec.core import ExecCtx, PlanNode, TargetSize
from spark_rapids_tpu_torch.exec.exchange import (AdaptiveShuffleReaderExec,
                                                  ShuffleExchangeExec)
from spark_rapids_tpu_torch.exec.generate import GenerateExec
from spark_rapids_tpu_torch.exec.partitioning import (HashPartitioning,
                                                      RoundRobinPartitioning)
from spark_rapids_tpu_torch.expr.core import (Alias, UnresolvedAttribute,
                                              col, output_name)
from spark_rapids_tpu_torch.expr.window import WindowExpression
from spark_rapids_tpu_torch.plan import logical as L

__all__ = ["PlannedNode", "lower", "TorchOverrides"]


@dataclass
class PlannedNode:
    """Physical exec + its planned children (the meta tree mirrors the
    exec tree while passes rewrite it)."""
    exec_node: PlanNode
    children: list = field(default_factory=list)

    @property
    def name(self) -> str:
        return type(self.exec_node).__name__


def lower(node: L.LogicalPlan, conf: TorchConf) -> PlannedNode:
    if isinstance(node, L.Scan):
        return PlannedNode(node.exec_node)
    if isinstance(node, L.Filter):
        c = lower(node.child, conf)
        return PlannedNode(FilterExec(node.condition, c.exec_node), [c])
    if isinstance(node, L.Project):
        return _lower_project(node, conf)
    if isinstance(node, L.Aggregate):
        return _lower_aggregate(node, conf)
    if isinstance(node, L.Join):
        lc, rc = (_aqe_join_reader(lower(c, conf), conf)
                  for c in (node.left, node.right))
        if node.how == "cross":
            ex = CrossJoinExec(lc.exec_node, rc.exec_node, node.condition)
        else:
            ex = JoinExec(lc.exec_node, rc.exec_node, node.left_on,
                          node.right_on, node.how, node.condition)
        # meta children mirror exec children: a right join runs swapped,
        # and the coalesce pass reassigns exec children from meta order
        metas = [rc, lc] if ex._swapped else [lc, rc]
        return PlannedNode(ex, metas)
    if isinstance(node, L.Sort):
        c = lower(node.child, conf)
        return PlannedNode(SortExec(node.orders, c.exec_node,
                                    global_sort=True), [c])
    if isinstance(node, L.Limit):
        c = lower(node.child, conf)
        return PlannedNode(GlobalLimitExec(node.n, c.exec_node), [c])
    if isinstance(node, L.Repartition):
        c = lower(node.child, conf)
        part = HashPartitioning(node.keys, node.num_partitions) \
            if node.keys else RoundRobinPartitioning(node.num_partitions)
        ex = ShuffleExchangeExec(part, c.exec_node)
        # an explicit repartition(n) keeps its n partitions: the map side
        # never coalesces it (Spark's REPARTITION_BY_NUM contract)
        ex._no_map_coalesce = True
        return PlannedNode(ex, [c])
    if isinstance(node, L.Union):
        cs = [lower(i, conf) for i in node.inputs]
        return PlannedNode(UnionExec([c.exec_node for c in cs]), cs)
    if isinstance(node, L.Generate):
        c = lower(node.child, conf)
        return PlannedNode(GenerateExec(node.generator, c.exec_node,
                                        outer=node.outer, pos=node.pos,
                                        output_names=node.output_names), [c])
    if isinstance(node, L.Window):
        c = lower(node.child, conf)
        # partition on the first expression's spec; WindowExec itself
        # checks that every expression shares it
        first = node.window_exprs[0]
        inner = first.children[0] if isinstance(first, Alias) else first
        cur, keys_partitioned = _ensure_window_distribution(c, inner.spec,
                                                            conf)
        return _stack_window_execs(cur, node.window_exprs, keys_partitioned)
    raise NotImplementedError(
        f"{type(node).__name__} is not ported yet (ROADMAP.md Queue 1)")


def _aqe_join_reader(c: PlannedNode, conf: TorchConf) -> PlannedNode:
    """A join side that is an explicit repartition reads its exchange
    through a split-only adaptive reader (reference :305-327): a skewed
    partition may fan out, the user's partition count is never reduced."""
    if not conf.get(ADAPTIVE_ENABLED) or \
            not isinstance(c.exec_node, ShuffleExchangeExec):
        return c
    reader = AdaptiveShuffleReaderExec(c.exec_node, allow_skew_split=True,
                                       allow_coalesce=False)
    return PlannedNode(reader, [c])


def _split_window_exprs(exprs):
    """Separate the window expressions of a projection list, at any depth:
    a nested one (``x * 100 / sum(x).over(spec)``) is hoisted into a
    generated column and replaced by a reference to it."""
    plain, windows = [], []
    counter = [0]

    def hoist(node):
        if isinstance(node, WindowExpression):
            name = f"_we{counter[0]}"
            counter[0] += 1
            windows.append(node.alias(name))
            return col(name)
        return node

    for e in exprs:
        inner = e.children[0] if isinstance(e, Alias) else e
        if isinstance(inner, WindowExpression):
            # a generated name, re-aliased: naming the appended column after
            # an existing child column would shadow it at bind time
            name = f"_we{counter[0]}"
            counter[0] += 1
            windows.append(inner.alias(name))
            plain.append(col(name).alias(output_name(e)))
        else:
            plain.append(e.transform_up(hoist))
    return plain, windows


def _window_key_names(keys) -> tuple | None:
    """Column names of a key list, or None when a key is not a plain
    column reference (then an exchange is inserted conservatively)."""
    names = []
    for k in keys:
        if isinstance(k, Alias):
            k = k.children[0]
        if not isinstance(k, UnresolvedAttribute):
            return None
        names.append(k.name)
    return tuple(names)


def _ensure_window_distribution(cur: PlannedNode, spec,
                                conf: TorchConf) -> tuple[PlannedNode, bool]:
    """Hash-partition on the window's partition keys so the window runs per
    partition instead of over one global batch (Spark's EnsureRequirements
    for ClusteredDistribution).  No exchange when the child has one
    partition, or is already hash-partitioned on a subset of the keys
    (rows equal on the keys are then co-located)."""
    if not spec.partition_by:
        return cur, False
    if cur.exec_node.num_partitions(
            ExecCtx(device="cpu", conf=conf, planning=True)) <= 1:
        return cur, False
    want = _window_key_names(spec.partition_by)
    if want is not None:
        node = cur.exec_node
        # window output keeps its child's distribution: look through the
        # WindowExecs stacked by earlier specs of the same projection
        while isinstance(node, WindowExec) and node._keys_partitioned:
            node = node.children[0]
        if isinstance(node, ShuffleExchangeExec) and \
                isinstance(node.partitioning, HashPartitioning):
            have = _window_key_names(node.partitioning._keys)
            if have and set(have) <= set(want):
                return cur, True
    exch = ShuffleExchangeExec(
        HashPartitioning(list(spec.partition_by), conf.shuffle_partitions),
        cur.exec_node)
    return PlannedNode(exch, [cur]), True


def _stack_window_execs(cur: PlannedNode, spec_windows,
                        keys_partitioned: bool) -> PlannedNode:
    """One spec's window expressions as a WindowExec over ``cur`` (the
    reference's native branch; pandas window UDFs are not ported)."""
    ex = WindowExec(spec_windows, cur.exec_node,
                    keys_partitioned=keys_partitioned)
    return PlannedNode(ex, [cur])


def _lower_project(node: L.Project, conf: TorchConf) -> PlannedNode:
    c = lower(node.child, conf)
    plain, windows = _split_window_exprs(node.exprs)
    if not windows:
        return PlannedNode(ProjectExec(node.exprs, c.exec_node), [c])
    # one WindowExec per distinct spec (specs hash by their expressions'
    # identities), then the final projection over the appended columns
    by_spec: dict = {}
    for w in windows:
        by_spec.setdefault(w.children[0].spec, []).append(w)
    cur = c
    for spec, spec_windows in by_spec.items():
        cur, keys_partitioned = _ensure_window_distribution(cur, spec, conf)
        cur = _stack_window_execs(cur, spec_windows, keys_partitioned)
    return PlannedNode(ProjectExec(plain, cur.exec_node), [cur])


def _lower_aggregate(node: L.Aggregate, conf: TorchConf) -> PlannedNode:
    c = lower(node.child, conf)
    # holistic aggregates (percentile) have no mergeable intermediate:
    # they keep the whole-input complete aggregation
    holistic = any(getattr(sub, "requires_complete", False)
                   for e in node.agg_exprs for sub in e.walk())
    nparts = c.exec_node.num_partitions(
        ExecCtx(device="cpu", conf=conf, planning=True))
    if node.group_exprs and nparts > 1 and not holistic:
        partial = HashAggregateExec(node.group_exprs, node.agg_exprs,
                                    c.exec_node, mode="partial")
        pmeta = PlannedNode(partial, [c])
        group_cols = [col(n) for n in partial._group_names]
        shuffle = ShuffleExchangeExec(
            HashPartitioning(group_cols, conf.shuffle_partitions), partial)
        smeta = PlannedNode(shuffle, [pmeta])
        agg_child = shuffle
        if conf.get(ADAPTIVE_ENABLED):
            agg_child = AdaptiveShuffleReaderExec(shuffle)
            smeta = PlannedNode(agg_child, [smeta])
        final = HashAggregateExec.final_from_partial(partial, agg_child)
        return PlannedNode(final, [smeta])
    ex = HashAggregateExec(node.group_exprs, node.agg_exprs, c.exec_node,
                           mode="complete")
    return PlannedNode(ex, [c])


class TorchOverrides:
    """Planning passes over a lowered tree."""

    def __init__(self, conf: TorchConf):
        self.conf = conf

    def prepare(self, root: PlannedNode, explain: bool = False) -> PlanNode:
        self._insert_coalesce(root)
        mode = self.conf.explain
        if explain and mode == "ALL":
            print(self.explain(root))
        return root.exec_node

    def _insert_coalesce(self, meta: PlannedNode) -> None:
        """Insert CoalesceBatchesExec where children_coalesce_goal asks for
        batching the child does not already satisfy; ``TargetSize(0)``
        resolves to spark.rapids.sql.batchSizeBytes."""
        for ch in meta.children:
            self._insert_coalesce(ch)
        goals = meta.exec_node.children_coalesce_goal
        if not any(g is not None for g in goals):
            return
        new_children, new_metas = [], []
        for ch, goal in zip(meta.children, goals):
            have = ch.exec_node.output_batching
            if goal is None or (have is not None and have.satisfies(goal)):
                new_children.append(ch.exec_node)
                new_metas.append(ch)
                continue
            if isinstance(goal, TargetSize) and goal.size <= 0:
                goal = TargetSize(self.conf.batch_size_bytes)
            co = CoalesceBatchesExec(goal, ch.exec_node)
            new_children.append(co)
            new_metas.append(PlannedNode(co, [ch]))
        meta.exec_node.children = tuple(new_children)
        meta.children = new_metas

    def explain(self, meta: PlannedNode, indent: int = 0) -> str:
        lines = ["  " * indent + f"* {meta.exec_node.node_desc()}"]
        for ch in meta.children:
            lines.append(self.explain(ch, indent + 1))
        return "\n".join(lines)
