"""Session and DataFrame API (port of ``spark_rapids_tpu/session.py:27, 586, 925``).

``TorchSession(conf)`` runs on the CUDA card and raises when there is none;
``TorchSession(conf, device="cpu")`` runs the kernels' plain PyTorch
versions on the CPU (the tests do this).  The DataFrame methods are the
ones the port's TPC-H, TPC-DS and mortgage query functions use --
``read_parquet``, ``read_csv``, ``from_pydict``, ``select``, ``where``, ``with_column``,
``join``, ``union``, ``group_by().agg()``, ``agg``, ``order_by``,
``limit``, ``collect``, ``explain`` -- and ``repartition``, ``explode``
and ``explode_split``; ``select`` takes window
expressions (``expr/window.py``), which the planner lowers to
``WindowExec``s.  Admission,
cancellation, the result cache and the serving planes wait for later
slices.
"""
from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.device import device_budget, resolve_device
from spark_rapids_tpu_torch.exec.core import ExecCtx, collect_device
from spark_rapids_tpu_torch.expr.core import col
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.overrides import (PlannedNode,
                                                   TorchOverrides, lower)

__all__ = ["TorchSession", "DataFrame", "GroupedData"]


class TorchSession:
    """Session: conf + device + data sources."""

    def __init__(self, conf: dict | TorchConf | None = None, device=None):
        self.conf = conf if isinstance(conf, TorchConf) \
            else TorchConf(conf or {})
        self.device = resolve_device(device)

    def device_budget(self) -> int:
        """Bytes of card memory the engine may hold (allocFraction and
        reserve of the conf); raises on the CPU."""
        return device_budget(self.device, self.conf)

    def read_parquet(self, path, columns=None) -> "DataFrame":
        from spark_rapids_tpu_torch.io import ParquetScanExec
        return DataFrame(self, L.Scan(ParquetScanExec(path, columns=columns)))

    def read_csv(self, path, schema: T.Schema | None = None,
                 **kw) -> "DataFrame":
        """CSV files with ``schema`` (``header``, ``delimiter`` and
        ``columns`` as :class:`~spark_rapids_tpu_torch.io.CsvScanExec`
        takes them)."""
        from spark_rapids_tpu_torch.io import CsvScanExec
        return DataFrame(self, L.Scan(CsvScanExec(path, schema=schema, **kw)))

    def from_pydict(self, data: dict, schema: T.Schema, partitions: int = 1,
                    rows_per_batch: int | None = None) -> "DataFrame":
        """An in-memory table (reference session.py:553): ``data``'s
        columns in ``schema``, cut into batches of ``rows_per_batch`` rows
        dealt round-robin to ``partitions`` partitions, staged through
        Arrow as a scan batch is."""
        from spark_rapids_tpu_torch.exec.basic import LocalScanExec
        return DataFrame(self, L.Scan(LocalScanExec.from_pydict(
            data, schema, partitions, rows_per_batch)))


class DataFrame:
    def __init__(self, session: TorchSession, plan: L.LogicalPlan):
        self._s = session
        self._plan = plan

    @property
    def schema(self) -> T.Schema:
        return self._planned().exec_node.output_schema

    # -- transformations ----------------------------------------------
    def select(self, *exprs) -> "DataFrame":
        return DataFrame(self._s, L.Project([self._col_or_expr(e)
                                             for e in exprs], self._plan))

    def where(self, condition) -> "DataFrame":
        return DataFrame(self._s, L.Filter(condition, self._plan))

    def with_column(self, name: str, expr) -> "DataFrame":
        """The columns plus ``expr`` as ``name``; a column of that name
        is replaced in its position (Spark's withColumn)."""
        names = self.schema.names
        if name in names:
            return self.select(*[expr.alias(name) if n == name else col(n)
                                 for n in names])
        return self.select(*[col(n) for n in names], expr.alias(name))

    def group_by(self, *keys) -> "GroupedData":
        return GroupedData(self, [self._col_or_expr(k) for k in keys])

    def agg(self, *aggs) -> "DataFrame":
        """Aggregate over all rows (one output row)."""
        return GroupedData(self, []).agg(*aggs)

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             condition=None) -> "DataFrame":
        """Equi-join on ``on``: a column name, or a list of names and
        (left, right) pairs of names or expressions.  No keys (or
        ``how="cross"``) is a cross join."""
        left_on, right_on = [], []
        if on is not None:
            for o in [on] if isinstance(on, str) else on:
                if isinstance(o, str):
                    left_on.append(col(o))
                    right_on.append(col(o))
                else:
                    lk, rk = o
                    left_on.append(self._col_or_expr(lk))
                    right_on.append(self._col_or_expr(rk))
        if how == "cross" or not left_on:
            return DataFrame(self._s, L.Join(self._plan, other._plan,
                                             "cross", [], [], condition))
        return DataFrame(self._s, L.Join(self._plan, other._plan, how,
                                         left_on, right_on, condition))

    def union(self, other: "DataFrame") -> "DataFrame":
        """The rows of both frames (UNION ALL), matched by position; the
        column types must agree."""
        return DataFrame(self._s, L.Union([self._plan, other._plan]))

    def order_by(self, *orders) -> "DataFrame":
        return DataFrame(self._s, L.Sort(list(orders), self._plan))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._s, L.Limit(n, self._plan))

    def repartition(self, num_partitions: int, *keys) -> "DataFrame":
        """Hash-repartition on ``keys`` into ``num_partitions``, or
        round-robin without keys (a shuffle exchange the adaptive layer
        never coalesces)."""
        return DataFrame(self._s, L.Repartition(
            num_partitions, [self._col_or_expr(k) for k in keys],
            self._plan))

    def explode(self, expr, output_name: str = "col", pos: bool = False,
                outer: bool = False) -> "DataFrame":
        """explode(array column): one output row per element, the child
        columns repeated; ``pos`` adds the element's index before it,
        ``outer`` keeps a null or empty array as one row of nulls."""
        from spark_rapids_tpu_torch.exec.generate import Explode
        gen = Explode(self._col_or_expr(expr))
        names = ["pos", output_name] if pos else [output_name]
        return DataFrame(self._s, L.Generate(gen, self._plan, outer=outer,
                                             pos=pos, output_names=names))

    def explode_split(self, expr, delimiter: str, output_name: str = "col",
                      pos: bool = False, outer: bool = False) -> "DataFrame":
        """explode(split(expr, delimiter)) for a one-byte delimiter: one
        output row per piece, the child columns repeated; ``pos`` adds the
        piece's index, ``outer`` keeps a null string as one row of
        nulls."""
        from spark_rapids_tpu_torch.exec.generate import SplitExplode
        gen = SplitExplode(self._col_or_expr(expr), delimiter)
        names = ["pos", output_name] if pos else [output_name]
        return DataFrame(self._s, L.Generate(gen, self._plan, outer=outer,
                                             pos=pos, output_names=names))

    # -- actions --------------------------------------------------------
    def collect(self) -> list[tuple]:
        """Run the query on the session's device; every row as a tuple."""
        root = self._prepared(quiet=False)
        return collect_device(root, self._ctx())

    def explain(self) -> str:
        meta = self._planned()
        ov = TorchOverrides(self._s.conf)
        ov.prepare(meta)
        return ov.explain(meta)

    # -- internals ------------------------------------------------------
    def _ctx(self) -> ExecCtx:
        return ExecCtx(device=self._s.device, conf=self._s.conf)

    def _col_or_expr(self, e):
        return col(e) if isinstance(e, str) else e

    def _planned(self) -> PlannedNode:
        return lower(self._plan, self._s.conf)

    def _prepared(self, quiet: bool = True):
        return TorchOverrides(self._s.conf).prepare(self._planned(),
                                                    explain=not quiet)


class GroupedData:
    def __init__(self, df: DataFrame, keys: list):
        self._df = df
        self._keys = keys

    def agg(self, *aggs) -> DataFrame:
        exprs = list(self._keys) + list(aggs)
        return DataFrame(self._df._s, L.Aggregate(list(self._keys), exprs,
                                                  self._df._plan))
