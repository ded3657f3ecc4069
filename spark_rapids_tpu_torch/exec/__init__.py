"""Physical operators of the port."""
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec  # noqa: F401
from spark_rapids_tpu_torch.exec.basic import (FilterExec,  # noqa: F401
                                               GlobalLimitExec,
                                               LocalLimitExec, ProjectExec,
                                               UnionExec)
from spark_rapids_tpu_torch.exec.core import (ExecCtx, PlanNode,  # noqa: F401
                                              collect_device)
from spark_rapids_tpu_torch.exec.exchange import (  # noqa: F401
    AdaptiveShuffleReaderExec, ShuffleExchangeExec)
from spark_rapids_tpu_torch.exec.generate import (Explode,  # noqa: F401
                                                  GenerateExec, SplitExplode)
from spark_rapids_tpu_torch.exec.joins import CrossJoinExec, JoinExec  # noqa: F401
from spark_rapids_tpu_torch.exec.partitioning import (  # noqa: F401
    HashPartitioning, RangePartitioning, RoundRobinPartitioning,
    SinglePartitioning)
from spark_rapids_tpu_torch.exec.sortexec import (CoalesceBatchesExec,  # noqa: F401
                                                  SortExec, resolve_orders)
from spark_rapids_tpu_torch.exec.window import WindowExec  # noqa: F401
