"""Expressions of the port (torch evaluation, reference null semantics)."""
from spark_rapids_tpu_torch.expr.core import (Alias, BoundReference,  # noqa: F401
                                              Expression, Literal,
                                              UnresolvedAttribute, bind, col,
                                              eval_device, lit, output_name)
from spark_rapids_tpu_torch.expr.collections import (  # noqa: F401
    ArrayContains, GetArrayItem, GetMapValue, MapKeys, MapLookup, MapValues,
    Size)
