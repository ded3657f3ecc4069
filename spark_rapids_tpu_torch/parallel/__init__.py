"""Distributed execution over a mesh of devices (port of
``spark_rapids_tpu/parallel``).

The reference's mesh is single-controller: one process drives P devices
with ``shard_map`` and its exchanges are XLA collectives.  The port's is
single-controller too: a :class:`~spark_rapids_tpu_torch.parallel.mesh.Mesh`
is an ordered list of torch devices, one Python loop over the shards
launches each shard's kernels, and the collective hands each (source,
destination) section to its destination with ``Tensor.to``
(``parallel/mesh_shuffle.py``).
"""
from spark_rapids_tpu_torch.parallel.mesh import (COUNTERS, Mesh,  # noqa: F401
                                                  make_mesh, mesh_devices)
from spark_rapids_tpu_torch.parallel.mesh_shuffle import (  # noqa: F401
    MERGE_OPS, make_distributed_groupby, make_hash_exchange,
    partition_ids_for_keys)

__all__ = ["Mesh", "make_mesh", "mesh_devices", "COUNTERS",
           "partition_ids_for_keys", "make_hash_exchange",
           "make_distributed_groupby", "MERGE_OPS"]
