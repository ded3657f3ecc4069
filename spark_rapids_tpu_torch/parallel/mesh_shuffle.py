"""All-to-all hash exchange and distributed aggregation over a mesh
(port of ``spark_rapids_tpu/parallel/mesh_shuffle.py``).

The reference runs each step inside ``shard_map``: partition ids (K9),
``_bucketize`` into ``[P, C]`` send buffers, ``lax.all_to_all``, then
``_repack``.  The port's mesh is single-controller as the reference's is,
but eager: :func:`exchange_local_checked` takes every shard at once and

1. orders each shard's rows stably by destination (K10,
   ``ops/partition.py`` :func:`partition_order`; not recounted later);
2. reads the P x P count matrix ONCE, with one ``.cpu()`` of the stacked
   counts: it sizes every send section and every output exactly;
3. packs each shard into one send buffer of P sections (K15a,
   ``ops/mesh_exchange.py`` :func:`mesh_pack`);
4. hands section (s, d) to destination d with ``Tensor.to(dst,
   non_blocking=True)`` -- no copy when both slots are on one card, a peer
   copy across cards (the reference's ``lax.all_to_all``);
5. front-packs each destination's P sections in source-major order (K15b,
   :func:`mesh_unpack`).

The reference bounds its send buffers by ``sendCapacityRows`` C and flags
an overflow when a destination gets more than C rows; its exec then
retries at worst-case capacity.  The port's sections are exact, so no row
is dropped; :func:`exchange_local_checked` still reports the flag (any
count above C), where the exec counts ``mesh_send_overflows``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.ops.kernels import slice_rows
from spark_rapids_tpu_torch.ops.mesh_exchange import (mesh_pack,
                                                      mesh_unpack,
                                                      section_columns)
from spark_rapids_tpu_torch.ops.partition import (partition_ids_for_keys,
                                                  partition_order)
from spark_rapids_tpu_torch.ops.segmented import AggSpec, sorted_group_by
from spark_rapids_tpu_torch.parallel.mesh import Mesh

__all__ = ["partition_ids_for_keys", "make_hash_exchange",
           "make_distributed_groupby", "MERGE_OPS", "exchange_local",
           "exchange_local_checked", "canonicalize", "count_matrix"]


def count_matrix(counts: Sequence[torch.Tensor]) -> list[list[int]]:
    """Rows every shard sends to every destination, ``[P][P]`` host ints,
    read in one copy (the counts of other cards move to the first's)."""
    dev = counts[0].device
    return torch.stack([c.to(dev) for c in counts]).cpu().tolist()


def exchange_local(batches: Sequence[ColumnBatch],
                   parts: Sequence[torch.Tensor],
                   mesh: Mesh) -> list[ColumnBatch]:
    """All-to-all rows of shard ``s`` (``batches[s]``, on
    ``mesh.devices[s]``) by destination ``parts[s]`` (int32 in [0, P));
    destination d's batch holds the rows sent to it, source-major."""
    out, _ = exchange_local_checked(batches, parts, mesh)
    return out


def exchange_local_checked(batches: Sequence[ColumnBatch],
                           parts: Sequence[torch.Tensor], mesh: Mesh,
                           send_capacity: int | None = None):
    """:func:`exchange_local` and the reference's overflow flag: True when
    one destination gets more than ``send_capacity`` rows of one shard
    (the rows all travel)."""
    p = mesh.size
    if len(batches) != p or len(parts) != p:
        raise ValueError(f"need {p} shards and ids, got {len(batches)} "
                         f"and {len(parts)}")
    orders = []
    for b, part in zip(batches, parts):
        if b.num_rows == 0:
            zero = torch.zeros(p, dtype=torch.int32, device=b.device)
            orders.append((torch.empty(0, dtype=torch.int32,
                                       device=b.device), zero))
        else:
            perm, counts, _starts = partition_order(part, p)
            orders.append((perm, counts))
    matrix = count_matrix([c for _perm, c in orders])  # the one host read
    packs = [mesh_pack(b.columns, perm, matrix[s])
             for s, (b, (perm, _c)) in enumerate(zip(batches, orders))]
    schema = batches[0].schema
    out = []
    for d, dev in enumerate(mesh.devices):
        segments = []
        for s, (buf, (sections, blocks)) in enumerate(packs):
            lo, hi = sections[d], sections[d + 1]
            sec = buf[lo:hi].to(dev, non_blocking=True)
            segments.append(section_columns(sec, batches[s].columns,
                                            matrix[s][d], blocks[d], lo))
        counts = [matrix[s][d] for s in range(p)]
        cols = mesh_unpack(segments, counts)
        out.append(ColumnBatch(cols, sum(counts), schema, dev))
    overflow = bool(send_capacity) and \
        max(max(row) for row in matrix) > send_capacity
    return out, overflow


def canonicalize(batch: ColumnBatch, num_rows: int) -> ColumnBatch:
    """The first ``num_rows`` rows of ``batch`` (reference :174: padding
    re-zeroed after an external row-count change; the port carries no
    padding, so a suppressed shard is a 0-row slice)."""
    return slice_rows(batch, 0, num_rows)


def make_hash_exchange(mesh: Mesh, schema, key_indices: Sequence[int]):
    """shards -> shards: the all-to-all hash exchange on ``key_indices``
    (Spark-exact murmur3 pmod P, K9)."""
    key_indices = list(key_indices)

    def step(shards: Sequence[ColumnBatch]) -> list[ColumnBatch]:
        parts = [partition_ids_for_keys(b, key_indices, mesh.size)
                 for b in shards]
        return exchange_local(shards, parts, mesh)

    return step


# Merge-side op per update op (reference: CudfAggregate mergeAggregate,
# AggregateFunctions.scala:531 -- count merges as sum, etc.).  `avg` is not
# single-column-mergeable: the exec layer decomposes it to sum+count.
MERGE_OPS = {
    "sum": "sum", "count": "sum", "count_star": "sum",
    "min": "min", "max": "max",
    "first": "first", "last": "last",
    "first_non_null": "first_non_null", "last_non_null": "last_non_null",
}


def make_distributed_groupby(mesh: Mesh, schema,
                             key_indices: Sequence[int],
                             specs: Sequence[AggSpec]):
    """shards -> shards: partial group-by per shard, all-to-all of the
    partial rows by key hash (a grand aggregate sends every row to slot
    0), merge group-by per destination; a grand aggregate's row stays on
    slot 0 and every other slot yields 0 rows."""
    key_indices = list(key_indices)
    for s in specs:
        if s.op not in MERGE_OPS:
            raise ValueError(f"op {s.op} is not mergeable here; decompose "
                             "at the exec layer (e.g. avg -> sum+count)")
    nkeys = len(key_indices)
    partial_keys = list(range(nkeys))
    merge_specs = [AggSpec(MERGE_OPS[s.op], nkeys + i)
                   for i, s in enumerate(specs)]

    def step(shards: Sequence[ColumnBatch]) -> list[ColumnBatch]:
        partials = [sorted_group_by(b, key_indices, list(specs))
                    for b in shards]
        if nkeys:
            parts = [partition_ids_for_keys(b, partial_keys, mesh.size)
                     for b in partials]
        else:
            parts = [torch.zeros(b.num_rows, dtype=torch.int32,
                                 device=b.device) for b in partials]
        out = []
        for d, ex in enumerate(exchange_local(partials, parts, mesh)):
            merged = sorted_group_by(ex, partial_keys, merge_specs)
            # merge outputs carry nested names (sum(sum(x))) but the
            # partial's types: relabel to the partial schema
            b = ColumnBatch(merged.columns, merged.num_rows,
                            partials[d].schema, merged.device)
            if not nkeys and d != 0:
                b = canonicalize(b, 0)
            out.append(b)
        return out

    return step
