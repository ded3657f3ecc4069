"""The device mesh (port of ``spark_rapids_tpu/parallel/mesh.py``).

A :class:`Mesh` is an ordered list of torch devices along one named axis
(``make_mesh``, reference :43-52).  Slot ``i`` of the mesh is shard ``i``
of every distributed operator; two slots may name the same physical
device.  The reference gets 8 devices on one host from
``--xla_force_host_platform_device_count=8``; the port's analog is the
environment variable ``SRT_VIRTUAL_DEVICES=N``, which lays N virtual
devices round-robin over the physical devices of the session's type
(:func:`mesh_devices`; read when a mesh is built, not at import).  On one
card every slot is ``cuda:0`` and a hand-over between slots is no copy.

The reference stacks P per-device batches into one sharded pytree
(``shard_batches``, ``local_view``, ``restack``, ``split_shards``,
``unshard_batch``) because ``shard_map`` takes one array per leaf.  The
port has no counterpart: it keeps a plain list of per-slot batches, each
exactly as long as its rows (``columnar/batch.py``), so there is nothing
to stack, squeeze or split.

``COUNTERS`` holds the mesh counters under the reference's registry names
(``spark_rapids_tpu/exec/mesh_exec.py``); the port has no metrics
registry yet (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import torch

__all__ = ["Mesh", "make_mesh", "mesh_devices", "COUNTERS",
           "reset_counters", "VIRTUAL_DEVICES_ENV"]

#: environment variable: lay this many virtual devices over the physical
#: devices of the session's type
VIRTUAL_DEVICES_ENV = "SRT_VIRTUAL_DEVICES"

#: the reference's mesh counters (obs registry names), process-wide
COUNTERS: dict[str, float] = {
    "mesh_all_to_all_bytes": 0.0,
    "mesh_send_overflows": 0,
    "mesh_gather_fallbacks": 0,
    "mesh_join_replicated": 0,
    "mesh_join_partitioned": 0,
    "mesh_join_broadcast_bytes": 0.0,
}


def reset_counters() -> None:
    """Set every mesh counter to 0."""
    for k in COUNTERS:
        COUNTERS[k] = type(COUNTERS[k])(0)


@dataclass(frozen=True)
class Mesh:
    """An ordered 1-D mesh: ``devices[i]`` holds shard ``i``."""
    devices: tuple
    axis_name: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)

    def physical(self) -> list:
        """The distinct devices of the mesh, in slot order."""
        seen: list = []
        for d in self.devices:
            if d not in seen:
                seen.append(d)
        return seen


def mesh_devices(session_device) -> list:
    """The devices a mesh may use on ``session_device``'s type: every CUDA
    card for CUDA, the one CPU for the CPU; with ``SRT_VIRTUAL_DEVICES=N``
    N virtual devices laid round-robin over those."""
    dev = torch.device(session_device)
    if dev.type == "cuda":
        phys = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        phys = [torch.device(dev.type)]
    n = os.environ.get(VIRTUAL_DEVICES_ENV, "").strip()
    if not n:
        return phys
    n = int(n)
    if n < 1:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV}={n}: must be positive")
    return [phys[i % len(phys)] for i in range(n)]


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              devices: Sequence | None = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (all by default) of
    ``devices`` (default: :func:`mesh_devices` of the card)."""
    if devices is None:
        from spark_rapids_tpu_torch.device import resolve_device
        devices = mesh_devices(resolve_device())
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(tuple(devs), axis_name)
