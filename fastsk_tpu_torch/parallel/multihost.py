"""Multi-process execution entry points, on ``torch.distributed``.

Counterpart of ``fastsk_tpu/parallel/multihost.py``: the same
``initialize`` / ``global_mesh`` / ``auto_mesh`` surface over
``torch.distributed`` in place of ``jax.distributed``. Every process runs
the same program on the same inputs; the ``(rows, theta)`` mesh spans all
processes' devices and records each entry's owning rank, each process
computes its own entries, and the merges are collectives
(parallel/sharding.py). Results reach every process, which fits the same
SVM replica.

    from fastsk_tpu_torch.parallel import multihost
    multihost.initialize(backend="nccl")     # torchrun's environment
    mesh = multihost.global_mesh(rows=-1)    # every process's card on "rows"
    cfg = KernelConfig(mesh=mesh)    # exact: the packed engine (kernel F)
    cfg = KernelConfig(mesh=mesh, exact_engine="theta")   # or a theta engine
    FastSK(g, m, config=cfg).compute_kernel(...)

The backend is the caller's choice and is never switched: ``"nccl"`` where
each process has its own card, ``"gloo"`` for processes on the CPU or
sharing one card (nccl refuses two ranks on one card). Under gloo the
collectives go through host memory.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from .sharding import Mesh, default_mesh_shape


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> None:
    """``torch.distributed.init_process_group`` for this process.

    ``coordinator_address`` is ``host:port`` of rank 0, with
    ``num_processes`` and ``process_id``; with none of them the group reads
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``), as ``jax.distributed.initialize`` detects its own."""
    import torch.distributed as dist

    if coordinator_address is None:
        dist.init_process_group(backend=backend, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def _local_devices(local_devices: Optional[Sequence]) -> list:
    """This process's devices: as given, or its own card (``LOCAL_RANK``,
    else the rank modulo the visible cards)."""
    if local_devices is not None:
        return [torch.device(d) for d in local_devices]
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device: pass local_devices (e.g. ['cpu']) explicitly")
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
    return [torch.device("cuda", local)]


def global_mesh(rows: int = -1, theta: int = 1, local_devices: Optional[Sequence] = None) -> Mesh:
    """A (rows, theta) mesh over ALL processes' devices.

    Each process contributes ``local_devices`` (default: its own card), the
    same number on every process; the entries follow rank order, so a
    process's entries are consecutive (row blocks land process-local
    first). ``rows=-1`` takes every entry not taken by ``theta``."""
    import torch.distributed as dist

    mine = [str(d) for d in _local_devices(local_devices)]
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    if len({len(d) for d in everyone}) != 1:
        raise ValueError(f"processes hold different numbers of devices: {everyone}")
    devices = [torch.device(d) for per in everyone for d in per]
    ranks = [rank for rank, per in enumerate(everyone) for _ in per]
    n = len(devices)
    if rows == -1:
        if n % theta:
            raise ValueError(f"{n} devices not divisible by theta={theta}")
        rows = n // theta
    if rows * theta != n:
        raise ValueError(f"mesh {rows}x{theta} != {n} global devices")
    return Mesh(tuple(devices), rows, theta, tuple(ranks))


def auto_mesh(local_devices: Optional[Sequence] = None) -> Mesh:
    """Balanced (rows, theta) mesh over all processes' devices."""
    import torch.distributed as dist

    n = dist.get_world_size() * len(_local_devices(local_devices))
    rows, theta = default_mesh_shape(n)
    return global_mesh(rows, theta, local_devices)
