"""Multi-device execution of the packed exact engine over a device mesh.

Counterpart of ``fastsk_tpu/parallel/sharding.py``'s mesh helpers and its
two packed-engine functions (``packed_round_sharded``,
``packed_ring_rowsharded``). The mesh is a ``(rows, theta)`` grid of
``torch.device``s; a Python loop over its devices takes the place of
``shard_map``. Kernel launches are asynchronous and the loops below never
wait on the device, so distinct cards can overlap (as far as the host
issues work fast enough: PERF.md §5); on one device named several times
(the tests' and the one-card smoke's stand-in for XLA's virtual host
devices) it runs in turn.

Both functions are integer-identical to the single-device engine: every
ordered sequence pair is summed exactly once, in int64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

ROWS_AXIS = "rows"
THETA_AXIS = "theta"


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(rows, theta)`` grid of devices.

    ``devices`` is the flat, row-major device list; ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does. A device
    may appear more than once."""

    devices: Tuple[torch.device, ...]
    n_rows: int
    n_theta: int

    def __post_init__(self):
        if self.n_rows < 1 or self.n_theta < 1:
            raise ValueError(f"mesh axes must be >= 1; got {self.n_rows} x {self.n_theta}")
        if len(self.devices) != self.n_rows * self.n_theta:
            raise ValueError(
                f"{len(self.devices)} devices for a {self.n_rows} x {self.n_theta} mesh"
            )

    @property
    def shape(self) -> dict:
        return {ROWS_AXIS: self.n_rows, THETA_AXIS: self.n_theta}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_rows: int, n_theta: int, devices=None) -> Mesh:
    """A ``(rows, theta)`` mesh of the first ``n_rows * n_theta`` visible
    CUDA devices, or of an explicit device list (which may repeat a
    device)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = n_rows * n_theta
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(tuple(devices[:need]), n_rows, n_theta)


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Split n_devices into (rows, theta) favoring a balanced 2-D mesh."""
    rows = 1
    for cand in range(int(np.sqrt(n_devices)), 0, -1):
        if n_devices % cand == 0:
            rows = cand
            break
    return rows, n_devices // rows


def host_gather(shards: Sequence[torch.Tensor]) -> np.ndarray:
    """The per-device shards, stacked on the host."""
    return np.stack([s.cpu().numpy() for s in shards])


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int) -> np.ndarray:
    size = x.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple
    if target == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - size)
    return np.pad(x, widths)


def packed_round_sharded(
    mats: List[torch.Tensor],  # per device: [Np, Np] int64 private replica
    rows: List,  # per device: the whole PackedRows table
    round_idx: int,
    *,
    mesh: Mesh,
    k: int,
    n_strips: int,
) -> List[torch.Tensor]:
    """One round-robin round of the packed (ragged) all-pairs engine.

    Device ``d`` runs strip ``a = round_idx * n_dev + d`` against all
    strips b >= a, one launch of kernel F's triangle
    (``ops/pairs_packed_cuda.py:packed_block``), adding into its PRIVATE
    replica: every row pair is handled by exactly one device, so the
    merge is a sum of the replicas (on the host, by the engine).
    Round-robin assignment balances the triangular b loop."""
    from ..ops.pairs_packed_cuda import packed_block

    n_dev = mesh.size
    for d in range(n_dev):
        a = round_idx * n_dev + d
        if a < n_strips:
            packed_block(mats[d], rows[d], (a, a + 1), k=k)
    return mats


def packed_ring_rowsharded(
    blocks: List[torch.Tensor],  # per device: [blk, Np] int64 row block
    shards: List,  # per device: PackedRows of its own spd strips
    row0: Sequence[int],  # per device: global row of block[0]
    *,
    mesh: Mesh,
    spd: int,
    k: int,
    n_strips: int,
) -> List[torch.Tensor]:
    """Operand-sharded packed sweep: the window table is strip-sharded to
    match each device's row block, and shards travel the ring once. At
    step s device d holds the shard of device (d + s) mod D and sweeps ALL
    its own live strips against ALL live visiting strips in one launch of
    kernel F (``ops/pairs_packed_cuda.py:packed_block``, landing rows ``si
    - row0`` of its block), then takes its upper neighbour's shard with
    ``.to(device, non_blocking=True)`` (JAX's ``ppermute``). At step 0 the
    shard is its own and the launch is F's triangle with its mirror, each
    unordered row pair once; the other steps are rectangles, every ordered
    pair. Dead strips (global id >= n_strips) are not launched.
    Per-device memory is the O(N^2 / D) row block plus two O(rows / D)
    shards. On a device named twice the visiting shard is the owner's own
    tensor, so nothing here writes into a shard."""
    from ..ops.pairs_packed_cuda import packed_block

    devices = mesh.devices
    n_dev = len(devices)
    visiting = list(shards)
    for s in range(n_dev):
        for d in range(n_dev):
            n_a = min(spd, n_strips - d * spd)
            n_b = min(spd, n_strips - ((d + s) % n_dev) * spd)
            if n_a <= 0 or n_b <= 0:
                continue
            if s == 0:
                packed_block(blocks[d], shards[d], (0, n_a), k=k, strips_j=(0, n_a), row_off=row0[d])
            else:
                packed_block(
                    blocks[d], shards[d], (0, n_a), k=k, rows_j=visiting[d],
                    strips_j=(0, n_b), row_off=row0[d],
                )
        if s + 1 < n_dev:
            visiting = [visiting[(d + 1) % n_dev].to(devices[d]) for d in range(n_dev)]
    return blocks
