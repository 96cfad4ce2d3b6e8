"""Configuration for the gapped k-mer kernel engine.

Counterpart of ``fastsk_tpu/kernel/config.py``: the knobs of the exact
engines, of the two theta engines (dense and sorted) and of approx mode,
with the JAX package's defaults. Checkpointing, the profiler and the TPU
compile cache belong to slices that are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from ..parallel.sharding import Mesh


@dataclass
class KernelConfig:
    """Knobs of the kernel engines."""

    # Device the kernel, the Gram and the SVM solves run on. On a CUDA
    # device every kernel launch goes through the hand-written kernels; on
    # the CPU their plain PyTorch versions run instead.
    device: Union[str, torch.device] = "cuda"

    # Largest dense bucket space B = hash_base**k that the dense theta
    # engine histograms; beyond it the sorted engine takes over.
    b_max_dense: int = 1 << 17

    # Device-memory budget (bytes) of one theta batch's count tensor
    # C [T, N, B]; it sets the dense engine's theta batch.
    counts_budget_bytes: int = 2 << 30

    # Device-memory budget (bytes) of one row chunk's hash and scatter-index
    # tensors (ops/gkm.py:HASH_BYTES a window and theta); it sets the dense
    # engine's row chunk.
    hash_budget_bytes: int = 1 << 30

    # Upper bound on thetas a batch.
    max_theta_batch: int = 64

    # Fixed overrides of the two sizes above (None = auto).
    theta_batch: Optional[int] = None
    row_chunk: Optional[int] = None

    # Exact-mode engine: "pairs" is the sequence-aligned all-pairs engine,
    # "packed" the ragged one (kernel/pairs_engine.py), "theta" the dense
    # or sorted theta engine by bucket space; "auto" picks as the JAX
    # package does (api.py:_make_exact_engine).
    exact_engine: str = "auto"

    # Packed-engine route: "auto" and "pallas" take kernel D (the band
    # sweep; kernel E with FASTSK_PACKED_PAIRLIST=1), "pallas_grouped"
    # kernel G. The sequence-aligned engine always takes kernel A. The
    # JAX package's "xla" and "*_interpret" are refused: on a card they
    # would put the plain version on the main path.
    pairs_backend: str = "auto"

    # Sorted engine: pairs a scatter chunk of one slab's count matrix.
    sorted_slab: int = 8192

    # Sorted engine: runs a slab (the width of its run-aligned count
    # matrix).
    sorted_run_width: int = 2048

    # Keep the counts on the device (kernel/device_counts.py): normalize,
    # Gram, SMO and decision values then run there and only O(n) results
    # come back. False pulls int64 counts and normalizes in f64 on the
    # host, bit-identical to the reference.
    device_resident: bool = False

    # Multi-device exact kernel (parallel/sharding.py:make_mesh): the packed
    # engine runs over the mesh's devices, which must be of ``device``'s
    # type (the fit runs on ``device``). None = one device.
    mesh: Optional[Mesh] = None

    # Mesh memory layout of the packed engine: "sharded" keeps a kernel row
    # block and a strip shard of the window table per device (the ring,
    # O(N^2 / n_dev) a device); "replicated" keeps a full private replica
    # per device and the whole table (round-robin strips).
    mesh_state: str = "sharded"

    quiet: bool = True

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.exact_engine not in ("auto", "pairs", "packed", "theta"):
            raise ValueError(f"unknown exact_engine {self.exact_engine!r}")
        if self.pairs_backend not in ("auto", "pallas", "pallas_grouped"):
            raise ValueError(
                f"pairs_backend={self.pairs_backend!r}: the port takes 'auto', "
                "'pallas' (kernel D) or 'pallas_grouped' (kernel G); the "
                "plain versions run only for CPU tensors"
            )
        if self.mesh_state not in ("sharded", "replicated"):
            raise ValueError(
                "mesh_state must be 'sharded' or 'replicated'; got "
                f"{self.mesh_state!r}"
            )
        if self.mesh is not None and any(
            d.type != self.device.type for d in self.mesh.devices
        ):
            raise ValueError(
                f"the mesh's devices {list(self.mesh.devices)} are not of the "
                f"fit device's type {self.device.type!r}"
            )
