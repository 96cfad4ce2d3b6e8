"""Configuration for the gapped k-mer kernel engine.

Counterpart of ``fastsk_tpu/kernel/config.py``: the knobs of the exact
engines, of the two theta engines (dense and sorted), of approx mode, of
the device mesh and of checkpoints, with the JAX package's defaults. It
takes every field of the JAX package's ``KernelConfig`` (``mesh`` and
``device`` as the port's own mesh and a torch device), so a config
written for one package builds the other's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from ..parallel.sharding import Mesh


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card raises
    instead of falling back to the CPU (pass ``device="cpu"`` for that)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' (or "
            "KernelConfig(device='cpu')) to run on the CPU"
        )
    return device


@dataclass
class KernelConfig:
    """Knobs of the kernel engines."""

    # Device the kernel, the Gram and the SVM solves run on (None: the
    # card). On a CUDA device every kernel launch goes through the
    # hand-written kernels; on the CPU their plain PyTorch versions run
    # instead.
    device: Union[str, torch.device, None] = "cuda"

    # Largest dense bucket space B = hash_base**k that the dense theta
    # engine histograms; beyond it the sorted engine takes over.
    b_max_dense: int = 1 << 17

    # Device-memory budget (bytes) of one theta batch's count tensor
    # C [T, N, B]; it sets the dense engine's theta batch.
    counts_budget_bytes: int = 2 << 30

    # Device-memory budget (bytes) of one row chunk's hash and scatter-index
    # tensors (ops/gkm.py:HASH_BYTES a window and theta); with the next
    # budget it sets the dense engine's row chunk (the smaller of the two).
    hash_budget_bytes: int = 1 << 30

    # Device-memory budget (bytes) of one row chunk's one-hot count
    # intermediates (b1 + b2 buckets a window and theta, in the product's
    # dtype), as the JAX package sizes its row chunk.
    onehot_budget_bytes: int = 1 << 30

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

    # Sorted engine's slab decomposition: the JAX package's "runs" or
    # "pairs", whose results are integer-identical; both run the port's
    # run-aligned layout.
    sorted_layout: str = "runs"

    # Sorted engine: runs a slab (the width of its run-aligned count
    # matrix).
    sorted_run_width: int = 2048

    # Keep the counts on the device (kernel/device_counts.py): normalize,
    # Gram, SMO and decision values then run there and only O(n) results
    # come back. False pulls int64 counts and normalizes in f64 on the
    # host, bit-identical to the reference.
    device_resident: bool = False

    # Mid-computation checkpointing (utils/checkpoint.py): the dense theta
    # engine persists its accumulator and work-queue cursor every
    # `checkpoint_every` thetas, so a long exact or approx run resumes
    # after an interruption. Across processes rank 0 writes the file and
    # every rank reads it, so it must lie on storage they all share.
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 512

    # Multi-device kernel (parallel/sharding.py:make_mesh, or
    # parallel/multihost.py:global_mesh across processes): the packed and
    # theta engines run over the mesh's devices, which must be of
    # ``device``'s type (the fit runs on ``device``). None = one device.
    mesh: Optional[Mesh] = None

    # Mesh memory layout of the packed and sorted engines: "sharded" keeps
    # a kernel row block per device (the packed ring, with a strip shard of
    # the window table; the sorted engine's row strips, O(N^2 / rows) a
    # device); "replicated" keeps a full private replica per device
    # (round-robin strips; the sorted engine's theta-sharded passes). The
    # dense theta engine always keeps row blocks.
    mesh_state: str = "sharded"

    # Write a torch.profiler trace (Chrome JSON) of the kernel computation
    # into this directory (utils/observe.py:profiler_trace).
    profile_dir: Optional[str] = None

    quiet: bool = True

    def __post_init__(self):
        self.device = torch.device("cuda" if self.device is None else self.device)
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
        if self.sorted_layout not in ("runs", "pairs"):
            raise ValueError(
                f"sorted_layout must be 'runs' or 'pairs'; got {self.sorted_layout!r}"
            )
        if self.mesh is not None and any(
            d.type != self.device.type for d in self.mesh.devices
        ):
            raise ValueError(
                f"the mesh's devices {list(self.mesh.devices)} are not of the "
                f"fit device's type {self.device.type!r}"
            )
