"""Configuration for the gapped k-mer kernel engine.

Counterpart of ``fastsk_tpu/kernel/config.py``, cut to the knobs the exact
path of this port reads. The TPU budgets, the mesh, checkpointing and the
approx-mode knobs belong to slices that are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch


@dataclass
class KernelConfig:
    """Knobs of the exact-kernel path."""

    # Device the kernel, the Gram and the SVM solves run on. On a CUDA
    # device every kernel launch goes through the hand-written kernels; on
    # the CPU their plain PyTorch versions run instead.
    device: Union[str, torch.device] = "cuda"

    # Exact-mode engine: "auto" and "pairs" take the sequence-aligned
    # all-pairs engine (kernel/pairs_engine.py). "packed" and "theta" are
    # accepted names whose engines are not ported yet; they raise.
    exact_engine: str = "auto"

    # All-pairs backend: "auto" is the one route of this slice — kernel A
    # (csrc/pairs.cu) for CUDA tensors, its plain version for CPU tensors.
    pairs_backend: str = "auto"

    # Keep the counts on the device (kernel/device_counts.py): normalize,
    # Gram, SMO and decision values then run there and only O(n) results
    # come back. False pulls int64 counts and normalizes in f64 on the
    # host, bit-identical to the reference.
    device_resident: bool = False

    quiet: bool = True

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.exact_engine not in ("auto", "pairs", "packed", "theta"):
            raise ValueError(f"unknown exact_engine {self.exact_engine!r}")
        if self.pairs_backend != "auto":
            raise NotImplementedError(
                f"pairs_backend={self.pairs_backend!r}: the port has one "
                "all-pairs route ('auto'); the grouped Pallas variant "
                "(kernel G) is still to be ported (ROADMAP.md queue 2)"
            )
