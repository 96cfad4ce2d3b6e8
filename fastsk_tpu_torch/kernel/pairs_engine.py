"""All-pairs exact-kernel engine over sequence-aligned windows.

Counterpart of ``fastsk_tpu/kernel/pairs_engine.py:PairsGkmEngine``. It
computes the full exact gapped k-mer kernel in one sweep over window pairs,
``K[i,j] = sum_{p,q} C(matches(w_ip, w_jq), k)`` (ops/pairs.py), instead of
the C(g, m) counting passes of the theta engine.

Exactness: integer counts bit-identical to the reference. Guard: every K
entry must stay < 2^31 (int32 sums); the engine checks the worst case
``p_pad^2 * C(g, k)`` and refuses shapes where one sequence pair could
overflow.

On a local card there is no transfer to hide, so ``exact()`` is the device
path followed by ``.cpu()``: the TPU tile sizing and the byte-plane
streaming of the JAX engine are not needed.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..ops import pairs
from ..ops.encode import EncodedSeqs
from ..ops.pairs_cuda import pairs_counts
from .config import KernelConfig
from .device_counts import DeviceCounts


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PairsGkmEngine:
    """Exact-mode engine over the all-pairs binomial identity."""

    def __init__(
        self,
        enc: EncodedSeqs,
        g: int,
        m: int,
        config: Optional[KernelConfig] = None,
    ):
        self.enc = enc
        self.g = g
        self.m = m
        self.k = g - m
        self.config = config or KernelConfig()
        self.alpha = enc.hash_base
        self.code_min = enc.code_min
        self.n = enc.n

        self.p = enc.max_len - g + 1
        self.p_pad = _next_multiple(self.p, 8)
        if self.p_pad**2 * math.comb(g, self.k) >= 2**31:
            raise ValueError(
                "per-pair count bound exceeds int32; use the theta engine "
                f"(p_pad={self.p_pad}, C(g,k)={math.comb(g, self.k)})"
            )
        # kernel A tiles up to 8 sequences a side; padding sequences have
        # no valid windows and count 0
        self.n_pad = _next_multiple(self.n, 8)

    def _build_x(self) -> torch.Tensor:
        """One-hot windows ``[n_pad * p_pad, g * alpha]`` int8 on the device."""
        dev = self.config.device
        ids = np.asarray(self.enc.ids)
        lengths = np.asarray(self.enc.lengths)
        if self.n_pad > self.n:
            ids = np.pad(ids, ((0, self.n_pad - self.n), (0, 0)))
            lengths = np.pad(lengths, (0, self.n_pad - self.n))
        x = pairs.onehot_windows(
            torch.from_numpy(ids).to(dev),
            torch.from_numpy(lengths).to(dev),
            g=self.g,
            alpha=self.alpha,
            code_min=self.code_min,
            p_pad=self.p_pad,
        )
        return x.reshape(self.n_pad * self.p_pad, self.g * self.alpha)

    def exact_device(self) -> DeviceCounts:
        """Exact unnormalized kernel as ``DeviceCounts`` on the configured
        device (kernel A on a CUDA device)."""
        t0 = time.perf_counter()
        full = pairs_counts(self._build_x(), g=self.g, k=self.k, p_pad=self.p_pad)
        counts = full[: self.n, : self.n].contiguous()
        if not self.config.quiet:
            if counts.is_cuda:
                torch.cuda.synchronize(counts.device)
            print(
                f"pairs exact: {self.n} sequences, p_pad={self.p_pad}, "
                f"{time.perf_counter() - t0:.3f} s on {counts.device}"
            )
        return DeviceCounts(counts)

    def exact(self) -> np.ndarray:
        """Exact unnormalized kernel, int64 [N, N] on the host."""
        return self.exact_device().to_host_int64()
