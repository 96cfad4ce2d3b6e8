"""Device-resident exact kernel counts.

Counterpart of ``fastsk_tpu/kernel/device_counts.py``. The exact integer
counts stay on the device and a host copy is made only when a caller asks
for the host matrix; fit/score (normalize -> Gram -> SMO -> decision
values) then run on the device and pull only O(n) values.

One int32 tensor holds the counts: the sequence-aligned engine's
constructor guard (``p_pad**2 * C(g, k) < 2**31``) bounds every entry, and
the packed engine returns host int64 instead when a count reaches 2**31,
so the JAX package's ``lo + 2**30 * hi`` carry pair is not needed here.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceCounts:
    """Exact integer kernel counts ``[n, n]`` int32, on the device."""

    def __init__(self, counts: torch.Tensor):
        if counts.dtype != torch.int32:
            raise ValueError(f"counts must be int32; got {counts.dtype}")
        self.counts = counts

    def normalized_f32(self) -> torch.Tensor:
        """Cosine normalization on the device, K / sqrt(diag x diag), f32 —
        ``fastsk_tpu/kernel/device_counts.py:_normalize_f32`` op for op."""
        k = self.counts.to(torch.float32)
        diag = torch.diagonal(k)
        return k / torch.sqrt(diag[:, None] * diag[None, :])

    def to_host_int64(self) -> np.ndarray:
        """Pull the exact integer counts to the host."""
        return self.counts.cpu().numpy().astype(np.int64)
