"""Device-resident exact kernel counts.

Counterpart of ``fastsk_tpu/kernel/device_counts.py``. The exact integer
counts stay on the device and a host copy is made only when a caller asks
for the host matrix; fit/score (normalize -> Gram -> SMO -> decision
values) then run on the device and pull only O(n) values.

Counts are ``lo + 2**30 * hi`` int32 pairs. The all-pairs engines fill
``lo`` alone (``hi`` is None): the sequence-aligned engine's constructor
guard (``p_pad**2 * C(g, k) < 2**31``) bounds every entry, and the packed
engine returns host int64 instead when a count reaches 2**31. The theta
engines' device-resident streams spill completed 2**30-units of ``lo``
into ``hi`` (``_carry_spill``) before int32 could overflow, as the JAX
engines do; totals are exact below 2**61.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_CARRY_SHIFT = 30  # hi counts units of 2**_CARRY_SHIFT (read at each call)


def _carry_spill(lo: torch.Tensor, hi: Optional[torch.Tensor]):
    """Move completed 2**30-units from ``lo`` into ``hi`` (values are
    nonnegative; ``hi`` None is a zero plane)."""
    carry = lo >> _CARRY_SHIFT
    hi = carry if hi is None else hi + carry
    return lo - (carry << _CARRY_SHIFT), hi


class DeviceCounts:
    """Exact integer kernel counts ``[n, n]`` on the device: ``counts``
    (the ``lo`` plane, int32) and, after a spill, ``hi`` (int32 carries of
    2**30)."""

    def __init__(self, counts: torch.Tensor, hi: Optional[torch.Tensor] = None):
        for plane in (counts, hi):
            if plane is not None and plane.dtype != torch.int32:
                raise ValueError(f"counts must be int32; got {plane.dtype}")
        self.counts = counts
        self.hi = hi

    def to_f32(self) -> torch.Tensor:
        """The counts in f32 (``hi`` first, as the JAX ``_combine_f32``)."""
        if self.hi is None:
            return self.counts.to(torch.float32)
        return (self.hi.to(torch.float32) * float(1 << _CARRY_SHIFT)
                + self.counts.to(torch.float32))

    def normalized_f32(self) -> torch.Tensor:
        """Cosine normalization on the device, K / sqrt(diag x diag), f32 —
        ``fastsk_tpu/kernel/device_counts.py:_normalize_f32`` op for op."""
        k = self.to_f32()
        diag = torch.diagonal(k)
        return k / torch.sqrt(diag[:, None] * diag[None, :])

    def to_host_int64(self) -> np.ndarray:
        """Pull the exact integer counts to the host."""
        out = self.counts.cpu().numpy().astype(np.int64)
        if self.hi is not None:
            out += self.hi.cpu().numpy().astype(np.int64) << _CARRY_SHIFT
        return out
