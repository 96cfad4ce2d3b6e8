"""Host-side kernel normalization.

Counterpart of ``fastsk_tpu/kernel/engine.py:cosine_normalize`` (the only
piece of that module on this port's path; the theta engines are ROADMAP.md
slice 3).
"""

from __future__ import annotations

import numpy as np


def cosine_normalize(counts: np.ndarray) -> np.ndarray:
    """float64 cosine normalization, bit-matching the reference's double math
    (fastsk_kernel.cpp:96-103)."""
    k = counts.astype(np.float64)
    diag = np.diag(k).copy()
    # sqrt of the product (not product of sqrts): the reference computes
    # sqrt(K[i][i] * K[j][j]) per entry, and the two differ in the last ulp.
    return k / np.sqrt(np.multiply.outer(diag, diag))
