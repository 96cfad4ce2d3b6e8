"""Position-subset combinatorics for the gapped k-mer decomposition.

Copied from ``fastsk_tpu/ops/combinatorics.py`` (numpy only), so that the
theta stream of approx mode is element for element the JAX package's.

The gkm kernel decomposes into ``C(g, m)`` independent counting passes, one
per choice of ``k = g - m`` kept positions. The reference enumerates subsets
recursively in lexicographic order (shared.cpp:347-360) and shuffles the work
queue with a time-seeded RNG (fastsk_kernel.cpp:36-38). Here enumeration is a
vectorized numpy routine and shuffling is explicitly seeded, making approx
mode reproducible — a deliberate improvement over the reference.
"""

from __future__ import annotations

import numpy as np


def nchoosek(n: int, k: int) -> int:
    """Binomial coefficient (exact integer)."""
    if k < 0 or k > n:
        return 0
    k = min(k, n - k)
    result = 1
    for i in range(1, k + 1):
        result = result * (n - k + i) // i
    return result


def enumerate_combinations(g: int, k: int) -> np.ndarray:
    """All C(g, k) sorted position subsets, shape ``[num_comb, k]`` int32.

    Rows are in lexicographic order, matching the reference's recursive
    enumeration order so exact mode visits passes identically.
    """
    num = nchoosek(g, k)
    out = np.empty((num, k), dtype=np.int32)
    if k == 0:
        return out
    # Iterative lexicographic successor; O(num * k) host work, at most
    # C(20,10) = 184,756 rows under the reference's g <= 20 constraint.
    comb = np.arange(k, dtype=np.int32)
    for i in range(num):
        out[i] = comb
        # advance to next combination
        j = k - 1
        while j >= 0 and comb[j] == g - k + j:
            j -= 1
        if j < 0:
            break
        comb[j] += 1
        for j2 in range(j + 1, k):
            comb[j2] = comb[j2 - 1] + 1
    return out


def sample_combinations(
    g: int, k: int, rng: np.random.Generator
) -> np.ndarray:
    """A seeded random permutation of all C(g, k) subsets.

    Approx mode consumes subsets from this stream in order — sampling
    *without replacement*, the same distribution the reference induces by
    shuffling its full work queue (fastsk_kernel.cpp:29-47) but deterministic
    given the seed.
    """
    combos = enumerate_combinations(g, k)
    perm = rng.permutation(len(combos))
    return combos[perm]
