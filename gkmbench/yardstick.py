"""The benchmark's frozen yardstick: the H100's peaks, the work of the
exact count matrix, and the arithmetic that turns device intervals into
busy and idle time.

Nothing here reads the program: the count work is worked out from the
configuration's sizes, so a later change to the engines moves the time
and never the work.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

# Published peaks of one NVIDIA H100 SXM (dense, no sparsity), which assume
# the card's full 700 W power limit.
INT8_OPS_PER_S = 1.979e15
HBM_BYTES_PER_S = 3.35e12
PEAK_POWER_W = 700.0


def count_work(windows: int, g: int, alpha: int, n_seqs: int) -> Tuple[float, float]:
    """(int8 operations, bytes) of the exact count matrix over ``windows``
    g-mer windows in all: the window-pair triangle, W (W + 1) / 2 pairs,
    each charged 2 g alpha operations (a one-hot product of depth g alpha);
    the bytes are the one-hot windows read once (g alpha bytes a window)
    and the int32 count matrix written once."""
    pairs = windows * (windows + 1) / 2.0
    ops = pairs * 2.0 * g * alpha
    nbytes = windows * g * alpha + 4.0 * n_seqs * n_seqs
    return ops, nbytes


def count_bound_s(windows: int, g: int, alpha: int, n_seqs: int) -> float:
    """The least time the card could take for the exact count matrix: the
    larger of its operations at the int8 peak and its bytes at HBM speed."""
    ops, nbytes = count_work(windows, g, alpha, n_seqs)
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted, disjoint intervals covering the same time: kernels of
    overlapping streams are counted once."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(merged: Sequence[Tuple[float, float]], t0: float, t1: float) -> float:
    """Length of [t0, t1] that the merged intervals cover."""
    total = 0.0
    for a, b in merged:
        if b <= t0:
            continue
        if a >= t1:
            break
        total += min(b, t1) - max(a, t0)
    return total


def gaps(merged: Sequence[Tuple[float, float]], t0: float, t1: float) -> List[Tuple[float, float]]:
    """The parts of [t0, t1] that the merged intervals leave uncovered."""
    out, at = [], t0
    for a, b in merged:
        if b <= at:
            continue
        if a >= t1:
            break
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return out
