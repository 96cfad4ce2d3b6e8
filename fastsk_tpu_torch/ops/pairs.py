"""All-pairs formulation of the exact gapped k-mer kernel, in PyTorch.

Counterpart of ``fastsk_tpu/ops/pairs.py``. The kernel is

    K[i, j] = sum_{p, q} C(matches(w_ip, w_jq), k)

where ``matches`` counts the agreeing positions of two g-mers and C is the
binomial coefficient: a position subset contributes to a window pair iff
all k kept positions agree, and there are exactly C(#agreeing, k) of them.
With a position-one-hot window encoding, ``matches`` is the dot product of
two 0/1 rows, so the whole kernel is one 0/1 matrix product, an exact
integer weight and a window-to-sequence sum (rows are sequence-aligned,
``p_pad`` per sequence).

``pairs_counts_plain`` is the plain version of kernel A
(``ops/pairs_cuda.py``): the CPU path (in the kernel's partition), and
what the kernel is held to on the card. ``pairs_probe_plain`` is that of
kernel H's variants.
"""

from __future__ import annotations

import contextlib
import math

import torch

# kernel H's variants of kernel A's tensor-core body, in the order of its C
# entry point ("current" is kernel A)
PROBE_VARIANTS = ("noop", "loads", "matmul", "skeleton", "no_mma", "current", "int32")


def binom_exact(x: torch.Tensor, k: int) -> torch.Tensor:
    """C(x, k) for integer-valued float x in [0, 20] (a match count of two
    windows of g <= 20 codes), exact: a lookup in the table of C(i, k),
    every entry at most C(20, 10) < 2^24. C(i, k) = 0 for i < k, so
    windows with too few matches (and padding, which matches nothing) get
    weight 0. (Stepwise products divided by j + 1 miss the integer on the
    card, where PyTorch divides by a scalar as a multiply by its
    reciprocal.)
    """
    table = torch.tensor([math.comb(i, k) for i in range(21)], dtype=x.dtype, device=x.device)
    return table[x.long()]


def onehot_windows(
    ids: torch.Tensor,  # [N, L] int32
    lengths: torch.Tensor,  # [N]
    *,
    g: int,
    alpha: int,  # hash alphabet size (code_max - code_min + 1)
    code_min: int,
    p_pad: int,
) -> torch.Tensor:
    """Per-window one-hot position encoding ``X [N, p_pad, g * alpha]`` int8.

    Row (n, p) holds the concatenated one-hots of the g codes of window p
    of sequence n; invalid windows (p > len - g) and the padding rows up to
    ``p_pad`` are all-zero, so their match count against anything is 0 and
    their binomial weight vanishes (k >= 1).
    """
    n, length = ids.shape
    p = length - g + 1
    win = ids.unfold(1, g, 1)  # [N, P, g]
    pos = torch.arange(p, device=ids.device)
    valid = pos[None, :] <= (lengths[:, None] - g)  # [N, P]
    codes = torch.arange(alpha, device=ids.device, dtype=ids.dtype)
    oh = (win[..., None] - code_min) == codes  # [N, P, g, alpha]
    oh = (oh & valid[:, :, None, None]).to(torch.int8)
    oh = oh.reshape(n, p, g * alpha)
    if p_pad > p:
        oh = torch.nn.functional.pad(oh, (0, 0, 0, p_pad - p))
    return oh


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matrix products in full f32 (no TF32) for the enclosed block:
    the match counts and Grams must be the exact values, not 10-bit ones."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pairs_counts_plain(
    x: torch.Tensor,  # [n_pad * p_pad, F] int8, sequence-aligned rows
    *,
    k: int,
    p_pad: int,
    strip_rows=None,
    weight=None,
    plan=None,
) -> torch.Tensor:
    """Full symmetric count matrix ``[n_pad, n_pad]`` int32.

    Strips of ``c`` sequences (about ``strip_rows`` window rows, 16384 by
    default) are computed for the upper block triangle only and mirrored.
    Per strip pair: ``D = X_i X_j^T`` in f32 (0/1 operands, exact counts
    <= g), ``C(D, k)`` exact in f32 (or ``weight(D)``, int32), then the
    window -> sequence reshape-sum in integers. Every per-pair total is
    < 2^31 by the engine's guard.

    With ``plan`` (``ops/pairs_cuda.py:mma_plan``'s ``MmaPlan``), the same
    sums in kernel A's partition instead (``_counts_as_planned``), so that
    a fault of the plan's tiling shows on the CPU.
    """
    if plan is not None:
        return _counts_as_planned(x, k, p_pad, plan, weight, strip_rows or 4096)
    n_pad = x.shape[0] // p_pad
    c = max(1, (strip_rows or 16384) // p_pad)
    xf = x.to(torch.float32)
    out = torch.empty((n_pad, n_pad), dtype=torch.int32, device=x.device)
    with full_f32_matmul():
        for i0 in range(0, n_pad, c):
            i1 = min(i0 + c, n_pad)
            xi = xf[i0 * p_pad : i1 * p_pad]
            for j0 in range(i0, n_pad, c):
                j1 = min(j0 + c, n_pad)
                d = xi @ xf[j0 * p_pad : j1 * p_pad].T
                w = (binom_exact(d, k) if weight is None else weight(d)).to(torch.int32)
                part = w.reshape(i1 - i0, p_pad, j1 - j0, p_pad).sum(dim=(1, 3))
                out[i0:i1, j0:j1] = part
                out[j0:j1, i0:i1] = part.T
    return out


def _counts_as_planned(x, k, p_pad, plan, weight, strip_rows):
    """Kernel A's partition of the count sums: a block a tile pair
    ``bi <= bj`` (``plan.tile`` sequences a side) and a range of
    ``plan.range_chunks`` 128-row j chunks of tile bj (of paired rows, two
    windows a row, in the resident and windows layouts); its match counts
    summed over ``plan.slab``-byte k-slabs, weighed once, summed into int32
    per-sequence bins; the bins added into a zeroed int32 matrix at
    ``K[i, j]`` and, off the diagonal tile, at ``K[j, i]``. Strips of
    tiles (about ``strip_rows`` rows each) take many blocks at once."""
    n_pad = x.shape[0] // p_pad
    s = plan.tile
    rows = s * p_pad  # a tile's window rows
    nt = n_pad // s
    # j windows a range (a paired row holds two; one sequence a tile
    # wherever there are several ranges, so its re-padding is at its end)
    span = plan.range_chunks * (256 if plan.layout in ("resident", "windows") else 128)
    ct = max(1, strip_rows // rows)  # tiles a strip
    xf = x.to(torch.float32).reshape(nt, rows, -1)
    f = xf.shape[-1]
    seq_of = torch.arange(rows, device=x.device) // p_pad  # a row's sequence in its tile
    tiles = torch.arange(nt, device=x.device)
    out = torch.zeros((n_pad, n_pad), dtype=torch.int32, device=x.device)
    with full_f32_matmul():
        for a0 in range(0, nt, ct):
            a1 = min(a0 + ct, nt)
            xi = xf[a0:a1].reshape(-1, f)
            for b0 in range(a0, nt, ct):
                b1 = min(b0 + ct, nt)
                # the tile pairs of a block (bi <= bj), and those mirrored
                ta, tb = tiles[a0:a1, None], tiles[None, b0:b1]
                direct = (ta <= tb).to(torch.int32)[:, None, :, None]
                mirror = (ta < tb).to(torch.int32)[:, None, :, None]
                for r0 in range(0, rows, span):
                    r1 = min(r0 + span, rows)
                    xj = xf[b0:b1, r0:r1].reshape(-1, f)
                    d = sum(
                        xi[:, c : c + plan.slab] @ xj[:, c : c + plan.slab].T
                        for c in range(0, f, plan.slab)
                    )
                    w = (binom_exact(d, k) if weight is None else weight(d)).to(torch.int32)
                    w = w.reshape(a1 - a0, s, p_pad, b1 - b0, r1 - r0).sum(2, dtype=torch.int32)
                    bins = torch.zeros(
                        (a1 - a0, s, b1 - b0, s), dtype=torch.int32, device=x.device
                    ).index_add_(3, seq_of[r0:r1], w)
                    shape = ((a1 - a0) * s, (b1 - b0) * s)
                    out[a0 * s : a1 * s, b0 * s : b1 * s] += (bins * direct).reshape(shape)
                    out[b0 * s : b1 * s, a0 * s : a1 * s] += (bins * mirror).reshape(shape).T
    return out


def binom_ffact_i32(d: torch.Tensor, k: int) -> torch.Tensor:
    """C(d, k) for int32 d in [0, g] as kernel H's ``int32`` variant
    computes it: the falling factorial d (d - 1) ... (d - k + 1) in int32
    with balanced factor pairing (``fastsk_tpu/ops/pairs_pallas.py:
    ffact_pairing_i32``), divided exactly by k!. Exact while g! / (g - k)!
    < 2^31."""
    d = d.to(torch.int32)
    if k == 1:
        return d
    t = d * (d - (k - 1))
    prod = t
    for i in range(1, k // 2):
        prod = prod * (t + i * (k - 1 - i))
    if k % 2:
        prod = prod * (d - (k - 1) // 2)
    return torch.div(prod, math.factorial(k), rounding_mode="floor")


def pairs_probe_plain(
    x: torch.Tensor,  # [n_pad * p_pad, F] int8, sequence-aligned rows
    *,
    k: int,
    p_pad: int,
    variant: str,
    plan,
    g: int = 0,
) -> torch.Tensor:
    """What each of kernel H's variants writes, ``[n_pad, n_pad]`` int32,
    under ``plan`` (``ops/pairs_cuda.py:mma_plan``'s ``MmaPlan``):

    - noop, loads, no_mma: zeros;
    - matmul: each pair of ``plan.tile``-sequence tiles' sum of match
      counts (``sum_{p, q} <x_ip, x_jq>`` over its sequences) at its corner
      entry ``K[bi s, bj s]`` and the mirror, modulo 2^32 as int32 (the
      kernel's int32 sums): the same whatever ranges of j chunks the plan
      splits the pair into. In the resident and windows layouts the sums
      of pair indices instead, ``(g + 1) d0 + d1`` over the even and odd
      windows q of the resident tile, the lower of the two (``g`` needed);
    - skeleton: ``S S^T`` with ``S_i = sum_p x_ip``, the match counts
      summed with weight d (modulo 2^32 likewise);
    - current: kernel A's counts; int32: the same through
      ``binom_ffact_i32``; both summed in the plan's partition.
    """
    n_pad = x.shape[0] // p_pad
    if variant in ("noop", "loads", "no_mma"):
        return torch.zeros((n_pad, n_pad), dtype=torch.int32, device=x.device)
    if variant in ("matmul", "skeleton"):
        s = plan.tile if variant == "matmul" else 1
        # the one-hot sums of each tile (or sequence): S_a . S_b sums the
        # match counts of a tile pair; exact in f64 (sums < 2^53)
        sums = x.reshape(n_pad // s, s * p_pad, -1).sum(1, dtype=torch.float64)
        other = sums
        if variant == "matmul" and plan.layout in ("resident", "windows"):
            if g < 1:
                raise ValueError("the paired layouts' matmul needs g")
            win = x.reshape(n_pad // s, s, p_pad, -1).to(torch.float64)
            other = (g + 1) * win[:, :, 0::2].sum((1, 2)) + win[:, :, 1::2].sum((1, 2))
        prod = sums @ other.T  # [streamed tile, resident tile]
        lower = torch.ones_like(prod, dtype=torch.bool).tril()
        prod = torch.where(lower, prod, prod.T).round().to(torch.int64).to(torch.int32)
        if variant == "skeleton":
            return prod
        out = torch.zeros((n_pad, n_pad), dtype=torch.int32, device=x.device)
        out[::s, ::s] = prod
        return out
    if variant == "current":
        return pairs_counts_plain(x, k=k, p_pad=p_pad, plan=plan)
    if variant == "int32":
        return pairs_counts_plain(
            x, k=k, p_pad=p_pad, plan=plan,
            weight=lambda d: binom_ffact_i32(d.round().to(torch.int32), k),
        )
    raise ValueError(f"unknown probe variant {variant!r}; one of {PROBE_VARIANTS}")
