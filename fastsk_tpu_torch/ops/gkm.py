"""Dense-bucket counting passes of the theta engine, in PyTorch.

Counterpart of ``fastsk_tpu/ops/gkm.py``. For one position subset theta
(k kept positions out of g) the partial kernel is

    K_theta = C_theta @ C_theta.T

where ``C_theta[n, b]`` counts the windows of sequence ``n`` whose
projected k-mer hashes to ``b = h1 * B2 + h2`` (``B1 = base^ceil(k/2)``,
``B2 = base^floor(k/2)``, the JAX package's split and bucket layout).

The JAX package builds ``C`` with one-hot matmuls shaped for the TPU's
matrix unit. On the card the natural form is a scatter-add of int32 ones
at ``(t * N + n) * B + b``: integer-equal counts, with the row chunk
bounding the index tensors as it bounds the JAX one-hot intermediates. A
theta batch's sum ``sum_t C_t C_t^T`` is one matrix product over the
batch's concatenated buckets.

Exactness: every product runs on integer-valued operands, by the route
``theta_route`` picks from what the engine observes. On the card without a
mesh, counts up to 255 take the hand-written u8 kernel
(``ops/theta_gram_cuda.py``, route ``u8_wgmma``: s32 sums, int32 out,
exact below 2^31). Otherwise the operand dtype is ``matmul_dtype``'s:
bf16 holds counts up to 256 exactly and runs with f32 outputs (never bf16
ones: ``torch.mm(..., out_dtype=torch.float32)``), f32 runs in full f32
(no TF32, ``ops/pairs.py:full_f32_matmul``), and both are exact while
every sum stays below 2^24 — the engine caps the batch at ``theta_batch *
p_max^2 < 2^24`` (``fastsk_tpu/kernel/engine.py:101-116``). Beyond 4095
windows a sequence the JAX package splits counts into 8-bit digits; here
one f64 product is exact below 2^53, and the engine keeps the batch below
2^31. ``gram`` stays the product of the sorted engine's slabs and of the
meshes' row blocks, whose operands are neither square nor bounded by 255.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.observe import count
from .pairs import full_f32_matmul
from .theta_gram_cuda import theta_gram_launch, u8_operand

# Peak bytes a (window, theta) of one row chunk in ``_counts_for_batch``:
# the two int32 level hashes, the int32 bucket and ones, and the int64
# scatter index with its flattened copy.
HASH_BYTES = 32


def window_matrix(ids: torch.Tensor, g: int) -> torch.Tensor:
    """Sliding g-windows: ``[N, L]`` -> ``[N, P, g]`` (a view), ``P = L - g + 1``."""
    return ids.unfold(1, g, 1)


def split_k(k: int) -> Tuple[int, int]:
    """Split k positions into the two hash levels (k1 >= k2)."""
    k2 = k // 2
    return k - k2, k2


def matmul_dtype(p_max: int, device: torch.device) -> torch.dtype:
    """Operand dtype of the count products for at most ``p_max`` windows a
    sequence: f64 past 4095 (the JAX package's count split), bf16 with f32
    outputs on the card while counts fit bf16 (<= 256, the JAX package's
    bf16 count dtype), f32 otherwise (the CPU has no bf16 -> f32 product)."""
    if p_max > 4095:
        return torch.float64
    if p_max <= 256 and device.type == "cuda":
        return torch.bfloat16
    return torch.float32


U8_ROUTE = "u8_wgmma"
ROUTE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
_DTYPE_ROUTES = {dt: name for name, dt in ROUTE_DTYPES.items()}


def theta_route(p_max: int, device, mesh: bool = False) -> str:
    """The dense engine's count-product route for at most ``p_max`` windows
    a sequence: ``u8_wgmma`` on the card without a mesh while every count
    fits u8 (<= 255), else the name of ``matmul_dtype``'s operand dtype
    (``bf16``, ``f32`` or ``f64``)."""
    device = torch.device(device)
    if device.type == "cuda" and p_max <= 255 and not mesh:
        return U8_ROUTE
    return _DTYPE_ROUTES[matmul_dtype(p_max, device)]


def theta_operand(counts: torch.Tensor, route: str) -> torch.Tensor:
    """A ``[T, N, B]`` int32 count batch as ``theta_gram``'s operand: the
    u8 kernel's padded ``[T, N, K_pad]``, or the counts in the route's
    dtype."""
    if route == U8_ROUTE:
        return u8_operand(counts)
    return counts.to(ROUTE_DTYPES[route])


def theta_gram(c: torch.Tensor, route: str) -> torch.Tensor:
    """Exact int32 ``sum_t C_t C_t^T`` of a ``theta_operand`` ``[T, N, ·]``,
    the dense engine's own product: the u8 kernel, or one ``gram`` over the
    batch's concatenated buckets (``f64`` past 4095 windows a sequence,
    where the JAX package's 8-bit digit grams give the same integers). The
    caller keeps every sum below 2^24 (bf16, f32) or 2^31 (u8, f64).
    Counts ``theta_gram.routes.<route>`` by the batch's subsets."""
    count(f"theta_gram.routes.{route}", c.shape[0])
    if route == U8_ROUTE:
        return theta_gram_launch(c)
    rows = batch_rows(c, c.dtype)
    return gram(rows, rows).to(torch.int32)


def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` for integer-valued operands of one dtype: bf16 operands
    give f32 outputs; f32 runs without TF32; f64 stays f64."""
    if a.dtype == torch.bfloat16:
        return torch.mm(a, b.T, out_dtype=torch.float32)
    with full_f32_matmul():
        return a @ b.T


def theta_hashes(
    windows: torch.Tensor,  # [N, P, g] int32
    thetas: torch.Tensor,  # [T, k] int64 position subsets
    base: int,
    code_min: int,
    k1: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positional hashes ``(H1, H2)`` ``[T, N, P]`` int32 of the projected
    k-mers in base ``base`` over digits ``code - code_min``, least
    significant digit first within each level, as the JAX package's: the
    projected k-mer value is ``H1 * base^k2 + H2``. Padding windows hash to
    whatever their codes give; ``histogram_counts`` masks them."""
    k = thetas.shape[1]
    h1 = h2 = None
    for j in range(k):
        digit = (windows[:, :, thetas[:, j]] - code_min) * (base ** (j if j < k1 else j - k1))
        if j < k1:
            h1 = digit if h1 is None else h1 + digit
        else:
            h2 = digit if h2 is None else h2 + digit
    if h2 is None:
        h2 = torch.zeros_like(h1)
    return h1.permute(2, 0, 1), h2.permute(2, 0, 1)


def histogram_counts(
    h1: torch.Tensor,  # [T, N, P] int32
    h2: torch.Tensor,  # [T, N, P] int32
    valid: torch.Tensor,  # [N, P] bool — window inside sequence bounds
    b1: int,
    b2: int,
) -> torch.Tensor:
    """Per-sequence k-mer counts ``C [T, N, b1 * b2]`` int32: a scatter-add
    of each valid window's 1 at its bucket (invalid windows add 0 at bucket
    0), integer-equal to the JAX package's one-hot contraction."""
    t, n, p = h1.shape
    b = b1 * b2
    bucket = torch.where(valid, h1 * b2 + h2, 0)
    row = torch.arange(t * n, device=h1.device).view(t, n, 1) * b
    ones = valid.to(torch.int32).expand(t, n, p)
    out = torch.zeros(t * n * b, dtype=torch.int32, device=h1.device)
    out.scatter_add_(0, (row + bucket).reshape(-1), ones.reshape(-1))
    return out.view(t, n, b)


def _counts_for_batch(
    ids: torch.Tensor,  # [N, L] int32
    lengths: torch.Tensor,  # [N]
    thetas: torch.Tensor,  # [T, k] int64
    *,
    g: int,
    base: int,
    code_min: int,
    k1: int,
    b1: int,
    b2: int,
    row_chunk: int,
) -> torch.Tensor:
    """Counts ``[T, N, B]`` int32 for a theta batch, built ``row_chunk``
    sequences at a time, which bounds the hash and index tensors
    (``row_chunk * P * T * HASH_BYTES`` bytes) independently of N."""
    n, length = ids.shape
    p = length - g + 1
    windows = window_matrix(ids, g)
    pos = torch.arange(p, device=ids.device)
    valid = pos[None, :] <= (lengths[:, None] - g)
    out = torch.empty((thetas.shape[0], n, b1 * b2), dtype=torch.int32, device=ids.device)
    for r0 in range(0, n, row_chunk):
        r1 = min(r0 + row_chunk, n)
        h1, h2 = theta_hashes(windows[r0:r1], thetas, base, code_min, k1)
        out[:, r0:r1] = histogram_counts(h1, h2, valid[r0:r1], b1, b2)
    return out


def batch_rows(counts: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A ``[T, N, B]`` count batch as the ``[N, T * B]`` operand of its
    batch product (the batch's buckets side by side), in ``dtype``."""
    t, n, b = counts.shape
    return counts.permute(1, 0, 2).reshape(n, t * b).to(dtype)


def exact_batch_update(
    k_acc: torch.Tensor,  # [N, N] int32 accumulator, updated in place
    ids: torch.Tensor,
    lengths: torch.Tensor,
    thetas: torch.Tensor,  # [T, k]
    *,
    g: int,
    base: int,
    code_min: int,
    k1: int,
    b1: int,
    b2: int,
    row_chunk: int,
    route: str,
) -> torch.Tensor:
    """``k_acc += sum_t C_t @ C_t.T`` for one theta batch by ``route``
    (``theta_route``; exact integers; in place, where the JAX function
    returns a new array)."""
    counts = _counts_for_batch(
        ids, lengths, thetas, g=g, base=base, code_min=code_min, k1=k1,
        b1=b1, b2=b2, row_chunk=row_chunk,
    )
    return k_acc.add_(theta_gram(theta_operand(counts, route), route))


def welford_partial(ks_int: torch.Tensor, mean: torch.Tensor, it_new: torch.Tensor, *,
                    row0: int, n_train: int):
    """The Welford update of one kernel row block (rows ``row0`` on) for
    one pass: ``(new_mean, its share of the train-triangle sum)``. The
    share reads the block's train rows against the train columns, its
    diagonal entries counted twice, halved: summed over the row blocks it
    is the reference's sum over packed train pairs."""
    ks = ks_int.to(torch.float32)
    delta = ks - mean
    new_mean = mean + delta / it_new.to(torch.float32)
    # the statistic reads the train block only: delta2 is formed there
    nt = n_train
    nr = max(0, min(ks.shape[0], nt - row0))
    prod = delta[:nr, :nt] * (ks[:nr, :nt] - new_mean[:nr, :nt])
    return new_mean, (prod.sum() + torch.diagonal(prod, offset=row0).sum()) / 2.0


def welford_finish(tri_sum: torch.Tensor, it_new: torch.Tensor, done: torch.Tensor, *,
                   n_train: int, conv_delta: float, max_iters: int):
    """The stop rule on the whole train-triangle sum: ``(sd, new_done)``."""
    # average over the packed triangular train pairs (diagonal included),
    # the reference's n_train_pairs loop bound
    tri_count = n_train * (n_train + 1) / 2.0
    avg_var = tri_sum / tri_count
    avg_var = torch.where(it_new == 1, 9999999.0, avg_var / torch.clamp(it_new - 1, min=1))
    sd = torch.sqrt(avg_var / it_new)
    converged = conv_delta / sd > 1.96
    hit_max = max_iters != -1 and (it_new >= max_iters)
    return sd, done | converged | hit_max


def welford_step(state, ks_int: torch.Tensor, *, n_train: int, conv_delta: float,
                 max_iters: int):
    """One Monte-Carlo iteration of the reference stop rule
    (fastsk_kernel.cpp:108-143, 243-262), on device tensors, masked once
    ``done``: ``fastsk_tpu/ops/gkm.py:approx_batch_update``'s scan step
    (with variance tracking, the only form its engine runs) and
    ``fastsk_tpu/kernel/sorted_engine.py:_welford_step`` op for op.

    State is ``(k_sum int32 [N, N], mean f32 [N, N], it int32 [], done
    bool [])``; ``ks_int`` is the pass's exact int32 kernel, summed into
    ``k_sum``; its f32 copy feeds the statistics, as in the JAX package.
    Returns ``(state, sd)``, sd NaN for a masked iteration.
    """
    k_sum, mean, it, done = state
    it_new = it + 1
    new_mean, tri_sum = welford_partial(ks_int, mean, it_new, row0=0, n_train=n_train)
    sd, new_done = welford_finish(tri_sum, it_new, done, n_train=n_train,
                                  conv_delta=conv_delta, max_iters=max_iters)
    # masked update: once done, this theta never happened
    k_sum = torch.where(done, k_sum, k_sum + ks_int)
    mean = torch.where(done, mean, new_mean)
    it = torch.where(done, it, it_new)
    sd = torch.where(done, float("nan"), sd)
    return (k_sum, mean, it, new_done), sd


def approx_batch_update(
    state,
    ids: torch.Tensor,
    lengths: torch.Tensor,
    thetas: torch.Tensor,  # [T, k]
    *,
    g: int,
    base: int,
    code_min: int,
    k1: int,
    b1: int,
    b2: int,
    row_chunk: int,
    route: str,
    n_train: int,
    conv_delta: float,
    max_iters: int,
):
    """One theta batch of Monte-Carlo sampling with the reference stop rule.

    The batch's counts are built at once, then each theta in stream order
    takes a ``welford_step`` on the device, with no host sync: once done,
    the batch's remaining thetas are masked no-ops, so the iterations
    consumed equal a batch-size-1 run's. ``k_sum`` is the exact integer
    sum (the approx kernel); the Welford mean and variance are f32.

    Each theta's product is ``theta_gram`` by ``route``.

    Returns ``(state, sds)``, ``sds [T]`` f32 the per-iteration sd trace
    (NaN for masked iterations).
    """
    c = theta_operand(_counts_for_batch(
        ids, lengths, thetas, g=g, base=base, code_min=code_min, k1=k1,
        b1=b1, b2=b2, row_chunk=row_chunk,
    ), route)
    sds = []
    for t in range(c.shape[0]):
        state, sd = welford_step(
            state, theta_gram(c[t : t + 1], route), n_train=n_train, conv_delta=conv_delta,
            max_iters=max_iters,
        )
        sds.append(sd)
    return state, torch.stack(sds)
