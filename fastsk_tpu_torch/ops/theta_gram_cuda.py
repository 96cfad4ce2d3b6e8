"""Wrapper of the theta Gram kernel (``csrc/theta_gram.cu``).

The dense theta engine's count product ``sum_t C_t C_t^T`` on the card
for counts that fit u8 (``ops/gkm.py:theta_route``, route ``u8_wgmma``):
``u8_operand`` casts a batch's int32 counts ``[T, N, B]`` into the
kernel's operand, u8 ``[T, N, K_pad]`` with ``K_pad`` the buckets rounded
up to the kernel's 128-byte stage and the padding zero (rows 16-byte
aligned, so the tensor-memory accelerator can copy them);
``theta_gram_launch`` returns the full symmetric ``[N, N]`` int32 matrix,
computed over the upper triangle's tiles and mirrored. It replaces no TPU
kernel (the JAX package leaves the product to XLA). A CPU tensor takes the
plain version (``theta_gram_plain``, an int64 product); a CUDA tensor
launches the kernel or raises. The counter ``theta_gram_launch.launches``
(``utils/observe.py``) counts its launches.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.observe import count

K_TILE = 128  # bytes of k a stage of the kernel: the operand's rows pad to a multiple


def u8_operand(counts: torch.Tensor) -> torch.Tensor:
    """Counts ``[T, N, B]`` (each <= 255) as the kernel's operand: u8
    ``[T, N, K_pad]``, ``K_pad`` the least multiple of ``K_TILE`` >= B,
    the padding columns zero. One pass writes the counts' bytes where the
    bf16 route's cast wrote twice as many."""
    t, n, b = counts.shape
    out = torch.empty((t, n, -(-b // K_TILE) * K_TILE), dtype=torch.uint8, device=counts.device)
    out[..., b:].zero_()
    out[..., :b].copy_(counts)
    return out


def theta_gram_plain(c: torch.Tensor) -> torch.Tensor:
    """``sum_t C_t C_t^T`` of a u8 operand ``[T, N, K]`` as an int64 product,
    cast to int32 (the caller keeps every entry below 2^31)."""
    t, n, k = c.shape
    x = c.permute(1, 0, 2).reshape(n, t * k).to(torch.int64)
    return (x @ x.T).to(torch.int32)


def _check(c: torch.Tensor) -> None:
    if c.dtype != torch.uint8 or c.dim() != 3 or not c.is_contiguous():
        raise ValueError(f"theta Gram operand must be a contiguous u8 [T, N, K]; got "
                         f"{c.dtype} {tuple(c.shape)}")
    if c.shape[2] % K_TILE:
        raise ValueError(f"theta Gram operand rows must be a multiple of {K_TILE} bytes "
                         f"(u8_operand pads them); got {c.shape[2]}")


def theta_gram_launch(c: torch.Tensor) -> torch.Tensor:
    """``sum_t C_t C_t^T``, ``[N, N]`` int32, of a ``u8_operand`` ``[T, N,
    K_pad]``: the kernel on the card, the plain version on the CPU."""
    _check(c)
    if c.device.type == "cpu":
        return theta_gram_plain(c)
    t, n, k_pad = c.shape
    out = torch.empty((n, n), dtype=torch.int32, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.kernels().theta_gram_launch(c.data_ptr(), out.data_ptr(), n, t, k_pad,
                                                    stream)
    _build.check_launch(status, "theta_gram_launch")
    count("theta_gram_launch.launches")
    return out
