"""Wrappers of kernels A and H (``csrc/pairs.cu``).

``pairs_counts`` (kernel A) is the counterpart of
``fastsk_tpu/ops/pairs_pallas.py`` as the engine uses it
(``_pairs_full_device_jit``): one-hot windows in, the full symmetric
``[n_pad, n_pad]`` int32 count matrix out. ``pairs_probe`` (kernel H)
runs one of the cost-attribution variants of A's body
(``experiments/probe_pairs.py:make_kernel``) on the same operands. A CPU
tensor takes the plain version (``ops/pairs.py``); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .pairs import PROBE_VARIANTS, pairs_counts_plain, pairs_probe_plain

# one-hot widths (in 32-bit words) the kernel is instantiated for
KERNEL_WIDTHS = (*range(1, 17), 20, 24, 32, 48, 64, 96, 128)
_TILE_SMEM_BYTES = 96 * 1024  # j-tile budget: two blocks fit on one SM
_MAX_SMEM_BYTES = 227 * 1024


def padded_width(f: int) -> int:
    """The smallest kernel width (in bytes) that holds ``f`` one-hot bytes."""
    for w in KERNEL_WIDTHS:
        if 4 * w >= f:
            return 4 * w
    raise ValueError(
        f"one-hot width {f} exceeds kernel A's {4 * KERNEL_WIDTHS[-1]} bytes"
    )


def tile_sequences(n_pad: int, p_pad: int, width: int) -> int:
    """Sequences per side of a block's tile: the largest power of two <= 8
    that divides ``n_pad`` and whose j windows fit the shared budget."""
    seq_bytes = p_pad * width
    if seq_bytes + 36 * 4 > _MAX_SMEM_BYTES:
        raise ValueError(
            f"one sequence's windows ({p_pad} x {width} B) exceed shared memory"
        )
    s = 8
    while s > 1 and (n_pad % s or s * seq_bytes > _TILE_SMEM_BYTES):
        s //= 2
    return s


def _check_x(x: torch.Tensor, g: int, k: int, p_pad: int) -> None:
    if x.dim() != 2 or x.dtype != torch.int8:
        raise ValueError(f"x must be a 2-D int8 tensor; got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if p_pad % 8 or x.shape[0] % p_pad:
        raise ValueError(f"rows {x.shape[0]} must be a multiple of p_pad={p_pad} (a multiple of 8)")
    if not 1 <= k <= g <= 20:
        raise ValueError(f"need 1 <= k <= g <= 20; got g={g}, k={k}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernels A and H run on CUDA or CPU tensors, not {x.device}")


def _launch(fn, name: str, x: torch.Tensor, p_pad: int, k: int, *extra):
    """Pad ``x`` to its kernel width and launch ``fn`` on it; returns the
    ``[n_pad, n_pad]`` int32 output."""
    width = padded_width(x.shape[1])
    if width != x.shape[1]:
        x = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    n_pad = x.shape[0] // p_pad
    s = tile_sequences(n_pad, p_pad, width)
    out = torch.empty((n_pad, n_pad), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), out.data_ptr(), n_pad, p_pad, width // 4, k, s, *extra, stream)
    _build.check_launch(status, name)
    return out


def pairs_counts(x: torch.Tensor, *, g: int, k: int, p_pad: int) -> torch.Tensor:
    """Full symmetric exact count matrix ``[n_pad, n_pad]`` int32 from
    sequence-aligned one-hot windows ``x [n_pad * p_pad, F]`` int8."""
    _check_x(x, g, k, p_pad)
    if x.device.type == "cpu":
        return pairs_counts_plain(x, k=k, p_pad=p_pad)
    out = _launch(_build.kernels().pairs_counts_launch, "pairs_counts", x, p_pad, k)
    pairs_counts.launches += 1
    return out


PROBE_WIDTHS = (10, 16)  # kernel H's instances, in 32-bit words


def pairs_probe(
    x: torch.Tensor, *, g: int, k: int, p_pad: int, variant: str
) -> torch.Tensor:
    """Kernel H: ``variant`` (one of ``PROBE_VARIANTS``) of kernel A's body
    on kernel A's operands, ``[n_pad, n_pad]`` int32; see
    ``ops/pairs.py:pairs_probe_plain`` for what each variant writes."""
    _check_x(x, g, k, p_pad)
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}; one of {PROBE_VARIANTS}")
    if variant == "int32" and 8 * math.perm(g, k) >= 2**31:
        raise ValueError(f"g!/(g-k)! = {math.perm(g, k)}: 8 of them exceed int32")
    width = padded_width(x.shape[1])
    if x.device.type == "cpu":
        tile = tile_sequences(x.shape[0] // p_pad, p_pad, width)
        return pairs_probe_plain(x, k=k, p_pad=p_pad, variant=variant, tile=tile)
    if width // 4 not in PROBE_WIDTHS:
        raise ValueError(
            f"kernel H is built for widths {PROBE_WIDTHS} words, not {width // 4}"
        )
    out = _launch(
        _build.kernels().pairs_probe_launch, "pairs_probe", x, p_pad, k,
        PROBE_VARIANTS.index(variant),
    )
    pairs_probe.launches += 1
    return out


# kernel launches; the CPU path does not count
pairs_counts.launches = 0
pairs_probe.launches = 0
