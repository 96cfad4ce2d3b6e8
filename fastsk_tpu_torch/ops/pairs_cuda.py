"""Wrappers of kernels A and H (``csrc/pairs.cu``).

``pairs_counts`` (kernel A) is the counterpart of
``fastsk_tpu/ops/pairs_pallas.py`` as the engine uses it
(``_pairs_full_device_jit``): one-hot windows in, the full symmetric
``[n_pad, n_pad]`` int32 count matrix out. It has two bodies: "mma", the
match counts on the int8 tensor cores (``pairs_mma_kernel``),
wherever its tile fits, and "dp4a" (``pairs_kernel``) elsewhere;
``pairs_body`` chooses and ``pairs_counts.bodies`` counts each body's
launches. ``pairs_probe`` (kernel H) runs one of the cost-attribution
variants of the dp4a body (``experiments/probe_pairs.py:make_kernel``) on
the same operands; ``pairs_mma_parts`` times the parts of the mma body. A
CPU tensor takes the plain version (``ops/pairs.py``); a CUDA tensor
launches the kernel or raises.
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


def mma_depth(f: int) -> int:
    """Bytes a one-hot row of ``f`` bytes takes in the tensor-core body:
    ``f`` rounded up to 64 (two k-steps of the int8 wgmma); the padding
    bytes are zero and add no matches."""
    return -(-f // 64) * 64


def mma_tile_sequences(n_pad: int, p_pad: int, depth: int) -> int:
    """Sequences per side of a tensor-core block's tile, as the kernel
    library sizes it (``csrc/pairs.cu:mma_tile``, which alone knows the
    block's shared-memory layout): the largest power of two <= 8 dividing
    ``n_pad`` whose block fits two to an SM; else 1 where one sequence's
    block fits the SM alone; else 0. Needs the built library (the card)."""
    return int(_build.kernels().pairs_mma_tile(n_pad, p_pad, depth))


def pairs_body(n_pad: int, p_pad: int, f: int) -> str:
    """Kernel A's body for ``n_pad`` sequences of ``p_pad`` windows of
    ``f`` one-hot bytes: "mma" (the int8 tensor-core product of one-hot
    rows) wherever its tile fits, else "dp4a". The tensor-core body beat
    the dp4a body at every one-hot depth that chip_smoke.py's phase-3
    sweep times (64 to 448 bytes, the deepest whose tile fits at p_pad =
    200; NVIDIA H100 80GB HBM3, 700 W)."""
    return "mma" if mma_tile_sequences(n_pad, p_pad, mma_depth(f)) >= 1 else "dp4a"


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


def _launch_mma(x: torch.Tensor, p_pad: int, k: int, variant: int):
    """Pad ``x`` to its tensor-core depth and launch the body's ``variant``
    (0: the counts); returns the ``[n_pad, n_pad]`` int32 output."""
    depth = mma_depth(x.shape[1])
    n_pad = x.shape[0] // p_pad
    if mma_tile_sequences(n_pad, p_pad, depth) < 1:
        raise ValueError(
            f"one sequence's windows ({p_pad} x {depth} B) exceed the tensor-core tile"
        )
    if depth != x.shape[1]:
        x = torch.nn.functional.pad(x, (0, depth - x.shape[1]))
    out = torch.empty((n_pad, n_pad), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.kernels().pairs_mma_launch(
            x.data_ptr(), out.data_ptr(), n_pad, p_pad, depth, k, variant, stream
        )
    _build.check_launch(status, "pairs_counts")
    return out


def pairs_counts(x: torch.Tensor, *, g: int, k: int, p_pad: int, body=None) -> torch.Tensor:
    """Full symmetric exact count matrix ``[n_pad, n_pad]`` int32 from
    sequence-aligned one-hot windows ``x [n_pad * p_pad, F]`` int8
    (``F = g * alpha``). ``body`` ("mma" or "dp4a") overrides
    ``pairs_body``'s choice."""
    _check_x(x, g, k, p_pad)
    if body not in (None, "mma", "dp4a"):
        raise ValueError(f"body must be 'mma' or 'dp4a'; got {body!r}")
    if x.device.type == "cpu":
        return pairs_counts_plain(x, k=k, p_pad=p_pad)
    if body is None:
        body = pairs_body(x.shape[0] // p_pad, p_pad, x.shape[1])
    if body == "mma":
        out = _launch_mma(x, p_pad, k, 0)
    else:
        out = _launch(_build.kernels().pairs_counts_launch, "pairs_counts", x, p_pad, k)
    pairs_counts.launches += 1
    pairs_counts.bodies[body] += 1
    return out


MMA_PARTS = ("current", "no_epilogue", "no_mma", "loads")


def pairs_mma_parts(
    x: torch.Tensor, *, g: int, k: int, p_pad: int, variant: str
) -> torch.Tensor:
    """One launch of a variant of kernel A's tensor-core body on the card,
    to time its parts (``MMA_PARTS``: the body itself; without the
    epilogue; without the wgmma loop; loads and writes only). Only
    "current" gives the count matrix. Not counted in ``pairs_counts``."""
    _check_x(x, g, k, p_pad)
    if variant not in MMA_PARTS:
        raise ValueError(f"unknown part {variant!r}; one of {MMA_PARTS}")
    if x.device.type != "cuda":
        raise ValueError("the tensor-core body's parts are timed on the card only")
    return _launch_mma(x, p_pad, k, MMA_PARTS.index(variant))


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
pairs_counts.bodies = {"mma": 0, "dp4a": 0}  # launches of each body
pairs_probe.launches = 0
