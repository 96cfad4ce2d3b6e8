"""Wrappers of kernels A and H (``csrc/pairs.cu``).

``pairs_counts`` (kernel A) is the counterpart of
``fastsk_tpu/ops/pairs_pallas.py`` as the engine uses it
(``_pairs_full_device_jit``): one-hot windows in, the full symmetric
``[n_pad, n_pad]`` int32 count matrix out. Its body counts the matches on
the int8 tensor cores at every shape, in one of four layouts that
``mma_plan`` picks from the shape (``MmaPlan``); ``body="dp4a"`` runs the
``__dp4a`` body (``pairs_kernel``) instead, where its tile fits (the
phase-3 body sweep of ``chip_smoke.py``), and the counters
``pairs_counts.launches`` and ``pairs_counts.bodies.<body>``
(``utils/observe.py``) count its launches and each body's. ``pairs_probe`` (kernel H) runs one of the
cost-attribution variants of the tensor-core body
(``experiments/probe_pairs.py:make_kernel``) on the same operands, in the
layout kernel A takes. A CPU tensor takes the plain version
(``ops/pairs.py``, following the plan's partition); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import _build
from ..utils.observe import count
from .pairs import PROBE_VARIANTS, pairs_counts_plain, pairs_probe_plain

_CURRENT = PROBE_VARIANTS.index("current")  # kernel A's own variant of its body

# one-hot widths (in 32-bit words) the dp4a body is instantiated for
KERNEL_WIDTHS = (*range(1, 17), 20, 24, 32, 48, 64, 96, 128)
_TILE_SMEM_BYTES = 96 * 1024  # j-tile budget: two blocks fit on one SM
_MAX_SMEM_BYTES = 227 * 1024


def padded_width(f: int) -> int:
    """The smallest dp4a-body width (in bytes) that holds ``f`` one-hot bytes."""
    for w in KERNEL_WIDTHS:
        if 4 * w >= f:
            return 4 * w
    raise ValueError(
        f"one-hot width {f} exceeds the dp4a body's {4 * KERNEL_WIDTHS[-1]} bytes"
    )


def tile_sequences(n_pad: int, p_pad: int, width: int) -> int:
    """Sequences per side of a dp4a block's tile: the largest power of two
    <= 8 that divides ``n_pad`` and whose j windows fit the shared budget."""
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


MMA_CHUNK = 128  # window rows of a chunk
MMA_SLAB = 64  # bytes of a k-slab in the depth and slabs layouts
MMA_LAYOUTS = ("resident", "windows", "depth", "slabs")  # in the order of the C entry point
# the depth layout's ring: 4 i slabs; the slabs layout's: 6 slab pairs
# (csrc/pairs.cu:Ring); each 1 KB aligned in shared memory
_DEPTH_RING_BYTES = 1024 + 4 * MMA_CHUNK * MMA_SLAB
_SLABS_RING_BYTES = 1024 + 6 * 2 * MMA_CHUNK * MMA_SLAB
_BLOCK_BYTES = 113 * 1024  # a block's share when two fit an SM
_WINDOWS_MIN_CHUNKS = 4  # the windows layout takes two blocks an SM from 4 j chunks each
_DEEP_BLOCKS = 8 * 132  # depth and slabs split tile pairs into ranges up to 8 blocks an SM


class MmaPlan(NamedTuple):
    """How kernel A's tensor-core body covers a shape (``mma_plan``)."""

    layout: str  # "resident", "windows", "depth" or "slabs"
    tile: int  # sequences a tile side
    range_chunks: int  # 128-row j chunks a block holds or walks (all of a tile's, resident)
    ranges: int  # blocks a tile pair
    slab: int  # bytes of depth a step multiplies (the whole depth but in "depth", "slabs")
    smem: int  # shared memory a block, bytes
    blocks: int  # the grid


def _bins_bytes(s: int) -> int:
    return (s * s + 32) * 4


def _chunks_smem(s: int, chunks: int, depth: int) -> int:
    """A resident or windows block's shared memory
    (``csrc/pairs.cu:mma_smem_bytes``): ``chunks`` j chunks, two streamed i
    chunks, the s x s bins and the C(d, k) table."""
    return (chunks + 2) * MMA_CHUNK * depth + _bins_bytes(s)


def mma_plan(n_pad: int, p_pad: int, depth: int) -> MmaPlan:
    """Kernel A's layout at ``n_pad`` sequences of ``p_pad`` windows of
    ``depth`` bytes (a multiple of 64). The kernel library refuses a plan
    whose block does not fit, so this rule is the only one.

    - resident: a tile's j windows stay in shared memory; the tile side is
      the largest power of two <= 8 dividing ``n_pad`` whose block fits
      two to an SM, else 1 where one sequence's block fits the SM alone;
    - windows: one sequence a tile, and a block holds a range of its j
      chunks (two blocks an SM where each holds at least 4 chunks, else
      one), ranges as even as the chunk count allows;
    - depth: where not even one j chunk and two i chunks fit at full
      depth, a block holds one j chunk at full depth and streams the i
      chunks past it in 64-byte k-slabs; tiles of up to 8 sequences,
      split into ranges of j chunks until the grid has about 8 blocks an
      SM;
    - slabs: where one j chunk does not fit at full depth either, both
      operands stream in k-slabs; tiles and ranges as in depth.

    Raises where the grid would pass the launch limit (2^31 - 1 blocks)."""

    def plan(layout: str, s: int, rc: int, slab: int, smem: int) -> MmaPlan:
        nc = -(-s * p_pad // MMA_CHUNK)
        nr = -(-nc // rc)
        nt = n_pad // s
        blocks = nt * (nt + 1) // 2 * nr
        if blocks > 2**31 - 1:
            raise ValueError(f"kernel A's grid of {blocks} blocks exceeds the launch limit")
        return MmaPlan(layout, s, rc, nr, slab, smem, blocks)

    for s in (8, 4, 2, 1):
        nc = -(-s * p_pad // MMA_CHUNK)
        if n_pad % s == 0 and _chunks_smem(s, nc, depth) <= _BLOCK_BYTES:
            return plan("resident", s, nc, depth, _chunks_smem(s, nc, depth))
    nc = -(-p_pad // MMA_CHUNK)
    if _chunks_smem(1, nc, depth) <= _MAX_SMEM_BYTES:
        return plan("resident", 1, nc, depth, _chunks_smem(1, nc, depth))
    fit2 = (_BLOCK_BYTES - _bins_bytes(1)) // (MMA_CHUNK * depth) - 2
    fit1 = (_MAX_SMEM_BYTES - _bins_bytes(1)) // (MMA_CHUNK * depth) - 2
    fit = fit2 if fit2 >= _WINDOWS_MIN_CHUNKS else fit1
    if fit >= 1:
        rc = -(-nc // -(-nc // fit))
        return plan("windows", 1, rc, depth, _chunks_smem(1, rc, depth))
    s = next(t for t in (8, 4, 2, 1) if n_pad % t == 0)
    nc = -(-s * p_pad // MMA_CHUNK)
    nt = n_pad // s
    nr = min(nc, max(1, -(-_DEEP_BLOCKS // (nt * (nt + 1) // 2))))
    smem = _DEPTH_RING_BYTES + MMA_CHUNK * depth + _bins_bytes(s)
    if smem <= _MAX_SMEM_BYTES:
        return plan("depth", s, -(-nc // nr), MMA_SLAB, smem)
    return plan("slabs", s, -(-nc // nr), MMA_SLAB, _SLABS_RING_BYTES + _bins_bytes(s))


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


def _launch_dp4a(x: torch.Tensor, p_pad: int, k: int):
    """Pad ``x`` to its dp4a-body width and launch the body; returns the
    ``[n_pad, n_pad]`` int32 output."""
    width = padded_width(x.shape[1])
    if width != x.shape[1]:
        x = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    n_pad = x.shape[0] // p_pad
    s = tile_sequences(n_pad, p_pad, width)
    out = torch.empty((n_pad, n_pad), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.kernels().pairs_counts_launch(
            x.data_ptr(), out.data_ptr(), n_pad, p_pad, width // 4, k, s, stream
        )
    _build.check_launch(status, "pairs_counts")
    return out


def _launch_mma(x: torch.Tensor, p_pad: int, k: int, variant: int, name: str):
    """Pad ``x`` to its tensor-core depth and launch the body's ``variant``
    (an index of ``PROBE_VARIANTS``; "current" gives the counts) in
    ``mma_plan``'s layout; returns the ``[n_pad, n_pad]`` int32 output
    (zeroed first where blocks add into it)."""
    depth = mma_depth(x.shape[1])
    n_pad = x.shape[0] // p_pad
    plan = mma_plan(n_pad, p_pad, depth)
    if depth != x.shape[1]:
        x = torch.nn.functional.pad(x, (0, depth - x.shape[1]))
    alloc = torch.empty if plan.layout == "resident" else torch.zeros
    out = alloc((n_pad, n_pad), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.kernels().pairs_mma_launch(
            x.data_ptr(), out.data_ptr(), n_pad, p_pad, depth, k, plan.tile,
            plan.range_chunks, MMA_LAYOUTS.index(plan.layout), variant, stream,
        )
    _build.check_launch(status, name)
    return out


def pairs_counts(x: torch.Tensor, *, g: int, k: int, p_pad: int, body=None) -> torch.Tensor:
    """Full symmetric exact count matrix ``[n_pad, n_pad]`` int32 from
    sequence-aligned one-hot windows ``x [n_pad * p_pad, F]`` int8
    (``F = g * alpha``): the tensor-core body ("mma", the default) or,
    asked for, the dp4a body ("dp4a", where its tile fits). On the CPU the
    plain version, partitioned as the tensor-core body's plan (the dp4a
    body's: unpartitioned)."""
    _check_x(x, g, k, p_pad)
    if body not in (None, "mma", "dp4a"):
        raise ValueError(f"body must be 'mma' or 'dp4a'; got {body!r}")
    body = body or "mma"
    if x.device.type == "cpu":
        plan = None
        if body == "mma":
            plan = mma_plan(x.shape[0] // p_pad, p_pad, mma_depth(x.shape[1]))
        return pairs_counts_plain(x, k=k, p_pad=p_pad, plan=plan)
    if body == "mma":
        out = _launch_mma(x, p_pad, k, _CURRENT, "pairs_counts")
    else:
        out = _launch_dp4a(x, p_pad, k)
    count("pairs_counts.launches")
    count(f"pairs_counts.bodies.{body}")
    return out


def pairs_probe(
    x: torch.Tensor, *, g: int, k: int, p_pad: int, variant: str
) -> torch.Tensor:
    """Kernel H: ``variant`` (one of ``PROBE_VARIANTS``) of kernel A's
    tensor-core body on kernel A's operands, in the layout ``mma_plan``
    gives them, ``[n_pad, n_pad]`` int32; see
    ``ops/pairs.py:pairs_probe_plain`` for what each variant writes.
    "int32" refuses where a lane's flush of 16 falling factorials
    g!/(g-k)! could pass int32."""
    _check_x(x, g, k, p_pad)
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}; one of {PROBE_VARIANTS}")
    if variant == "int32" and 16 * math.perm(g, k) >= 2**31:
        raise ValueError(f"g!/(g-k)! = {math.perm(g, k)}: 16 of them exceed int32")
    if x.device.type == "cpu":
        plan = mma_plan(x.shape[0] // p_pad, p_pad, mma_depth(x.shape[1]))
        return pairs_probe_plain(x, k=k, p_pad=p_pad, variant=variant, plan=plan)
    out = _launch_mma(x, p_pad, k, PROBE_VARIANTS.index(variant), "pairs_probe")
    count("pairs_probe.launches")  # the CPU path does not count
    return out
