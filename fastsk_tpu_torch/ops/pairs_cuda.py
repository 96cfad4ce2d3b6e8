"""Wrappers of kernels A and H (``csrc/pairs.cu``).

``pairs_counts`` (kernel A) is the counterpart of
``fastsk_tpu/ops/pairs_pallas.py`` as the engine uses it
(``_pairs_full_device_jit``): one-hot windows in, the full symmetric
``[n_pad, n_pad]`` int32 count matrix out. Its body counts the matches on
the int8 tensor cores at every shape, in one of four layouts that
``mma_plan`` picks from the shape (``MmaPlan``); ``body="dp4a"`` runs the
``__dp4a`` body (``pairs_kernel``) instead, where its tile fits (the
phase-3 body sweep of ``chip_smoke.py``), and the counters
``pairs_counts.launches``, ``pairs_counts.bodies.<body>`` and
``pairs_counts.layouts.<layout>`` (``utils/observe.py``; the tensor-core
body's layout, "resident" and "windows" being its persistent loop,
``pairs_ws_kernel``) count its launches, each body's and each layout's.
``pairs_probe`` (kernel H) runs one of the
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


def ws_depth(f: int) -> int:
    """Bytes a one-hot row of ``f`` bytes takes in the resident and windows
    layouts: ``f`` rounded up to 32 (one k-step of the int8 wgmma); the
    padding bytes are zero and add no matches."""
    return -(-f // 32) * 32


MMA_CHUNK = 128  # window rows of a chunk
MMA_SLAB = 64  # bytes of a k-slab in the depth and slabs layouts
MMA_LAYOUTS = ("resident", "windows", "depth", "slabs")  # in the order of the C entry point
MMA_EPILOGUES = ("one", "two", "runs")  # pairs_ws_kernel's, in the order of the C entry point
# the depth layout's ring: 4 i slabs; the slabs layout's: 6 slab pairs
# (csrc/pairs.cu:Ring); each 1 KB aligned in shared memory
_DEPTH_RING_BYTES = 1024 + 4 * MMA_CHUNK * MMA_SLAB
_SLABS_RING_BYTES = 1024 + 6 * 2 * MMA_CHUNK * MMA_SLAB
_DEEP_BLOCKS = 8 * 132  # depth and slabs split tile pairs into ranges up to 8 blocks an SM
_SMS = 132  # the H100's SMs: the resident and windows layouts' grid, one block each
_WS_STAGES = (3, 4)  # the fewest and the most i chunks in their ring
_WS_LAST_STAGES = 2  # one sequence a tile's fewest, where 3 leave no room for a chunk
_WS_TILE_ROWS = 2048  # a resident tile of several sequences holds at most 16 i chunks


class MmaPlan(NamedTuple):
    """How kernel A's tensor-core body covers a shape (``mma_plan``)."""

    layout: str  # "resident", "windows", "depth" or "slabs"
    tile: int  # sequences a tile side
    range_chunks: int  # 128-row j chunks a block holds or walks (all of a tile's, resident; paired
    # rows, two windows a row, in the resident and windows layouts)
    ranges: int  # j ranges a tile pair
    slab: int  # bytes of depth a step multiplies (the whole row but in "depth", "slabs")
    smem: int  # shared memory a block, bytes
    blocks: int  # the grid (on 132 SMs)
    stages: int = 0  # the resident and windows layouts' ring of i chunks
    epilogue: str = ""  # their epilogue (``mma_epilogue``)


def _bins_bytes(s: int) -> int:
    return (s * s + 32) * 4


def _ws_smem(s: int, chunks: int, stages: int, depth: int, g: int) -> int:
    """A resident or windows block's shared memory
    (``csrc/pairs.cu:ws_smem_bytes``): ``chunks`` resident j chunks,
    ``stages`` streamed i chunks, the pair table (a copy a lane of
    C(d0, k) + C(d1, k), d0, d1 <= g), two sets of s x s bins and the
    ring's and the strip's mbarriers."""
    return ((chunks + stages) * MMA_CHUNK * depth + (g + 1) ** 2 * 32 * 4 + 2 * s * s * 4
            + (2 * stages + 2) * 8)


def _ws_stages(s: int, chunks: int, depth: int, g: int) -> int:
    """The most ring stages (up to 4) that fit beside ``chunks`` resident
    chunks (0 where none does)."""
    room = _MAX_SMEM_BYTES - _ws_smem(s, chunks, 0, depth, g)
    return max(0, min(_WS_STAGES[1], room // (MMA_CHUNK * depth + 16)))


def ws_windows(p_pad: int) -> int:
    """Windows a sequence takes in the resident and windows layouts:
    ``p_pad`` re-padded with zero rows to a multiple of 16, so that a
    warp's 16 fragment rows, and the 8-column groups of the paired rows,
    each lie in one sequence."""
    return -(-p_pad // 16) * 16


def mma_epilogue(s: int, p_pad: int) -> str:
    """The resident and windows layouts' epilogue at ``s`` sequences a
    tile of ``p_pad`` windows (re-padded by ``ws_windows``): "one" where
    every 32 paired columns of a product lie in one sequence (one
    sequence a tile, or a multiple of 64 windows), "two" where each
    64-column half spans at most two (128 windows or more), else "runs"
    (a run per column sequence)."""
    p = ws_windows(p_pad)
    if s == 1 or p % 64 == 0:
        return "one"
    return "two" if p >= 128 else "runs"


def mma_plan(n_pad: int, p_pad: int, depth: int, g: int) -> MmaPlan:
    """Kernel A's layout at ``n_pad`` sequences of ``p_pad`` windows of
    one-hot rows ``depth`` bytes wide (the rows' own width, or any padding
    of it), ``g`` codes a row (the pair table's side). The kernel library
    refuses a plan whose block does not fit, so this rule is the only one.

    - resident: rows padded to 32 bytes and each sequence to a multiple
      of 16 windows (``ws_windows``); a tile's paired j rows (two windows
      a row, ``ws_operands``) stay in shared memory beside a ring of 3 or
      4 i chunks (``stages``), one persistent block an SM walking the tile
      triangle; the tile side is the largest power of two <= 8 dividing
      ``n_pad`` whose block fits and whose tile holds at most 2,048
      windows (longer sequences gain little from sharing a tile, and one
      sequence a tile takes the cheapest epilogue); ``range_chunks``
      counts paired chunks;
    - windows: the same with one sequence a tile, a block holding a range
      of its paired chunks at a time, ranges as even as the chunk count
      allows;
    - where not even one chunk fits beside three i chunks, one sequence a
      tile with a ring of 2 (resident where the range is the whole
      tile, else windows);
    - depth: where not one chunk fits beside two i chunks either, rows
      padded to 64 bytes; a block holds one j chunk at full depth and
      streams the i chunks past it in 64-byte k-slabs; tiles of up to 8
      sequences, split into ranges of j chunks until the grid has about 8
      blocks an SM;
    - slabs: where one j chunk does not fit at full depth either, both
      operands stream in k-slabs; tiles and ranges as in depth.

    Raises where the depth or slabs layout's grid would pass the launch
    limit (2^31 - 1 blocks)."""

    def plan(layout: str, s: int, rc: int, nj: int, slab: int, smem: int,
             stages: int = 0) -> MmaPlan:
        nr = -(-nj // rc)  # nj: j chunks a tile
        nt = n_pad // s
        units = nt * (nt + 1) // 2 * nr
        if layout in ("depth", "slabs"):
            if units > 2**31 - 1:
                raise ValueError(f"kernel A's grid of {units} blocks exceeds the launch limit")
            return MmaPlan(layout, s, rc, nr, slab, smem, units)
        return MmaPlan(layout, s, rc, nr, slab, smem, min(units, _SMS), stages,
                       mma_epilogue(s, p_pad))

    d32, pw = ws_depth(depth), ws_windows(p_pad)
    for s in (8, 4, 2, 1):
        ny = -(-s * pw // (2 * MMA_CHUNK))  # paired chunks a tile
        stages = _ws_stages(s, ny, d32, g)
        if n_pad % s == 0 and stages >= _WS_STAGES[0] and (s == 1 or s * pw <= _WS_TILE_ROWS):
            return plan("resident", s, ny, ny, d32, _ws_smem(s, ny, stages, d32, g), stages)
    ny = -(-pw // (2 * MMA_CHUNK))
    for least in (_WS_STAGES[0], _WS_LAST_STAGES):
        fit = (_MAX_SMEM_BYTES - _ws_smem(1, 0, least, d32, g)) // (MMA_CHUNK * d32)
        if fit >= 1:
            rc = -(-ny // -(-ny // fit))
            stages = _ws_stages(1, rc, d32, g)
            return plan("resident" if rc == ny else "windows", 1, rc, ny, d32,
                        _ws_smem(1, rc, stages, d32, g), stages)
    depth = mma_depth(depth)
    s = next(t for t in (8, 4, 2, 1) if n_pad % t == 0)
    nc = -(-s * p_pad // MMA_CHUNK)
    nt = n_pad // s
    nr = min(nc, max(1, -(-_DEEP_BLOCKS // (nt * (nt + 1) // 2))))
    smem = _DEPTH_RING_BYTES + MMA_CHUNK * depth + _bins_bytes(s)
    if smem <= _MAX_SMEM_BYTES:
        return plan("depth", s, -(-nc // nr), nc, MMA_SLAB, smem)
    return plan("slabs", s, -(-nc // nr), nc, MMA_SLAB, _SLABS_RING_BYTES + _bins_bytes(s))


def _core_order(rows: torch.Tensor) -> torch.Tensor:
    """``rows [tiles, r, depth]`` padded with zero rows to whole 128-row
    chunks, each chunk in wgmma's K-major core-matrix order (row r, byte b
    at ``(r // 8) * 8 * depth + (b // 16) * 128 + (r % 8) * 16 + b % 16``,
    csrc/hopper.cuh:onehot_at), so that a chunk is one contiguous copy."""
    nt, r, depth = rows.shape
    chunks = -(-r // MMA_CHUNK)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, chunks * MMA_CHUNK - r))
    return (
        rows.reshape(nt, chunks * MMA_CHUNK // 8, 8, depth // 16, 16)
        .permute(0, 1, 3, 2, 4)
        .contiguous()
        .view(nt, chunks * MMA_CHUNK, depth)
    )


def ws_operands(x: torch.Tensor, p_pad: int, s: int, depth: int, g: int):
    """The resident and windows layouts' operands from ``x [n_pad * p_pad,
    F]``: each sequence re-padded with zero rows to ``ws_windows(p_pad)``
    windows and each row with zero bytes to ``depth``; tiles of ``s``
    sequences. Returns (i rows, paired j rows), each ``[n_pad / s, chunks
    * 128, depth]`` int8 in ``_core_order``: the one-hot rows, and
    ``(g + 1) x_2q + x_2q+1`` (two windows of one sequence a row, entries
    <= g + 2), whose product with a one-hot row is the pair index
    ``(g + 1) d0 + d1`` of two match counts."""
    n_pad = x.shape[0] // p_pad
    pw = ws_windows(p_pad)
    rows = torch.nn.functional.pad(
        x.view(n_pad, p_pad, x.shape[1]), (0, depth - x.shape[1], 0, pw - p_pad)
    ).view(n_pad // s, s * pw, depth)
    paired = rows[:, 0::2] * (g + 1) + rows[:, 1::2]
    return _core_order(rows), _core_order(paired)


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


def _launch_mma(x: torch.Tensor, p_pad: int, g: int, k: int, variant: int, name: str):
    """Lay ``x`` out for ``mma_plan``'s layout and launch the body's
    ``variant`` (an index of ``PROBE_VARIANTS``; "current" gives the
    counts) in it; returns the ``[n_pad, n_pad]`` int32 output (zeroed
    first where blocks add into it) and the plan."""
    n_pad = x.shape[0] // p_pad
    plan = mma_plan(n_pad, p_pad, x.shape[1], g)
    s, rc, stages = plan.tile, plan.range_chunks, plan.stages
    if plan.layout in ("resident", "windows"):
        depth = plan.slab
        epilogue = MMA_EPILOGUES.index(plan.epilogue)
        rows, paired = ws_operands(x, p_pad, s, depth, g)
        adds = rc < paired.shape[1] // MMA_CHUNK  # several ranges a tile
        x = torch.cat((rows.view(-1), paired.view(-1)))
        period = ws_windows(p_pad)
    else:
        depth, epilogue, adds = mma_depth(x.shape[1]), 0, True
        if depth != x.shape[1]:
            x = torch.nn.functional.pad(x, (0, depth - x.shape[1]))
        period = p_pad
    out = (torch.zeros if adds else torch.empty)((n_pad, n_pad), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.kernels().pairs_mma_launch(
            x.data_ptr(), out.data_ptr(), n_pad, period, depth, k, s, rc,
            MMA_LAYOUTS.index(plan.layout), variant, g, stages, epilogue, stream,
        )
    _build.check_launch(status, name)
    return out, plan


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
            plan = mma_plan(x.shape[0] // p_pad, p_pad, x.shape[1], g)
        return pairs_counts_plain(x, k=k, p_pad=p_pad, plan=plan)
    if body == "mma":
        out, plan = _launch_mma(x, p_pad, g, k, _CURRENT, "pairs_counts")
        count(f"pairs_counts.layouts.{plan.layout}")
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
        plan = mma_plan(x.shape[0] // p_pad, p_pad, x.shape[1], g)
        return pairs_probe_plain(x, k=k, p_pad=p_pad, variant=variant, plan=plan, g=g)
    out, _ = _launch_mma(x, p_pad, g, k, PROBE_VARIANTS.index(variant), "pairs_probe")
    count("pairs_probe.launches")  # the CPU path does not count
    return out
