"""Operation, bound and MFU accounting for the port's kernels on the H100.

Counterpart of ``fastsk_tpu/utils/roofline.py``. That module counts the
TPU's tiles against TPU peaks; this one counts the work the port's own
kernels do and sets it against one NVIDIA H100's published dense peaks
(NVIDIA's data sheet, SXM part, without sparsity, at the full 700 W power
limit):

- ``pairs_engine_flops``: kernel A (``csrc/pairs.cu``), the int8 products
  of one-hot window rows over the tiles its body walks (the tensor-core
  body's ``wgmma`` blocks in its plan's layout, or the dp4a body's tile
  pairs), padding included, beside the useful products alone;
- ``packed_engine_flops``: kernel D (``csrc/pairs_packed.cu``), the window
  pairs its triangle walk visits on the code planes (one LOP3 a plane and
  one POPC a pair), with the int8 operations of the same pairs' one-hot
  product for the bound;
- ``bound``, ``count_bound``, ``theta_gram_bound`` and ``smo_bound``: the least time the card
  could take for a piece of work, the larger of its operations over the
  peak rate and its bytes over the memory rate (``chip_smoke.py``'s kernel
  record takes its ``bound_ms`` from here).

One multiply-accumulate counts 2 operations, also on the int8 paths (the
int8 peak is quoted on the same convention). The TPU composites of the JAX
module (its VPU tables and serialized MXU + VPU brackets) describe TPU
units and are not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

# one H100 SXM's dense peaks, operations a second (int8: int-OP/s on the
# 2-ops-a-MAC convention; f32 outside the tensor cores)
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12

GPU_PEAKS: dict[str, dict[str, float]] = {
    "h100": {"int8": PEAK_INT8_OPS, "bf16": 989e12, "f32": PEAK_F32_FLOPS},
}

# HBM bandwidth, bytes a second
GPU_HBM_BW: dict[str, float] = {"h100": HBM_BYTES_S}


def bound(ops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take for work of ``ops`` operations
    (at ``peak`` a second) that must move ``nbytes`` (each input read once,
    each output written once): the larger of the two times, and which."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def count_bound(windows: int, width: int, nbytes: float) -> dict:
    """Bound of an exact count matrix over ``windows`` valid windows: every
    unordered window pair once, as an int8 product of ``width``-byte
    one-hot rows (2 * width operations a pair)."""
    return bound(2.0 * width * windows * (windows + 1) / 2, nbytes, PEAK_INT8_OPS)


def theta_gram_bound(n: int, k: int) -> dict:
    """Bound of the theta Gram kernel (``csrc/theta_gram.cu``) on ``n``
    rows of ``k`` u8 counts (a batch's buckets side by side): the upper
    triangle's n (n + 1) / 2 entries of k int8 multiply-adds at the int8
    peak, against the operand read once and the int32 [n, n] written
    once."""
    return bound(n * (n + 1) * k, n * k + 4 * n * n, PEAK_INT8_OPS)


def smo_bound(n: int, iters: int) -> dict:
    """Bound of an SMO solve of ``iters`` iterations at ``n`` rows: the
    gradient update's two f32 multiply-adds per row an iteration, and Q
    read once."""
    return bound(4.0 * n * iters, 4.0 * n * n + 20.0 * n, PEAK_F32_FLOPS)


def classify_device(device) -> Optional[str]:
    """A GPU generation key ("h100") for a ``torch.device``, a device
    string, or a card's name as ``torch.cuda.get_device_name`` gives it;
    None for the CPU and for unknown cards."""
    name = device
    if isinstance(device, str):
        try:
            device = torch.device(device)
        except RuntimeError:
            device = None  # a card's name, not a device string
    if isinstance(device, torch.device):
        if device.type != "cuda" or not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(device)
    if not isinstance(name, str):
        return None
    return "h100" if "h100" in name.lower() else None


def device_peak_flops(device, dtype: str = "bf16") -> Optional[float]:
    gen = classify_device(device)
    if gen is None:
        return None
    return GPU_PEAKS[gen].get(dtype)


def device_hbm_bw(device) -> Optional[float]:
    gen = classify_device(device)
    return GPU_HBM_BW.get(gen) if gen else None


def mfu(flops: float, wall_s: float, device, dtype: str = "bf16") -> Optional[float]:
    """Achieved / peak operations a second, or None off a known card."""
    peak = device_peak_flops(device, dtype)
    if not peak or wall_s <= 0:
        return None
    return (flops / wall_s) / peak


def pairs_engine_flops(engine, body: str = "mma") -> dict:
    """Int8 work of one ``PairsGkmEngine`` exact run on kernel A.

    ``flops`` counts the operations the kernel executes, padding included.
    The tensor-core body (``body="mma"``, in ``pairs_cuda.mma_plan``'s
    layout): pairs of s-sequence tiles ``bi <= bj``, each multiplying every
    128-row j chunk of tile bj (all of them at once, or in ranges) by
    every 128-row i chunk of tile bi; in the resident and windows layouts
    rows padded to 32 bytes and sequences to ``ws_windows``, the j chunks
    of paired rows (two windows a row), in the depth and slabs layouts
    rows padded to 64 bytes.
    The dp4a body (``body="dp4a"``): the same
    tile pairs, every window pair of the two tiles at the padded width.
    ``useful_flops`` counts the work itself: every unordered pair of
    valid windows once, ``g * alpha`` bytes wide (``count_bound``'s
    operations).

    Returns dict(flops, useful_flops, dtype, body, layout, tile,
    live_tiles, bytes_hbm, ai): ``bytes_hbm`` counts the operand read
    once and the int32 matrix written once; ``ai`` is executed flops a
    byte."""
    from ..ops.pairs_cuda import (MMA_CHUNK, mma_depth, mma_plan, padded_width, tile_sequences,
                                  ws_windows)

    f = engine.g * engine.alpha
    n_pad, p_pad = engine.n_pad, engine.p_pad
    if body == "mma":
        plan = mma_plan(n_pad, p_pad, f, engine.g)
        s, layout = plan.tile, plan.layout
        if layout in ("resident", "windows"):
            width, rows = plan.slab, s * ws_windows(p_pad)
            cols = -(-rows // (2 * MMA_CHUNK)) * MMA_CHUNK
        else:
            width, rows = mma_depth(f), s * p_pad
            cols = -(-rows // MMA_CHUNK) * MMA_CHUNK
        macs_block = -(-rows // MMA_CHUNK) * MMA_CHUNK * cols * width
    elif body == "dp4a":
        width, layout = padded_width(f), None
        s = tile_sequences(n_pad, p_pad, width)
        rows = s * p_pad
        macs_block = rows * rows * width
    else:
        raise ValueError(f"body must be 'mma' or 'dp4a'; got {body!r}")
    nt = n_pad // s
    nt_pairs = nt * (nt + 1) // 2
    flops = 2.0 * nt_pairs * macs_block
    bytes_hbm = float(n_pad * p_pad * width + n_pad * n_pad * 4)
    windows = int(engine.enc.num_windows(engine.g).sum())
    return {
        "flops": flops,
        "useful_flops": 2.0 * f * windows * (windows + 1) / 2,
        "dtype": "int8",
        "body": body,
        "layout": layout,
        "tile": s,
        "live_tiles": nt_pairs,
        "bytes_hbm": bytes_hbm,
        "ai": flops / bytes_hbm,
    }


def packed_engine_flops(engine) -> dict:
    """Work of one ``PackedPairsEngine`` exact run on kernel D (the band
    route): its triangle walk over the 128-row tiles of the packed window
    table, diagonal tiles included, visits ``tile_pairs * 128 * 128``
    window pairs, each ``nb`` LOP3 and one POPC on the code planes
    (``bit_ops``). ``flops`` is the int8 one-hot product of the same pairs
    (2 * g * alpha a pair), the work the bound is set against.

    Returns dict(flops, dtype, window_pairs, tile_pairs, code_planes,
    bit_ops, bytes_hbm, ai): ``bytes_hbm`` counts the planes and
    sequence ids read once and the int64 matrix written once."""
    from ..ops.pairs_packed_cuda import ROW_TILE, code_planes, plane_stride

    r_pad = -(-engine.total_rows // ROW_TILE) * ROW_TILE
    n_tiles = r_pad // ROW_TILE
    tile_pairs = n_tiles * (n_tiles + 1) // 2
    pairs = tile_pairs * ROW_TILE * ROW_TILE
    nb = code_planes(engine.alpha)
    flops = 2.0 * engine.g * engine.alpha * pairs
    bytes_hbm = float(r_pad * (plane_stride(nb) + 1) * 4 + engine.n * engine.n * 8)
    return {
        "flops": flops,
        "dtype": "int8",
        "window_pairs": pairs,
        "tile_pairs": tile_pairs,
        "code_planes": nb,
        "bit_ops": float(pairs * (nb + 1)),
        "bytes_hbm": bytes_hbm,
        "ai": flops / bytes_hbm,
    }


def format_mfu_line(label: str, flops: float, wall_s: float, device, dtype: str) -> str:
    """One human-readable roofline line for logs and benches."""
    achieved = flops / max(wall_s, 1e-12)
    gen = classify_device(device)
    peak = device_peak_flops(device, dtype)
    if peak:
        return (
            f"{label}: {flops:.3e} ops ({dtype}) in {wall_s:.4f} s = "
            f"{achieved / 1e12:.1f} TOP/s, {100 * achieved / peak:.1f}% "
            f"of the {gen} {dtype} peak {peak / 1e12:.0f} T"
        )
    return (
        f"{label}: {flops:.3e} ops ({dtype}) in {wall_s:.4f} s = "
        f"{achieved / 1e12:.2f} TOP/s (unknown device peak)"
    )

