"""Packed (ragged-aware) all-pairs exact kernel, in PyTorch.

Counterpart of ``fastsk_tpu/ops/pairs_packed.py``. The sequence-aligned
pairs path (ops/pairs.py) pads every sequence to the longest one's window
count; on ragged protein or text data that wastes up to ~35x of the work
(SCOP lengths span 16..905). Here windows pack back to back (each sequence
rounded to 8 rows, sequences sorted by descending length), and strips of
``tile`` rows may split sequences.

For an ordered strip pair (a, b) the part block is

    P[i, j] = sum_{r in a, seq(r) = fa + i} sum_{c in b, seq(c) = fb + j}
              C(matches(r, c), k)

with ``fa = first_seq[a]``, ``fb = first_seq[b]``. Landing rule (the JAX
``strip_planes_update`` rule): P at (fa, fb), and for b > a also P^T at
(fb, fa); the diagonal pair lands once. Every ordered row pair is then
counted exactly once, sequences straddling strips included, and the
result is the full symmetric matrix.

The plain versions here (``packed_pair_parts_plain``,
``packed_counts_plain``, ``packed_block_plain``, ``packed_s1_plain``) are
what kernels D, E, G and F (``ops/pairs_packed_cuda.py``) compute. They
sum exact integers: the JAX package's base-128/256 digit planes only kept
bf16/int8 MXU operands exact and are not part of the function.

The JAX mesh paths split a part block in two stages (``_pair_parts``):
kernel F's stage 1 (rows -> i sequences, ``s1 [n_b, c_pad, tile]``), then
stage 2 (columns -> j sequences: a cumsum gathered at the strip's
sequence boundaries), then land it. ``packed_block_plain`` is that
composite (``packed_s1_plain``, ``parts_from_s1``, ``add_blocks``); on the
card kernel F does all three in one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from .pairs import binom_exact, full_f32_matmul


def pack_windows(
    lengths: np.ndarray, g: int, tile: int, group: int = 1
) -> dict:
    """Row layout for the packed table (host side).

    Sequences are assumed pre-sorted by the caller (descending length).
    Each sequence s gets ``ceil(p_s / 8) * 8`` rows starting at
    ``row0[s]``; the total rounds up to a multiple of ``tile * group``
    (padding strips carry all-zero rows and contribute nothing).
    """
    p = np.maximum(lengths - g + 1, 0).astype(np.int64)
    rows = ((p + 7) // 8) * 8
    row0 = np.concatenate([[0], np.cumsum(rows)])
    total = int(row0[-1])
    unit = tile * group
    total_pad = ((total + unit - 1) // unit) * unit
    n_strips = total_pad // tile

    # per-row sequence id (-1 padding) and window position
    seq_of = np.full(total_pad, -1, dtype=np.int32)
    win_of = np.zeros(total_pad, dtype=np.int32)
    for s in range(len(lengths)):
        a, b = int(row0[s]), int(row0[s] + p[s])
        seq_of[a:b] = s
        win_of[a:b] = np.arange(p[s], dtype=np.int32)

    # per-strip: local sequence span + per-local-seq end-row boundaries
    # (vectorized — the naive per-cell scan is O(strips * c_max * tile),
    # seconds of host time on large ragged sets)
    grid = seq_of.reshape(n_strips, tile)
    any_valid = (grid >= 0).any(axis=1)
    first_seq = np.where(
        any_valid, np.where(grid >= 0, grid, np.iinfo(np.int32).max).min(axis=1),
        len(lengths),
    ).astype(np.int32)
    last_seq = np.where(any_valid, grid.max(axis=1), -1)
    c_strip = np.where(any_valid, last_seq - first_seq + 1, 0).astype(np.int32)
    c_max = int(max(c_strip.max(initial=1), 1))
    # bounds[t, c]: 1 + last row index (within the strip) of local seq c —
    # cumsum gathered at bounds-1 gives per-seq prefix totals; past the
    # strip's last sequence the boundary carries forward (same prefix)
    rows = np.arange(total_pad, dtype=np.int64)
    t_of = rows // tile
    valid = seq_of >= 0
    local = seq_of.astype(np.int64) - first_seq[t_of]
    flat = np.zeros(n_strips * c_max, dtype=np.int32)
    np.maximum.at(
        flat,
        (t_of[valid] * c_max + local[valid]).astype(np.int64),
        (rows[valid] % tile + 1).astype(np.int32),
    )
    bounds = np.maximum.accumulate(
        flat.reshape(n_strips, c_max), axis=1
    ).astype(np.int32)
    return dict(
        p=p,
        rows=rows,
        row0=row0[:-1],
        total_pad=total_pad,
        n_strips=n_strips,
        seq_of=seq_of,
        win_of=win_of,
        first_seq=first_seq,
        c_max=c_max,
        bounds=bounds,
    )


def window_codes(
    ids: torch.Tensor,  # [N, L] int32
    seq_of: torch.Tensor,  # [R] int32 (-1 padding)
    win_of: torch.Tensor,  # [R] int32
    *,
    g: int,
    code_min: int,
) -> torch.Tensor:
    """The g codes (``code - code_min``) of each packed row's window,
    ``[R, g]`` int32; padding rows hold -1."""
    safe = seq_of.clamp_min(0).long()
    cols = win_of.long()[:, None] + torch.arange(g, device=ids.device)[None, :]
    codes = ids[safe[:, None], cols] - code_min
    return torch.where((seq_of >= 0)[:, None], codes, torch.full_like(codes, -1))


def onehot_rows(codes: torch.Tensor, alpha: int) -> torch.Tensor:
    """One-hot rows ``[R, g * alpha]`` int8 of window codes ``[R, g]``
    (a code of -1, padding, sets no byte): with ``window_codes``, the JAX
    ``build_packed_x`` table, the plain versions' operand."""
    iota = torch.arange(alpha, device=codes.device, dtype=codes.dtype)
    oh = codes[:, :, None] == iota
    return oh.reshape(codes.shape[0], -1).to(torch.int8)


def packed_pair_parts_plain(
    x: torch.Tensor,  # [R, F] int8 one-hot rows
    seq_of: torch.Tensor,  # [R] int32
    first_seq: torch.Tensor,  # [n_strips] int32
    pa,  # S strip ids (sequence of ints or a tensor)
    pb,
    *,
    k: int,
    tile: int,
    c_pad: int,
) -> torch.Tensor:
    """Part blocks ``[S, c_pad, c_pad]`` int64 of the ordered strip pairs
    ``(pa[s], pb[s])``.

    Per pair: ``D = X_a X_b^T`` in f32 (0/1 operands, exact counts <= g),
    ``C(D, k)`` exact in f32, then both landings as f64 matrix products
    with one-hot row -> local-sequence maps (padding rows, seq_of = -1,
    map nowhere). Every sum is below ``tile^2 * C(20, 10) < 2^53``, so the
    f64 products are exact integers.
    """
    pa = [int(v) for v in pa]
    pb = [int(v) for v in pb]
    dev = x.device
    xf = x.to(torch.float32)
    iota = torch.arange(c_pad, device=dev)
    fs = first_seq.long()

    def seq_map(s: int) -> torch.Tensor:  # [c_pad, tile] f64 one-hot
        local = seq_of[s * tile : (s + 1) * tile].long() - fs[s]
        return (local[None, :] == iota[:, None]).to(torch.float64)

    out = torch.empty((len(pa), c_pad, c_pad), dtype=torch.int64, device=dev)
    with full_f32_matmul():
        for s, (a, b) in enumerate(zip(pa, pb)):
            d = xf[a * tile : (a + 1) * tile] @ xf[b * tile : (b + 1) * tile].T
            w = binom_exact(d, k).to(torch.float64)
            out[s] = (seq_map(a) @ w @ seq_map(b).T).round().to(torch.int64)
    return out


def land_parts(
    mat: torch.Tensor,  # [M, M] int64, M >= max(first_seq) + c_pad
    parts: torch.Tensor,  # [S, c_pad, c_pad] int64
    fa: torch.Tensor,  # [S] first sequence of each part's a strip
    fb: torch.Tensor,  # [S]
    mirror: torch.Tensor,  # [S] bool: also add P^T at (fb, fa)
) -> None:
    """Add part blocks into ``mat`` in place: ``P`` at (fa, fb), and
    ``P^T`` at (fb, fa) where ``mirror``. Overlapping blocks (adjacent
    strips sharing a sequence) compose, since every landing is an add."""
    add_blocks(mat, parts, fa, fb)
    if bool(mirror.any()):
        add_blocks(mat, parts[mirror].transpose(1, 2), fb[mirror], fa[mirror])


def add_blocks(
    mat: torch.Tensor,  # [M, M'] int64
    parts: torch.Tensor,  # [S, c, c] int64
    row0: torch.Tensor,  # [S] first row of each block in mat
    col0: torch.Tensor,  # [S] first column
) -> None:
    """``mat[row0[s] + i, col0[s] + j] += parts[s, i, j]`` in place, with
    overlapping blocks composing."""
    c = parts.shape[1]
    iota = torch.arange(c, device=mat.device)
    rows = (row0.long()[:, None, None] + iota[None, :, None]).expand_as(parts)
    cols = (col0.long()[:, None, None] + iota[None, None, :]).expand_as(parts)
    mat.index_put_((rows, cols), parts, accumulate=True)


def packed_counts_plain(
    x: torch.Tensor,
    seq_of: torch.Tensor,
    first_seq: torch.Tensor,
    *,
    k: int,
    tile: int,
    c_pad: int,
    n_out: int,
) -> torch.Tensor:
    """The full symmetric count matrix ``[n_out, n_out]`` int64 (packed,
    length-sorted sequence order): every upper-triangle strip pair's part
    block landed by ``land_parts``."""
    n_strips = x.shape[0] // tile
    dev = x.device
    fs = first_seq.to(dev)
    m = max(n_out, int(fs.max())) + c_pad
    mat = torch.zeros((m, m), dtype=torch.int64, device=dev)
    for a in range(n_strips):
        pb = torch.arange(a, n_strips, device=dev)
        pa = torch.full_like(pb, a)
        parts = packed_pair_parts_plain(
            x, seq_of, fs, pa.tolist(), pb.tolist(), k=k, tile=tile, c_pad=c_pad
        )
        land_parts(mat, parts, fs[pa], fs[pb], pb > pa)
    return mat[:n_out, :n_out]


def packed_s1_plain(
    xa: torch.Tensor,  # [tile, F] int8 one-hot rows of strip a
    seq_a: torch.Tensor,  # [tile] int32 (-1 padding)
    fa,  # first sequence of strip a (int or 0-d tensor)
    xb: torch.Tensor,  # [n_b * tile, F] int8 one-hot rows of the b strips
    *,
    k: int,
    tile: int,
    c_pad: int,
) -> torch.Tensor:
    """Stage 1 of strip a against ``n_b`` strips: ``[n_b, c_pad, tile]``
    int32 with ``s1[b, li, c] = sum_{r in a, seq_a[r] = fa + li}
    C(matches(r, c), k)``.

    Per b: ``D = X_a X_b^T`` in f32 (exact counts <= g), ``C(D, k)`` exact
    in f32, then the i-side landing as an f64 product with the one-hot
    row -> local-sequence map (sums <= tile * C(20, 10) < 2^53: exact).
    Padding rows are all-zero one-hots, so they weigh 0 on either side.
    The JAX kernel's ``sum_d base^d * s1_d`` is this one value."""
    dev = xa.device
    n_b = xb.shape[0] // tile
    local = seq_a.long() - fa
    ga = (local[None, :] == torch.arange(c_pad, device=dev)[:, None]).to(torch.float64)
    xaf = xa.to(torch.float32)
    out = torch.empty((n_b, c_pad, tile), dtype=torch.int32, device=dev)
    with full_f32_matmul():
        for b in range(n_b):
            d = xaf @ xb[b * tile : (b + 1) * tile].to(torch.float32).T
            w = binom_exact(d, k).to(torch.float64)
            out[b] = (ga @ w).round().to(torch.int32)
    return out


def parts_from_s1(
    s1: torch.Tensor,  # [n_b, c_pad, tile] int32
    bounds: torch.Tensor,  # [n_b, c_max] int32: the b strips' bounds rows
    *,
    c_max: int,
) -> torch.Tensor:
    """Stage 2: part blocks ``[n_b, c_max, c_max]`` int64 from stage 1.

    An int64 cumsum over each strip's columns, gathered at ``bounds - 1``
    (1 + the last row of each local j sequence; the strip's last boundary
    carries forward past its last sequence), then differenced: each j
    sequence's columns, padding rows between sequences included (their
    s1 is 0). The JAX package's ``_pair_parts`` stage 2, in int64."""
    n_b, _, tile = s1.shape
    cum = torch.cumsum(s1[:, :c_max], dim=2, dtype=torch.int64)
    bnd = bounds.long()
    idx = (bnd - 1).clamp(0, tile - 1)[:, None, :].expand(n_b, c_max, c_max)
    at = torch.gather(cum, 2, idx)
    at = torch.where((bnd > 0)[:, None, :], at, torch.zeros_like(at))
    return at - torch.nn.functional.pad(at[:, :, :-1], (1, 0))


# the plain composite's stage-1 sums per step; kernel E's and G's part
# blocks per launch (kernel/pairs_engine.py)
SLAB_BYTES = 128 << 20


def strip_span(seq_of: torch.Tensor, first_seq: torch.Tensor, tile: int) -> int:
    """The largest number of sequences any ``tile``-row strip holds part
    of (at least 1)."""
    s = seq_of.view(-1, tile).long()
    local = torch.where(s >= 0, s - first_seq.long()[:, None], -1)
    return max(int(local.max()) + 1, 1)


def strip_bounds(
    seq_of: torch.Tensor, first_seq: torch.Tensor, tile: int, c: int
) -> torch.Tensor:
    """``pack_windows``'s ``bounds`` of a table's strips at width ``c``
    (``[n_strips, c]`` int32): 1 + the last row (within the strip) of each
    local sequence, carried forward past the strip's last one."""
    s = seq_of.view(-1, tile).long()
    valid = s >= 0
    local = torch.where(valid, s - first_seq.long()[:, None], 0)
    end = torch.arange(1, tile + 1, device=s.device).expand_as(s) * valid
    last = torch.zeros((s.shape[0], c), dtype=torch.int64, device=s.device)
    last.scatter_reduce_(1, local, end, "amax")
    return torch.cummax(last, dim=1).values.to(torch.int32)


def packed_block_plain(
    out: torch.Tensor,  # [M, ld] int64
    rows_i,  # PackedRows
    strips_i,  # (a0, a1)
    *,
    k: int,
    rows_j=None,  # PackedRows: the rectangle's column table
    strips_j=None,  # (b0, b1); the triangle's (a0, b1), to the table's end by default
    row_off: int = 0,
) -> torch.Tensor:
    """Kernel F's plain version (``ops/pairs_packed_cuda.py:packed_block``),
    the JAX mesh paths' composite: per row strip a and run of column strips,
    stage 1 (``packed_s1_plain``), stage 2 (``parts_from_s1``) and the
    landing (``add_blocks``), into ``out`` in place.

    Rectangle (``rows_j``, ``strips_j`` given; ``strip_block_shard_update``
    in the JAX package): strips a0 .. a1 - 1 of ``rows_i`` against strips
    b0 .. b1 - 1 of ``rows_j``, P at (fa - row_off, fb). Triangle (no
    ``rows_j``; ``strip_planes_update``): each strip a against every strip
    b >= a of ``rows_i`` below b1, P at (fa - row_off, fb) and for b > a
    also P^T at (fb - row_off, fa)."""
    tri = rows_j is None
    rows_j = rows_i if tri else rows_j
    tile, c_pad = rows_i.tile, rows_i.c_pad
    c = max(
        strip_span(rows_i.seq_of, rows_i.first_seq, tile),
        strip_span(rows_j.seq_of, rows_j.first_seq, tile),
    )
    bounds = strip_bounds(rows_j.seq_of, rows_j.first_seq, tile, c)
    fs_i, fs_j = rows_i.first_seq.long(), rows_j.first_seq.long()
    step = max(1, SLAB_BYTES // (c_pad * tile * 4))
    for a in range(*strips_i):
        fa = fs_i[a]
        if tri:
            lo, hi = a, rows_j.n_strips if strips_j is None else strips_j[1]
        else:
            lo, hi = strips_j
        for b0 in range(lo, hi, step):
            n_b = min(step, hi - b0)
            s1 = packed_s1_plain(
                rows_i.onehot[a * tile : (a + 1) * tile],
                rows_i.seq_of[a * tile : (a + 1) * tile], fa,
                rows_j.onehot[b0 * tile : (b0 + n_b) * tile], k=k, tile=tile, c_pad=c_pad,
            )
            parts = parts_from_s1(s1, bounds[b0 : b0 + n_b], c_max=c)
            fb = fs_j[b0 : b0 + n_b]
            add_blocks(out, parts, (fa - row_off).expand(n_b), fb)
            if tri:
                skip = 1 if b0 == a else 0  # the diagonal pair lands once
                add_blocks(
                    out, parts[skip:].transpose(1, 2), fb[skip:] - row_off, fa.expand(n_b - skip)
                )
    return out
