"""Wrappers of kernels D, F, G and E (``csrc/pairs_packed.cu``).

Counterparts of ``fastsk_tpu/ops/pairs_packed_pallas.py``:

- ``packed_band``     (kernel D, ``packed_band_pallas``): every
  upper-triangle row-pair tile at once, landed straight into the full
  symmetric count matrix;
- ``packed_block``    (kernel F, ``packed_s1_pallas`` with the mesh
  paths' stage 2 and landing folded in): one block of the count matrix,
  a strip's triangle or a rectangle of strips, added into the caller's
  matrix or row block;
- ``packed_grouped``  (kernel G, ``packed_part_pallas``): part blocks of
  strip a against one or more groups of b strips;
- ``packed_pairlist`` (kernel E, ``packed_pairlist_pallas``): a list of
  strip pairs in one launch, landed straight into the count matrix (or
  into part blocks, for ``ops/pairs_packed.py:land_parts``);
- ``packed_s1``       (F's stage 1 alone, the TPU kernel's own output).

D, E, F and G are one persistent kernel, ``packed_bytes_kernel``, on the
windows' code planes (``PackedRows.planes``), walked four ways.

Each takes a ``PackedRows`` (the packed window codes and their layout).
On a CPU tensor it runs the plain version (``ops/pairs_packed.py``); on a
CUDA tensor it launches its kernel or raises, counted as
``<wrapper>.launches`` (``utils/observe.py``; the CPU path does not
count). Outputs are int64 counts (F's stage-1 sums are int32).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from .. import _build
from ..utils.observe import count
from .pairs_packed import (
    land_parts, onehot_rows, packed_block_plain, packed_counts_plain,
    packed_pair_parts_plain, packed_s1_plain,
)

ROW_TILE = 128  # rows a side of the kernels' tile pair


class TileMeta(NamedTuple):
    tile_first: torch.Tensor  # [R / tr] int32: first sequence of each tile
    cb: int  # largest sequence span of a tile (bins a side)


@dataclass(eq=False)
class PackedRows:
    """The packed window table as the kernels and their plain versions
    take it. ``codes [R, g]`` int32 window codes (``code - code_min``, -1
    on padding rows), ``seq_of [R]`` int32 (-1 padding), ``first_seq
    [n_strips]`` int32, all on one device; ``R`` is a multiple of
    ``tile``."""

    codes: torch.Tensor
    seq_of: torch.Tensor
    first_seq: torch.Tensor
    tile: int
    c_pad: int
    alpha: int
    _meta: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        r, g = self.codes.shape
        if self.codes.dtype != torch.int32 or self.seq_of.dtype != torch.int32:
            raise ValueError("codes and seq_of must be int32")
        if self.seq_of.shape != (r,) or r % self.tile:
            raise ValueError(f"{r} rows must match seq_of and be a multiple of tile={self.tile}")
        if not 1 <= g <= 20:
            raise ValueError(f"need 1 <= g <= 20; got g={g}")
        if self.alpha > 256:
            raise ValueError(
                f"alphabet {self.alpha} exceeds the kernels' one-byte codes (<= 256)"
            )

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def g(self) -> int:
        return self.codes.shape[1]

    @property
    def n_strips(self) -> int:
        return self.codes.shape[0] // self.tile

    @functools.cached_property
    def onehot(self) -> torch.Tensor:
        """``[R, g * alpha]`` int8: the plain versions' operand."""
        return onehot_rows(self.codes, self.alpha)

    @functools.cached_property
    def words(self) -> torch.Tensor:
        """``[R', ceil(g / 4)]`` int32, F's stage-1 operand: each window's
        codes one byte each (zero bytes past g), rows padded with zero
        words up to a multiple of ``ROW_TILE``."""
        r, g = self.codes.shape
        w = -(-g // 4)
        r_pad = -(-r // ROW_TILE) * ROW_TILE
        b = self.codes.clamp_min(0).to(torch.uint8)
        b = torch.nn.functional.pad(b, (0, 4 * w - g, 0, r_pad - r))
        return b.contiguous().view(torch.int32)

    @functools.cached_property
    def planes(self) -> torch.Tensor:
        """``[R', S]`` int32, the operand of kernels D to G: word p of a
        row holds bit p of its window's code q at bit q (zero bits past
        g), for the ``code_planes(alpha)`` bits of a code, padded with
        zero words to ``S = plane_stride(...)`` and rows as ``words``
        (the kernel masks padding rows by ``seq_padded``, not by these).

        The kernel reads a sequence once per aligned group of 8 rows, so
        each group must hold one sequence's rows, valid ones first (as
        ``pack_windows`` lays them out); raises otherwise."""
        r, g = self.codes.shape
        nb = code_planes(self.alpha)
        r_pad = -(-r // ROW_TILE) * ROW_TILE
        c = self.codes.clamp_min(0)
        bit = torch.arange(nb, device=c.device, dtype=torch.int32)
        pos = torch.arange(g, device=c.device, dtype=torch.int32)
        planes = (((c[:, None, :] >> bit[None, :, None]) & 1) << pos).sum(-1, dtype=torch.int32)
        planes = torch.nn.functional.pad(planes, (0, plane_stride(nb) - nb, 0, r_pad - r))
        s8 = self.seq_padded.view(-1, 8)
        valid = (s8 >= 0).to(torch.int8)
        if not bool(((s8 == s8[:, :1]) | (valid == 0)).all() & (valid[:, 1:] <= valid[:, :-1]).all()):
            raise ValueError(
                "kernels D to G need every aligned group of 8 rows to hold one "
                "sequence's rows, valid ones first"
            )
        return planes.contiguous()

    @functools.cached_property
    def seq_padded(self) -> torch.Tensor:
        """``seq_of`` padded with -1 to the rows of ``words``."""
        r_pad = -(-self.seq_of.shape[0] // ROW_TILE) * ROW_TILE
        return torch.nn.functional.pad(
            self.seq_of, (0, r_pad - self.seq_of.shape[0]), value=-1
        ).contiguous()

    def to(self, device) -> "PackedRows":
        """This table on ``device`` (itself when it is there already), its
        kernel operands moved without waiting on the host."""
        device = torch.device(device)
        if device == self.device:
            return self
        moved = PackedRows(
            *(t.to(device, non_blocking=True) for t in (self.codes, self.seq_of, self.first_seq)),
            tile=self.tile, c_pad=self.c_pad, alpha=self.alpha,
        )
        for name in ("words", "planes", "seq_padded"):
            if name in self.__dict__:
                moved.__dict__[name] = self.__dict__[name].to(device, non_blocking=True)
        for tr, m in self._meta.items():  # no host sync to recompute them
            moved._meta[tr] = TileMeta(m.tile_first.to(device, non_blocking=True), m.cb)
        return moved

    def meta(self, tr: int) -> TileMeta:
        """Per ``tr``-row tile: its first sequence (0 where the tile has no
        valid row) and the largest span of sequences in any tile."""
        if tr in self._meta:
            return self._meta[tr]
        s = self.seq_padded.view(-1, tr)
        valid = s >= 0
        any_valid = valid.any(1)
        first = torch.where(valid, s, torch.iinfo(torch.int32).max).amin(1)
        last = torch.where(valid, s, -1).amax(1)
        span = torch.where(any_valid, last - first + 1, 0)
        cb = max(int(span.max()), 1)
        # every sequence owns at least 8 rows (length >= g), so a tile spans
        # at most tr / 8 + 1 of them: the kernels' cb^2 shared bins stay small
        assert cb <= tr // 8 + 1, f"a {tr}-row tile spans {cb} sequences"
        tile_first = torch.where(any_valid, first, 0).to(torch.int32).contiguous()
        self._meta[tr] = TileMeta(tile_first, cb)
        return self._meta[tr]

    def sub_tile(self) -> int:
        """Rows a side of E's tile pairs (and G's on narrow strips): 128,
        or the strip when strips are narrower."""
        tr = min(self.tile, ROW_TILE)
        if self.tile % tr:
            raise ValueError(f"strip tile {self.tile} is not a multiple of {tr}")
        return tr


def _check_k(rows: PackedRows, k: int) -> None:
    if not 1 <= k <= rows.g:
        raise ValueError(f"need 1 <= k <= g; got g={rows.g}, k={k}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernels D to G run on CUDA or CPU tensors, not {rows.device}")


def code_planes(alpha: int) -> int:
    """Bits of a code over ``alpha`` letters: the planes of kernels D to G
    (csrc/pairs_packed.cu:planes_of)."""
    return max(1, (alpha - 1).bit_length())


def plane_stride(nb: int) -> int:
    """Words a row of the code-plane operand: ``nb`` planes padded to 4 or
    8 (one or two 16-byte loads; csrc/pairs_packed.cu:plane_stride)."""
    return 4 if nb <= 4 else 8


def _launch(fn, name: str, rows: PackedRows, *args) -> None:
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(*args, stream)
    _build.check_launch(status, name)


def packed_band(rows: PackedRows, *, k: int, n_out: int) -> torch.Tensor:
    """Kernel D: the full symmetric count matrix ``[n_out, n_out]`` int64
    in packed (length-sorted) sequence order; ``n_out`` is at least the
    number of sequences."""
    _check_k(rows, k)
    if rows.device.type == "cpu":
        return packed_counts_plain(
            rows.onehot, rows.seq_of, rows.first_seq,
            k=k, tile=rows.tile, c_pad=rows.c_pad, n_out=n_out,
        )
    planes, meta = rows.planes, rows.meta(ROW_TILE)
    out = torch.zeros((n_out, n_out), dtype=torch.int64, device=rows.device)
    _launch(
        _build.kernels().packed_band_launch, "packed_band", rows,
        planes.data_ptr(), rows.seq_padded.data_ptr(), meta.tile_first.data_ptr(),
        out.data_ptr(), planes.shape[0] // ROW_TILE, n_out, planes.shape[1], rows.g,
        rows.alpha, meta.cb, k,
    )
    count("packed_band.launches")
    return out


def packed_block(
    out: torch.Tensor,
    rows_i: PackedRows,
    strips_i,
    *,
    k: int,
    rows_j: PackedRows = None,
    strips_j=None,
    row_off: int = 0,
) -> torch.Tensor:
    """Kernel F: add one block of the count matrix into ``out`` (``[M,
    ld]`` int64, in place; it must hold every landing) and return it.

    - The rectangle (``rows_j`` and ``strips_j = (b0, b1)``; a ring step of
      the mesh): every row of strips ``strips_i = (a0, a1)`` of ``rows_i``
      against every row of strips b0 .. b1 - 1 of ``rows_j`` (ordered
      pairs), ``C(matches, k)`` summed into ``out[si - row_off, sj]``.
    - The triangle (no ``rows_j``; a round-robin strip of the mesh, or a
      ring's diagonal step, a device's own strips against themselves): the
      rows of strips a0 .. a1 - 1 against every row of their own 128-row
      tile and of every later tile of ``rows_i`` up to strip b1 - 1
      (``strips_j = (a0, b1)``, by default to the table's end), into
      ``out[si - row_off, sj]`` and, across two tiles, also ``out[sj -
      row_off, si]``: kernel D's rule on those rows. The calls over a
      partition of the strips add up to kernel D's matrix. A call equals
      its plain version (strip a against strips b >= a, mirrored for b >
      a) where its rows start on a 128-row tile and end on one or at b1;
      narrower strips share tiles, and only their sum does.

    Sequence ids are global (shards of one table keep them)."""
    _check_k(rows_i, k)
    tri = rows_j is None
    if tri:
        rows_j = rows_i
        strips_j = (strips_i[0], rows_i.n_strips) if strips_j is None else strips_j
    elif strips_j is None:
        raise ValueError("the rectangle's rows_j and strips_j come together")
    elif rows_j.device != rows_i.device:
        raise ValueError(f"strips on {rows_i.device} and {rows_j.device}")
    if (rows_j.g, rows_j.tile, rows_j.c_pad, rows_j.alpha) != (
        rows_i.g, rows_i.tile, rows_i.c_pad, rows_i.alpha
    ):
        raise ValueError("rows_i and rows_j must share g, tile, c_pad and alpha")
    (a0, a1), (b0, b1) = strips_i, strips_j
    if not (0 <= a0 < a1 <= rows_i.n_strips and 0 <= b0 < b1 <= rows_j.n_strips):
        raise ValueError(
            f"strips {a0}..{a1 - 1} of {rows_i.n_strips} or {b0}..{b1 - 1} of "
            f"{rows_j.n_strips} out of range"
        )
    if tri and (b0 != a0 or b1 < a1):
        raise ValueError(f"the triangle's columns {strips_j} must start at its rows {strips_i} and cover them")
    if out.dtype != torch.int64 or out.dim() != 2 or not out.is_contiguous():
        raise ValueError("out must be a contiguous 2-D int64 tensor")
    if out.device != rows_i.device:
        raise ValueError(f"out on {out.device}, strips on {rows_i.device}")
    if rows_i.device.type == "cpu":
        return packed_block_plain(
            out, rows_i, strips_i, k=k, rows_j=None if tri else rows_j,
            strips_j=strips_j, row_off=row_off,
        )
    tile = rows_i.tile
    wi, wj = rows_i.planes, rows_j.planes
    mi, mj = rows_i.meta(ROW_TILE), rows_j.meta(ROW_TILE)
    _launch(
        _build.kernels().packed_block_launch, "packed_block", rows_i,
        wi.data_ptr(), rows_i.seq_padded.data_ptr(), mi.tile_first.data_ptr(),
        wj.data_ptr(), rows_j.seq_padded.data_ptr(), mj.tile_first.data_ptr(),
        a0 * tile, a1 * tile, b0 * tile, b1 * tile, int(tri), out.data_ptr(),
        out.shape[1], row_off, wi.shape[1], rows_i.g, rows_i.alpha, max(mi.cb, mj.cb), k,
    )
    count("packed_block.launches")
    return out


def packed_grouped(
    rows: PackedRows, a: int, gidx: int, *, k: int, group: int, n_groups: int = 1,
) -> torch.Tensor:
    """Kernel G: part blocks ``[n_groups * group, c_pad, c_pad]`` int64 of
    strip ``a`` against strips ``gidx * group + u``, u < n_groups * group,
    in one launch, over 128-row tile pairs. Its part blocks land per
    column strip, so a tile must lie in one: strips narrower than 128 rows
    (only tests make them) take kernel E's walk over the pair list (a, b),
    in tiles of the strip."""
    _check_k(rows, k)
    n_b, b0 = n_groups * group, gidx * group
    if not (0 <= a < rows.n_strips and 0 <= gidx and n_groups >= 1 and b0 + n_b <= rows.n_strips):
        raise ValueError(
            f"strip {a} or groups {gidx}..{gidx + n_groups - 1} x {group} outside "
            f"{rows.n_strips} strips"
        )
    if rows.device.type == "cpu":
        return packed_pair_parts_plain(
            rows.onehot, rows.seq_of, rows.first_seq, [a] * n_b, range(b0, b0 + n_b),
            k=k, tile=rows.tile, c_pad=rows.c_pad,
        )
    _check_first_seq(rows)
    c = rows.c_pad
    out = torch.zeros((n_b, c, c), dtype=torch.int64, device=rows.device)
    if rows.tile % ROW_TILE == 0:
        planes, meta = rows.planes, rows.meta(ROW_TILE)
        _launch(
            _build.kernels().packed_grouped_launch, "packed_grouped", rows,
            planes.data_ptr(), rows.seq_padded.data_ptr(), meta.tile_first.data_ptr(),
            rows.first_seq.data_ptr(), a, b0, n_b, out.data_ptr(), rows.tile // ROW_TILE, c,
            planes.shape[1], rows.g, rows.alpha, meta.cb, k,
        )
    else:
        pb = torch.arange(b0, b0 + n_b, dtype=torch.int32, device=rows.device)
        _launch_pairlist("packed_grouped", rows, torch.full_like(pb, a), pb, out, k, parts=True)
    count("packed_grouped.launches")
    return out


def _check_first_seq(rows: PackedRows) -> None:
    if rows.first_seq.dtype != torch.int32 or not rows.first_seq.is_contiguous():
        raise ValueError("first_seq must be a contiguous int32 tensor")


def _launch_pairlist(name, rows, pa, pb, out, k, *, parts: bool) -> None:
    """Kernel E's one launch over the slots (pa[s], pb[s]), in tiles of
    ``rows.sub_tile()`` rows: into part blocks, or into the matrix ``out``
    with each slot's mirror where pb[s] > pa[s]."""
    tr = rows.sub_tile()
    if tr % 8:
        raise ValueError(f"kernel E's tiles of {tr} rows must be a multiple of 8")
    meta, planes = rows.meta(tr), rows.planes
    _launch(
        _build.kernels().packed_pairlist_launch, name, rows,
        planes.data_ptr(), rows.seq_padded.data_ptr(), meta.tile_first.data_ptr(),
        rows.first_seq.data_ptr(), pa.data_ptr(), pb.data_ptr(), pa.numel(), out.data_ptr(),
        out.shape[-1], int(parts), planes.shape[1], rows.g, rows.alpha, tr, rows.tile // tr,
        meta.cb, k, rows.c_pad,
    )


def packed_pairlist(
    rows: PackedRows, pa: torch.Tensor, pb: torch.Tensor, *, k: int, out=None
) -> torch.Tensor:
    """Kernel E over the ordered strip pairs ``(pa[s], pb[s])`` (1-D
    integer tensors), in one launch.

    Without ``out``: part blocks ``[S, c_pad, c_pad]`` int64 (the JAX
    kernel's contract). With ``out`` (``[M, ld]`` int64, contiguous, on the
    rows' device; it must hold every landing): each slot's part block
    added at (fa, fb) of ``out`` in place, and for pb[s] > pa[s] also its
    transpose at (fb, fa) (``land_parts``'s rule: a diagonal slot holds
    both orders); returns ``out``."""
    _check_k(rows, k)
    if pa.shape != pb.shape or pa.dim() != 1:
        raise ValueError("pa and pb must be 1-D and of one length")
    if out is not None:
        if out.dtype != torch.int64 or out.dim() != 2 or not out.is_contiguous():
            raise ValueError("out must be a contiguous 2-D int64 tensor")
        if out.device != rows.device:
            raise ValueError(f"out on {out.device}, strips on {rows.device}")
    if rows.device.type == "cpu":
        parts = packed_pair_parts_plain(
            rows.onehot, rows.seq_of, rows.first_seq, pa.tolist(), pb.tolist(),
            k=k, tile=rows.tile, c_pad=rows.c_pad,
        )
        if out is None:
            return parts
        fs = rows.first_seq.long()
        pa, pb = pa.long(), pb.long()
        land_parts(out, parts, fs[pa], fs[pb], pb > pa)
        return out
    _check_first_seq(rows)
    pa = pa.to(device=rows.device, dtype=torch.int32).contiguous()
    pb = pb.to(device=rows.device, dtype=torch.int32).contiguous()
    parts = out is None
    if parts:
        c = rows.c_pad
        out = torch.zeros((pa.numel(), c, c), dtype=torch.int64, device=rows.device)
    _launch_pairlist("packed_pairlist", rows, pa, pb, out, k, parts=parts)
    count("packed_pairlist.launches")
    return out


def packed_s1(
    rows_a: PackedRows, a: int, rows_b: PackedRows, b0: int, n_b: int, *, k: int
) -> torch.Tensor:
    """Kernel F's stage 1 alone, the TPU kernel's own output (the mesh
    paths run ``packed_block``): ``[n_b, c_pad, tile]`` int32 of strip
    ``a`` of ``rows_a`` against strips ``b0 .. b0 + n_b - 1`` of ``rows_b`` (one
    table, or two shards of one, on one device): ``s1[b, li, c] = sum_{r
    in a, seq_of[r] = first_seq[a] + li} C(matches(r, c), k)``."""
    _check_k(rows_a, k)
    if rows_b.device != rows_a.device:
        raise ValueError(f"strips on {rows_a.device} and {rows_b.device}")
    if (rows_b.g, rows_b.tile, rows_b.c_pad, rows_b.alpha) != (
        rows_a.g, rows_a.tile, rows_a.c_pad, rows_a.alpha
    ):
        raise ValueError("rows_a and rows_b must share g, tile, c_pad and alpha")
    if not (0 <= a < rows_a.n_strips and n_b >= 1 and 0 <= b0 and b0 + n_b <= rows_b.n_strips):
        raise ValueError(
            f"strip {a} of {rows_a.n_strips} or strips {b0}..{b0 + n_b - 1} "
            f"of {rows_b.n_strips} out of range"
        )
    tile, c = rows_a.tile, rows_a.c_pad
    if tile * math.comb(rows_a.g, k) >= 2**31:
        raise ValueError(
            f"tile={tile} x C({rows_a.g}, {k}) exceeds kernel F's int32 sums"
        )
    if rows_a.device.type == "cpu":
        return packed_s1_plain(
            rows_a.onehot[a * tile : (a + 1) * tile],
            rows_a.seq_of[a * tile : (a + 1) * tile],
            rows_a.first_seq[a],
            rows_b.onehot[b0 * tile : (b0 + n_b) * tile],
            k=k, tile=tile, c_pad=c,
        )
    _check_first_seq(rows_a)
    out = torch.zeros((n_b, c, tile), dtype=torch.int32, device=rows_a.device)
    wa, wb = rows_a.words, rows_b.words
    lib = _build.kernels()
    _launch(
        lib.packed_s1_launch, "packed_s1", rows_a,
        wa.data_ptr(), rows_a.seq_padded.data_ptr(), rows_a.first_seq.data_ptr(),
        a, tile, wb[b0 * tile :].data_ptr(), rows_b.seq_padded[b0 * tile :].data_ptr(),
        n_b * tile, c, wa.shape[1], k, 4 * wa.shape[1] - rows_a.g, out.data_ptr(),
    )
    count("packed_s1.launches")
    return out
