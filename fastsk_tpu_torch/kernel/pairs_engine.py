"""All-pairs exact-kernel engines.

Counterpart of ``fastsk_tpu/kernel/pairs_engine.py``'s ``PairsGkmEngine``
(sequence-aligned windows) and ``PackedPairsEngine`` (ragged windows packed
back to back). Both compute the full exact gapped k-mer kernel in one sweep
over window pairs, ``K[i,j] = sum_{p,q} C(matches(w_ip, w_jq), k)``
(ops/pairs.py), instead of the C(g, m) counting passes of the theta engine.

Exactness: integer counts bit-identical to the reference. The
sequence-aligned engine's guard: every K entry must stay < 2^31 (int32
sums); it checks the worst case ``p_pad^2 * C(g, k)`` and refuses shapes
where one sequence pair could overflow, as the JAX engine does; the API
then routes them to the packed engine, which sums int64 and has no such
bound. Kernel A takes every other shape (any one-hot depth and sequence
length), so the engines' choice is the JAX package's.

On a local card there is no transfer to hide, so ``exact()`` is the device
path followed by ``.cpu()``: the TPU tile sizing and the byte-plane
streaming of the JAX engine are not needed.

Under ``KernelConfig.mesh`` only the packed engine of these two runs,
over the mesh's devices (``parallel/sharding.py``, kernel F), and its
counts come back to the host: the ring (``mesh_state="sharded"``) or
round-robin strips (``"replicated"``), as in the JAX engine. A mesh
across processes (``parallel/multihost.py``) runs the same routes: each
process builds and launches its own entries only, the ring's shards
cross between processes point to point, and one sum over the processes
merges the host matrices, so every rank holds the whole count matrix.

Progress lines go through ``utils/observe.Progress`` (gated by
``KernelConfig.quiet``), and ``KernelConfig.profile_dir`` takes a
``torch.profiler`` trace of each exact run of both engines. The stages
are spans of ``utils/observe.py``: ``engine.stage`` (sequences to the
device, one-hot windows or window codes), ``count`` (the count kernel's
call) and ``engine.unsort`` (the packed engine's length sort undone, and
its wait on the counts' maximum).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ..ops import pairs, pairs_packed
from ..ops.encode import EncodedSeqs
from ..ops.pairs_cuda import mma_plan, pairs_counts
from ..ops.pairs_packed_cuda import (
    PackedRows, packed_band, packed_grouped, packed_pairlist,
)
from ..parallel import sharding as shd
from ..utils.observe import Progress, profiler_trace, span, timed
from .config import KernelConfig
from .device_counts import DeviceCounts


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PairsGkmEngine:
    """Exact-mode engine over the all-pairs binomial identity."""

    def __init__(
        self,
        enc: EncodedSeqs,
        g: int,
        m: int,
        config: Optional[KernelConfig] = None,
    ):
        self.enc = enc
        self.g = g
        self.m = m
        self.k = g - m
        self.config = config or KernelConfig()
        self.alpha = enc.hash_base
        self.code_min = enc.code_min
        self.n = enc.n
        if self.config.mesh is not None:
            # as in the JAX engine: mesh exact kernels are the packed
            # engine's job (its ring shards the window table and the
            # kernel rows); the API's auto route falls back to it on this
            raise ValueError(
                "the seq-aligned pairs engine is single-device; mesh "
                "exact kernels run on the packed engine -- use "
                "exact_engine='packed' or 'auto'"
            )

        self.p = enc.max_len - g + 1
        self.p_pad = _next_multiple(self.p, 8)
        if self.p_pad**2 * math.comb(g, self.k) >= 2**31:
            raise ValueError(
                "per-pair count bound exceeds int32; use the theta engine "
                f"(p_pad={self.p_pad}, C(g,k)={math.comb(g, self.k)})"
            )
        # kernel A's own limits, checked on shapes alone so that every
        # device makes the same choice: its C(d, k) table (the API's g <= 20)
        # and its grid (mma_plan raises past the launch limit)
        if not 1 <= self.k <= g <= 20:
            raise ValueError(f"kernel A needs 1 <= k <= g <= 20; got g={g}, k={self.k}")
        # kernel A tiles up to 8 sequences a side; padding sequences have
        # no valid windows and count 0
        self.n_pad = _next_multiple(self.n, 8)
        mma_plan(self.n_pad, self.p_pad, g * self.alpha, g)

    def _build_x(self) -> torch.Tensor:
        """One-hot windows ``[n_pad * p_pad, g * alpha]`` int8 on the device."""
        dev = self.config.device
        with span("engine.stage"):
            ids = np.asarray(self.enc.ids)
            lengths = np.asarray(self.enc.lengths)
            if self.n_pad > self.n:
                ids = np.pad(ids, ((0, self.n_pad - self.n), (0, 0)))
                lengths = np.pad(lengths, (0, self.n_pad - self.n))
            x = pairs.onehot_windows(
                torch.from_numpy(ids).to(dev),
                torch.from_numpy(lengths).to(dev),
                g=self.g,
                alpha=self.alpha,
                code_min=self.code_min,
                p_pad=self.p_pad,
            )
            return x.reshape(self.n_pad * self.p_pad, self.g * self.alpha)

    def exact_device(self) -> DeviceCounts:
        """Exact unnormalized kernel as ``DeviceCounts`` on the configured
        device (kernel A on a CUDA device)."""
        progress = Progress(quiet=self.config.quiet)
        progress.log(f"pairs exact: {self.n} sequences, p_pad={self.p_pad}")
        pairs_total = self.n * (self.n + 1) / 2 * math.comb(self.g, self.k)
        with profiler_trace(self.config.profile_dir), timed(
            progress, "pairs exact kernel", pairs_total, "pairs",
            device=None if self.config.quiet else self.config.device,
        ):
            x = self._build_x()
            with span("count"):
                full = pairs_counts(x, g=self.g, k=self.k, p_pad=self.p_pad)
            counts = full[: self.n, : self.n].contiguous()
        return DeviceCounts(counts)

    def exact(self) -> np.ndarray:
        """Exact unnormalized kernel, int64 [N, N] on the host."""
        return self.exact_device().to_host_int64()


class PackedPairsEngine:
    """Ragged-aware all-pairs exact engine (ops/pairs_packed.py).

    Sequences sorted by descending length pack back to back (rows rounded
    to 8), so the work tracks the true window count instead of
    N * max_windows (up to ~35x less on SCOP or NLP data), and int64 sums
    remove the sequence-aligned engine's int32 per-pair bound.

    Routes, as in the JAX engine: kernel D (``packed_band``, one launch)
    by default; kernel E (``packed_pairlist``, one launch over the upper
    list of strip pairs, landing in the matrix) with
    ``FASTSK_PACKED_PAIRLIST=1``; kernel G (``packed_grouped``, one launch
    a strip) with ``pairs_backend="pallas_grouped"``.
    Under a mesh, kernel F (``packed_block``) in the ring ("ring": one
    launch a device and ring step) or in round-robin strips ("round-robin":
    one launch a strip), by ``mesh_state``.
    """

    TILE = 2048
    GROUP = 8  # b strips per kernel G launch
    SLAB_BYTES = pairs_packed.SLAB_BYTES  # kernel G's part blocks per launch

    def __init__(
        self,
        enc: EncodedSeqs,
        g: int,
        m: int,
        config: Optional[KernelConfig] = None,
    ):
        self.enc = enc
        self.g = g
        self.m = m
        self.k = g - m
        self.config = config or KernelConfig()
        self.alpha = enc.hash_base
        self.code_min = enc.code_min
        self.n = enc.n

        # the JAX engine's refusal (its smallest digit base, 2, must keep
        # p_max^2 * (base - 1) < 2^31); kept so that the API falls back
        # at the same shapes
        p_max = int(enc.num_windows(g).max())
        if p_max**2 >= 2**31:
            raise ValueError(
                f"windows per sequence too large for int32 digit planes "
                f"(p_max={p_max})"
            )
        if self.alpha > 256:
            raise ValueError(
                f"alphabet {self.alpha} exceeds the packed kernels' one-byte codes"
            )

        self.order = np.argsort(-np.asarray(enc.lengths), kind="stable")
        lengths_sorted = np.asarray(enc.lengths)[self.order]
        self.tile = self.TILE
        backend = self.config.pairs_backend
        self.mesh = self.config.mesh
        self.route = "grouped" if backend == "pallas_grouped" else "band"
        if self.mesh is not None:
            self.route = "ring" if self.config.mesh_state == "sharded" else "round-robin"
        self.group = self.GROUP if self.route == "grouped" else 1
        self.pack = pairs_packed.pack_windows(
            lengths_sorted, g, self.tile, self.group
        )
        self.n_strips = self.pack["n_strips"]
        self.c_max = self.pack["c_max"]
        self.c_pad = -(-self.c_max // 16) * 16
        self.total_rows = self.pack["total_pad"]
        if self.route == "band" and os.environ.get("FASTSK_PACKED_PAIRLIST") == "1":
            self.route = "pairlist"
        self._ids_sorted = np.asarray(enc.ids)[self.order]

    def rows(self, device=None) -> PackedRows:
        """The packed window table on ``device`` (the configured one by
        default)."""
        dev = self.config.device if device is None else device
        with span("engine.stage"):
            seq_of = torch.from_numpy(self.pack["seq_of"]).to(dev)
            codes = pairs_packed.window_codes(
                torch.from_numpy(self._ids_sorted).to(dev),
                seq_of,
                torch.from_numpy(self.pack["win_of"]).to(dev),
                g=self.g, code_min=self.code_min,
            ).to(torch.int32)
            return PackedRows(
                codes=codes.contiguous(), seq_of=seq_of,
                first_seq=torch.from_numpy(self.pack["first_seq"]).to(dev),
                tile=self.tile, c_pad=self.c_pad, alpha=self.alpha,
            )

    def counts_sorted(self) -> torch.Tensor:
        """The full symmetric count matrix ``[n, n]`` int64 on the device,
        in length-sorted order."""
        rows = self.rows()
        with span("count"):
            if self.route == "band":
                return packed_band(rows, k=self.k, n_out=self.n)
            dev = rows.device
            ns = self.n_strips
            fs = rows.first_seq
            mat = torch.zeros(
                (self.n + self.c_pad,) * 2, dtype=torch.int64, device=dev
            )
            if self.route == "pairlist":
                # every upper strip pair (a, b >= a), row-major, in one launch
                pa, pb = torch.triu_indices(ns, ns, device=dev).to(torch.int32)
                packed_pairlist(rows, pa, pb, k=self.k, out=mat)
            else:  # grouped: strip a against the groups of strips b >= a
                group, n_groups = self.group, ns // self.group
                per = max(1, self.SLAB_BYTES // (group * self.c_pad**2 * 8))
                for a in range(ns):
                    g0 = a // group
                    parts = torch.cat([
                        packed_grouped(
                            rows, a, gi, k=self.k, group=group, n_groups=min(per, n_groups - gi)
                        )
                        for gi in range(g0, n_groups, per)
                    ])[a - g0 * group :]
                    b = torch.arange(a, ns, device=dev)
                    pairs_packed.land_parts(
                        mat, parts, fs[torch.full_like(b, a)], fs[b], b > a
                    )
            return mat[: self.n, : self.n]

    def _counts(self) -> torch.Tensor:
        """Exact int64 counts ``[n, n]`` in the input order, on the device
        (the length sort is undone there)."""
        progress = Progress(quiet=self.config.quiet)
        progress.log(
            f"packed pairs exact ({self.route}): {self.n} sequences, "
            f"{self.total_rows} window rows, strips={self.n_strips}, c_max={self.c_max}"
        )
        with profiler_trace(self.config.profile_dir), timed(
            progress, "packed pairs kernel", self._pairs_total(), "pairs",
            device=None if self.config.quiet else self.config.device,
        ):
            k_sorted = self.counts_sorted()
            with span("engine.unsort"):
                pos = np.empty(self.n, dtype=np.int64)
                pos[self.order] = np.arange(self.n)
                pos_t = torch.from_numpy(pos).to(k_sorted.device)
                return k_sorted.index_select(0, pos_t).index_select(1, pos_t)

    def _pairs_total(self) -> float:
        return self.n * (self.n + 1) / 2 * math.comb(self.g, self.k)

    def exact_device(self):
        """Exact unnormalized kernel: ``DeviceCounts`` (int32, on the
        device) when every count is < 2^31, and host int64 numpy otherwise,
        as the JAX engine returns; callers take both. Single-device."""
        if self.mesh is not None:
            raise ValueError("device-resident exact is single-device")
        full = self._counts()
        with span("engine.unsort"):
            small = int(full.max()) < 2**31
        if small:
            return DeviceCounts(full.to(torch.int32))
        return full.cpu().numpy()

    def exact(self) -> np.ndarray:
        """Exact unnormalized kernel, int64 [N, N] on the host."""
        if self.mesh is None:
            return self._counts().cpu().numpy()
        progress = Progress(quiet=self.config.quiet)
        progress.log(
            f"packed pairs exact ({self.route}, {self.mesh.size} devices): "
            f"{self.n} sequences, {self.total_rows} window rows, "
            f"strips={self.n_strips}, c_max={self.c_max}"
        )
        with profiler_trace(self.config.profile_dir), timed(
            progress, "packed pairs kernel (mesh)", self._pairs_total(), "pairs"
        ):
            if self.config.mesh_state == "sharded":
                k_sorted = self._exact_sharded_planes_rows()
            else:
                k_sorted = self._exact_sharded_planes()
        pos = np.empty(self.n, dtype=np.int64)
        pos[self.order] = np.arange(self.n)
        return k_sorted[np.ix_(pos, pos)]

    def _per_device(self, make) -> dict:
        """``make(device)`` for each of this process's mesh entries, by
        entry, made once per distinct device (a repeated device shares its
        tensors, as JAX's replicated operands are one buffer per device).
        Another process's entries are not made: their device names that
        process's card."""
        made, out = {}, {}
        for e, _, _ in self.mesh.local_entries():
            dev = self.mesh.devices[e]
            if dev not in made:
                made[dev] = make(dev)
            out[e] = made[dev]
        return out

    def _exact_sharded_planes_rows(self) -> np.ndarray:
        """Ring-sharded mesh run (``mesh_state="sharded"``, the default):
        the window table is strip-sharded to match each entry's kernel
        row block and travels the ring once while every entry sweeps its
        own strips against each visiting shard
        (``parallel/sharding.py:packed_ring_rowsharded``). Per-entry
        memory is the [blk, Np] block plus two shards; overlapping row
        blocks (sequences straddling them) add on the host, and across
        processes one sum merges the hosts' matrices. The block sizes are
        the JAX engine's."""
        mesh = self.mesh
        n_dev = mesh.size
        n_pad = self.n + self.c_pad
        spd = -(-self.n_strips // n_dev)  # own strips per entry
        fs = np.asarray(self.pack["first_seq"])
        row0 = np.zeros(n_dev, np.int64)
        blk = self.c_max
        for d in range(n_dev):
            s0 = d * spd
            s1 = min(s0 + spd, self.n_strips)
            if s0 < self.n_strips:
                row0[d] = fs[s0]
                blk = max(blk, int(fs[s1 - 1]) + self.c_max - int(fs[s0]))

        # the table padded to n_dev * spd strips: dead strips hold padding
        # rows only (seq_of = -1) and are skipped
        full = self.rows(torch.device("cpu"))
        rows_pad = n_dev * spd * self.tile
        extra = rows_pad - self.total_rows
        codes = torch.nn.functional.pad(full.codes, (0, 0, 0, extra), value=-1)
        seq_of = torch.nn.functional.pad(full.seq_of, (0, extra), value=-1)
        first = torch.nn.functional.pad(
            full.first_seq, (0, n_dev * spd - self.n_strips), value=self.n
        )
        rows_d = spd * self.tile
        local = [(d, mesh.devices[d]) for d, _, _ in mesh.local_entries()]
        shards = {
            d: PackedRows(
                codes=codes[d * rows_d : (d + 1) * rows_d].to(dev),
                seq_of=seq_of[d * rows_d : (d + 1) * rows_d].to(dev),
                first_seq=first[d * spd : (d + 1) * spd].to(dev),
                tile=self.tile, c_pad=self.c_pad, alpha=self.alpha,
            )
            for d, dev in local
        }
        blocks = {d: torch.zeros((blk, n_pad), dtype=torch.int64, device=dev)
                  for d, dev in local}
        blocks = shd.packed_ring_rowsharded(
            blocks, shards, [int(r) for r in row0], mesh=mesh, spd=spd, k=self.k,
            n_strips=self.n_strips,
        )
        rows_total = max(int(row0.max()) + blk, n_pad)
        k_full = np.zeros((rows_total, n_pad), np.int64)
        for d, b in blocks.items():
            k_full[row0[d] : row0[d] + blk] += b.cpu().numpy()
        shd.reduce_across(torch.from_numpy(k_full), mesh)
        return k_full[: self.n, : self.n]

    def _exact_sharded_planes(self) -> np.ndarray:
        """Mesh-parallel strips, round-robin (``mesh_state="replicated"``):
        each entry adds its strips' part blocks into a private full-size
        replica; the host sums this process's replicas and one sum merges
        the processes' (each (a, b) pair lands on exactly one entry)."""
        mesh = self.mesh
        n_pad = self.n + self.c_pad
        rows = self._per_device(self.rows)
        mats = {e: torch.zeros((n_pad, n_pad), dtype=torch.int64, device=mesh.devices[e])
                for e in rows}
        for ridx in range(-(-self.n_strips // mesh.size)):
            mats = shd.packed_round_sharded(
                mats, rows, ridx, mesh=mesh, k=self.k, n_strips=self.n_strips,
            )
        total = torch.zeros((n_pad, n_pad), dtype=torch.int64)
        for m in mats.values():
            total += m.cpu()
        return shd.reduce_across(total, mesh).numpy()[: self.n, : self.n]
