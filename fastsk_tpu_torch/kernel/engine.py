"""Exact and Monte-Carlo gapped k-mer kernels over theta passes.

Counterpart of ``fastsk_tpu/kernel/engine.py``. The engine owns the theta
work queue (the ``C(g, m)`` position subsets), cuts it into device-sized
batches and accumulates exact integer count matrices on the device
(ops/gkm.py); approx mode samples a seeded shuffle of the queue with the
reference's Welford stop rule, deterministic given the seed. Under
``KernelConfig.mesh`` exact mode shards rows x theta and approx mode rows
only (parallel/sharding.py). ``KernelConfig.checkpoint_path`` persists the
accumulator and the queue's cursor (utils/checkpoint.py), in the JAX
engine's layout and under its digests: either package resumes the other's
checkpoint. Progress lines go through ``utils/observe.Progress`` (gated by
``KernelConfig.quiet``), and ``KernelConfig.profile_dir`` takes a
``torch.profiler`` trace of each exact run, where the JAX engine traces.
Approx mode's batch updates and its one pull a batch are the spans
``theta.batch`` and ``theta.pull`` of ``utils/observe.py``.

Integer exactness, as in the JAX engine: each batch's partial kernel is
exact (``theta_batch * p_max^2 < 2^24`` in f32, or below 2^31 in f64 past
4095 windows a sequence), accumulated in an int32 device buffer that
spills — to a host int64 accumulator, or into the device ``hi`` plane of
``DeviceCounts`` — before int32 could overflow. Under a mesh one step
lands a whole batch on every row block, so the spill comes before the add.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..ops import gkm
from ..ops.combinatorics import enumerate_combinations, sample_combinations
from ..ops.encode import EncodedSeqs
from ..parallel import sharding as shd
from ..utils.checkpoint import KernelCheckpoint, problem_digest, theta_tag
from ..utils.observe import Progress, profiler_trace, span, timed
from .config import KernelConfig
from .device_counts import _CARRY_SHIFT, DeviceCounts, _carry_spill


@dataclass
class ApproxResult:
    counts: object  # int64 [N, N] numpy, or DeviceCounts with device_out
    iters: int  # number of thetas consumed
    stdevs: List[float]  # per-iteration convergence sd trace
    converged: bool


def theta_stream(g: int, k: int, seed: int) -> np.ndarray:
    """The seeded shuffle of all C(g, k) subsets that approx mode consumes
    (``fastsk_tpu/kernel/engine.py:485-488``, element for element)."""
    return sample_combinations(g, k, np.random.default_rng(seed))


def _top_left(a: np.ndarray, size: int) -> np.ndarray:
    """``a`` cut or zero-padded to ``[size, size]``: a checkpoint's matrix
    from a mesh of another rows-axis size, or from one device (padding
    rows and columns count zero)."""
    out = np.zeros((size, size), dtype=a.dtype)
    m = min(size, a.shape[0])
    out[:m, :m] = a[:m, :m]
    return out


class DenseGkmEngine:
    """Dense-bucket engine: valid when ``hash_base ** k`` is materializable.

    Covers every DNA workload and the small-k protein/text configurations;
    the sorted engine (``kernel/sorted_engine.py``) covers the rest.
    """

    def __init__(self, enc: EncodedSeqs, g: int, m: int, config: Optional[KernelConfig] = None):
        self.enc = enc
        self.g = g
        self.m = m
        self.k = g - m
        self.config = config or KernelConfig()
        self.progress = Progress(quiet=self.config.quiet)
        self.base = enc.hash_base
        self.code_min = enc.code_min

        self.b_total = self.base**self.k
        if self.b_total > self.config.b_max_dense:
            raise ValueError(
                f"bucket space base**k = {self.b_total} exceeds dense "
                f"limit {self.config.b_max_dense}; use the sorted path"
            )
        self.k1, self.k2 = gkm.split_k(self.k)
        self.b1 = self.base**self.k1
        self.b2 = self.base**self.k2

        self.n = enc.n
        self.p = enc.max_len - g + 1
        self.p_max = int(enc.num_windows(g).max())
        self.device = self.config.device
        self.matmul_dtype = gkm.matmul_dtype(self.p_max, self.device)

        cfg = self.config
        self.theta_batch = cfg.theta_batch or self._auto_theta_batch()
        self.row_chunk = cfg.row_chunk or self._auto_row_chunk()
        self.mesh = cfg.mesh
        # the count product: the u8 kernel on one card while counts fit u8
        self.route = gkm.theta_route(self.p_max, self.device, mesh=self.mesh is not None)
        if self.mesh is not None:
            # entry -> its row block, on its device (length-0 padding rows)
            self._ids, self._lengths, self.n_padded = shd.shard_rows(
                self.mesh, enc.ids, enc.lengths
            )
        else:
            self._ids = torch.as_tensor(np.asarray(enc.ids, dtype=np.int32), device=self.device)
            self._lengths = torch.as_tensor(np.asarray(enc.lengths, dtype=np.int32),
                                            device=self.device)
            self.n_padded = self.n

        # Batches keep sum_t Ks_t < 2^24 for exact f32 products; beyond
        # 4095 windows a sequence the f64 product takes over (route f64).
        f64 = self.route == "f64"
        if not f64:
            f32_exact_cap = max(1, (1 << 24) // max(self.p_max**2, 1))
            self.theta_batch = max(1, min(self.theta_batch, f32_exact_cap))
        # Spill the int32 accumulator before int32 could overflow: a run
        # of thetas accumulated on the device keeps sum_t Ks_t <= thetas *
        # p_max^2 < 2^31 (with margin 2).
        int32_safe = max(1, ((1 << 31) - 1) // max(self.p_max**2, 1) // 2)
        if f64:
            # one batch's product is cast to int32 whole
            self.theta_batch = max(1, min(self.theta_batch, int32_safe))
        self.spill_every_thetas = max(self.theta_batch, int32_safe)

    # ---------------------------------------------------------- sizing

    def _auto_theta_batch(self) -> int:
        cfg = self.config
        bytes_per_theta = self.n * self.b_total * np.dtype(np.float32).itemsize
        t = max(1, cfg.counts_budget_bytes // max(bytes_per_theta, 1))
        return int(min(t, cfg.max_theta_batch))

    def _auto_row_chunk(self) -> int:
        """Rows a chunk: the fewer of those whose hash and scatter-index
        tensors (``gkm.HASH_BYTES`` a window and theta) fit
        ``hash_budget_bytes`` and those whose one-hot count intermediates
        (``b1 + b2`` buckets a window and theta) fit
        ``onehot_budget_bytes``, the latter as the JAX package sizes its
        chunk (fastsk_tpu/kernel/engine.py:_auto_row_chunk)."""
        cfg = self.config
        per_row = self.p * self.theta_batch * gkm.HASH_BYTES
        hash_rows = max(1, min(self.n, cfg.hash_budget_bytes // per_row))
        per_row = self.p * (self.b1 + self.b2) * self.matmul_dtype.itemsize * self.theta_batch
        rows = max(8, cfg.onehot_budget_bytes // max(per_row, 1))
        onehot_rows = min(-(-min(rows, self.n) // 8) * 8, -(-self.n // 8) * 8)
        return int(min(hash_rows, onehot_rows))

    def _hash_kwargs(self) -> dict:
        return dict(g=self.g, base=self.base, code_min=self.code_min, k1=self.k1, b1=self.b1,
                    b2=self.b2, row_chunk=self.row_chunk)

    def _static_kwargs(self) -> dict:
        """The batch updates' arguments (ops/gkm.py, parallel/sharding.py)."""
        return dict(self._hash_kwargs(), route=self.route)

    def _batch(self, thetas: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(thetas, dtype=np.int64), device=self.device)

    # ---------------------------------------------------------- exact

    def _checkpoint(self, tag: str) -> Optional[KernelCheckpoint]:
        """The KernelCheckpoint of this problem under ``tag`` (None if
        disabled)."""
        if self.config.checkpoint_path is None:
            return None
        digest = problem_digest(
            np.asarray(self.enc.ids), np.asarray(self.enc.lengths), self.g, self.m, extra=tag,
        )
        return KernelCheckpoint(self.config.checkpoint_path, digest)

    @staticmethod
    def _save(ckpt: KernelCheckpoint, **arrays) -> None:
        """Write a checkpoint: across processes every rank holds the same
        arrays and rank 0 writes them."""
        if shd.process_rank() == 0:
            ckpt.save(**arrays)

    def _sum_thetas(self, thetas: np.ndarray) -> np.ndarray:
        """Exact integer sum of K_theta over an explicit theta list, int64
        on the host."""
        if self.mesh is not None:
            return self._sum_thetas_sharded(thetas)
        n = self.n
        host_acc = np.zeros((n, n), dtype=np.int64)
        k_acc = torch.zeros((n, n), dtype=torch.int32, device=self.device)
        kwargs = self._static_kwargs()
        ckpt = self._checkpoint(f"sum:{len(thetas)}:{theta_tag(thetas)}")
        since_spill = since_ckpt = 0
        i = 0
        if ckpt is not None and (saved := ckpt.load()) is not None:
            host_acc = saved["host_acc"].copy()
            i = int(saved["next_theta"])
        while i < len(thetas):
            batch = thetas[i : i + self.theta_batch]
            gkm.exact_batch_update(k_acc, self._ids, self._lengths, self._batch(batch), **kwargs)
            i += len(batch)
            since_spill += len(batch)
            since_ckpt += len(batch)
            if since_spill >= self.spill_every_thetas:
                host_acc += k_acc.cpu().numpy()
                k_acc.zero_()
                since_spill = 0
            if ckpt is not None and since_ckpt >= self.config.checkpoint_every:
                host_acc += k_acc.cpu().numpy()
                k_acc.zero_()
                since_spill = since_ckpt = 0
                self._save(ckpt, host_acc=host_acc, next_theta=np.int64(i))
        host_acc += k_acc.cpu().numpy()
        return host_acc

    def _sum_thetas_device(self, thetas: np.ndarray) -> DeviceCounts:
        """Exact integer sum of K_theta, kept on the device: the same
        batching and spill cadence as ``_sum_thetas``, but a spill carries
        completed 2**30-units into the ``hi`` plane instead of pulling to
        the host. A checkpoint carries first (so the saved ``lo`` keeps the
        spill invariant) and pulls ``lo`` and ``hi``; the result stays on
        the device."""
        n = self.n
        lo = torch.zeros((n, n), dtype=torch.int32, device=self.device)
        hi = None
        kwargs = self._static_kwargs()
        ckpt = self._checkpoint(f"sum_dev:{len(thetas)}:{theta_tag(thetas)}")
        since_spill = since_ckpt = 0
        i = 0
        total = len(thetas)
        if ckpt is not None and (saved := ckpt.load()) is not None:
            lo = torch.as_tensor(saved["lo"], dtype=torch.int32, device=self.device)
            if bool(saved["spilled"]):
                hi = torch.as_tensor(saved["hi"], dtype=torch.int32, device=self.device)
            i = int(saved["next_theta"])
        while i < total:
            batch = thetas[i : i + self.theta_batch]
            gkm.exact_batch_update(lo, self._ids, self._lengths, self._batch(batch), **kwargs)
            i += len(batch)
            since_spill += len(batch)
            since_ckpt += len(batch)
            if since_spill >= self.spill_every_thetas and i < total:
                lo, hi = _carry_spill(lo, hi)
                since_spill = 0
            if ckpt is not None and since_ckpt >= self.config.checkpoint_every:
                lo, hi = _carry_spill(lo, hi)
                since_spill = since_ckpt = 0
                self._save(ckpt, lo=lo.cpu().numpy(), hi=hi.cpu().numpy(),
                           spilled=np.bool_(True), next_theta=np.int64(i))
        return DeviceCounts(lo, hi)

    def _sharded_batch_sz(self, n_theta: int) -> int:
        """Thetas a step under a mesh, clamped to the int32 headroom.

        One sharded step lands ``per_dev * n_theta`` thetas on every row
        block at once, so the *batch itself* must respect the spill bound:
        the pre-add spill can only protect accumulated history, never the
        incoming batch. With so many theta-axis devices that even one theta
        a device exceeds the margin-2 headroom, no spill cadence helps:
        refuse loudly rather than overflow silently.
        """
        per_dev = min(max(self.theta_batch, 1), max(1, self.spill_every_thetas // n_theta))
        batch_sz = per_dev * n_theta
        if batch_sz > 2 * self.spill_every_thetas:
            raise ValueError(
                f"theta mesh axis too wide for int32 accumulation: one "
                f"theta per device lands {n_theta} thetas x p_max^2="
                f"{self.p_max ** 2} counts per step, above the int32 "
                f"headroom of {2 * self.spill_every_thetas} thetas; "
                f"shrink the theta axis or the windows-per-sequence bound"
            )
        return batch_sz

    def _mesh_step(self, thetas: np.ndarray, i: int, acc, since_spill: int, spill):
        """One mesh step over ``thetas[i:]`` into the row-block
        accumulators ``acc``; returns the new ``(i, since_spill)``.
        ``spill()`` runs BEFORE a step whose thetas would pass the int32
        headroom: one step lands the whole batch on every row block, more
        than the single-device overshoot margin covers."""
        n_theta = self.mesh.n_theta
        t = min(self._sharded_batch_sz(n_theta), len(thetas) - i)
        if since_spill + t > self.spill_every_thetas:
            spill()
            since_spill = 0
        batch, mask = shd.pad_theta_batch(np.asarray(thetas[i : i + t], dtype=np.int64), n_theta)
        shd.exact_batch_update_sharded(
            acc, self._ids, self._lengths, batch, mask, mesh=self.mesh, **self._static_kwargs()
        )
        return i + t, since_spill + t

    def _sum_thetas_sharded_device(self, thetas: np.ndarray) -> DeviceCounts:
        """Mesh device-resident exact sum: ``lo`` and ``hi`` stay in row
        blocks on the mesh's entries (the dense engine's layout), and the
        result is collapsed onto ``config.device`` (``_collapse``)."""
        lo = shd.row_accumulators(self.mesh, self.n_padded // self.mesh.n_rows, self.n_padded)
        hi = {}

        def carry():
            for r in lo:
                lo[r], hi[r] = _carry_spill(lo[r], hi.get(r))

        i = since_spill = 0
        while i < len(thetas):
            i, since_spill = self._mesh_step(thetas, i, lo, since_spill, carry)
        return self._collapse(lo, hi or None)

    def _collapse(self, lo, hi) -> DeviceCounts:
        """The row blocks' ``DeviceCounts`` on ``config.device``, the
        counterpart of ``fastsk_tpu/api.py:_collapse_shards``: within one
        process moved device to device, padding cut; across processes
        every rank assembles the whole matrix (one int64 sum, split again
        into ``lo`` and ``hi``) and fits the same replica."""
        mesh, dev, n = self.mesh, self.device, self.n
        if not mesh.multiprocess:
            def whole(blocks):
                return torch.cat([blocks[r].to(dev) for r in range(mesh.n_rows)])[:n, :n].contiguous()

            return DeviceCounts(whole(lo), None if hi is None else whole(hi))
        v = {r: lo[r].to(torch.int64) + (0 if hi is None else hi[r].to(torch.int64) << _CARRY_SHIFT)
             for r in lo}
        full = torch.cat(shd.gather_rows(v, mesh, (self.n_padded,) * 2, 0, torch.int64))
        full = full[:n, :n].to(dev)
        hi_full = (full >> _CARRY_SHIFT).to(torch.int32)
        lo_full = (full - (hi_full.to(torch.int64) << _CARRY_SHIFT)).to(torch.int32)
        return DeviceCounts(lo_full, hi_full if bool(hi_full.any()) else None)

    def exact_device(self) -> DeviceCounts:
        """Exact unnormalized kernel as device-resident ``DeviceCounts``
        (one device, or collapsed from a mesh's row blocks)."""
        thetas = enumerate_combinations(self.g, self.k)
        self.progress.log(
            f"dense exact (device-resident): {len(thetas)} passes over {self.n} sequences"
        )
        with profiler_trace(self.config.profile_dir):
            if self.mesh is not None:
                return self._sum_thetas_sharded_device(thetas)
            return self._sum_thetas_device(thetas)

    def _sum_thetas_sharded(self, thetas: np.ndarray) -> np.ndarray:
        """Mesh-parallel exact sum: rows x theta sharding, psum merge.

        Checkpointing mirrors the single-device path: the host int64
        accumulator plus the work-queue cursor persist under a digest that
        pins the exact theta stream, so a multi-device run interrupted
        mid-queue resumes without recomputation.
        """
        mesh, np_pad = self.mesh, self.n_padded
        k_acc = shd.row_accumulators(mesh, np_pad // mesh.n_rows, np_pad)
        ckpt = self._checkpoint(f"sum_sharded:{len(thetas)}:{theta_tag(thetas)}")
        host_acc = np.zeros((np_pad, np_pad), dtype=np.int64)
        i = 0
        if ckpt is not None and (saved := ckpt.load()) is not None:
            host_acc = _top_left(saved["host_acc"], np_pad)
            i = int(saved["next_theta"])

        def spill():
            shd.host_rows(k_acc, mesh, host_acc, np_pad // mesh.n_rows)
            for a in k_acc.values():
                a.zero_()

        since_spill = since_ckpt = 0
        while i < len(thetas):
            j, since_spill = self._mesh_step(thetas, i, k_acc, since_spill, spill)
            since_ckpt += j - i
            i = j
            if ckpt is not None and since_ckpt >= self.config.checkpoint_every:
                spill()
                since_spill = since_ckpt = 0
                self._save(ckpt, host_acc=host_acc, next_theta=np.int64(i))
        spill()
        return host_acc[: self.n, : self.n]

    def exact(self) -> np.ndarray:
        """Exact unnormalized kernel (int64 [N, N]) over all C(g, m) subsets."""
        thetas = enumerate_combinations(self.g, self.k)
        self.progress.log(
            f"dense exact: {len(thetas)} passes over {self.n} sequences "
            f"(B={self.b_total}, batch={self.theta_batch})"
        )
        pairs_total = self.n * (self.n + 1) / 2 * len(thetas)
        with profiler_trace(self.config.profile_dir), timed(
            self.progress, "dense exact kernel", pairs_total, "pairs",
            device=None if self.config.quiet else self.device,
        ):
            return self._sum_thetas(thetas)

    # ---------------------------------------------------------- approx

    def _approx_state(self, saved=None):
        """The Welford state ``(k_sum, mean, it, done)``: ``[n, n]``
        tensors on one device, or under a mesh maps from each row block
        whose entry ``(r, 0)`` is this process's to its ``[n_local, Np]``
        block on that entry's device; zero, or from a checkpoint."""
        mesh = self.mesh
        if mesh is None:
            size, lead, n_blocks, home = self.n, self.device, 1, {0: self.device}
        else:
            size, lead, n_blocks = self.n_padded, mesh.lead_device, mesh.n_rows
            home = {r: mesh.devices[mesh.entry(r, 0)] for r in range(n_blocks)
                    if mesh.is_local(mesh.entry(r, 0))}
        nl = size // n_blocks
        planes = []
        for key, dtype in (("k_sum", torch.int32), ("mean", torch.float32)):
            full = None if saved is None else _top_left(saved[key], size)
            planes.append({
                r: (torch.zeros((nl, size), dtype=dtype, device=dev) if full is None
                    else torch.as_tensor(full[r * nl : (r + 1) * nl], device=dev))
                for r, dev in home.items()
            })
        it = torch.tensor(0 if saved is None else int(saved["it"]), dtype=torch.int32, device=lead)
        done = torch.tensor(False if saved is None else bool(saved["done"]), device=lead)
        if mesh is None:
            return planes[0][0], planes[1][0], it, done
        return planes[0], planes[1], it, done

    def _approx_host(self, state, plane: int = 0) -> np.ndarray:
        """A Welford state's ``k_sum`` (``plane`` 0, int64) or ``mean`` (1,
        f32) on the host (every process, under a mesh)."""
        if self.mesh is None:
            return state[plane].cpu().numpy().astype(np.int64 if plane == 0 else np.float32)
        size = self.n_padded
        out = np.zeros((size, size), dtype=np.int64 if plane == 0 else np.float32)
        return shd.host_rows(state[plane], self.mesh, out, size // self.mesh.n_rows)

    def approx(
        self,
        conv_delta: float = 0.025,
        max_iters: int = -1,
        skip_variance: bool = False,
        seed: int = 0,
        device_out: bool = False,
    ) -> ApproxResult:
        """Monte-Carlo sampling of position subsets without replacement.

        The reference's single-thread semantics (fastsk_kernel.cpp:188-262):
        a seeded shuffle of all subsets; with variance tracking, stop when
        the 95% CI half-width drops below ``conv_delta``; honor
        ``max_iters``; with ``skip_variance`` sum the first ``max_iters``
        passes. The host reads the done flag and the sd trace once a batch.
        ``device_out`` returns ``DeviceCounts`` instead of host counts (one
        device, no checkpoint).
        """
        if device_out and (self.mesh is not None or self.config.checkpoint_path is not None):
            raise ValueError("device_out requires a single device without checkpointing")
        stream = theta_stream(self.g, self.k, seed)
        total = len(stream)

        if skip_variance:
            limit = total if max_iters == -1 else min(max_iters, total)
            if device_out:
                counts = self._sum_thetas_device(stream[:limit])
            else:
                counts = self._sum_thetas(stream[:limit])
            return ApproxResult(counts=counts, iters=limit, stdevs=[], converged=False)

        welford = dict(n_train=self.enc.n_train, conv_delta=conv_delta, max_iters=max_iters)
        ckpt = self._checkpoint(f"approx:{seed}:{conv_delta}:{max_iters}")
        saved = ckpt.load() if ckpt is not None else None
        state = self._approx_state(saved)
        stdevs: List[float] = [] if saved is None else [float(s) for s in saved["stdevs"]]
        i = 0 if saved is None else int(saved["next_theta"])
        done = bool(state[3])
        since_ckpt = 0
        while i < total and not done:
            batch = stream[i : i + self.theta_batch]
            with span("theta.batch"):
                if self.mesh is None:
                    state, sds = gkm.approx_batch_update(
                        state, self._ids, self._lengths, self._batch(batch),
                        **self._static_kwargs(), **welford)
                else:
                    state, sds = shd.approx_batch_update_sharded(
                        state, self._ids, self._lengths, np.asarray(batch), mesh=self.mesh,
                        **self._static_kwargs(), **welford)
            i += len(batch)
            since_ckpt += len(batch)
            # one sync a batch: the sd trace and the done flag together
            with span("theta.pull"):
                pulled = torch.cat([sds, state[3].to(torch.float32)[None]]).cpu().numpy()
            stdevs.extend(float(s) for s in pulled[:-1] if not math.isnan(s))
            done = bool(pulled[-1])
            if ckpt is not None and since_ckpt >= self.config.checkpoint_every:
                since_ckpt = 0
                self._save(ckpt, k_sum=self._approx_host(state).astype(np.int32),
                           mean=self._approx_host(state, 1),
                           it=np.int32(state[2].item()), done=np.bool_(state[3].item()),
                           next_theta=np.int64(i), stdevs=np.asarray(stdevs, dtype=np.float64))

        it, done_flag = int(state[2]), bool(state[3])
        self.progress.log(f"approx: {'converged' if done_flag else 'stopped'} after {it} iterations")
        # the variance-tracked loop sums k_sum in int32 with no spill, as
        # the JAX engine does (the stream's length bounds it)
        if device_out:
            counts = DeviceCounts(state[0])
        else:
            counts = self._approx_host(state)[: self.n, : self.n]
        return ApproxResult(
            counts=counts,
            iters=it,
            stdevs=stdevs,
            converged=done_flag and (max_iters == -1 or it < max_iters),
        )


def cosine_normalize(counts: np.ndarray) -> np.ndarray:
    """float64 cosine normalization, bit-matching the reference's double math
    (fastsk_kernel.cpp:96-103)."""
    k = counts.astype(np.float64)
    diag = np.diag(k).copy()
    # sqrt of the product (not product of sqrts): the reference computes
    # sqrt(K[i][i] * K[j][j]) per entry, and the two differ in the last ulp.
    return k / np.sqrt(np.multiply.outer(diag, diag))
