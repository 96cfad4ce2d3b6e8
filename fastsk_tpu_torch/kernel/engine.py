"""Exact and Monte-Carlo gapped k-mer kernels over theta passes.

Counterpart of ``fastsk_tpu/kernel/engine.py`` on one device. The engine
owns the theta work queue (the ``C(g, m)`` position subsets), cuts it into
device-sized batches and accumulates exact integer count matrices on the
device (ops/gkm.py); approx mode samples a seeded shuffle of the queue
with the reference's Welford stop rule, deterministic given the seed.

Integer exactness, as in the JAX engine: each batch's partial kernel is
exact (``theta_batch * p_max^2 < 2^24`` in f32, or below 2^31 in f64 past
4095 windows a sequence), accumulated in an int32 device buffer that
spills — to a host int64 accumulator, or into the device ``hi`` plane of
``DeviceCounts`` — before int32 could overflow.

The theta mesh functions (``KernelConfig.mesh``) and checkpoints are not
ported yet (ROADMAP.md §1, slice 3c and slice 5).
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
from .config import KernelConfig
from .device_counts import DeviceCounts, _carry_spill


@dataclass
class ApproxResult:
    counts: object  # int64 [N, N] numpy, or DeviceCounts with device_out
    iters: int  # number of thetas consumed
    stdevs: List[float]  # per-iteration convergence sd trace
    converged: bool


def refuse_mesh(config: KernelConfig) -> None:
    """The theta engines run on one device until slice 3c is ported."""
    if config.mesh is not None:
        raise NotImplementedError(
            "the theta engines under KernelConfig.mesh are not ported yet: "
            "ROADMAP.md §1 item 3 (slice 3c, the theta mesh functions)"
        )


def theta_stream(g: int, k: int, seed: int) -> np.ndarray:
    """The seeded shuffle of all C(g, k) subsets that approx mode consumes
    (``fastsk_tpu/kernel/engine.py:485-488``, element for element)."""
    return sample_combinations(g, k, np.random.default_rng(seed))


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
        refuse_mesh(self.config)
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
        self._ids = torch.as_tensor(np.asarray(enc.ids, dtype=np.int32), device=self.device)
        self._lengths = torch.as_tensor(np.asarray(enc.lengths, dtype=np.int32), device=self.device)

        # Batches keep sum_t Ks_t < 2^24 for exact f32 products; beyond
        # 4095 windows a sequence the f64 product takes over (count_split).
        self.count_split = self.p_max > 4095
        if not self.count_split:
            f32_exact_cap = max(1, (1 << 24) // max(self.p_max**2, 1))
            self.theta_batch = max(1, min(self.theta_batch, f32_exact_cap))
        # Spill the int32 accumulator before int32 could overflow: a run
        # of thetas accumulated on the device keeps sum_t Ks_t <= thetas *
        # p_max^2 < 2^31 (with margin 2).
        int32_safe = max(1, ((1 << 31) - 1) // max(self.p_max**2, 1) // 2)
        if self.count_split:
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
        """Rows a chunk so that the chunk's hash and scatter-index tensors
        (``gkm.HASH_BYTES`` a window and theta) fit ``hash_budget_bytes``."""
        per_row = self.p * self.theta_batch * gkm.HASH_BYTES
        return int(max(1, min(self.n, self.config.hash_budget_bytes // per_row)))

    def _static_kwargs(self) -> dict:
        return dict(
            g=self.g,
            base=self.base,
            code_min=self.code_min,
            k1=self.k1,
            b1=self.b1,
            b2=self.b2,
            row_chunk=self.row_chunk,
            matmul_dtype=self.matmul_dtype,
            count_split=self.count_split,
        )

    def _batch(self, thetas: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(thetas, dtype=np.int64), device=self.device)

    def _log(self, msg: str) -> None:
        if not self.config.quiet:
            print(msg)

    # ---------------------------------------------------------- exact

    def _sum_thetas(self, thetas: np.ndarray) -> np.ndarray:
        """Exact integer sum of K_theta over an explicit theta list, int64
        on the host."""
        n = self.n
        host_acc = np.zeros((n, n), dtype=np.int64)
        k_acc = torch.zeros((n, n), dtype=torch.int32, device=self.device)
        kwargs = self._static_kwargs()
        since_spill = 0
        for i in range(0, len(thetas), self.theta_batch):
            batch = thetas[i : i + self.theta_batch]
            gkm.exact_batch_update(k_acc, self._ids, self._lengths, self._batch(batch), **kwargs)
            since_spill += len(batch)
            if since_spill >= self.spill_every_thetas:
                host_acc += k_acc.cpu().numpy()
                k_acc.zero_()
                since_spill = 0
        host_acc += k_acc.cpu().numpy()
        return host_acc

    def _sum_thetas_device(self, thetas: np.ndarray) -> DeviceCounts:
        """Exact integer sum of K_theta, kept on the device: the same
        batching and spill cadence as ``_sum_thetas``, but a spill carries
        completed 2**30-units into the ``hi`` plane instead of pulling to
        the host."""
        n = self.n
        lo = torch.zeros((n, n), dtype=torch.int32, device=self.device)
        hi = None
        kwargs = self._static_kwargs()
        since_spill = 0
        total = len(thetas)
        for i in range(0, total, self.theta_batch):
            batch = thetas[i : i + self.theta_batch]
            gkm.exact_batch_update(lo, self._ids, self._lengths, self._batch(batch), **kwargs)
            since_spill += len(batch)
            if since_spill >= self.spill_every_thetas and i + len(batch) < total:
                lo, hi = _carry_spill(lo, hi)
                since_spill = 0
        return DeviceCounts(lo, hi)

    def exact_device(self) -> DeviceCounts:
        """Exact unnormalized kernel as device-resident ``DeviceCounts``."""
        thetas = enumerate_combinations(self.g, self.k)
        self._log(f"dense exact (device-resident): {len(thetas)} passes over {self.n} sequences")
        return self._sum_thetas_device(thetas)

    def exact(self) -> np.ndarray:
        """Exact unnormalized kernel (int64 [N, N]) over all C(g, m) subsets."""
        thetas = enumerate_combinations(self.g, self.k)
        self._log(
            f"dense exact: {len(thetas)} passes over {self.n} sequences "
            f"(B={self.b_total}, batch={self.theta_batch})"
        )
        return self._sum_thetas(thetas)

    # ---------------------------------------------------------- approx

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
        ``device_out`` returns ``DeviceCounts`` instead of host counts.
        """
        stream = theta_stream(self.g, self.k, seed)
        total = len(stream)

        if skip_variance:
            limit = total if max_iters == -1 else min(max_iters, total)
            if device_out:
                counts = self._sum_thetas_device(stream[:limit])
            else:
                counts = self._sum_thetas(stream[:limit])
            return ApproxResult(counts=counts, iters=limit, stdevs=[], converged=False)

        n = self.n
        kwargs = dict(self._static_kwargs(), n_train=self.enc.n_train)
        state = (
            torch.zeros((n, n), dtype=torch.int32, device=self.device),
            torch.zeros((n, n), dtype=torch.float32, device=self.device),
            torch.zeros((), dtype=torch.int32, device=self.device),
            torch.zeros((), dtype=torch.bool, device=self.device),
        )
        stdevs: List[float] = []
        i = 0
        done = False
        while i < total and not done:
            batch = stream[i : i + self.theta_batch]
            state, sds = gkm.approx_batch_update(
                state, self._ids, self._lengths, self._batch(batch),
                conv_delta=conv_delta, max_iters=max_iters, **kwargs,
            )
            i += len(batch)
            # one sync a batch: the sd trace and the done flag together
            pulled = torch.cat([sds, state[3].to(torch.float32)[None]]).cpu().numpy()
            stdevs.extend(float(s) for s in pulled[:-1] if not math.isnan(s))
            done = bool(pulled[-1])

        k_sum, _, it, done_flag = state
        iters = int(it)
        self._log(f"approx: {'converged' if bool(done_flag) else 'stopped'} after {iters} iterations")
        # the variance-tracked loop sums k_sum in int32 with no spill, as
        # the JAX engine does (the stream's length bounds it)
        counts = DeviceCounts(k_sum) if device_out else k_sum.cpu().numpy().astype(np.int64)
        return ApproxResult(
            counts=counts,
            iters=iters,
            stdevs=stdevs,
            converged=bool(done_flag) and (max_iters == -1 or iters < max_iters),
        )


def cosine_normalize(counts: np.ndarray) -> np.ndarray:
    """float64 cosine normalization, bit-matching the reference's double math
    (fastsk_kernel.cpp:96-103)."""
    k = counts.astype(np.float64)
    diag = np.diag(k).copy()
    # sqrt of the product (not product of sqrts): the reference computes
    # sqrt(K[i][i] * K[j][j]) per entry, and the two differ in the last ulp.
    return k / np.sqrt(np.multiply.outer(diag, diag))
