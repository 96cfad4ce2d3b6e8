"""Sorted/rank engine for huge k-mer spaces (large-alphabet protein/text).

Counterpart of ``fastsk_tpu/kernel/sorted_engine.py`` on one device. When
``hash_base**k`` is too large to histogram densely (DenseGkmEngine), each
counting pass runs the sort/rank pipeline of ops/sorted_theta.py — the
reference's LSD counting sort and run walk (shared.cpp:156-333), with the
per-run outer products as run-aligned slab count products.

The same semantics as DenseGkmEngine: ``exact()`` enumerates all
C(g, m) subsets with int32 device accumulation and an int64 host spill
(or the device ``hi`` plane), ``approx()`` samples the seeded stream with
the reference's Welford stop rule (fastsk_kernel.cpp:108-143, 243-262),
a pass at a time by default. The theta mesh functions are not ported yet
(ROADMAP.md §1, slice 3c).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..ops.combinatorics import enumerate_combinations
from ..ops.encode import EncodedSeqs
from ..ops.gkm import welford_step
from ..ops.sorted_theta import hash_plan, sorted_theta_pass
from .config import KernelConfig
from .device_counts import DeviceCounts, _carry_spill
from .engine import ApproxResult, refuse_mesh, theta_stream


def window_table(enc: EncodedSeqs, g: int):
    """The flattened window table (the reference's feature table,
    shared.cpp:17-91), compacted on the host to the valid windows:
    ``(windows [nfeat, g] int32, seq_of [nfeat] int64)``, sequence-major."""
    ids = np.asarray(enc.ids)
    n = ids.shape[0]
    p = ids.shape[1] - g + 1
    windows = np.lib.stride_tricks.sliding_window_view(ids, g, axis=1)
    windows = windows.reshape(n * p, g).astype(np.int32)
    pos = np.arange(p)
    keep = np.flatnonzero((pos[None, :] <= (np.asarray(enc.lengths)[:, None] - g)).reshape(-1))
    seq_of = np.repeat(np.arange(n, dtype=np.int64), p)
    return np.ascontiguousarray(windows[keep]), seq_of[keep]


class SortedGkmEngine:
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
        refuse_mesh(self.config)
        self.base = enc.hash_base
        self.code_min = enc.code_min
        self.n = enc.n
        self.p = enc.max_len - g + 1
        self.p_max = int(enc.num_windows(g).max())
        if self.p_max >= 16384:
            # the JAX engine's bound (its int8 digits); kept so that both
            # packages take the same shapes and p_max^2 < 2^28
            raise ValueError(
                f"sorted engine requires < 16384 windows per sequence "
                f"(got {self.p_max})"
            )
        self.dpw, self.n_words = hash_plan(self.base, self.k)
        self.slab = self.config.sorted_slab
        self.device = self.config.device

        windows, seq_of = window_table(enc, g)
        self._windows = torch.as_tensor(windows, device=self.device)
        self._seq_of = torch.as_tensor(seq_of, device=self.device)

        # per-pass kernel entries are bounded by p_i * p_j <= p_max^2
        self._acc_limit = (1 << 31) - 1
        self._per_theta_bound = max(self.p_max**2, 1)
        self.spill_every = max(1, self._acc_limit // self._per_theta_bound // 2)
        # long documents make the worst-case bound spill every few thetas,
        # but real counts sit far below p_max^2: check the accumulator's
        # actual max (one scalar read a batch) and spill only when the
        # next batch could overflow int32
        self._adaptive_spill = self.spill_every < 32
        # thetas a batch: one pass at a time unless configured
        tb = self.config.theta_batch or 1
        batch_cap = (
            self._acc_limit // self._per_theta_bound
            if self._adaptive_spill
            else self.spill_every
        )
        self.theta_batch = max(1, min(tb, batch_cap))

    def _static_kwargs(self) -> dict:
        return dict(
            base=self.base,
            code_min=self.code_min,
            n=self.n,
            slab=self.slab,
            dpw=self.dpw,
            n_words=self.n_words,
            # f64 products past 4095 windows a sequence (the JAX package's
            # int8 digit range); bf16 or f32 below (ops/sorted_theta.py)
            count_split=self.p_max > 4095,
            run_width=self.config.sorted_run_width,
        )

    def _thetas(self, thetas: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(thetas, dtype=np.int64), device=self.device)

    def _pass(self, theta: np.ndarray) -> torch.Tensor:
        return sorted_theta_pass(
            self._windows, self._seq_of, self._thetas(theta), **self._static_kwargs()
        )

    # ------------------------------------------------------------- exact

    def _must_spill(self, k_acc: torch.Tensor, next_t: int) -> bool:
        """True when adding ``next_t`` worst-case thetas could overflow,
        judged by the accumulator's actual max (counts are nonnegative)."""
        cur = int(k_acc.max())
        return cur > self._acc_limit - next_t * self._per_theta_bound

    def _stream_step(self, acc: torch.Tensor, thetas: np.ndarray, i: int, tb: int,
                     since: int):
        """Add the passes of the next batch of ``thetas`` from ``i`` to
        ``acc``, with one spill check a batch; returns (thetas consumed,
        spill now)."""
        total = len(thetas)
        t = min(tb, total - i)
        if not self._adaptive_spill:
            t = min(t, self.spill_every - since)
        for theta in thetas[i : i + t]:
            acc += self._pass(theta)
        if self._adaptive_spill:
            nxt = min(self.theta_batch, total - i - t)
            spill = i + t < total and self._must_spill(acc, nxt)
        else:
            spill = since + t >= self.spill_every
        return t, spill

    def _sum_stream(self, thetas: np.ndarray) -> np.ndarray:
        """Exact integer sum over a theta stream, int64 on the host."""
        host = np.zeros((self.n, self.n), dtype=np.int64)
        k_acc = torch.zeros((self.n, self.n), dtype=torch.int32, device=self.device)
        since = 0
        i = 0
        while i < len(thetas):
            t, spill = self._stream_step(k_acc, thetas, i, self.theta_batch, since)
            i += t
            since += t
            if spill:
                host += k_acc.cpu().numpy()
                k_acc.zero_()
                since = 0
        host += k_acc.cpu().numpy()
        return host

    def _device_batch_cap(self) -> int:
        """A carry spill leaves a < 2^30 residue in lo (the host spill
        zeroes it), so a batch must fit the remaining headroom: residue +
        t * bound <= acc_limit (always >= 1: p_max < 16384)."""
        return max(1, (self._acc_limit - (1 << 30)) // self._per_theta_bound)

    def _sum_stream_device(self, thetas: np.ndarray) -> DeviceCounts:
        """Exact integer sum over a theta stream, on the device: spills
        carry completed 2**30-units into the ``hi`` plane
        (kernel/device_counts.py) instead of pulling to the host."""
        lo = torch.zeros((self.n, self.n), dtype=torch.int32, device=self.device)
        hi = None
        tb = min(self.theta_batch, self._device_batch_cap())
        since = 0
        i = 0
        while i < len(thetas):
            t, spill = self._stream_step(lo, thetas, i, tb, since)
            i += t
            since += t
            if spill:
                lo, hi = _carry_spill(lo, hi)
                since = 0
        return DeviceCounts(lo, hi)

    def exact_device(self) -> DeviceCounts:
        """Exact unnormalized kernel as device-resident ``DeviceCounts``."""
        return self._sum_stream_device(enumerate_combinations(self.g, self.k))

    def exact(self) -> np.ndarray:
        return self._sum_stream(enumerate_combinations(self.g, self.k))

    # ------------------------------------------------------------- approx

    def approx(
        self,
        conv_delta: float = 0.025,
        max_iters: int = -1,
        skip_variance: bool = False,
        seed: int = 0,
        device_out: bool = False,
    ) -> ApproxResult:
        stream = theta_stream(self.g, self.k, seed)
        total = len(stream)

        if skip_variance:
            limit = total if max_iters == -1 else min(max_iters, total)
            if device_out:
                counts = self._sum_stream_device(stream[:limit])
            else:
                counts = self._sum_stream(stream[:limit])
            return ApproxResult(counts=counts, iters=limit, stdevs=[], converged=False)

        n = self.n
        state = (
            torch.zeros((n, n), dtype=torch.int32, device=self.device),
            torch.zeros((n, n), dtype=torch.float32, device=self.device),
            torch.zeros((), dtype=torch.int32, device=self.device),
            torch.zeros((), dtype=torch.bool, device=self.device),
        )
        sd_buf: List[torch.Tensor] = []
        # Welford steps in stream order over each batch's passes; the done
        # flag syncs to the host once a batch (overshot passes are no-ops
        # under the done mask)
        bsz = max(self.theta_batch, 1)
        host64 = np.zeros((n, n), dtype=np.int64)
        hi = None  # device carries, made at the first device_out spill
        if device_out:
            bsz = min(bsz, self._device_batch_cap())
        since = 0
        for start in range(0, total, bsz):
            batch = stream[start : start + bsz]
            for theta in batch:
                state, sd = welford_step(
                    state, self._pass(theta), n_train=self.enc.n_train, conv_delta=conv_delta,
                    max_iters=max_iters,
                )
                sd_buf.append(sd)
            if bool(state[3]):
                break
            # the int32 count sum spills as the exact stream does (the
            # Welford mean and variance stay f32 on the device)
            since += len(batch)
            if self._adaptive_spill:
                spill = self._must_spill(state[0], bsz)
            else:
                spill = since >= self.spill_every
            if spill:
                if device_out:
                    new_lo, hi = _carry_spill(state[0], hi)
                    state = (new_lo,) + state[1:]
                else:
                    host64 += state[0].cpu().numpy()
                    state = (torch.zeros_like(state[0]),) + state[1:]
                since = 0
        stdevs = [
            float(s) for s in torch.stack(sd_buf).cpu().numpy() if not math.isnan(float(s))
        ]
        if device_out:
            counts = DeviceCounts(state[0], hi)
        else:
            counts = host64 + state[0].cpu().numpy()
        return ApproxResult(
            counts=counts,
            iters=int(state[2]),
            stdevs=stdevs,
            converged=bool(state[3]),
        )
