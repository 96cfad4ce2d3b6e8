"""Drive fastsk_tpu_torch's exact and approx paths on one CUDA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and the CUDA toolkit. Phases, one JSON line each; the first failure
raises and the exit code is non-zero:

1. env    torch / CUDA / card / nvcc / triton facts; refuses to run
          without a CUDA device.
2. build  compiles kernels A, H (csrc/pairs.cu), B, C (csrc/smo.cu) and
          D, E, F, G (csrc/pairs_packed.cu; both share csrc/hopper.cuh)
          from the checkout, one nvcc per source in parallel; prints the
          seconds and the kernels whose wgmma ptxas serializes. Then the
          inner loop of D to G's kernel at 5 code planes, read from the
          built library's SASS (experiments/sass_loop.py): its common
          path's instructions a window pair, for E's bound.
3. pairs  kernel A's two bodies (the int8 tensor-core one and the dp4a
          one) against the plain PyTorch version: a small seeded shape (also against inline
          numpy counts), the full KAT2B shape (g=8, m=4) and 7230 seeded
          length-200 DNA at g=16, m=10, each body timed. Integers must be
          equal. Then the KAT2B counts through kernel D
          (exact_engine="packed"), timed, equal to kernel A's; and both
          bodies timed on seeded 1000 x 200 sets at g=8 over 16, 24, 40,
          48 and 56 letters (one-hot depths 128 to 448 bytes, the deepest
          whose tensor-core tile fits), equal.
4. smo    kernel B (one thread-block cluster a problem) against its plain
          twin on the KAT2B linear Gram (the main solve of phase 5): the
          same iteration count at the eps-KKT stop, bit-identical alpha and
          grad; timed at clusters of 8 and 16 CTAs, with the same bits.
4b. platt-folds  the five KAT2B Platt folds (C=1, held-out rows boxed
          at 0) in one batched launch of B against five lone launches:
          equal iterations, bit-identical alpha and grad; fold 0 against
          the twin on a 20,000-iteration prefix, bit for bit.
5. slice  KAT2B g=8 m=4 C=1 through FastaUtility -> FastSK.compute_kernel
          (device_resident=True) -> fit -> score("auc"), with the launch
          counters zeroed just before: kernel A launched with its
          tensor-core body once, kernel B twice
          for 6 problems (the main solve, then the 5 Platt folds in one
          batch), AUC 0.904993 to 6 decimals and |AUC - 0.903321| <= 0.005.
5b. theta-dense  KAT2B (g=8, m=4) through exact_engine="theta": the
          dense theta engine (kernel/engine.py, no kernel of its own),
          device-resident; counts integer-equal to phase 5's kernel A
          counts; kernel_s, ms a theta, peak memory, and a theta's time
          split with CUDA events (histogram, products, one Welford step).
5c. approx-kat2b  FastSK(8, 4, approx=True, delta=0.025, seed=0) on KAT2B
          (device-resident) -> fit (C=1; kernel B twice for 6 problems)
          -> score("auc") within 0.02 of 0.904993; the first 8 thetas
          with skip_variance integer-equal to the port on the CPU, and
          the same Welford call on the CPU: equal iterations and counts.
6. golden tests/golden/ep_sl at g=6, m=2 with device_resident=False on the
          card: the f64 kernel equals ep_sl_g6m2.txt bit for bit.
7. packed kernels D, E and G (the packed engine's band, pair-list and
          grouped routes, one kernel on code planes; E one launch landing
          in the matrix, no torch landing; G one launch a strip) against
          the plain version: a small seeded
          ragged set whose sequences straddle 2048-row strips (also
          against inline numpy counts) and a medium one (400 sequences,
          lengths 16-905, alphabet 24, g=8, m=4). Integers must be equal.
          Then D timed on medium sets over 8 to 88 letters (one-hot
          depths 64 to 704 bytes) and on 400 sequences over 100 letters
          at g=12 (experiments/probe_band.py's wide set), each equal to
          the plain version, and 24 sequences of that set equal to numpy.
8. packed-full  the shape of protein 2.19 (2564 sequences, lengths
          16-905, alphabet 24, g=8, m=4): D, E and G equal each other and
          the plain version, and D equals kernel A run on the same set in
          the padded sequence-aligned layout; E's route is one launch
          that calls no land_parts; G's route launches once a strip.
9. ragged-slice  that set, 80/20 split, positives carrying a seeded motif,
          through FastSK(8, 4).compute_kernel (device_resident=True) ->
          fit(C=0.01) -> score("auc") with the counters zeroed just
          before: the auto route must take kernel D once (and not
          kernel A), kernel B 2 launches for 6 problems, AUC
          >= 0.9, and a host-path run (device_resident=False) must give an
          AUC within 0.005. Kernel B is then held to its twin, as in phase
          4, on that fit's training Gram: the main solve (C=0.01) and the
          first Platt fold.
10. smo-nu  kernel C (Solver_NU, csrc/smo.cu, one thread-block cluster)
          against its plain twin on the nu-SVC solve (nu=0.5) of the KAT2B
          linear Gram (n=6318), both capped at 20,000 iterations, timed
          also at clusters of 8 and 16 CTAs with the same bits, and of the
          ragged slice's training Gram (n=2051) to the eps stop: equal
          iterations, bit-identical alpha and grad, each class's sum of
          alpha at nu*n/2.
11. svm-family  KAT2B g=8 m=4, one compute_kernel (device_resident=True),
          then fit + score of nu_svc (AUC), one_class, epsilon_svr and
          nu_svr (r2 on the 0/1 test labels), the counters zeroed before
          each fit: nu_svc launches kernel C 6 times and B never, AUC >=
          0.85 and within 0.005 of the host path's; one_class and
          epsilon_svr launch B once, nu_svr C once (that launch timed with
          CUDA events inside the fit); the solvers' sums of
          alpha hold; one_class leaves at most nu + 0.02 of the training
          rows outside; r2 > 0; every decision finite. Then kernels B and
          C against their twins on the epsilon-SVR and nu-SVR duals of that
          Gram (2n = 12,636 rows, both in shared memory), with the fits'
          p vectors and starts, both capped at 3,000 iterations: equal
          iterations, bit-identical alpha and grad (C also at clusters of
          8 and 16, timed).
12. multiclass  a seeded 4-class ragged set (one motif per class, planted
          once per 100 letters, 1,000 sequences, lengths 16-905, alphabet
          24, 80/20 split) through
          kernel D, then one-vs-one c_svc (12 launches of B for 36
          problems: 6 pairs x (1 solve + 5 Platt folds in one batch)) and
          nu_svc (36 launches of C, its folds on sub-Grams). Each
          model is refitted on the CPU from the same f32 Gram (the twins):
          equal predictions, pair decisions within 1e-4 where the CPU's
          |decision| > 1e-3, probabilities within 1e-4; accuracy >= 90%
          as a sanity bound.
13. cli     `python -m fastsk_tpu_torch.cli -g 10 -m 4 --json --device cuda`
          on EP300 (2000 + 2000 sequences): AUC within 0.005 of 0.990146;
          then -s nu_svc -r fastsk with a LIBSVM model and the kernel saved,
          and `python -m fastsk_tpu_torch.predict_cli` on them: its accuracy
          within 0.05 points (one row of 2000) of the CLI's; then `-a
          --seed 0` (approx mode, the dense theta engine): AUC within
          0.02 of the exact run's, and its iterations.
14. packed-block  kernel F (csrc/pairs_packed.cu packed_block, stage 1,
          stage 2 and the landing in one launch) against its plain
          composite (ops/pairs_packed.py:packed_block_plain) at phase 7's
          medium set (g=8, m=4) and at a seeded ragged DNA set at g=12,
          m=6 (two digit planes in the JAX package): the
          rectangle of the later half of the row strips against every
          strip but the first, landed with a row offset (the ring's walk),
          and the triangles of strip 0 and of a middle strip (the
          round-robin's); then F's stage-1 kernel alone (packed_s1): strip
          0 against every strip, and a middle strip against every later
          one (a == b, a < b, sequences straddling the strips). Integers
          must be equal.
15. mesh    kernel F at the 2.19 shape timed against D on the same rows:
          the ring's whole rectangle in one launch, and the round-robin's
          triangles, one launch a strip, both equal to D. Then the 2.19
          shape's ragged slice through FastSK.compute_kernel under
          make_mesh(1, 1) and make_mesh(2, 2) over the card named four
          times, each with mesh_state "sharded" (the ring) and
          "replicated" (round-robin strips), the counters zeroed before
          each: counts integer-equal to kernel D's single-device counts;
          kernel F launched once a (device, ring step) or a strip, the
          stage-1 kernel never, the plain composite, stage 2 and the torch
          landing never called, no other count kernel launched. The 2x2
          ring run then fits (C=0.01) and scores: AUC equal to the
          single-device host path's within 1e-9 and >= 0.9. With two or
          more cards a mesh over distinct cards runs too; on one card a
          line says it was skipped.
16. probe   kernel H (csrc/pairs.cu, the variants of kernel A's body) at
          KAT2B and at the 7230 x 200 g=16 m=10 shape of phase 3, best of
          3 each, the counters zeroed before: every variant equal to its
          plain version (current and int32 to phase 3's plain counts) and
          the same checksum in every repetition; the chain cost of current
          and int32 against skeleton. Then the parts of kernel A's
          tensor-core body at both shapes (experiments/probe_pairs.py
          --body mma): whole, without the epilogue, without the wgmma
          loop, loads only; the whole equal to phase 3's plain counts.
17. approx-219  the 2.19 set of phase 8 (alphabet 24, g=8, m=4: 24^4
          buckets, so the sorted theta engine) with approx=True, seed 0,
          device-resident -> fit (C=0.01; kernel B twice for 6 problems)
          -> score: AUC >= 0.9; iterations, kernel_s, ms a pass, peak
          memory and a pass's split (hash and sort, slab products full
          and upper block triangle, one Welford step).
18. theta-sorted-exact  phase 7's medium set through
          exact_engine="theta" (the sorted engine): counts
          integer-equal to kernel D's (one launch); kernel_s, ms a pass,
          peak memory and its split.

The last three lines are the card's name and power limit (nvidia-smi),
the per-kernel JSON record (every kernel's launches on its path, error
against its plain version, times, and the bound: the larger of its
operations over the card's peak rate and its bytes over the memory rate),
and the result line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KAT2B = os.path.join(HERE, "experiments", "results_baselines", "tmp", "KAT2B")
EP300 = os.path.join(HERE, "experiments", "results_baselines", "tmp", "EP300")
GOLDEN = os.path.join(HERE, "tests", "golden")
AUC_ANCHOR = 0.903321  # experiments/results_baselines/oracle_comparison.csv, KAT2B g8 m4
AUC_KAT2B = 0.904993  # the port's KAT2B C-SVC AUC since the first card run: kernel B's
# trajectory is the twin's, bit for bit, so it must not move
EP300_ANCHOR = 0.990146  # the same file, EP300 g10 m4
MOTIF = [5, 17, 2, 11, 20, 8, 14, 3]  # planted in the ragged positives

# published dense peaks of one H100 SXM (NVIDIA's data sheet), for bounds
PEAK_INT8_OPS = 1979e12  # int8 tensor-core operations a second
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_S = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, *args, **kwargs):
    """(result, milliseconds) of one call, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn(*args, **kwargs)
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def wall(fn, *args, **kwargs):
    """(result, seconds) of one call on the host clock, ending synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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


def smo_bound(n: int, iters: int) -> dict:
    """Bound of an SMO solve of ``iters`` iterations at ``n`` rows: the
    gradient update's two f32 multiply-adds per row an iteration, and Q
    read once."""
    return bound(4.0 * n * iters, 4.0 * n * n + 20.0 * n, PEAK_F32_FLOPS)


def sm_clock_mhz() -> float:
    """The card's highest SM clock (nvidia-smi)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])


def issue_floor_ms(pairs: int, per_pair: float, lanes: int) -> float:
    """Milliseconds for ``pairs`` window pairs at ``per_pair`` instructions
    each, on every SM's ``lanes`` a clock (128 issue, 16 POPC) at the
    highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pairs * per_pair / (sms * lanes * sm_clock_mhz() * 1e6) * 1e3


def windows_of(X, g: int) -> int:
    return sum(max(len(s) - g + 1, 0) for s in X)


def numpy_counts(X, g: int, k: int) -> np.ndarray:
    """Exact counts by brute force over window pairs (codes compared
    directly — another algorithm than the one-hot kernel)."""
    wins = [np.array([s[p : p + g] for p in range(len(s) - g + 1)]) for s in X]
    n = len(X)
    out = np.zeros((n, n), dtype=np.int64)
    comb = np.array([math.comb(d, k) for d in range(g + 1)], dtype=np.int64)
    for i in range(n):
        for j in range(i, n):
            d = (wins[i][:, None, :] == wins[j][None, :, :]).sum(-1)
            out[i, j] = out[j, i] = comb[d].sum()
    return out


def ragged_set(seed: int, n: int, lmin: int, lmax: int, alpha: int = 24, motifs=None):
    """Seeded ragged sequences over codes 1..alpha, lengths uniform in
    [lmin, lmax], with 0/1 labels; a positive carries one copy of MOTIF
    with 0-3 random substitutions at a random place. With ``motifs`` (one
    8-letter motif per class) the labels are 0..len(motifs)-1 and every
    sequence carries its class's motif the same way, once per 100 letters
    (at least once), so that one copy does not drown in a long sequence."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2 if motifs is None else len(motifs), size=n)
    X = []
    for label in y:
        s = rng.integers(1, alpha + 1, size=int(rng.integers(lmin, lmax + 1)))
        copies = (1 if label else 0) if motifs is None else max(1, len(s) // 100)
        for _ in range(copies):
            motif = np.array(MOTIF if motifs is None else motifs[label])
            subs = rng.choice(8, size=int(rng.integers(0, 4)), replace=False)
            motif[subs] = rng.integers(1, alpha + 1, size=len(subs))
            at = int(rng.integers(0, len(s) - 8 + 1))
            s[at : at + 8] = motif
        X.append(s.tolist())
    return X, y


def straddling(eng) -> int:
    """Sequences of a packed engine whose rows cross a strip border."""
    first = eng.pack["row0"]
    last = first + (eng.pack["p"] + 7) // 8 * 8 - 1
    return int((first // eng.tile != last // eng.tile).sum())


def read_split_fasta(prefix: str, split: str, tmpdir: str):
    """The pos/neg split files rewritten with >1 / >0 labels (their headers
    are sequence ids), positives first, read through FastaUtility."""
    path = os.path.join(tmpdir, f"{split}.fasta")
    with open(path, "w") as out:
        for part, label in (("pos", 1), ("neg", 0)):
            with open(f"{prefix}.{split}.{part}.fasta") as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith(">"):
                        out.write(f">{label}\n{line}\n")
    return path


def load_tri(path: str) -> np.ndarray:
    with open(path) as f:
        header = f.readline()
        while not header.startswith("n="):
            header = f.readline()
        n = int(header.split()[0].split("=")[1])
        K = np.zeros((n, n))
        for i in range(n):
            vals = [float(v) for v in f.readline().split()]
            K[i, : i + 1] = vals
            K[: i + 1, i] = vals
    return K


def _c_svc_dual(gram, labels, c_box):
    """(Q, y, C, p, alpha0, max_iter) of the C-SVC solve KernelSVC makes
    of ``gram``; ``c_box`` [n] or [b, n] (0 on a Platt fold's held-out
    rows)."""
    dev, n = gram.device, gram.shape[0]
    classes = np.unique(labels)
    y = torch.as_tensor(
        np.where(np.asarray(labels) == classes[1], 1.0, -1.0), dtype=torch.float32, device=dev
    )
    C = torch.as_tensor(np.asarray(c_box, np.float32), device=dev)
    return (gram * torch.outer(y, y), y, C, -torch.ones(n, device=dev),
            torch.zeros(C.shape, device=dev), max(10_000_000, 100 * n))


def smo_twin(shape: str, gram, labels, c_box, clusters=()) -> dict:
    """Kernel B against its plain twin on one C-SVC solve of ``gram`` with
    KernelSVC's eps and max_iter; ``c_box`` is the per-row box (0 on the
    held-out rows of a Platt fold). Both must stop at the same iteration
    with bit-identical alpha and grad (and so equal decision signs). Each
    of ``clusters`` (CTAs a problem) is timed too and must give the same
    bits. Emits an "smo" line and returns its fields."""
    from fastsk_tpu_torch.ops import pairs
    from fastsk_tpu_torch.svm import smo_cuda
    from fastsk_tpu_torch.svm.kernel_svm import _finalize_rho

    Q, y, C, p, a0, max_iter = _c_svc_dual(gram, labels, c_box)
    n = Q.shape[0]
    (a_k, g_k, it_k), ms = cuda_ms(smo_cuda.smo_solve, Q, y, C, p, a0, 1e-3, max_iter)
    grad0, qd = smo_cuda.initial_state(Q, p, a0)
    (a_p, g_p, it_p), plain_ms = cuda_ms(smo_cuda.smo_loop_plain, Q, y, C, qd, a0, grad0, 1e-3, max_iter)
    same = it_k == it_p and torch.equal(a_k, a_p) and torch.equal(g_k, g_p)
    ms_by_cluster, same_by_cluster = {}, {}
    for cs in clusters:
        (a_c, g_c, it_c), ms_by_cluster[cs] = cuda_ms(
            smo_cuda.smo_solve, Q, y, C, p, a0, 1e-3, max_iter, cluster=cs
        )
        same_by_cluster[cs] = it_c == it_k and torch.equal(a_c, a_k) and torch.equal(g_c, g_k)
    a_k, rho_k = _finalize_rho(a_k, g_k, y, C)
    a_p, rho_p = _finalize_rho(a_p, g_p, y, C)
    with pairs.full_f32_matmul():
        dec_k = gram @ (a_k * y) - rho_k
        dec_p = gram @ (a_p * y) - rho_p
    # the stop quantity gmax + gmax2 with grad recomputed from scratch in
    # f64: what the incremental f32 grad drifted to over the iterations
    grad = Q.double() @ a_k.double() - 1.0
    up = torch.where(y > 0, a_k < C, a_k > 0)
    low = torch.where(y > 0, a_k > 0, a_k < C)
    kkt = float((-y * grad)[up].max() + (y * grad)[low].max())
    cluster = smo_cuda.smo_cluster_size()
    fields = dict(
        shape=shape, n=n, C=float(np.max(c_box)), held_out=int((C == 0).sum()),
        kernel_ms=ms, plain_ms=plain_ms, iters_kernel=it_k, iters_plain=it_p,
        us_per_iter=ms * 1e3 / max(it_k, 1), cluster_size=cluster,
        smem_path=smo_cuda.smo_smem_path(n, cluster), bit_identical=same,
        max_abs_dalpha=float((a_k - a_p).abs().max()), rho_kernel=float(rho_k),
        rho_plain=float(rho_p), kkt_violation_f64=kkt,
        decision_signs_equal=bool(torch.equal(torch.sign(dec_k), torch.sign(dec_p))),
        ms_by_cluster=ms_by_cluster, bit_identical_by_cluster=same_by_cluster,
    )
    emit("smo", **fields)
    require(it_k == it_p, f"kernel B stopped at {it_k} iterations, its twin at {it_p} ({shape})")
    require(same, f"kernel B left its twin's trajectory ({shape})")
    require(all(same_by_cluster.values()), f"a cluster size changed kernel B's result ({shape}): {same_by_cluster}")
    require(it_k < max_iter, f"the SMO run hit max_iter before the eps stop ({shape})")
    return fields


def kat2b_on_d(dev, Xtr, Xte, a_counts) -> dict:
    """Part of phase 3: the KAT2B count matrix through the packed engine
    (``exact_engine="packed"``) and kernel D, warmed up then timed: the
    yardstick for kernel A's tensor-core body. Integer-equal to kernel A's
    counts."""
    from fastsk_tpu_torch import KernelConfig
    from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine
    from fastsk_tpu_torch.ops import pairs_packed_cuda
    from fastsk_tpu_torch.ops.encode import encode_sequences

    eng = PackedPairsEngine(
        encode_sequences(Xtr, Xte), 8, 4, KernelConfig(device=dev, exact_engine="packed")
    )
    rows = eng.rows()
    pairs_packed_cuda.packed_band(rows, k=4, n_out=eng.n)
    before = pairs_packed_cuda.packed_band.launches
    got, ms = cuda_ms(pairs_packed_cuda.packed_band, rows, k=4, n_out=eng.n)
    launches = pairs_packed_cuda.packed_band.launches - before
    pos = torch.from_numpy(np.argsort(eng.order)).to(dev)
    err = int((got[pos][:, pos] - a_counts.long()).abs().max())
    fields = dict(shape="KAT2B", g=8, m=4, launches=launches, d_ms=ms, max_abs_err_vs_a=err)
    emit("pairs-on-d", **fields)
    require(launches == 1, f"KAT2B through kernel D took {launches} launches")
    require(err == 0, "kernel D's KAT2B counts differ from kernel A's")
    del eng, rows, got
    torch.cuda.empty_cache()
    return fields


def pairs_body_sweep(dev, n: int = 1000, length: int = 200, alphas=(16, 24, 40, 48, 56)) -> dict:
    """Part of phase 3: kernel A's two bodies on seeded sets of ``n``
    sequences of ``length`` letters at g=8, m=4 over each of ``alphas``
    letters (one-hot depths 128, 192, 320, 384 and 448 bytes, 448 the
    deepest whose tensor-core tile fits at p_pad = 200; KAT2B and the
    g=16 set give 64), each warmed up then timed, integer-equal."""
    from fastsk_tpu_torch import KernelConfig
    from fastsk_tpu_torch.kernel.pairs_engine import PairsGkmEngine
    from fastsk_tpu_torch.ops import pairs_cuda
    from fastsk_tpu_torch.ops.encode import encode_sequences

    sweep = {}
    for alpha in alphas:
        X = np.random.default_rng(300 + alpha).integers(1, alpha + 1, size=(n, length))
        X[0, :alpha] = np.arange(1, alpha + 1)  # every letter
        eng = PairsGkmEngine(encode_sequences(X.tolist()), 8, 4, KernelConfig(device=dev))
        x = eng._build_x()
        got, ms = {}, {}
        for body in ("mma", "dp4a"):
            pairs_cuda.pairs_counts(x, g=8, k=4, p_pad=eng.p_pad, body=body)
            got[body], ms[body] = cuda_ms(pairs_cuda.pairs_counts, x, g=8, k=4, p_pad=eng.p_pad, body=body)
        depth = pairs_cuda.mma_depth(x.shape[1])
        sweep[alpha] = dict(
            depth=depth, alpha=eng.alpha,
            default=pairs_cuda.pairs_body(eng.n_pad, eng.p_pad, x.shape[1]),
            mma_ms=ms["mma"], dp4a_ms=ms["dp4a"],
            tile_mma=pairs_cuda.mma_tile_sequences(eng.n_pad, eng.p_pad, depth),
            equal=bool(torch.equal(got["mma"], got["dp4a"])),
        )
        del eng, x, got
    emit("a-bodies", g=8, m=4, n=n, length=length, sweep=sweep)
    require(all(v["equal"] for v in sweep.values()), f"kernel A's bodies disagree: {sweep}")
    require(all(v["alpha"] == a for a, v in sweep.items()), "a sweep set lost a letter")
    torch.cuda.empty_cache()
    return sweep


def platt_folds_phase(gram, labels, folds: int = 5, twin_iters: int = 20_000) -> dict:
    """Phase 4b: the Platt folds of a C-SVC fit (C=1, each fold's
    held-out rows boxed at 0) in one batched launch of kernel B against
    one launch a fold: equal iterations, bit-identical alpha and grad.
    Fold 0 is then held to the twin on a ``twin_iters`` prefix (a capped
    lone launch against the capped twin, bit for bit)."""
    from fastsk_tpu_torch.svm import smo_cuda
    from fastsk_tpu_torch.svm.linear import stratified_kfold_indices

    n = gram.shape[0]
    masks = np.ones((folds, n), np.float32)
    for r, f in enumerate(stratified_kfold_indices(np.asarray(labels), folds)):
        masks[r, f] = 0.0
    Q, y, C, p, a0, max_iter = _c_svc_dual(gram, labels, masks)
    before = smo_cuda.smo_solve.launches, smo_cuda.smo_solve.problems
    (a_b, g_b, it_b), batched_ms = cuda_ms(smo_cuda.smo_solve, Q, y, C, p, a0, 1e-3, max_iter)
    launched = (smo_cuda.smo_solve.launches - before[0], smo_cuda.smo_solve.problems - before[1])
    single_ms, same = [], []
    for r in range(folds):
        (a_s, g_s, it_s), ms = cuda_ms(
            smo_cuda.smo_solve, Q, y, C[r].contiguous(), p, a0[r].contiguous(), 1e-3, max_iter
        )
        single_ms.append(ms)
        same.append(it_s == it_b[r] and torch.equal(a_s, a_b[r]) and torch.equal(g_s, g_b[r]))
    c0, z0 = C[0].contiguous(), a0[0].contiguous()
    a_k, g_k, it_k = smo_cuda.smo_solve(Q, y, c0, p, z0, 1e-3, twin_iters)
    grad0, qd = smo_cuda.initial_state(Q, p, z0)
    (a_p, g_p, it_p), twin_ms = cuda_ms(smo_cuda.smo_loop_plain, Q, y, c0, qd, z0, grad0, 1e-3, twin_iters)
    twin_same = it_k == it_p and torch.equal(a_k, a_p) and torch.equal(g_k, g_p)
    fields = dict(
        n=n, folds=folds, held_out=[int((c == 0).sum()) for c in masks], iters=it_b,
        batched_ms=batched_ms, single_ms=single_ms, single_ms_sum=sum(single_ms),
        slowest_single_ms=max(single_ms), launched=list(launched),
        bit_identical_to_single=same, twin_prefix_iters=twin_iters,
        fold0_twin_bit_identical=twin_same, fold0_twin_ms=twin_ms,
    )
    emit("platt-folds", **fields)
    require(launched == (1, folds), f"the batched folds took {launched} launches / problems")
    require(all(same), f"a batched fold differs from its lone launch: {same}")
    require(all(i < max_iter for i in it_b), "a Platt fold hit max_iter before the eps stop")
    require(twin_same, f"fold 0 left its twin's trajectory within {twin_iters} iterations")
    return fields


def slice_219(full=(2564, 16, 905)):
    """The seeded set of the 2.19 shape, ``full`` (sequences, shortest,
    longest), and its 80/20 split: (X, y, train, test, y_train, y_test)."""
    X, y = ragged_set(219, *full)
    n_tr = int(0.8 * len(X))
    perm = np.random.default_rng(2190).permutation(len(X))
    tr_idx, te_idx = perm[:n_tr], perm[n_tr:]
    return (
        X, y, [X[i] for i in tr_idx], [X[i] for i in te_idx], y[tr_idx], y[te_idx],
    )


def peak_mib(fn, *args, **kwargs):
    """(result, the peak MiB the call allocated on the card above what was
    allocated when it began)."""
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(*args, **kwargs)
    return out, (torch.cuda.max_memory_allocated() - before) / 2**20


def welford_ms(ks_int) -> float:
    """CUDA-event ms of one Welford step (ops/gkm.py:welford_step) on the
    pass ``ks_int``, warmed up, past the first iteration's branch."""
    from fastsk_tpu_torch.ops.gkm import welford_step

    n = ks_int.shape[0]
    state = (
        torch.zeros_like(ks_int), torch.zeros((n, n), dtype=torch.float32, device=ks_int.device),
        torch.full((), 5, dtype=torch.int32, device=ks_int.device),
        torch.zeros((), dtype=torch.bool, device=ks_int.device),
    )
    kw = dict(n_train=n, conv_delta=0.025, max_iters=-1)
    welford_step(state, ks_int, **kw)
    return cuda_ms(welford_step, state, ks_int, **kw)[1]


def dense_split(eng) -> dict:
    """Where a dense theta's time goes (CUDA events, ms a theta, warmed
    up): one batch's histogram (ops/gkm.py:_counts_for_batch), its
    products (count_gram_int32), one theta's product alone (the Welford
    loop's unit) and one Welford step."""
    from fastsk_tpu_torch.ops import gkm
    from fastsk_tpu_torch.ops.combinatorics import enumerate_combinations

    thetas = enumerate_combinations(eng.g, eng.k)[: eng.theta_batch]
    batch = eng._batch(thetas)
    kw = {key: v for key, v in eng._static_kwargs().items()
          if key not in ("matmul_dtype", "count_split")}
    gkm._counts_for_batch(eng._ids, eng._lengths, batch, **kw)
    counts, hist_ms = cuda_ms(gkm._counts_for_batch, eng._ids, eng._lengths, batch, **kw)
    counts = counts.to(eng.matmul_dtype)
    gkm.count_gram_int32(counts, eng.count_split)
    _, prod_ms = cuda_ms(gkm.count_gram_int32, counts, eng.count_split)
    ks, one_ms = cuda_ms(gkm.gram, counts[0], counts[0])
    t = len(thetas)
    return dict(
        thetas_timed=t, histogram_ms=hist_ms / t, products_ms=prod_ms / t,
        product_one_theta_ms=one_ms, welford_ms=welford_ms(ks.to(torch.int32)),
        matmul_dtype=str(eng.matmul_dtype), theta_batch=eng.theta_batch,
        row_chunk=eng.row_chunk,
    )


def sorted_split(eng, n_thetas: int = 4) -> dict:
    """Where a sorted pass's time goes (CUDA events, ms a pass, the mean
    over the first ``n_thetas`` subsets after a warm-up pass): hash, sort
    and run detection (ops/sorted_theta.py:_pass_phase1), then the slab
    products (pass_products); one Welford step."""
    from fastsk_tpu_torch.ops import sorted_theta
    from fastsk_tpu_torch.ops.combinatorics import enumerate_combinations

    st = eng._static_kwargs()
    p1 = {key: st[key] for key in ("base", "code_min", "n", "dpw", "n_words")}
    prod_kw = dict(n=eng.n, run_width=st["run_width"], slab=st["slab"],
                   count_split=st["count_split"])
    thetas = enumerate_combinations(eng.g, eng.k)
    eng._pass(thetas[-1])
    sort_ms, prod_ms, runs = [], [], []
    for theta in thetas[:n_thetas]:
        th = eng._thetas(theta)
        phase1, ms = cuda_ms(sorted_theta._pass_phase1, eng._windows, eng._seq_of, th, **p1)
        sort_ms.append(ms)
        runs.append(int(phase1[2][-1]) + 1 if phase1[2].shape[0] else 0)
        ks, ms = cuda_ms(sorted_theta.pass_products, *phase1, **prod_kw)
        prod_ms.append(ms)
    return dict(
        passes_timed=n_thetas, sort_ms=float(np.mean(sort_ms)), products_ms=float(np.mean(prod_ms)),
        multi_runs=runs, slabs=[-(-r // st["run_width"]) for r in runs],
        windows=int(eng._windows.shape[0]), welford_ms=welford_ms(ks),
    )


def theta_dense_phase(dev, a_counts, Xtr, Xte) -> dict:
    """Phase 5b: KAT2B (g=8, m=4) through exact_engine="theta", the dense
    engine, device-resident: its counts integer-equal to kernel A's of
    phase 5 (``a_counts``, on the card); kernel_s, ms a theta, peak memory
    and the split of a theta's time."""
    from fastsk_tpu_torch import FastSK, KernelConfig
    from fastsk_tpu_torch.kernel.engine import DenseGkmEngine
    from fastsk_tpu_torch.ops.combinatorics import nchoosek
    from fastsk_tpu_torch.ops.encode import encode_sequences

    fsk = FastSK(8, 4, config=KernelConfig(device=dev, exact_engine="theta", device_resident=True))
    # the host's share of kernel_s: encoding and the engine's set-up
    eng, setup_s = wall(lambda: fsk._make_exact_engine(encode_sequences(Xtr, Xte)))
    require(isinstance(eng, DenseGkmEngine), f"exact_engine='theta' took {type(eng).__name__}")
    (_, kernel_s), peak = peak_mib(wall, fsk.compute_kernel, Xtr, Xte)
    counts = fsk._counts_dev
    equal = counts.hi is None and torch.equal(counts.counts, a_counts)
    thetas = nchoosek(8, 4)
    fields = dict(
        dataset="KAT2B", g=8, m=4, n=eng.n, p_max=eng.p_max, buckets=eng.b_total,
        thetas=thetas, kernel_s=kernel_s, ms_a_theta=kernel_s * 1e3 / thetas,
        setup_s=setup_s, peak_mib=peak, counts_equal_kernel_a=equal, split=dense_split(eng),
    )
    emit("theta-dense", **fields)
    require(equal, "the dense theta engine's KAT2B counts differ from kernel A's")
    return fields


def approx_kat2b_phase(dev, Xtr, Xte, Ytr, Yte, cpu_iters: int = 8) -> dict:
    """Phase 5c: FastSK(8, 4, approx=True, delta=0.025, seed=0) on KAT2B,
    device-resident, then fit (C-SVC, C=1, kernel B) and score("auc"): AUC
    within 0.02 of the exact 0.904993. The card is held to the port on the
    CPU: the first ``cpu_iters`` thetas with skip_variance, counts
    integer-equal; the same Welford call, equal iterations and counts."""
    from fastsk_tpu_torch import FastSK, KernelConfig
    from fastsk_tpu_torch.kernel.engine import DenseGkmEngine
    from fastsk_tpu_torch.ops.encode import encode_sequences
    from fastsk_tpu_torch.svm import smo_cuda

    fsk = FastSK(8, 4, approx=True, delta=0.025, seed=0,
                 config=KernelConfig(device=dev, device_resident=True))
    (_, kernel_s), peak = peak_mib(wall, fsk.compute_kernel, Xtr, Xte, Ytr, Yte)
    smo_cuda.smo_solve.launches = 0
    smo_cuda.smo_solve.problems = 0
    _, fit_s = wall(fsk.fit, C=1.0)
    auc, score_s = wall(fsk.score, "auc")
    launches = dict(smo_solve=smo_cuda.smo_solve.launches, problems=smo_cuda.smo_solve.problems)
    k_dev = fsk._K_dev
    outputs_ok = (
        tuple(k_dev.shape) == (len(Xtr) + len(Xte),) * 2 and bool(torch.isfinite(k_dev).all())
        and float((torch.diagonal(k_dev) - 1).abs().max()) < 1e-6
    )
    enc = encode_sequences(Xtr, Xte)
    card_sv = DenseGkmEngine(enc, 8, 4, KernelConfig(device=dev)).approx(
        max_iters=cpu_iters, skip_variance=True, seed=0)
    cpu_sv, cpu_sv_s = wall(DenseGkmEngine(enc, 8, 4, KernelConfig(device="cpu")).approx,
                            max_iters=cpu_iters, skip_variance=True, seed=0)
    sv_equal = bool(np.array_equal(card_sv.counts, cpu_sv.counts))
    cpu_w, cpu_w_s = wall(DenseGkmEngine(enc, 8, 4, KernelConfig(device="cpu")).approx,
                          conv_delta=0.025, seed=0)
    w_equal = bool(np.array_equal(fsk.kernel_counts, cpu_w.counts))
    sd_card = np.asarray(fsk.get_stdevs())
    sd_rel = (float(np.max(np.abs(sd_card - cpu_w.stdevs) / np.abs(cpu_w.stdevs)))
              if len(sd_card) == len(cpu_w.stdevs) else None)
    fields = dict(
        dataset="KAT2B", g=8, m=4, delta=0.025, seed=0, C=1.0, iterations=fsk.iterations,
        kernel_s=kernel_s, ms_a_theta=kernel_s * 1e3 / max(fsk.iterations, 1), peak_mib=peak,
        fit_s=fit_s, score_s=score_s, auc=auc, auc_exact=AUC_KAT2B,
        last_sd=float(sd_card[-1]) if len(sd_card) else None, launches=launches,
        outputs_ok=outputs_ok, cpu_skip_variance_iters=cpu_iters,
        cpu_skip_variance_s=cpu_sv_s, skip_variance_counts_equal_cpu=sv_equal,
        cpu_welford_s=cpu_w_s, cpu_welford_iterations=cpu_w.iters,
        welford_counts_equal_cpu=w_equal, sd_max_rel_diff_cpu=sd_rel,
    )
    emit("approx-kat2b", **fields)
    require(outputs_ok, "the approx KAT2B kernel is malformed")
    require(launches == dict(smo_solve=2, problems=6),
            f"the approx C-SVC fit did not launch kernel B twice for 6 problems: {launches}")
    require(abs(auc - AUC_KAT2B) <= 0.02, f"approx KAT2B AUC {auc} is off the exact {AUC_KAT2B}")
    require(sv_equal, "approx skip_variance counts differ between the card and the CPU")
    require(cpu_w.iters == fsk.iterations,
            f"Welford iterations: card {fsk.iterations}, CPU {cpu_w.iters}")
    require(w_equal, "approx Welford counts differ between the card and the CPU")
    return fields


def approx_219_phase(dev, full=(2564, 16, 905), cpu_iters: int = 2) -> dict:
    """Phase 17: the seeded 2.19 set (alphabet 24, g=8, m=4: 24^4 buckets
    past b_max_dense, so the sorted engine runs) with approx=True (seed 0),
    device-resident, then fit (C=0.01) and score: AUC >= 0.9 (the planted
    motif's gate). Records iterations, kernel_s, the ms a pass and its
    split (sort, then slab products). The card is held to the port on the
    CPU over the stream's first ``cpu_iters`` passes at this size: the
    skip_variance counts and a Welford call's counts integer-equal, its
    iterations equal, and the sd traces (the main call's first passes
    too) within rtol 1e-4."""
    from fastsk_tpu_torch import FastSK, KernelConfig
    from fastsk_tpu_torch.kernel.sorted_engine import SortedGkmEngine
    from fastsk_tpu_torch.ops.encode import encode_sequences
    from fastsk_tpu_torch.svm import smo_cuda

    _, _, r_tr, r_te, ry_tr, ry_te = slice_219(full)
    fsk = FastSK(8, 4, approx=True, seed=0, config=KernelConfig(device=dev, device_resident=True))
    eng, setup_s = wall(lambda: fsk._make_engine(encode_sequences(r_tr, r_te)))
    require(isinstance(eng, SortedGkmEngine), f"approx at 2.19 took {type(eng).__name__}")
    (_, kernel_s), peak = peak_mib(wall, fsk.compute_kernel, r_tr, r_te, ry_tr, ry_te)
    smo_cuda.smo_solve.launches = 0
    smo_cuda.smo_solve.problems = 0
    _, fit_s = wall(fsk.fit, C=0.01)
    auc, score_s = wall(fsk.score, "auc")
    launches = dict(smo_solve=smo_cuda.smo_solve.launches, problems=smo_cuda.smo_solve.problems)
    k_dev = fsk._K_dev
    outputs_ok = tuple(k_dev.shape) == (len(r_tr) + len(r_te),) * 2 and bool(torch.isfinite(k_dev).all())
    enc = encode_sequences(r_tr, r_te)
    card_eng = SortedGkmEngine(enc, 8, 4, KernelConfig(device=dev))
    card_sv = card_eng.approx(max_iters=cpu_iters, skip_variance=True, seed=0)
    card_w = card_eng.approx(max_iters=cpu_iters, seed=0)
    cpu_w, cpu_s = wall(SortedGkmEngine(enc, 8, 4, KernelConfig(device="cpu")).approx,
                        max_iters=cpu_iters, seed=0)
    sv_equal = bool(np.array_equal(card_sv.counts, cpu_w.counts))
    w_equal = card_w.iters == cpu_w.iters and bool(np.array_equal(card_w.counts, cpu_w.counts))
    sd_cpu = np.asarray(cpu_w.stdevs)
    sd_rel = max(
        float(np.max(np.abs(np.asarray(sd)[: len(sd_cpu)] - sd_cpu) / sd_cpu))
        for sd in (card_w.stdevs, fsk.get_stdevs())
    )
    fields = dict(
        shape="2.19", g=8, m=4, C=0.01, seed=0, n=eng.n, buckets=eng.base**eng.k,
        iterations=fsk.iterations, kernel_s=kernel_s,
        ms_a_pass=kernel_s * 1e3 / max(fsk.iterations, 1), setup_s=setup_s, peak_mib=peak,
        fit_s=fit_s,
        score_s=score_s, auc=auc, launches=launches, outputs_ok=outputs_ok,
        cpu_iters=cpu_iters, cpu_s=cpu_s, skip_variance_counts_equal_cpu=sv_equal,
        welford_counts_iters_equal_cpu=w_equal, sd_max_rel_diff_cpu=sd_rel,
        split=sorted_split(eng),
    )
    emit("approx-219", **fields)
    require(outputs_ok, "the approx 2.19 kernel is malformed")
    require(sv_equal, "approx 2.19 skip_variance counts differ between the card and the CPU")
    require(w_equal, "approx 2.19 Welford counts or iterations differ between the card and the CPU")
    require(sd_rel <= 1e-4, f"approx 2.19 sd trace off the CPU's by {sd_rel}")
    require(launches == dict(smo_solve=2, problems=6),
            f"the approx 2.19 fit did not launch kernel B twice for 6 problems: {launches}")
    require(auc >= 0.9, f"approx 2.19 AUC {auc} < 0.9")
    return fields


def theta_sorted_phase(dev, medium=(400, 16, 905)) -> dict:
    """Phase 18: phase 7's medium set (g=8, m=4, alphabet 24) through
    exact_engine="theta", the sorted engine, device-resident: counts
    integer-equal to kernel D's (exact_engine="packed", one launch)."""
    from fastsk_tpu_torch import FastSK, KernelConfig
    from fastsk_tpu_torch.kernel.sorted_engine import SortedGkmEngine
    from fastsk_tpu_torch.ops import pairs_packed_cuda
    from fastsk_tpu_torch.ops.encode import encode_sequences

    X = ragged_set(4, *medium)[0]
    pairs_packed_cuda.packed_band.launches = 0
    dfsk = FastSK(8, 4, config=KernelConfig(device=dev, exact_engine="packed"))
    _, d_kernel_s = wall(dfsk.compute_train, X)
    d_launches = pairs_packed_cuda.packed_band.launches
    tfsk = FastSK(8, 4, config=KernelConfig(device=dev, exact_engine="theta", device_resident=True))
    eng, setup_s = wall(lambda: tfsk._make_exact_engine(encode_sequences(X)))
    require(isinstance(eng, SortedGkmEngine), f"exact_engine='theta' took {type(eng).__name__}")
    (_, kernel_s), peak = peak_mib(wall, tfsk.compute_train, X)
    equal = bool(np.array_equal(tfsk.kernel_counts, dfsk.kernel_counts))
    fields = dict(
        shape="medium", sequences=medium[0], g=8, m=4, p_max=eng.p_max, kernel_s=kernel_s,
        ms_a_pass=kernel_s * 1e3 / 70, setup_s=setup_s, peak_mib=peak, d_kernel_s=d_kernel_s,
        d_launches=d_launches, counts_equal_kernel_d=equal, split=sorted_split(eng),
    )
    emit("theta-sorted-exact", **fields)
    require(d_launches == 1, f"kernel D launched {d_launches} times, not once")
    require(equal, "the sorted theta engine's counts differ from kernel D's")
    return fields


def band_depth_sweep(dev, medium=(400, 16, 905), alphas=(8, 16, 24, 40, 56, 72, 88),
                     wide=400):
    """Part of phase 7: kernel D on seeded ragged sets of the ``medium``
    shape at g=8, m=4 over each of ``alphas`` letters (one-hot depths 64
    to 704 bytes), then on experiments/probe_band.py's wide set (``wide``
    sequences over 100 letters, g=12, m=7: 1,200 bytes), each warmed up,
    timed and equal to the plain version; its first 24 sequences also
    equal to numpy. Returns ({alpha: fields}, the wide set's fields)."""
    from fastsk_tpu_torch import KernelConfig
    from fastsk_tpu_torch.experiments.probe_band import wide_set
    from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine
    from fastsk_tpu_torch.ops import pairs_packed, pairs_packed_cuda
    from fastsk_tpu_torch.ops.encode import encode_sequences

    def timed(X, g, m):
        """(D's counts in the input order, ms, the plain counts so, plain
        ms, the engine)."""
        eng = PackedPairsEngine(encode_sequences(X), g, m, KernelConfig(device=dev))
        rows = eng.rows()
        pairs_packed_cuda.packed_band(rows, k=g - m, n_out=eng.n)
        got, ms = cuda_ms(pairs_packed_cuda.packed_band, rows, k=g - m, n_out=eng.n)
        want, plain_ms = cuda_ms(
            pairs_packed.packed_counts_plain, rows.onehot, rows.seq_of, rows.first_seq,
            k=g - m, tile=eng.tile, c_pad=eng.c_pad, n_out=eng.n,
        )
        pos = torch.from_numpy(np.argsort(eng.order)).to(dev)
        return got[pos][:, pos], ms, want[pos][:, pos], plain_ms, eng

    sweep = {}
    for alpha in alphas:
        X = ragged_set(70 + alpha, *medium, alpha=alpha)[0]
        X = [[(c - 1) % alpha + 1 for c in seq] for seq in X]  # MOTIF's codes reach 20
        got, ms, want, plain_ms, eng = timed(X, 8, 4)
        sweep[alpha] = dict(
            depth=8 * eng.alpha, alpha=eng.alpha, ms=ms, plain_ms=plain_ms,
            max_abs_err=int((got - want).abs().max()),
        )
        del got, want, eng
    emit("d-depths", g=8, m=4, sweep=sweep)
    require(all(f["max_abs_err"] == 0 for f in sweep.values()),
            f"kernel D differs from its plain version in the depth sweep: {sweep}")

    got, ms, want, plain_ms, eng = timed(wide_set(wide), 12, 7)
    X24 = wide_set(24)
    got24 = timed(X24, 12, 7)[0]
    numpy_ok = bool(np.array_equal(got24.cpu().numpy(), numpy_counts(X24, 12, 5)))
    fields = dict(
        n=eng.n, alpha=eng.alpha, g=12, m=7, depth=12 * eng.alpha, windows=int(eng.pack["p"].sum()),
        ms=ms, plain_ms=plain_ms, max_abs_err=int((got - want).abs().max()),
        equal_numpy_24=numpy_ok,
    )
    emit("d-wide", **fields)
    require(eng.alpha == 100, f"the wide set's alphabet is {eng.alpha}, not 100")
    require(fields["max_abs_err"] == 0 and numpy_ok, "kernel D differs on the wide set")
    del got, want, eng, got24
    torch.cuda.empty_cache()
    return sweep, fields


def packed_phases(dev, sass: dict, small=(24, 100, 905), medium=(400, 16, 905),
                  full=(2564, 16, 905)):
    """Phases 7-9 (the packed engine and kernels D, E, G); each size is
    (sequences, shortest, longest); ``sass`` is the kernel's inner loop as
    phase 2 read it (experiments/sass_loop.py:loop_stats). Returns the
    kernels' JSON records and kernel B's twin check on the ragged slice's
    main solve."""
    from fastsk_tpu_torch import FastSK, KernelConfig
    from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine, PairsGkmEngine
    from fastsk_tpu_torch.ops import pairs_cuda, pairs_packed, pairs_packed_cuda
    from fastsk_tpu_torch.ops.encode import encode_sequences
    from fastsk_tpu_torch.svm import smo_cuda
    from fastsk_tpu_torch.svm.linear import stratified_kfold_indices

    # --------------------------------------------- kernels D, E, G vs plain

    def packed_engines(X, g, m):
        enc = encode_sequences(X)
        band = PackedPairsEngine(enc, g, m, KernelConfig(device=dev))
        grouped = PackedPairsEngine(
            enc, g, m, KernelConfig(device=dev, pairs_backend="pallas_grouped")
        )
        return band, grouped

    land_parts = pairs_packed.land_parts

    def route_counts(band, grouped, launches):
        """{route: (int64 counts in the input order, ms)}; each route runs
        once to warm up, then once timed with CUDA events, its kernel's
        launches in that run (and the torch landings of part blocks on E's
        route) into ``launches``."""
        out = {}
        landed = []

        def spy(*args):
            landed.append(1)
            return land_parts(*args)

        for name, eng, route, fn in (
            ("D", band, "band", pairs_packed_cuda.packed_band),
            ("E", band, "pairlist", pairs_packed_cuda.packed_pairlist),
            ("G", grouped, "grouped", pairs_packed_cuda.packed_grouped),
        ):
            eng.route = route
            eng._counts()
            fn.launches = 0
            landed.clear()
            pairs_packed.land_parts = spy
            try:
                out[name] = cuda_ms(eng._counts)
            finally:
                pairs_packed.land_parts = land_parts
            launches[name] = fn.launches
            if name == "E":
                launches["E_land_parts"] = len(landed)
        band.route = "band"
        return out

    def require_e_once(launches, shape):
        require(
            launches["E"] == 1 and launches["E_land_parts"] == 0,
            f"E's route at the {shape} shape was not one launch landing in the matrix: {launches}",
        )

    packed_times, packed_launches = {}, {}
    for shape, X, check_numpy in (
        ("small", ragged_set(3, *small)[0], True),
        ("medium", ragged_set(4, *medium)[0], False),
    ):
        band, grouped = packed_engines(X, 8, 4)
        rows = band.rows()
        kw = dict(k=4, tile=band.tile, c_pad=band.c_pad, n_out=band.n)
        cuda_ms(pairs_packed.packed_counts_plain, rows.onehot, rows.seq_of, rows.first_seq, **kw)
        plain_sorted, plain_ms = cuda_ms(
            pairs_packed.packed_counts_plain, rows.onehot, rows.seq_of, rows.first_seq, **kw
        )
        pos = torch.from_numpy(np.argsort(band.order)).to(dev)
        plain = plain_sorted[pos][:, pos]
        launches = {}
        res = route_counts(band, grouped, launches)
        errs = {name: int((got - plain).abs().max()) for name, (got, _) in res.items()}
        numpy_ok = (
            bool(np.array_equal(plain.cpu().numpy(), numpy_counts(X, 8, 4)))
            if check_numpy else None
        )
        emit(
            "packed", shape=shape, n=band.n, rows=band.total_rows,
            strips=band.n_strips, c_max=band.c_max, straddling=straddling(band),
            kernel_ms={name: ms for name, (_, ms) in res.items()},
            plain_ms=plain_ms, max_abs_err=errs, equal_numpy=numpy_ok,
            checksum=int(plain.sum()), launches=launches,
        )
        require(all(e == 0 for e in errs.values()), f"D/E/G differ from the plain version on {shape}: {errs}")
        require(numpy_ok is not False, "the plain packed counts differ from numpy on the small shape")
        require_e_once(launches, shape)
        packed_times[shape] = {name: (ms, plain_ms, errs[name]) for name, (_, ms) in res.items()}
        packed_launches[shape] = launches
        if shape == "medium":  # one count matrix, whichever route: one bound
            # (inputs: 8 code bytes and a 4-byte seq_of a row; int64 output)
            medium_bound = count_bound(
                int(band.pack["p"].sum()), 8 * band.alpha, band.total_rows * 12 + band.n**2 * 8
            )
        del band, grouped, rows, plain_sorted, plain, res
    torch.cuda.empty_cache()
    sweep, wide = band_depth_sweep(dev, medium)

    # ------------------------------- the 2.19 shape: D = E = G = kernel A
    X219, _, r_tr, r_te, ry_tr, ry_te = slice_219(full)
    band, grouped = packed_engines(X219, 8, 4)
    full_launches = {}
    res = route_counts(band, grouped, full_launches)
    d_counts = res["D"][0]
    eng_a = PairsGkmEngine(encode_sequences(X219), 8, 4, KernelConfig(device=dev))
    x_a = eng_a._build_x()
    pairs_cuda.pairs_counts(x_a, g=8, k=4, p_pad=eng_a.p_pad)
    a_full, a_ms = cuda_ms(pairs_cuda.pairs_counts, x_a, g=8, k=4, p_pad=eng_a.p_pad)
    a_counts = a_full[: eng_a.n, : eng_a.n].long()
    errs = {name: int((got - d_counts).abs().max()) for name, (got, _) in res.items()}
    errs["A"] = int((a_counts - d_counts).abs().max())
    rows = band.rows()
    plain_sorted, full_plain_ms = cuda_ms(
        pairs_packed.packed_counts_plain, rows.onehot, rows.seq_of, rows.first_seq,
        k=4, tile=band.tile, c_pad=band.c_pad, n_out=band.n,
    )
    pos = torch.from_numpy(np.argsort(band.order)).to(dev)
    errs["plain"] = int((plain_sorted[pos][:, pos] - d_counts).abs().max())
    del rows, plain_sorted
    windows = int(band.pack["p"].sum())
    full_bound = count_bound(windows, 8 * band.alpha, band.total_rows * 12 + band.n**2 * 8)
    emit(
        "packed-full", n=band.n, rows=band.total_rows, strips=band.n_strips,
        c_max=band.c_max, windows=windows, d_bound_ms=full_bound["bound_ms"],
        window_pairs_upper=windows * (windows + 1) // 2, p_pad_a=eng_a.p_pad,
        width_a=x_a.shape[1], kernel_ms={name: ms for name, (_, ms) in res.items()},
        kernel_a_ms=a_ms, plain_ms=full_plain_ms, max_abs_err_vs_d=errs,
        checksum=int(d_counts.sum()), launches=full_launches, g_strips=grouped.n_strips,
    )
    require(all(e == 0 for e in errs.values()), f"D, E, G, A and plain disagree at the 2.19 shape: {errs}")
    require_e_once(full_launches, "2.19")
    require(full_launches["G"] == grouped.n_strips,
            f"G's route did not launch once a strip: {full_launches}")
    full_times = {name: ms for name, (_, ms) in res.items()}
    del band, grouped, res, d_counts, x_a, a_full, a_counts
    torch.cuda.empty_cache()

    # ------------------------------- the ragged slice through the public API
    counters = (
        pairs_cuda.pairs_counts, smo_cuda.smo_solve, pairs_packed_cuda.packed_band,
        pairs_packed_cuda.packed_pairlist, pairs_packed_cuda.packed_grouped,
    )
    for fn in counters:
        fn.launches = 0
    smo_cuda.smo_solve.problems = 0
    rfsk = FastSK(g=8, m=4, config=KernelConfig(device=dev, device_resident=True))
    _, r_kernel_s = wall(rfsk.compute_kernel, r_tr, r_te, ry_tr, ry_te)
    _, r_fit_s = wall(rfsk.fit, C=0.01)
    r_auc, r_score_s = wall(rfsk.score, "auc")
    r_launches = {fn.__name__: fn.launches for fn in counters}
    r_problems = smo_cuda.smo_solve.problems
    rk = rfsk._K_dev
    r_dec = rfsk._model.decision_function(rfsk._test_gram())
    r_ok = (
        tuple(rk.shape) == (len(X219),) * 2
        and bool(torch.isfinite(rk).all())
        and float((torch.diagonal(rk) - 1).abs().max()) < 1e-6
        and r_dec.shape == (len(r_te),) and bool(np.isfinite(r_dec).all())
    )
    hfsk = FastSK(g=8, m=4, config=KernelConfig(device=dev, device_resident=False))
    hfsk.compute_kernel(r_tr, r_te, ry_tr, ry_te)
    hfsk.fit(C=0.01)
    h_auc = hfsk.score("auc")
    emit(
        "ragged-slice", shape="2.19", g=8, m=4, C=0.01, n_train=len(r_tr),
        n_test=len(r_te), kernel_s=r_kernel_s, fit_s=r_fit_s,
        score_s=r_score_s, auc=r_auc, auc_host_path=h_auc,
        svm_iters=rfsk._model.iters_, launches=r_launches, smo_problems=r_problems, outputs_ok=r_ok,
    )
    require(r_ok, "the ragged slice's kernel or decision values are malformed")
    require(r_launches["packed_band"] == 1, f"kernel D did not launch once: {r_launches}")
    require(r_launches["pairs_counts"] == 0, f"the ragged set took kernel A: {r_launches}")
    require(r_launches["smo_solve"] == 2 and r_problems == 6,
            f"kernel B: {r_launches['smo_solve']} launches for {r_problems} problems, not 2 for 6")
    require(r_auc >= 0.9, f"ragged slice AUC {r_auc} < 0.9")
    require(abs(r_auc - h_auc) <= 0.005, f"device AUC {r_auc} vs host AUC {h_auc}")

    # kernel B at this slice's own shape: its main solve and one Platt fold
    # (held-out rows boxed at 0) on the training Gram that fit built
    rows_tr = rfsk._rows()[0]
    gram = rfsk._build_gram(rows_tr, rows_tr, "linear")
    c_box = np.full(len(ry_tr), 0.01)
    smo_219 = smo_twin("2.19 main solve", gram, ry_tr, c_box)
    c_box[stratified_kfold_indices(ry_tr, 5)[0]] = 0.0
    smo_twin("2.19 Platt fold 0", gram, ry_tr, c_box)
    del gram, rows_tr

    # the other two routes of the packed engine through the same API call,
    # each with the counters zeroed just before and read just after
    d_kernel_counts = rfsk.kernel_counts
    for key, fn, env, backend in (
        ("E", pairs_packed_cuda.packed_pairlist, "1", "auto"),
        ("G", pairs_packed_cuda.packed_grouped, None, "pallas_grouped"),
    ):
        if env:
            os.environ["FASTSK_PACKED_PAIRLIST"] = env
        for c in counters:
            c.launches = 0
        ofsk = FastSK(
            g=8, m=4,
            config=KernelConfig(device=dev, device_resident=True, pairs_backend=backend),
        )
        _, o_kernel_s = wall(ofsk.compute_kernel, r_tr, r_te, ry_tr, ry_te)
        o_launches = {c.__name__: c.launches for c in counters}
        os.environ.pop("FASTSK_PACKED_PAIRLIST", None)
        same = bool(np.array_equal(ofsk.kernel_counts, d_kernel_counts))
        emit(
            "ragged-slice", route=key, kernel_s=o_kernel_s,
            launches=o_launches, counts_equal_d=same,
        )
        require(o_launches[fn.__name__] > 0, f"kernel {key} did not launch: {o_launches}")
        require(key != "E" or o_launches[fn.__name__] == 1,
                f"E's route through the API was not one launch: {o_launches}")
        require(o_launches["packed_band"] == 0, f"route {key} took kernel D: {o_launches}")
        require(same, f"route {key}'s kernel counts differ from kernel D's")
        r_launches[fn.__name__] = o_launches[fn.__name__]
        del ofsk

    # the kernel's own floor at 2.19 (D and E run the same kernel over the
    # same window pairs): its SASS a window pair, counted in phase 2 from
    # the library this run built (and its one POPC), over the card's issue
    # (and POPC) rate
    pairs_219 = windows * (windows + 1) // 2
    body_floor = {
        "code_plane_bound_ms_2_19": issue_floor_ms(pairs_219, sass["per_pair"], 128),
        "popc_floor_ms_2_19": issue_floor_ms(pairs_219, 1, 16),
        "sass_per_pair": sass["per_pair"], "sm_clock_mhz": sm_clock_mhz(),
    }
    packed_src = "fastsk_tpu_torch/csrc/pairs_packed.cu"
    d_extra = {
        "depth_sweep": sweep, "ms_wide": wide["ms"], "plain_ms_wide": wide["plain_ms"],
        "max_abs_err_wide": wide["max_abs_err"], "n_wide": wide["n"], **body_floor,
    }
    e_extra = {"launches_medium_route": packed_launches["medium"]["E"], **body_floor}
    packed_rec = [
        {
            "name": fn.__name__, "route": "cuda", "source": packed_src,
            "replaces": f"fastsk_tpu/ops/pairs_packed_pallas.py:{line}",
            "launches": r_launches[fn.__name__],
            "max_abs_err": packed_times["medium"][key][2],
            "ms": packed_times["medium"][key][0],
            "plain_ms": packed_times["medium"][key][1],
            "ms_2_19": full_times[key], "plain_ms_2_19": full_plain_ms,
            **medium_bound, "library_ms": None, "bound_ms_2_19": full_bound["bound_ms"],
            "launches_2_19_route": full_launches[key],
            **(d_extra if key == "D" else {}),
            **(e_extra if key == "E" else {}),
        }
        for key, fn, line in (
            ("D", pairs_packed_cuda.packed_band, 605),
            ("E", pairs_packed_cuda.packed_pairlist, 318),
            ("G", pairs_packed_cuda.packed_grouped, 257),
        )
    ]
    return packed_rec, smo_219, rfsk


def smo_nu_twin(shape: str, gram, labels, nu: float, max_iter: int, clusters=()) -> dict:
    """Kernel C against its plain twin on the nu-SVC solve of ``gram`` that
    NuSVC.fit makes (LIBSVM's start, eps=1e-3), both capped at
    ``max_iter``: the same iteration count, bit-identical alpha and grad,
    and each class's sum of alpha still nu*n/2. Each of ``clusters`` (CTAs
    a problem) is timed too and must give the same bits. Emits an
    "smo-nu" line and returns its fields."""
    from fastsk_tpu_torch.svm import smo_cuda
    from fastsk_tpu_torch.svm.kernel_svm import nu_svc_start

    dev, n = gram.device, gram.shape[0]
    classes = np.unique(labels)
    ys = np.where(np.asarray(labels) == classes[1], 1.0, -1.0).astype(np.float32)
    y = torch.as_tensor(ys, device=dev)
    Q = gram * torch.outer(y, y)
    C = torch.ones(n, device=dev)
    p = torch.zeros(n, device=dev)
    a0 = torch.as_tensor(nu_svc_start(ys, nu), device=dev)
    (a_k, g_k, it_k), ms = cuda_ms(smo_cuda.smo_nu_solve, Q, y, C, p, a0, 1e-3, max_iter)
    grad0, qd = smo_cuda.initial_state(Q, p, a0)
    (a_p, g_p, it_p), plain_ms = cuda_ms(
        smo_cuda.smo_nu_loop_plain, Q, y, C, qd, a0, grad0, 1e-3, max_iter
    )
    dalpha = float((a_k - a_p).abs().max())
    dgrad = float((g_k - g_p).abs().max())
    ms_by_cluster, same_by_cluster = by_cluster(
        smo_cuda.smo_nu_solve, (Q, y, C, p, a0, 1e-3, max_iter), (a_k, g_k, it_k), clusters
    )
    target = nu * n / 2.0
    sums = [float(a_k[y == c].double().sum()) for c in (1.0, -1.0)]
    cluster = smo_cuda.smo_cluster_size()
    fields = dict(
        shape=shape, n=n, nu=nu, max_iter=max_iter, kernel_ms=ms,
        plain_ms=plain_ms, iters_kernel=it_k, iters_plain=it_p,
        us_per_iter=ms * 1e3 / max(it_k, 1), cluster_size=cluster,
        smem_path=smo_cuda.smo_smem_path(n, cluster, "C"),
        reached_eps=it_k < max_iter, max_abs_dalpha=dalpha,
        max_abs_dgrad=dgrad, class_sums=sums, class_sum_target=target,
        ms_by_cluster=ms_by_cluster, bit_identical_by_cluster=same_by_cluster,
    )
    emit("smo-nu", **fields)
    require(it_k == it_p, f"kernel C stopped at {it_k} iterations, its twin at {it_p} ({shape})")
    require(dalpha == 0.0 and dgrad == 0.0, f"kernel C left its twin's trajectory ({shape})")
    require(all(same_by_cluster.values()), f"a cluster size changed kernel C's result ({shape}): {same_by_cluster}")
    require(
        all(abs(v - target) <= 1e-3 * target for v in sums),
        f"kernel C did not conserve the class sums {sums} (target {target}, {shape})",
    )
    return fields


def by_cluster(solve, args, ref, clusters):
    """({cluster: ms}, {cluster: bit-identical to ``ref``}) of ``solve(*args,
    cluster=cs)`` for each of ``clusters``."""
    ms_by, same_by = {}, {}
    a_r, g_r, it_r = ref
    for cs in clusters:
        (a_c, g_c, it_c), ms_by[cs] = cuda_ms(solve, *args, cluster=cs)
        same_by[cs] = it_c == it_r and torch.equal(a_c, a_r) and torch.equal(g_c, g_r)
    return ms_by, same_by


def svr_twins(gram, targets, max_iter: int, clusters=(8, 16)) -> dict:
    """Kernels B and C against their twins on the 2n-row SVR duals of
    ``gram`` as EpsilonSVR.fit (C=1, epsilon=0.1, zero start) and
    NuSVR.fit (C=1, nu=0.5, LIBSVM's start) assemble them, p vectors
    included, both capped at ``max_iter``; both keep their slices in
    shared memory. Equal iterations and bit-identical alpha and grad, also
    for kernel C at each of ``clusters`` (timed). Emits an "svr-twin" line
    per solver and returns {svm_type: fields}."""
    from fastsk_tpu_torch.svm import smo_cuda
    from fastsk_tpu_torch.svm.kernel_svm import EpsilonSVR, nu_svr_start, svr_dual

    dev, n = gram.device, gram.shape[0]
    y = np.asarray(targets, dtype=np.float32)
    eps = EpsilonSVR().epsilon
    Q2, y2 = svr_dual(gram)
    C2 = torch.full((2 * n,), 1.0, device=dev)
    out = {}
    for svm_type, solve, plain, p, a0 in (
        ("epsilon_svr", smo_cuda.smo_solve, smo_cuda.smo_loop_plain,
         np.concatenate([eps - y, eps + y]), np.zeros(2 * n, np.float32)),
        ("nu_svr", smo_cuda.smo_nu_solve, smo_cuda.smo_nu_loop_plain,
         np.concatenate([-y, y]), nu_svr_start(n, 1.0, 0.5)),
    ):
        p = torch.as_tensor(p.astype(np.float32), device=dev)
        a0 = torch.as_tensor(a0, device=dev)
        (a_k, g_k, it_k), ms = cuda_ms(solve, Q2, y2, C2, p, a0, 1e-3, max_iter)
        grad0, qd = smo_cuda.initial_state(Q2, p, a0)
        (a_p, g_p, it_p), plain_ms = cuda_ms(plain, Q2, y2, C2, qd, a0, grad0, 1e-3, max_iter)
        ms_by, same_by = by_cluster(
            solve, (Q2, y2, C2, p, a0, 1e-3, max_iter), (a_k, g_k, it_k),
            clusters if svm_type == "nu_svr" else (),
        )
        fields = dict(
            svm_type=svm_type, rows=2 * n, max_iter=max_iter, kernel_ms=ms,
            plain_ms=plain_ms, iters_kernel=it_k, iters_plain=it_p,
            us_per_iter=ms * 1e3 / max(it_k, 1),
            max_abs_dalpha=float((a_k - a_p).abs().max()),
            max_abs_dgrad=float((g_k - g_p).abs().max()),
            ms_by_cluster=ms_by, bit_identical_by_cluster=same_by,
        )
        emit("svr-twin", **fields)
        require(all(same_by.values()), f"{svm_type}: a cluster size changed the result: {same_by}")
        require(it_k == it_p, f"{svm_type}: the kernel stopped at {it_k} iterations, its twin at {it_p}")
        require(fields["max_abs_dalpha"] == 0.0 and fields["max_abs_dgrad"] == 0.0,
                f"{svm_type}: the kernel left its twin's trajectory on the 2n dual")
        out[svm_type] = fields
    del Q2
    torch.cuda.empty_cache()
    return out


def svr_record(fields: dict) -> dict:
    """A kernel record's fields from one of svr_twins' results."""
    return {
        "max_abs_err_svr": fields["max_abs_dalpha"], "ms_svr": fields["kernel_ms"],
        "plain_ms_svr": fields["plain_ms"], "iters_svr": fields["iters_kernel"],
    }


def svm_family_phase(dev, Xtr, Xte, Ytr, Yte, svr_twin_iters: int = 3000):
    """Phase 11: nu_svc, one_class, epsilon_svr and nu_svr on the KAT2B
    kernel through FastSK, the counters zeroed before each fit and read
    after its score; then kernels B and C against their twins on the SVR
    duals of the same Gram for ``svr_twin_iters`` iterations. Returns
    ({svm_type: fields}, svr_twins' result)."""
    from fastsk_tpu_torch import FastSK, KernelConfig
    from fastsk_tpu_torch.svm import kernel_svm, smo_cuda

    counters = (smo_cuda.smo_solve, smo_cuda.smo_nu_solve)
    real_nu, c_solves = kernel_svm.smo_nu_solve, []

    def timed_nu(*args, **kwargs):  # kernel C's launches in a fit, timed
        out, ms = cuda_ms(real_nu, *args, **kwargs)
        c_solves.append(dict(ms=ms, iters=out[2], rows=args[0].shape[0],
                             us_per_iter=ms * 1e3 / max(out[2], 1)))
        return out

    fsk = FastSK(g=8, m=4, config=KernelConfig(device=dev, device_resident=True))
    _, kernel_s = wall(fsk.compute_kernel, Xtr, Xte, Ytr, Yte)
    rows_tr = fsk._rows()[0]
    gram_tr = fsk._build_gram(rows_tr, rows_tr, "linear")
    n, nu = len(Xtr), 0.5
    out = {}
    for svm_type, kw, metric in (
        ("nu_svc", dict(nu=nu), "auc"),
        ("one_class", dict(nu=nu), "accuracy"),
        ("epsilon_svr", dict(C=1.0), "r2"),
        ("nu_svr", dict(C=1.0, nu=nu), "r2"),
    ):
        for c in counters:
            c.launches = 0
        smo_cuda.smo_solve.problems = 0
        c_solves.clear()
        kernel_svm.smo_nu_solve = timed_nu if svm_type == "nu_svr" else real_nu
        try:
            _, fit_s = wall(fsk.fit, svm_type=svm_type, **kw)
        finally:
            kernel_svm.smo_nu_solve = real_nu
        score, score_s = wall(fsk.score, metric)
        launches = {c.__name__: c.launches for c in counters}
        problems = smo_cuda.smo_solve.problems
        model = fsk._model
        decide = getattr(model, "decision_function", model.predict)
        dec_test, dec_train = decide(fsk._test_gram()), decide(gram_tr)
        fields = dict(
            svm_type=svm_type, kernel_s=kernel_s, fit_s=fit_s, score_s=score_s,
            metric=metric, score=score, svm_iters=getattr(model, "iters_", None),
            fit_us_per_iter=fit_s * 1e6 / max(getattr(model, "iters_", 1), 1),
            launches=launches, smo_problems=problems,
            decisions_finite=bool(np.isfinite(dec_test).all() and np.isfinite(dec_train).all()),
        )
        if svm_type == "nu_svr":
            fields["kernel_c_solve"] = c_solves[0]
        if svm_type == "nu_svc":
            hfsk = FastSK(g=8, m=4, config=KernelConfig(device=dev, device_resident=False))
            hfsk.compute_kernel(Xtr, Xte, Ytr, Yte)
            hfsk.fit(svm_type="nu_svc", nu=nu)
            fields["auc_host_path"] = hfsk.score("auc")
            del hfsk
        if svm_type in ("nu_svc", "nu_svr"):
            dual = model.dual_
            half = len(dual) // 2
            if svm_type == "nu_svc":
                ys = np.where(np.asarray(Ytr) == model.classes_[1], 1.0, -1.0)
                sums = [float(dual[ys > 0].sum()), float(dual[ys < 0].sum())]
            else:
                sums = [float(dual[:half].sum()), float(dual[half:].sum())]
            fields.update(class_sums=sums, class_sum_target=nu * n / 2.0)
        if svm_type == "one_class":
            fields.update(
                alpha_sum=float(model.coef_.sum()), alpha_sum_target=nu * n,
                outside_fraction=float((dec_train < -1e-3).mean()),
            )
        emit("svm-family", **fields)
        require(fields["decisions_finite"], f"{svm_type}: a decision value is not finite")
        want_b, want_c = {"nu_svc": (0, 6), "one_class": (1, 0), "epsilon_svr": (1, 0),
                          "nu_svr": (0, 1)}[svm_type]
        require(
            launches == {"smo_solve": want_b, "smo_nu_solve": want_c} and problems == want_b,
            f"{svm_type}: launches {launches} ({problems} problems of B), expected B {want_b} and C {want_c}",
        )
        if "class_sums" in fields:
            t = fields["class_sum_target"]
            require(all(abs(v - t) <= 1e-3 * t for v in fields["class_sums"]),
                    f"{svm_type}: class sums {fields['class_sums']} off {t}")
        if svm_type == "nu_svc":
            require(score >= 0.85, f"nu_svc AUC {score} < 0.85")
            require(abs(score - fields["auc_host_path"]) <= 0.005,
                    f"nu_svc device AUC {score} vs host AUC {fields['auc_host_path']}")
        if svm_type == "one_class":
            require(abs(fields["alpha_sum"] - nu * n) <= 1e-3 * nu * n,
                    f"one_class alpha sums to {fields['alpha_sum']}, not {nu * n}")
            require(fields["outside_fraction"] <= nu + 0.02,
                    f"one_class leaves {fields['outside_fraction']} of the rows outside")
        if metric == "r2":
            require(score > 0, f"{svm_type} r2 {score} <= 0")
        out[svm_type] = fields
    twins = svr_twins(gram_tr, fsk.train_labels, svr_twin_iters)
    del fsk, rows_tr, gram_tr
    torch.cuda.empty_cache()
    return out, twins


def multiclass_phase(dev, size=(1000, 16, 905)) -> dict:
    """Phase 12: a seeded 4-class ragged set of ``size`` (sequences,
    shortest, longest) through kernel D and one-vs-one c_svc / nu_svc,
    each with the counters zeroed before it and held to the same model
    refitted on the CPU."""
    from fastsk_tpu_torch import FastSK, KernelConfig
    from fastsk_tpu_torch.ops import pairs_cuda, pairs_packed_cuda
    from fastsk_tpu_torch.svm import smo_cuda

    motifs = np.random.default_rng(12).integers(1, 25, size=(4, 8))
    X, y = ragged_set(412, *size, motifs=motifs)
    perm = np.random.default_rng(4120).permutation(len(X))
    n_tr = int(0.8 * len(X))
    tr, te = perm[:n_tr], perm[n_tr:]
    counters = (
        pairs_cuda.pairs_counts, pairs_packed_cuda.packed_band,
        smo_cuda.smo_solve, smo_cuda.smo_nu_solve,
    )
    for c in counters:
        c.launches = 0
    fsk = FastSK(g=8, m=4, config=KernelConfig(device=dev, device_resident=True))
    _, kernel_s = wall(fsk.compute_kernel, [X[i] for i in tr], [X[i] for i in te], y[tr], y[te])
    kernel_launches = {c.__name__: c.launches for c in counters}
    require(kernel_launches["packed_band"] > 0 and kernel_launches["pairs_counts"] == 0,
            f"the 4-class ragged set did not take kernel D: {kernel_launches}")
    out = {"kernel_s": kernel_s, "kernel_launches": kernel_launches}
    rows_tr, rows_te = fsk._rows()
    gram_tr = fsk._build_gram(rows_tr, rows_tr, "linear")
    gram_te = fsk._build_gram(rows_te, rows_tr, "linear")
    for svm_type, kw, want in (
        ("c_svc", dict(C=1.0), "smo_solve"), ("nu_svc", dict(nu=0.5), "smo_nu_solve"),
    ):
        for c in counters:
            c.launches = 0
        smo_cuda.smo_solve.problems = 0
        _, fit_s = wall(fsk.fit, svm_type=svm_type, **kw)
        acc, score_s = wall(fsk.score, "accuracy")
        launches = {c.__name__: c.launches for c in counters}
        problems = smo_cuda.smo_solve.problems
        model = fsk._model
        dec = model.decision_function(gram_te)
        # the same model refitted on the CPU from the same f32 Gram: the
        # twins on host tensors and host gathers, against the card's
        # gathers, pair order, solves, Platt folds and vote
        host = dataclasses.replace(model).fit(gram_tr.cpu(), np.asarray(fsk.train_labels))
        dec_host = host.decision_function(gram_te.cpu())
        sure = np.abs(dec_host) > 1e-3
        fields = dict(
            svm_type=svm_type, classes=4, n_train=len(tr), n_test=len(te),
            kernel_s=kernel_s, fit_s=fit_s, score_s=score_s, accuracy=acc,
            launches=launches, smo_problems=problems, decisions_shape=list(dec.shape),
            decisions_finite=bool(np.isfinite(dec).all()),
            predictions_equal_host=bool(np.array_equal(
                model.predict(gram_te), host.predict(gram_te.cpu())
            )),
            max_abs_ddecision_host=float(np.abs(dec - dec_host)[sure].max()),
            max_abs_dproba_host=float(np.abs(
                model.predict_proba(gram_te) - host.predict_proba(gram_te.cpu())
            ).max()),
        )
        emit("multiclass", **fields)
        # c_svc: 6 pairs x (the pair's solve + its 5 Platt folds in one
        # batch) = 12 launches of B for 36 problems; nu_svc: 36 of C
        other = "smo_nu_solve" if want == "smo_solve" else "smo_solve"
        want_launches, want_problems = (12, 36) if want == "smo_solve" else (36, 0)
        require(launches[want] == want_launches and launches[other] == 0 and problems == want_problems,
                f"{svm_type}: launches {launches} ({problems} problems of B), "
                f"expected {want_launches} of {want}")
        require(dec.shape == (len(te), 6) and bool(np.isfinite(dec).all()),
                f"{svm_type}: malformed pair decisions")
        require(fields["predictions_equal_host"],
                f"{svm_type}: the card's one-vs-one predictions differ from the CPU refit's")
        require(fields["max_abs_ddecision_host"] <= 1e-4,
                f"{svm_type}: pair decisions off the CPU refit's by {fields['max_abs_ddecision_host']}")
        require(fields["max_abs_dproba_host"] <= 1e-4,
                f"{svm_type}: probabilities off the CPU refit's by {fields['max_abs_dproba_host']}")
        require(acc >= 90.0, f"{svm_type}: 4-class accuracy {acc}% < 90%")
        out[svm_type] = dict(fit_s=fit_s, accuracy=acc, launches=launches, smo_problems=problems)
    del fsk, rows_tr, rows_te, gram_tr, gram_te
    torch.cuda.empty_cache()
    return out


def cli_phase(tmpdir: str, device: str = "cuda", prefix: str = EP300) -> dict:
    """Phase 13: the fastsk-torch CLI on the EP300 splits (``prefix``),
    then its LIBSVM model and kernel through the predict tool, each in a
    process of its own."""

    def run(module, *args):
        proc = subprocess.run(
            [sys.executable, "-m", module, *args], cwd=HERE, capture_output=True,
            text=True,
        )
        require(proc.returncode == 0, f"{module} {args} failed:\n{proc.stderr[-3000:]}")
        return proc

    tr = read_split_fasta(prefix, "train", tmpdir)
    te = read_split_fasta(prefix, "test", tmpdir)
    base = ["-g", "10", "-m", "4", "--json", "-q", "--device", device]
    t0 = time.perf_counter()
    c_svc = json.loads(run("fastsk_tpu_torch.cli", *base, tr, te).stdout.splitlines()[-1])
    c_svc_s = time.perf_counter() - t0
    model = os.path.join(tmpdir, "ep300_nu.model")
    kernel = os.path.join(tmpdir, "ep300_kernel.npz")
    nu = json.loads(run(
        "fastsk_tpu_torch.cli", *base, "-s", "nu_svc", "-r", "fastsk", "--save-model", model,
        "--model-format", "libsvm", "--save-kernel", kernel, tr, te,
    ).stdout.splitlines()[-1])
    pred = run("fastsk_tpu_torch.predict_cli", model, kernel, os.path.join(tmpdir, "p.txt"),
               "--test-file", te)
    line = [ln for ln in pred.stderr.splitlines() if ln.startswith("Accuracy = ")][-1]
    pred_acc = float(line.split()[2].rstrip("%"))
    # approx mode (the dense theta engine, seed 0); its stderr line names
    # the iterations
    t0 = time.perf_counter()
    proc = run("fastsk_tpu_torch.cli", *[a for a in base if a != "-q"], "-a", "--seed", "0", tr, te)
    approx_s = time.perf_counter() - t0
    approx = json.loads(proc.stdout.splitlines()[-1])
    approx["iterations"] = int(proc.stderr.split("iters=")[-1].split(",")[0])
    fields = dict(
        dataset="EP300", g=10, m=4, c_svc=c_svc, c_svc_wall_s=c_svc_s,
        auc_anchor=EP300_ANCHOR, nu_svc=nu, predict_cli_accuracy=pred_acc,
        approx=approx, approx_wall_s=approx_s, auc_exact=c_svc["auc"],
    )
    emit("cli", **fields)
    require(abs(c_svc["auc"] - EP300_ANCHOR) <= 0.005,
            f"CLI AUC {c_svc['auc']} is off the anchor {EP300_ANCHOR}")
    require(abs(approx["auc"] - c_svc["auc"]) <= 0.02,
            f"CLI approx AUC {approx['auc']} is off the exact run's {c_svc['auc']}")
    require(abs(pred_acc - nu["accuracy"]) <= 0.05,
            f"predict_cli accuracy {pred_acc} vs the CLI's {nu['accuracy']}")
    return fields


def s1_phase(dev, medium=(400, 16, 905), dna=(300, 16, 905)) -> dict:
    """Phase 14: kernel F (``packed_block``) against its plain composite
    at ``medium`` (phase 7's set, g=8 m=4) and at a seeded ragged DNA set
    of ``dna`` at g=12 m=6, both walks, each warmed up and timed; then F's
    stage-1 kernel (``packed_s1``) against its plain version. Returns
    {shape: fields}: the rectangle's at the top, every case's under
    "cases", the stage-1 kernel's under "s1"."""
    from fastsk_tpu_torch import KernelConfig
    from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine
    from fastsk_tpu_torch.ops import pairs_packed, pairs_packed_cuda
    from fastsk_tpu_torch.ops.encode import encode_sequences

    out = {}
    for shape, X, g, m in (
        ("medium", ragged_set(4, *medium)[0], 8, 4),
        ("dna-g12m6", ragged_set(5, *dna, alpha=4)[0], 12, 6),
    ):
        eng = PackedPairsEngine(encode_sequences(X), g, m, KernelConfig(device=dev))
        rows = eng.rows()
        tile, ns, k = eng.tile, eng.n_strips, g - m
        mid = ns // 2
        valid = (rows.seq_of >= 0).view(ns, tile).sum(1).tolist()
        fs = rows.first_seq.tolist()
        words, planes = rows.words.shape[1], rows.planes.shape[1]
        n_pad = eng.n + eng.c_pad

        # the ring's steps with a row offset (a rectangle against other
        # strips; the triangle of a device's own strips with its mirror),
        # the round-robin's triangles: (rows, kwargs, out rows, column
        # windows, window pairs)
        blk = fs[ns - 1] + eng.c_max - fs[mid]
        w_mid = sum(valid[mid:])
        cases = {
            "rectangle": ((mid, ns), dict(rows_j=rows, strips_j=(1, ns), row_off=fs[mid]),
                          blk, sum(valid[1:]), w_mid * sum(valid[1:])),
            "ring_diagonal": ((mid, ns), dict(strips_j=(mid, ns), row_off=fs[mid]),
                              blk, w_mid, w_mid * (w_mid + 1) // 2),
            "triangle_0": ((0, 1), {}, n_pad, sum(valid), valid[0] * sum(valid)),
            "triangle_mid": ((mid, mid + 1), {}, n_pad, w_mid, valid[mid] * w_mid),
        }
        fields, errs = {}, {}
        for name, (strips_i, kw, m_rows, cols, pairs) in cases.items():
            zeros = lambda: torch.zeros((m_rows, n_pad), dtype=torch.int64, device=dev)  # noqa: E731
            want, plain_ms = cuda_ms(pairs_packed.packed_block_plain, zeros(), rows, strips_i, k=k, **kw)
            ops_bytes = (
                2.0 * g * eng.alpha * pairs,
                (tile * (strips_i[1] - strips_i[0]) + cols) * (4 * planes + 4) + want.numel() * 8,
            )
            pairs_packed_cuda.packed_block(zeros(), rows, strips_i, k=k, **kw)
            got, ms = cuda_ms(pairs_packed_cuda.packed_block, zeros(), rows, strips_i, k=k, **kw)
            errs[name] = int((got - want).abs().max())
            fields[name] = dict(
                ms=ms, plain_ms=plain_ms, strips_i=list(strips_i), window_pairs=pairs,
                **bound(*ops_bytes, PEAK_INT8_OPS),
            )
            del got, want
        top = dict(fields["rectangle"], max_abs_err=max(errs.values()))

        # F's stage-1 kernel alone: strip 0 against every strip, a middle
        # strip against every later one
        s1_errs, s1 = [], None
        for a, b0, n_b in ((0, 0, ns), (mid, mid, ns - mid)):
            args = (rows, a, rows, b0, n_b)
            pairs_packed_cuda.packed_s1(*args, k=k)  # warm-up launch
            got, ms = cuda_ms(pairs_packed_cuda.packed_s1, *args, k=k)
            plain_args = (
                rows.onehot[a * tile : (a + 1) * tile], rows.seq_of[a * tile : (a + 1) * tile],
                rows.first_seq[a], rows.onehot[b0 * tile : (b0 + n_b) * tile],
            )
            want, plain_ms = cuda_ms(
                pairs_packed.packed_s1_plain, *plain_args, k=k, tile=tile, c_pad=eng.c_pad
            )
            s1_errs.append(int((got.long() - want.long()).abs().max()))
            if s1 is None:
                s1 = dict(
                    ms=ms, plain_ms=plain_ms, launch=dict(a=a, b0=b0, n_b=n_b),
                    **bound(
                        2.0 * g * eng.alpha * valid[a] * sum(valid[b0 : b0 + n_b]),
                        (1 + n_b) * tile * (4 * words + 4) + got.numel() * 4,
                        PEAK_INT8_OPS,
                    ),
                )
            del got, want
        s1["max_abs_err"] = max(s1_errs)
        emit(
            "packed-block", shape=shape, g=g, m=m, n=eng.n, strips=ns, tile=tile,
            c_max=eng.c_max, c_pad=eng.c_pad, straddling=straddling(eng), max_abs_err=errs,
            cases=fields,
            s1=dict(s1, max_abs_err_per_launch=s1_errs),
        )
        require(straddling(eng) > 0, f"no sequence straddles a strip on {shape}")
        require(all(e == 0 for e in errs.values()), f"kernel F differs from its plain composite on {shape}: {errs}")
        require(s1["max_abs_err"] == 0, f"kernel F's stage 1 differs from its plain version on {shape}: {s1_errs}")
        out[shape] = dict(top, cases=fields, s1=s1)
        del eng, rows
    torch.cuda.empty_cache()
    return out


def f_at_full(dev, r_tr, r_te, d_counts) -> dict:
    """Part of phase 15: kernel F at the ragged slice's rows (``r_tr`` then
    ``r_te``, g=8 m=4), timed against kernel D on the same rows
    (``d_counts``, D's counts in the input order): the 1x1 ring's one
    launch (its only step is the diagonal one: the triangle over every
    strip, with its mirror) and the round-robin's triangles, one launch a
    strip; both equal to D, both bounded by the upper triangle, and the
    launches of each timed call counted from zero. Also returns each
    strip's windows, for the mesh runs' bounds. The launches here are not
    the main path's."""
    from fastsk_tpu_torch import KernelConfig
    from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine
    from fastsk_tpu_torch.ops import pairs_packed_cuda
    from fastsk_tpu_torch.ops.encode import encode_sequences

    eng = PackedPairsEngine(encode_sequences(r_tr, r_te), 8, 4, KernelConfig(device=dev))
    rows, ns, n = eng.rows(), eng.n_strips, eng.n
    d_sorted = torch.from_numpy(d_counts[np.ix_(eng.order, eng.order)]).to(dev)
    out = torch.zeros((n + eng.c_pad,) * 2, dtype=torch.int64, device=dev)
    block = pairs_packed_cuda.packed_block

    def ring_1x1():
        block(out, rows, (0, ns), k=4, strips_j=(0, ns))

    def round_robin():
        for a in range(ns):
            block(out, rows, (a, a + 1), k=4)

    windows = int(eng.pack["p"].sum())
    in_bytes = eng.total_rows * 12  # 8 code bytes and a 4-byte seq_of a row
    res = {}
    for name, fn in (("ring_1x1", ring_1x1), ("round_robin", round_robin)):
        fn()  # warm-up
        out.zero_()
        block.launches = 0
        _, ms = cuda_ms(fn)
        res[name] = dict(
            ms=ms, launches=block.launches,
            max_abs_err_vs_d=int((out[:n, :n] - d_sorted).abs().max()),
            **count_bound(windows, 8 * eng.alpha, in_bytes + n * n * 8),
        )
    _, res["d_ms"] = cuda_ms(pairs_packed_cuda.packed_band, rows, k=4, n_out=n)
    res.update(
        strips=ns, windows=windows, width=8 * eng.alpha, nbytes=in_bytes + n * n * 8,
        strip_windows=(rows.seq_of >= 0).view(ns, eng.tile).sum(1).tolist(),
    )
    emit("packed-block-full", shape="2.19", **{key: v for key, v in res.items() if key != "strip_windows"})
    require(
        all(res[w]["max_abs_err_vs_d"] == 0 for w in ("ring_1x1", "round_robin")),
        f"kernel F differs from kernel D at the 2.19 shape: {res}",
    )
    require(res["ring_1x1"]["launches"] == 1 and res["round_robin"]["launches"] == ns,
            f"kernel F's launches at the 2.19 shape: "
            f"{[res[w]['launches'] for w in ('ring_1x1', 'round_robin')]} for {ns} strips")
    del eng, rows, out, d_sorted
    torch.cuda.empty_cache()
    return res


def route_bound(f_full: dict, n_dev: int, state: str) -> dict:
    """Bound of one mesh run's kernel-F launches at the slice: the
    round-robin's upper triangle (every unordered window pair once), or
    the ring's diagonal steps (the unordered pairs of each device's own
    windows) and its other steps (every ordered pair of two devices'
    windows: each device fills its own rows)."""
    sw = f_full["strip_windows"]
    if state == "replicated":
        w = sum(sw)
        pairs = w * (w + 1) / 2
    else:
        spd = -(-len(sw) // n_dev)
        ws = [sum(sw[d * spd : (d + 1) * spd]) for d in range(n_dev)]
        pairs = sum(w * (w + 1) / 2 + w * (sum(ws) - w) for w in ws)
    return bound(2.0 * f_full["width"] * pairs, f_full["nbytes"], PEAK_INT8_OPS)


def mesh_launches(n_strips: int, n_dev: int, state: str) -> int:
    """Kernel F's launches in one mesh run: the ring's one a (device,
    step) whose own and visiting shards both hold live strips, or one a
    round-robin strip."""
    if state == "replicated":
        return n_strips
    spd = -(-n_strips // n_dev)
    return sum(d * spd < n_strips for d in range(n_dev)) ** 2


def mesh_phase(dev, full=(2564, 16, 905)) -> dict:
    """Phase 15: kernel F at the ragged slice of ``full`` against D, then
    that slice through FastSK under four meshes over this card (and one
    over distinct cards where there are several), each held to kernel D's
    single-device counts; the 2x2 ring run fits and scores. Returns the
    main run's fields, with kernel F's timing at the slice and every mesh
    run's counted launches, times and bound under "runs"."""
    from fastsk_tpu_torch import FastSK, KernelConfig
    from fastsk_tpu_torch.ops import pairs_cuda, pairs_packed, pairs_packed_cuda
    from fastsk_tpu_torch.parallel import make_mesh
    from fastsk_tpu_torch.parallel import sharding as shd
    from fastsk_tpu_torch.svm import smo_cuda

    _, _, r_tr, r_te, ry_tr, ry_te = slice_219(full)
    hfsk = FastSK(g=8, m=4, config=KernelConfig(device=dev, device_resident=False))
    _, d_kernel_s = wall(hfsk.compute_kernel, r_tr, r_te, ry_tr, ry_te)
    hfsk.fit(C=0.01)
    h_auc = hfsk.score("auc")
    d_counts = hfsk.kernel_counts
    del hfsk
    torch.cuda.empty_cache()
    f_full = f_at_full(dev, r_tr, r_te, d_counts)

    counters = (
        pairs_cuda.pairs_counts, pairs_packed_cuda.packed_band,
        pairs_packed_cuda.packed_pairlist, pairs_packed_cuda.packed_grouped,
        pairs_packed_cuda.packed_s1, pairs_packed_cuda.packed_block, smo_cuda.smo_solve,
    )
    seen = {}
    spied = (shd.packed_ring_rowsharded, shd.packed_round_sharded)

    def spy(fn):
        def call(state, *args, **kwargs):
            seen.setdefault("state", sorted({tuple(t.shape) for t in state}))
            out, ms = cuda_ms(fn, state, *args, **kwargs)  # the route's launches
            seen["route_ms"] = seen.get("route_ms", 0.0) + ms
            return out
        return call

    # the plain composite, its stage 2 and the torch landing: never on the card
    patched = [
        (pairs_packed_cuda, "packed_s1_plain"), (pairs_packed_cuda, "packed_block_plain"),
        (pairs_packed, "parts_from_s1"), (pairs_packed, "add_blocks"),
    ]
    originals = [getattr(mod, name) for mod, name in patched]
    plain_calls = {name: 0 for _, name in patched}

    def counted(name, fn):
        def call(*args, **kwargs):
            plain_calls[name] += 1
            return fn(*args, **kwargs)
        return call

    n_cards = torch.cuda.device_count()
    runs = [((1, 1), state, [dev]) for state in ("sharded", "replicated")]
    runs += [((2, 2), state, [dev] * 4) for state in ("sharded", "replicated")]
    if n_cards >= 2:
        cards = [torch.device("cuda", i) for i in range(min(n_cards, 4))]
        runs += [((1, len(cards)), state, cards) for state in ("sharded", "replicated")]
        # untimed: each card's context and kernels load at first use
        for state in ("sharded", "replicated"):
            FastSK(g=8, m=4, config=KernelConfig(
                device=dev, mesh=make_mesh(1, len(cards), devices=cards), mesh_state=state,
            )).compute_kernel(r_tr[:200], r_te[:50])
    main, per_run = None, {}
    shd.packed_ring_rowsharded, shd.packed_round_sharded = map(spy, spied)
    for (mod, name), fn in zip(patched, originals):
        setattr(mod, name, counted(name, fn))
    try:
        for shape, state, devices in runs:
            mesh = make_mesh(*shape, devices=devices)
            for c in counters:
                c.launches = 0
            plain_calls.update({name: 0 for name in plain_calls})
            base = {}
            for d in set(mesh.devices):
                torch.cuda.reset_peak_memory_stats(d)
                base[d] = torch.cuda.memory_allocated(d)
            fsk = FastSK(g=8, m=4, config=KernelConfig(device=dev, mesh=mesh, mesh_state=state))
            _, kernel_s = wall(fsk.compute_kernel, r_tr, r_te, ry_tr, ry_te)
            one_card = len(set(mesh.devices)) == 1
            fields = dict(
                mesh=list(shape), devices=[str(d) for d in mesh.devices],
                mesh_state=state, kernel_s=kernel_s, kernel_s_d=d_kernel_s,
                state_shape_per_device=seen.pop("state"),
                # CUDA events on the first card around the route's launches
                route_ms=seen.pop("route_ms") if one_card else None,
                # above what the card held before the run, all entries of it
                peak_mem_added_bytes={
                    str(d): torch.cuda.max_memory_allocated(d) - b for d, b in base.items()
                },
                counts_equal_d=bool(np.array_equal(fsk.kernel_counts, d_counts)),
            )
            seen.pop("route_ms", None)
            if shape == (2, 2) and state == "sharded":  # the path's main run
                _, fit_s = wall(fsk.fit, C=0.01)
                auc, score_s = wall(fsk.score, "auc")
                fields.update(fit_s=fit_s, score_s=score_s, auc=auc, auc_host_path=h_auc)
                main = fields
            launches = {c.__name__: c.launches for c in counters}
            want = mesh_launches(f_full["strips"], mesh.size, state)
            fields.update(
                launches=launches, plain_calls=dict(plain_calls),
                route_bound=route_bound(f_full, mesh.size, state),
            )
            emit("mesh", **fields)
            per_run[f"{shape[0]}x{shape[1]} {state}"] = dict(
                kernel_s=kernel_s, route_ms=fields["route_ms"],
                launches=launches["packed_block"], **fields["route_bound"],
            )
            require(fields["counts_equal_d"], f"mesh {shape} {state}: counts differ from kernel D's")
            require(launches["packed_block"] == want,
                    f"mesh {shape} {state}: kernel F launched {launches['packed_block']} times, not {want}")
            require(launches["packed_s1"] == 0, f"mesh {shape} {state}: F's stage-1 kernel launched")
            require(not any(plain_calls.values()),
                    f"mesh {shape} {state}: the plain composite or torch stage 2 ran: {plain_calls}")
            require(
                all(launches[c.__name__] == 0 for c in counters[:5]),
                f"mesh {shape} {state}: another count kernel launched: {launches}",
            )
            if "auc" in fields:
                require(launches["smo_solve"] > 0, f"kernel B did not launch under the mesh: {launches}")
                require(abs(fields["auc"] - h_auc) <= 1e-9, f"mesh AUC {fields['auc']} vs host path {h_auc}")
                require(fields["auc"] >= 0.9, f"mesh AUC {fields['auc']} < 0.9")
            del fsk
            torch.cuda.empty_cache()
    finally:
        shd.packed_ring_rowsharded, shd.packed_round_sharded = spied
        for (mod, name), fn in zip(patched, originals):
            setattr(mod, name, fn)
    if n_cards < 2:
        emit("mesh", distinct_cards="skipped", reason=f"{n_cards} CUDA device visible")
    return dict(main, f_full=f_full, runs=per_run)


def probe_phase(cases: dict, reps: int = 3) -> dict:
    """Phase 16: kernel H's five variants at each of ``cases`` ({shape:
    (x, g, k, p_pad, plain counts, windows, width)}), the counter zeroed
    before. Returns {"launches": n, "shapes": {shape: run_probe's
    result}}, each variant with its bound."""
    from fastsk_tpu_torch.experiments.probe_pairs import run_mma_parts, run_probe
    from fastsk_tpu_torch.ops import pairs_cuda

    pairs_cuda.pairs_probe.launches = 0
    out, parts = {}, {}
    for shape, (x, g, k, p_pad, plain, windows, width) in cases.items():
        res = run_probe(x, g=g, k=k, p_pad=p_pad, reps=reps, counts_plain=plain)
        out_bytes = (x.shape[0] // p_pad) ** 2 * 4
        for variant, fields in res.items():
            fields.update(
                bound(0.0, out_bytes, PEAK_INT8_OPS) if variant == "noop"
                else count_bound(windows, width, x.numel() + out_bytes)
            )
        emit("probe", shape=shape, g=g, m=g - k, reps=reps, variants=res)
        for variant, fields in res.items():
            require(fields["max_abs_err"] == 0, f"kernel H {variant} differs from its plain version on {shape}")
            require(fields["checksums_equal"], f"kernel H {variant} gave different checksums on {shape}")
        out[shape] = res
    launches = pairs_cuda.pairs_probe.launches
    require(launches == reps * 5 * len(cases), f"kernel H launched {launches} times")
    # the parts of kernel A's tensor-core body (not kernel H: uncounted)
    for shape, (x, g, k, p_pad, plain, _, _) in cases.items():
        parts[shape] = run_mma_parts(x, g=g, k=k, p_pad=p_pad, reps=reps, counts_plain=plain)
        emit("probe-mma", shape=shape, g=g, m=g - k, reps=reps, parts=parts[shape])
        require(parts[shape]["current"]["max_abs_err"] == 0,
                f"kernel A's tensor-core body differs from its plain version on {shape}")
    return {"launches": launches, "shapes": out,
            "mma_parts": {shape: p["split"] | {"current_ms": p["current"]["best_ms"]}
                          for shape, p in parts.items()}}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; there is no CPU run")
    from fastsk_tpu_torch import FastSK, FastaUtility, KernelConfig, _build
    from fastsk_tpu_torch.experiments.sass_loop import loop_stats
    from fastsk_tpu_torch.kernel.device_counts import DeviceCounts
    from fastsk_tpu_torch.kernel.pairs_engine import PairsGkmEngine
    from fastsk_tpu_torch.ops import pairs, pairs_cuda
    from fastsk_tpu_torch.ops.encode import encode_sequences
    from fastsk_tpu_torch.svm import smo_cuda

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    try:
        nvcc = subprocess.run(
            [_build.nvcc_path(), "--version"], capture_output=True, text=True,
            check=True,
        ).stdout.strip().splitlines()[-1]
    except RuntimeError as exc:
        nvcc = f"missing: {exc}"
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit(
        "env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvcc=nvcc, triton=triton_version, nvidia_smi=smi,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
    )

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    _build.kernels()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln]
    # kernels whose wgmma ptxas serializes (C7510, C7515, C7518 and kin)
    serialized = sorted({
        ln.split("function '")[-1].rstrip("'")
        for ln in _build.build_log.splitlines()
        if "wgmma.mma_async instructions are serialized" in ln
    })
    emit("build", seconds=build_s, library_dir=_build.BUILD_DIR, ptxas=regs,
         wgmma_serialized=serialized)
    # the inner loop of D to G's kernel at 5 planes (the 2.19 shape's 24
    # letters), in the library just built
    sass = loop_stats()
    emit("sass", **sass)
    require(sass["popc"] > 0 and sass["lop3"] >= 5 * sass["popc"],
            f"the inner loop's common path is not 5 LOP3 and a POPC a pair: {sass}")

    # --------------------------------------------------- kernel A vs plain
    rng = np.random.default_rng(0)
    X = [rng.integers(1, 5, size=int(rng.integers(12, 30))).tolist() for _ in range(13)]
    eng = PairsGkmEngine(encode_sequences(X), 6, 2, KernelConfig(device=dev))
    x = eng._build_x()
    want = pairs.pairs_counts_plain(x, k=4, p_pad=eng.p_pad)[:13, :13]
    small_ok = {}
    for body in ("mma", "dp4a"):
        got = pairs_cuda.pairs_counts(x, g=6, k=4, p_pad=eng.p_pad, body=body)[:13, :13]
        small_ok[body] = torch.equal(got, want) and np.array_equal(
            got.cpu().numpy(), numpy_counts(X, 6, 4)
        )
    emit("pairs", shape="seeded 13 x <=30, g=6 m=2", equal=small_ok)
    require(all(small_ok.values()), f"kernel A differs from its plain version on the small shape: {small_ok}")

    reader = FastaUtility()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        Xtr, Ytr = reader.read_data(read_split_fasta(KAT2B, "train", tmpdir))
        Xte, Yte = reader.read_data(read_split_fasta(KAT2B, "test", tmpdir))
    dna = np.random.default_rng(1).integers(1, 5, size=(7230, 200)).tolist()
    pairs_times = {}
    probe_cases = {}  # kernel A's operands and plain counts, for phase 16
    kat2b_counts = None
    for name, seqs, g, m in (
        ("KAT2B", (Xtr, Xte), 8, 4),
        ("dna7230x200", (dna, None), 16, 10),
    ):
        eng = PairsGkmEngine(encode_sequences(*seqs), g, m, KernelConfig(device=dev))
        x = eng._build_x()
        kw = dict(g=g, k=g - m, p_pad=eng.p_pad)
        want, plain_ms = cuda_ms(pairs.pairs_counts_plain, x, k=g - m, p_pad=eng.p_pad)
        # each body, warmed up, then timed; both held to the plain counts
        ms_by, err_by = {}, {}
        for body in ("mma", "dp4a"):
            pairs_cuda.pairs_counts(x, **kw, body=body)
            got, ms_by[body] = cuda_ms(pairs_cuda.pairs_counts, x, **kw, body=body)
            err_by[body] = int((got.long() - want.long()).abs().max())
            if name == "KAT2B" and body == "mma":
                kat2b_counts = got[: eng.n, : eng.n].clone()
            del got
        default_key = pairs_cuda.pairs_body(eng.n_pad, eng.p_pad, x.shape[1])
        depth = pairs_cuda.mma_depth(x.shape[1])
        emit(
            "pairs", shape=name, n=eng.n, p_pad=eng.p_pad, width=x.shape[1], depth_mma=depth,
            body=default_key,
            tile_dp4a=pairs_cuda.tile_sequences(eng.n_pad, eng.p_pad, pairs_cuda.padded_width(x.shape[1])),
            tile_mma=pairs_cuda.mma_tile_sequences(eng.n_pad, eng.p_pad, depth),
            kernel_ms=ms_by, plain_ms=plain_ms, max_abs_err=err_by,
            checksum=int(want.long().sum()),
        )
        require(all(e == 0 for e in err_by.values()), f"kernel A differs from its plain version on {name}: {err_by}")
        windows = windows_of([s for part in seqs if part for s in part], g)
        width = g * eng.alpha
        pairs_times[name] = (
            ms_by[default_key], plain_ms, max(err_by.values()),
            count_bound(windows, width, x.numel() + eng.n_pad**2 * 4), ms_by,
        )
        probe_cases[name] = (x, g, g - m, eng.p_pad, want, windows, width)
        del x, want
    torch.cuda.empty_cache()
    d_kat2b = kat2b_on_d(dev, Xtr, Xte, kat2b_counts)
    a_sweep = pairs_body_sweep(dev)

    # --------------------------------------------------- kernel B vs twin
    ntr = len(Xtr)
    K = DeviceCounts(kat2b_counts).normalized_f32()
    rows = K[:ntr, :ntr]
    with pairs.full_f32_matmul():
        gram = rows @ rows.T
    smo_kat2b = smo_twin("KAT2B", gram, Ytr, np.ones(ntr), clusters=(8, 16))
    folds_kat2b = platt_folds_phase(gram, Ytr)
    del rows, K, kat2b_counts  # the Gram stays for kernel C (phase 10)
    torch.cuda.empty_cache()

    # --------------------------------------------------------- main path
    pairs_cuda.pairs_counts.launches = 0
    pairs_cuda.pairs_counts.bodies = {"mma": 0, "dp4a": 0}
    smo_cuda.smo_solve.launches = 0
    smo_cuda.smo_solve.problems = 0
    fsk = FastSK(g=8, m=4, config=KernelConfig(device=dev, device_resident=True))
    _, kernel_s = wall(fsk.compute_kernel, Xtr, Xte, Ytr, Yte)
    _, fit_s = wall(fsk.fit, C=1.0)
    auc, score_s = wall(fsk.score, "auc")
    launches = {
        "pairs_counts": pairs_cuda.pairs_counts.launches,
        "smo_solve": smo_cuda.smo_solve.launches,
    }
    smo_problems = smo_cuda.smo_solve.problems
    a_bodies = dict(pairs_cuda.pairs_counts.bodies)
    k_dev = fsk._K_dev
    dec = fsk._model.decision_function(fsk._test_gram())
    outputs_ok = (
        tuple(k_dev.shape) == (len(Xtr) + len(Xte),) * 2
        and bool(torch.isfinite(k_dev).all())
        and float((torch.diagonal(k_dev) - 1).abs().max()) < 1e-6
        and dec.shape == (len(Xte),)
        and bool(np.isfinite(dec).all())
    )
    emit(
        "slice", dataset="KAT2B", g=8, m=4, C=1.0, n_train=len(Xtr),
        n_test=len(Xte), kernel_s=kernel_s, fit_s=fit_s, score_s=score_s,
        auc=auc, auc_anchor=AUC_ANCHOR, auc_diff=auc - AUC_ANCHOR,
        svm_iters=fsk._model.iters_, launches=launches, smo_problems=smo_problems,
        a_bodies=a_bodies, outputs_ok=outputs_ok,
    )
    require(outputs_ok, "the slice's kernel or decision values are malformed")
    require(launches["pairs_counts"] > 0, f"kernel A did not launch: {launches}")
    require(a_bodies == {"mma": 1, "dp4a": 0}, f"KAT2B did not take kernel A's tensor-core body once: {a_bodies}")
    require(
        launches["smo_solve"] == 2 and smo_problems == 6,
        f"the C-SVC fit took {launches['smo_solve']} launches of kernel B for "
        f"{smo_problems} problems, not 2 for 6 (the main solve, then 5 Platt folds)",
    )
    require(abs(auc - AUC_ANCHOR) <= 0.005, f"AUC {auc} is off the anchor {AUC_ANCHOR}")
    require(round(auc, 6) == AUC_KAT2B, f"AUC {auc} moved from {AUC_KAT2B} (the same trajectories)")

    # ------------------------------- the dense theta engine and approx mode
    a_counts = fsk._counts_dev.counts
    del fsk, k_dev
    torch.cuda.empty_cache()
    theta_dense_phase(dev, a_counts, Xtr, Xte)
    del a_counts
    approx_kat2b_phase(dev, Xtr, Xte, Ytr, Yte)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ golden
    golden = load_tri(os.path.join(GOLDEN, "ep_sl_g6m2.txt"))
    reader = FastaUtility()
    g_tr, _ = reader.read_data(os.path.join(GOLDEN, "ep_sl.train.fasta"))
    g_te, _ = reader.read_data(os.path.join(GOLDEN, "ep_sl.test.fasta"))
    gfsk = FastSK(g=6, m=2, config=KernelConfig(device=dev, device_resident=False))
    gfsk.compute_kernel(g_tr, g_te)
    golden_ok = bool(np.array_equal(gfsk.kernel, golden))
    emit("golden", n=golden.shape[0], bit_identical=golden_ok)
    require(golden_ok, "the ep_sl kernel differs from the reference golden")

    packed_rec, smo_219, rfsk = packed_phases(dev, sass)

    # ------------------------------------------------ kernel C vs its twin
    nu_kat2b = smo_nu_twin("KAT2B nu-SVC main solve", gram, Ytr, 0.5, 20_000, clusters=(8, 16))
    del gram
    rows_219 = rfsk._rows()[0]
    gram_219 = rfsk._build_gram(rows_219, rows_219, "linear")
    nu_219 = smo_nu_twin(
        "2.19 nu-SVC main solve", gram_219, rfsk.train_labels, 0.5,
        max(10_000_000, 100 * gram_219.shape[0]),
    )
    require(nu_219["reached_eps"], "kernel C hit max_iter before the eps stop at the 2.19 shape")
    del rfsk, rows_219, gram_219
    torch.cuda.empty_cache()

    # ----------------------------- the SVM family, multiclass and the CLI
    family, svr = svm_family_phase(dev, Xtr, Xte, Ytr, Yte)
    multiclass_phase(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmpdir:
        cli_phase(tmpdir)

    # ------------------------------- kernel F, the mesh path and kernel H
    s1 = s1_phase(dev)
    mesh = mesh_phase(dev)
    probe = probe_phase(probe_cases)
    del probe_cases
    torch.cuda.empty_cache()

    # ------------------------------- the sorted theta engine, approx and exact
    approx_219_phase(dev)
    theta_sorted_phase(dev)

    record = {
        "kernels": [
            {
                "name": "pairs_counts", "route": "cuda",
                "source": "fastsk_tpu_torch/csrc/pairs.cu",
                "replaces": "fastsk_tpu/ops/pairs_pallas.py:108",
                "launches": launches["pairs_counts"],
                "max_abs_err": pairs_times["KAT2B"][2],
                "ms": pairs_times["KAT2B"][0], "plain_ms": pairs_times["KAT2B"][1],
                **pairs_times["KAT2B"][3], "library_ms": None,
                "bodies": a_bodies, "ms_by_body": pairs_times["KAT2B"][4],
                "ms_g16": pairs_times["dna7230x200"][0],
                "ms_by_body_g16": pairs_times["dna7230x200"][4],
                "plain_ms_g16": pairs_times["dna7230x200"][1],
                "bound_ms_g16": pairs_times["dna7230x200"][3]["bound_ms"],
                "d_ms_kat2b": d_kat2b["d_ms"], "body_sweep": a_sweep,
                "mma_parts": probe["mma_parts"],
            },
            {
                "name": "smo_solve", "route": "cuda",
                "source": "fastsk_tpu_torch/csrc/smo.cu",
                "replaces": "fastsk_tpu/svm/smo_pallas.py:118",
                "launches": launches["smo_solve"],
                "max_abs_err": smo_kat2b["max_abs_dalpha"],
                "ms": smo_kat2b["kernel_ms"], "plain_ms": smo_kat2b["plain_ms"],
                "iters": smo_kat2b["iters_kernel"], "us_per_iter": smo_kat2b["us_per_iter"],
                "cluster_size": smo_kat2b["cluster_size"], "smem_path": smo_kat2b["smem_path"],
                "ms_by_cluster": smo_kat2b["ms_by_cluster"], "problems": smo_problems,
                "platt_batched_ms": folds_kat2b["batched_ms"],
                "platt_single_ms_sum": folds_kat2b["single_ms_sum"],
                "platt_slowest_single_ms": folds_kat2b["slowest_single_ms"],
                "platt_iters": folds_kat2b["iters"],
                "max_abs_err_2_19": smo_219["max_abs_dalpha"],
                "ms_2_19": smo_219["kernel_ms"], "plain_ms_2_19": smo_219["plain_ms"],
                **svr_record(svr["epsilon_svr"]),
                "epsilon_svr_fit_s": family["epsilon_svr"]["fit_s"],
                "epsilon_svr_iters": family["epsilon_svr"]["svm_iters"],
                "epsilon_svr_fit_us_per_iter": family["epsilon_svr"]["fit_us_per_iter"],
                "slice_fit_s": fit_s,
                **smo_bound(smo_kat2b["n"], smo_kat2b["iters_kernel"]), "library_ms": None,
            },
            *packed_rec,
            {
                # the top-level numbers are the nu-SVR fit's one launch at
                # 2n = 12,636 rows (its twin, and so max_abs_err and
                # plain_ms, on a 3,000-iteration prefix of the same dual)
                "name": "smo_nu_solve", "route": "cuda",
                "source": "fastsk_tpu_torch/csrc/smo.cu",
                "replaces": "fastsk_tpu/svm/smo_pallas.py:254",
                "launches": family["nu_svr"]["launches"]["smo_nu_solve"],
                "max_abs_err": svr["nu_svr"]["max_abs_dalpha"],
                "ms": family["nu_svr"]["kernel_c_solve"]["ms"],
                "plain_ms": svr["nu_svr"]["plain_ms"],
                "plain_iters": svr["nu_svr"]["iters_plain"],
                "iters": family["nu_svr"]["kernel_c_solve"]["iters"],
                "us_per_iter": family["nu_svr"]["kernel_c_solve"]["us_per_iter"],
                "rows": family["nu_svr"]["kernel_c_solve"]["rows"],
                "nu_svr_fit_s": family["nu_svr"]["fit_s"],
                "cluster_size": smo_cuda.smo_cluster_size(),
                "prefix_ms_by_cluster": svr["nu_svr"]["ms_by_cluster"],
                **smo_bound(family["nu_svr"]["kernel_c_solve"]["rows"],
                            family["nu_svr"]["kernel_c_solve"]["iters"]),
                "library_ms": None,
                "nu_svc_launches": family["nu_svc"]["launches"]["smo_nu_solve"],
                "max_abs_err_kat2b": nu_kat2b["max_abs_dalpha"],
                "ms_kat2b": nu_kat2b["kernel_ms"], "plain_ms_kat2b": nu_kat2b["plain_ms"],
                "iters_kat2b": nu_kat2b["iters_kernel"], "us_per_iter_kat2b": nu_kat2b["us_per_iter"],
                "ms_by_cluster_kat2b": nu_kat2b["ms_by_cluster"],
                "bound_ms_kat2b": smo_bound(nu_kat2b["n"], nu_kat2b["iters_kernel"])["bound_ms"],
                "max_abs_err_2_19": nu_219["max_abs_dalpha"],
                "ms_2_19": nu_219["kernel_ms"], "plain_ms_2_19": nu_219["plain_ms"],
                "iters_2_19": nu_219["iters_kernel"],
            },
            {
                # the top-level numbers are the medium set's rectangle (the
                # walk of the ring's other steps) against the plain
                # composite; launches are the 2x2 ring
                # run's (the main run); *_2_19_* the slice's rows (phase
                # 15), each timed call's launches counted; mesh_runs each
                # mesh run's launches, route ms and bound; s1_* F's
                # stage-1 kernel alone at the medium set
                "name": "packed_block", "route": "cuda",
                "source": "fastsk_tpu_torch/csrc/pairs_packed.cu",
                "replaces": "fastsk_tpu/ops/pairs_packed_pallas.py:130",
                "launches": mesh["launches"]["packed_block"],
                **{key: s1["medium"][key] for key in (
                    "ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")},
                "library_ms": None,
                "cases": s1["medium"]["cases"],
                "ms_dna_g12m6": s1["dna-g12m6"]["ms"],
                "plain_ms_dna_g12m6": s1["dna-g12m6"]["plain_ms"],
                "max_abs_err_dna_g12m6": s1["dna-g12m6"]["max_abs_err"],
                "bound_ms_dna_g12m6": s1["dna-g12m6"]["bound_ms"],
                "cases_dna_g12m6": s1["dna-g12m6"]["cases"],
                **{f"{key}_2_19_{route}": mesh["f_full"][route][key]
                   for route in ("ring_1x1", "round_robin")
                   for key in ("ms", "launches", "bound_ms")},
                "d_ms_2_19": mesh["f_full"]["d_ms"],
                "mesh_runs": mesh["runs"],
                **{f"s1_{key}": s1["medium"]["s1"][key] for key in (
                    "ms", "plain_ms", "max_abs_err", "bound_ms")},
                "s1_launches": mesh["launches"]["packed_s1"],
            },
            {
                # the top-level numbers are the `current` variant's at KAT2B;
                # `variants` has each variant at both shapes
                "name": "pairs_probe", "route": "cuda",
                "source": "fastsk_tpu_torch/csrc/pairs.cu",
                "replaces": "experiments/probe_pairs.py:39",
                "launches": probe["launches"],
                "max_abs_err": max(
                    v["max_abs_err"] for res in probe["shapes"].values() for v in res.values()
                ),
                "ms": probe["shapes"]["KAT2B"]["current"]["best_ms"],
                "plain_ms": pairs_times["KAT2B"][1],
                "bound_ms": probe["shapes"]["KAT2B"]["current"]["bound_ms"],
                "bound_by": probe["shapes"]["KAT2B"]["current"]["bound_by"],
                "library_ms": None,
                "variants": {
                    shape: {
                        v: {key: f[key] for key in ("best_ms", "max_abs_err", "bound_ms", "bound_by")}
                        | ({"chain_ms_vs_skeleton": f["chain_ms_vs_skeleton"]}
                           if "chain_ms_vs_skeleton" in f else {})
                        for v, f in res.items()
                    }
                    for shape, res in probe["shapes"].items()
                },
            },
        ]
    }
    print(smi)
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
