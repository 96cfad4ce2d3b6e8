"""Drive fastsk_tpu_torch's exact paths on one CUDA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and the CUDA toolkit. Phases, one JSON line each; the first failure
raises and the exit code is non-zero:

1. env    torch / CUDA / card / nvcc / triton facts; refuses to run
          without a CUDA device.
2. build  compiles kernels A, B (csrc/pairs.cu, csrc/smo.cu) and D, E, G
          (csrc/pairs_packed.cu) from the checkout, one nvcc per source in
          parallel; prints the seconds.
3. pairs  kernel A against its plain PyTorch version: a small seeded shape
          (also against inline numpy counts), the full KAT2B shape
          (g=8, m=4) and 7230 seeded length-200 DNA at g=16, m=10.
          Integers must be equal.
4. smo    kernel B against its plain twin on the KAT2B linear Gram (the
          main solve of phase 5): the same iteration count at the eps-KKT
          stop, max|dalpha| <= 1e-4*C, equal decision signs.
5. slice  KAT2B g=8 m=4 C=1 through FastaUtility -> FastSK.compute_kernel
          (device_resident=True) -> fit -> score("auc"), with the launch
          counters zeroed just before; both kernels must have launched,
          and |AUC - 0.903321| <= 0.005.
6. golden tests/golden/ep_sl at g=6, m=2 with device_resident=False on the
          card: the f64 kernel equals ep_sl_g6m2.txt bit for bit.
7. packed kernels D, E and G (the packed engine's band, pair-list and
          grouped routes) against the plain version: a small seeded
          ragged set whose sequences straddle 2048-row strips (also
          against inline numpy counts) and a medium one (400 sequences,
          lengths 16-905, alphabet 24, g=8, m=4). Integers must be equal.
8. packed-full  the shape of protein 2.19 (2564 sequences, lengths
          16-905, alphabet 24, g=8, m=4): D, E and G equal each other and
          the plain version, and D equals kernel A run on the same set in
          the padded sequence-aligned layout.
9. ragged-slice  that set, 80/20 split, positives carrying a seeded motif,
          through FastSK(8, 4).compute_kernel (device_resident=True) ->
          fit(C=0.01) -> score("auc") with the counters zeroed just
          before: the auto route must take kernel D (and not kernel A),
          kernel B must launch, AUC >= 0.9, and a host-path run
          (device_resident=False) must give an AUC within 0.005. Kernel B
          is then held to its twin, as in phase 4, on that fit's training
          Gram: the main solve (C=0.01) and the first Platt fold.
10. smo-nu  kernel C (Solver_NU, csrc/smo.cu) against its plain twin on
          the nu-SVC solve (nu=0.5) of the KAT2B linear Gram (n=6318), both
          capped at 20,000 iterations, and of the ragged slice's training
          Gram (n=2051) to the eps stop: equal iterations, bit-identical
          alpha and grad, each class's sum of alpha at nu*n/2.
11. svm-family  KAT2B g=8 m=4, one compute_kernel (device_resident=True),
          then fit + score of nu_svc (AUC), one_class, epsilon_svr and
          nu_svr (r2 on the 0/1 test labels), the counters zeroed before
          each fit: nu_svc launches kernel C 6 times and B never, AUC >=
          0.85 and within 0.005 of the host path's; one_class and
          epsilon_svr launch B once, nu_svr C once; the solvers' sums of
          alpha hold; one_class leaves at most nu + 0.02 of the training
          rows outside; r2 > 0; every decision finite. Then kernels B and
          C against their twins on the epsilon-SVR and nu-SVR duals of that
          Gram (2n = 12,636 rows, the global-memory path), with the fits'
          p vectors and starts, both capped at 3,000 iterations: equal
          iterations, bit-identical alpha and grad.
12. multiclass  a seeded 4-class ragged set (one motif per class, planted
          once per 100 letters, 1,000 sequences, lengths 16-905, alphabet
          24, 80/20 split) through
          kernel D, then one-vs-one c_svc (36 launches of B: 6 pairs x
          (1 solve + 5 Platt folds)) and nu_svc (36 launches of C). Each
          model is refitted on the CPU from the same f32 Gram (the twins):
          equal predictions, pair decisions within 1e-4 where the CPU's
          |decision| > 1e-3, probabilities within 1e-4; accuracy >= 90%
          as a sanity bound.
13. cli     `python -m fastsk_tpu_torch.cli -g 10 -m 4 --json --device cuda`
          on EP300 (2000 + 2000 sequences): AUC within 0.005 of 0.990146;
          then -s nu_svc -r fastsk with a LIBSVM model and the kernel saved,
          and `python -m fastsk_tpu_torch.predict_cli` on them: its accuracy
          within 0.05 points (one row of 2000) of the CLI's.

The last three lines are the card's name and power limit (nvidia-smi),
the per-kernel JSON record, and the result line.
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
EP300_ANCHOR = 0.990146  # the same file, EP300 g10 m4
MOTIF = [5, 17, 2, 11, 20, 8, 14, 3]  # planted in the ragged positives


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


def smo_twin(shape: str, gram, labels, c_box) -> dict:
    """Kernel B against its plain twin on one C-SVC solve of ``gram`` with
    KernelSVC's eps and max_iter; ``c_box`` is the per-row box (0 on the
    held-out rows of a Platt fold). Both must stop at the same iteration
    with max|dalpha| <= 1e-4 * C and equal decision signs. Emits an "smo"
    line and returns its fields."""
    from fastsk_tpu_torch.ops import pairs
    from fastsk_tpu_torch.svm import smo_cuda
    from fastsk_tpu_torch.svm.kernel_svm import _finalize_rho, _smo_solve_general

    dev, n = gram.device, gram.shape[0]
    classes = np.unique(labels)
    y = torch.as_tensor(
        np.where(np.asarray(labels) == classes[1], 1.0, -1.0), dtype=torch.float32, device=dev
    )
    Q = gram * torch.outer(y, y)
    C = torch.as_tensor(c_box, dtype=torch.float32, device=dev)
    p = -torch.ones(n, device=dev)
    a0 = torch.zeros(n, device=dev)
    max_iter = max(10_000_000, 100 * n)
    (a_k, g_k, it_k), ms = cuda_ms(smo_cuda.smo_solve, Q, y, C, p, a0, 1e-3, max_iter)
    a_k, rho_k = _finalize_rho(a_k, g_k, y, C)
    (a_p, rho_p, it_p), plain_ms = cuda_ms(_smo_solve_general, Q, y, C, p, a0, 1e-3, max_iter)
    dalpha = float((a_k - a_p).abs().max())
    with pairs.full_f32_matmul():
        dec_k = gram @ (a_k * y) - rho_k
        dec_p = gram @ (a_p * y) - rho_p
    # the stop quantity gmax + gmax2 with grad recomputed from scratch in
    # f64: what the incremental f32 grad drifted to over the iterations
    grad = Q.double() @ a_k.double() - 1.0
    up = torch.where(y > 0, a_k < C, a_k > 0)
    low = torch.where(y > 0, a_k > 0, a_k < C)
    kkt = float((-y * grad)[up].max() + (y * grad)[low].max())
    signs_equal = bool(torch.equal(torch.sign(dec_k), torch.sign(dec_p)))
    c_max = float(np.max(c_box))
    fields = dict(
        shape=shape, n=n, C=c_max, held_out=int((C == 0).sum()), kernel_ms=ms,
        plain_ms=plain_ms, iters_kernel=it_k, iters_plain=it_p,
        max_abs_dalpha=dalpha, rho_kernel=float(rho_k), rho_plain=float(rho_p),
        kkt_violation_f64=kkt, decision_signs_equal=signs_equal,
    )
    emit("smo", **fields)
    require(it_k == it_p, f"kernel B stopped at {it_k} iterations, its twin at {it_p} ({shape})")
    require(dalpha <= 1e-4 * c_max, f"kernel B's alpha is off its twin's by more than 1e-4*C ({shape})")
    require(signs_equal, f"kernel B's decision signs differ from its twin's ({shape})")
    require(it_k < max_iter, f"the SMO run hit max_iter before the eps stop ({shape})")
    return fields


def packed_phases(dev, small=(24, 100, 905), medium=(400, 16, 905),
                  full=(2564, 16, 905)):
    """Phases 7-9 (the packed engine and kernels D, E, G); each size is
    (sequences, shortest, longest). Returns the kernels' JSON records and
    kernel B's twin check on the ragged slice's main solve."""
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

    def route_counts(band, grouped):
        """{route: (int64 counts in the input order, ms)}; each route runs
        once to warm up, then once timed with CUDA events."""
        out = {}
        for name, eng, route in (
            ("D", band, "band"), ("E", band, "pairlist"), ("G", grouped, "grouped"),
        ):
            eng.route = route
            eng._counts()
            out[name] = cuda_ms(eng._counts)
        band.route = "band"
        return out

    packed_times = {}
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
        res = route_counts(band, grouped)
        errs = {name: int((got - plain).abs().max()) for name, (got, _) in res.items()}
        numpy_ok = (
            bool(np.array_equal(plain.cpu().numpy(), numpy_counts(X, 8, 4)))
            if check_numpy else None
        )
        emit(
            "packed", shape=shape, n=band.n, rows=band.total_rows,
            strips=band.n_strips, c_max=band.c_max,
            straddling=straddling(band),
            kernel_ms={name: ms for name, (_, ms) in res.items()},
            plain_ms=plain_ms, max_abs_err=errs, equal_numpy=numpy_ok,
            checksum=int(plain.sum()),
        )
        require(all(e == 0 for e in errs.values()), f"D/E/G differ from the plain version on {shape}: {errs}")
        require(numpy_ok is not False, "the plain packed counts differ from numpy on the small shape")
        packed_times[shape] = {name: (ms, plain_ms, errs[name]) for name, (_, ms) in res.items()}
        del band, grouped, rows, plain_sorted, plain, res
    torch.cuda.empty_cache()

    # ------------------------------- the 2.19 shape: D = E = G = kernel A
    X219, y219 = ragged_set(219, *full)
    band, grouped = packed_engines(X219, 8, 4)
    res = route_counts(band, grouped)
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
    emit(
        "packed-full", n=band.n, rows=band.total_rows, strips=band.n_strips,
        c_max=band.c_max, windows=windows,
        window_pairs_upper=windows * (windows + 1) // 2, p_pad_a=eng_a.p_pad,
        width_a=x_a.shape[1], kernel_ms={name: ms for name, (_, ms) in res.items()},
        kernel_a_ms=a_ms, plain_ms=full_plain_ms, max_abs_err_vs_d=errs,
        checksum=int(d_counts.sum()),
    )
    require(all(e == 0 for e in errs.values()), f"D, E, G, A and plain disagree at the 2.19 shape: {errs}")
    full_times = {name: ms for name, (_, ms) in res.items()}
    del band, grouped, res, d_counts, x_a, a_full, a_counts
    torch.cuda.empty_cache()

    # ------------------------------- the ragged slice through the public API
    n_tr = int(0.8 * len(X219))
    perm = np.random.default_rng(2190).permutation(len(X219))
    tr_idx, te_idx = perm[:n_tr], perm[n_tr:]
    r_tr = [X219[i] for i in tr_idx]
    r_te = [X219[i] for i in te_idx]
    ry_tr, ry_te = y219[tr_idx], y219[te_idx]
    counters = (
        pairs_cuda.pairs_counts, smo_cuda.smo_solve, pairs_packed_cuda.packed_band,
        pairs_packed_cuda.packed_pairlist, pairs_packed_cuda.packed_grouped,
    )
    for fn in counters:
        fn.launches = 0
    rfsk = FastSK(g=8, m=4, config=KernelConfig(device=dev, device_resident=True))
    _, r_kernel_s = wall(rfsk.compute_kernel, r_tr, r_te, ry_tr, ry_te)
    _, r_fit_s = wall(rfsk.fit, C=0.01)
    r_auc, r_score_s = wall(rfsk.score, "auc")
    r_launches = {fn.__name__: fn.launches for fn in counters}
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
        svm_iters=rfsk._model.iters_, launches=r_launches, outputs_ok=r_ok,
    )
    require(r_ok, "the ragged slice's kernel or decision values are malformed")
    require(r_launches["packed_band"] > 0, f"kernel D did not launch: {r_launches}")
    require(r_launches["pairs_counts"] == 0, f"the ragged set took kernel A: {r_launches}")
    require(r_launches["smo_solve"] > 0, f"kernel B did not launch: {r_launches}")
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
        require(o_launches["packed_band"] == 0, f"route {key} took kernel D: {o_launches}")
        require(same, f"route {key}'s kernel counts differ from kernel D's")
        r_launches[fn.__name__] = o_launches[fn.__name__]
        del ofsk

    packed_src = "fastsk_tpu_torch/csrc/pairs_packed.cu"
    packed_rec = [
        {
            "name": fn.__name__, "route": "cuda", "source": packed_src,
            "replaces": f"fastsk_tpu/ops/pairs_packed_pallas.py:{line}",
            "launches": r_launches[fn.__name__],
            "max_abs_err": packed_times["medium"][key][2],
            "ms": packed_times["medium"][key][0],
            "plain_ms": packed_times["medium"][key][1],
            "ms_2_19": full_times[key], "plain_ms_2_19": full_plain_ms,
        }
        for key, fn, line in (
            ("D", pairs_packed_cuda.packed_band, 605),
            ("E", pairs_packed_cuda.packed_pairlist, 318),
            ("G", pairs_packed_cuda.packed_grouped, 257),
        )
    ]
    return packed_rec, smo_219, rfsk


def smo_nu_twin(shape: str, gram, labels, nu: float, max_iter: int) -> dict:
    """Kernel C against its plain twin on the nu-SVC solve of ``gram`` that
    NuSVC.fit makes (LIBSVM's start, eps=1e-3), both capped at
    ``max_iter``: the same iteration count, bit-identical alpha and grad,
    and each class's sum of alpha still nu*n/2. Emits an "smo-nu" line
    and returns its fields."""
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
    target = nu * n / 2.0
    sums = [float(a_k[y == c].double().sum()) for c in (1.0, -1.0)]
    fields = dict(
        shape=shape, n=n, nu=nu, max_iter=max_iter, kernel_ms=ms,
        plain_ms=plain_ms, iters_kernel=it_k, iters_plain=it_p,
        reached_eps=it_k < max_iter, max_abs_dalpha=dalpha,
        max_abs_dgrad=dgrad, class_sums=sums, class_sum_target=target,
    )
    emit("smo-nu", **fields)
    require(it_k == it_p, f"kernel C stopped at {it_k} iterations, its twin at {it_p} ({shape})")
    require(dalpha == 0.0 and dgrad == 0.0, f"kernel C left its twin's trajectory ({shape})")
    require(
        all(abs(v - target) <= 1e-3 * target for v in sums),
        f"kernel C did not conserve the class sums {sums} (target {target}, {shape})",
    )
    return fields


def svr_twins(gram, targets, max_iter: int) -> dict:
    """Kernels B and C against their twins on the 2n-row SVR duals of
    ``gram`` as EpsilonSVR.fit (C=1, epsilon=0.1, zero start) and
    NuSVR.fit (C=1, nu=0.5, LIBSVM's start) assemble them, p vectors
    included, both capped at ``max_iter``. Past 10,240 rows this is the
    kernels' global-memory path. Equal iterations and bit-identical alpha
    and grad. Emits an "svr-twin" line per solver and returns
    {svm_type: fields}."""
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
        fields = dict(
            svm_type=svm_type, rows=2 * n, max_iter=max_iter, kernel_ms=ms,
            plain_ms=plain_ms, iters_kernel=it_k, iters_plain=it_p,
            max_abs_dalpha=float((a_k - a_p).abs().max()),
            max_abs_dgrad=float((g_k - g_p).abs().max()),
        )
        emit("svr-twin", **fields)
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
    from fastsk_tpu_torch.svm import smo_cuda

    counters = (smo_cuda.smo_solve, smo_cuda.smo_nu_solve)
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
        _, fit_s = wall(fsk.fit, svm_type=svm_type, **kw)
        score, score_s = wall(fsk.score, metric)
        launches = {c.__name__: c.launches for c in counters}
        model = fsk._model
        decide = getattr(model, "decision_function", model.predict)
        dec_test, dec_train = decide(fsk._test_gram()), decide(gram_tr)
        fields = dict(
            svm_type=svm_type, kernel_s=kernel_s, fit_s=fit_s, score_s=score_s,
            metric=metric, score=score, svm_iters=getattr(model, "iters_", None),
            launches=launches,
            decisions_finite=bool(np.isfinite(dec_test).all() and np.isfinite(dec_train).all()),
        )
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
            launches == {"smo_solve": want_b, "smo_nu_solve": want_c},
            f"{svm_type}: launches {launches}, expected B {want_b} and C {want_c}",
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
        _, fit_s = wall(fsk.fit, svm_type=svm_type, **kw)
        acc, score_s = wall(fsk.score, "accuracy")
        launches = {c.__name__: c.launches for c in counters}
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
            launches=launches, decisions_shape=list(dec.shape),
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
        other = "smo_nu_solve" if want == "smo_solve" else "smo_solve"
        require(launches[want] == 36 and launches[other] == 0,
                f"{svm_type}: launches {launches}, expected 36 of {want}")
        require(dec.shape == (len(te), 6) and bool(np.isfinite(dec).all()),
                f"{svm_type}: malformed pair decisions")
        require(fields["predictions_equal_host"],
                f"{svm_type}: the card's one-vs-one predictions differ from the CPU refit's")
        require(fields["max_abs_ddecision_host"] <= 1e-4,
                f"{svm_type}: pair decisions off the CPU refit's by {fields['max_abs_ddecision_host']}")
        require(fields["max_abs_dproba_host"] <= 1e-4,
                f"{svm_type}: probabilities off the CPU refit's by {fields['max_abs_dproba_host']}")
        require(acc >= 90.0, f"{svm_type}: 4-class accuracy {acc}% < 90%")
        out[svm_type] = dict(fit_s=fit_s, accuracy=acc, launches=launches)
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
    fields = dict(
        dataset="EP300", g=10, m=4, c_svc=c_svc, c_svc_wall_s=c_svc_s,
        auc_anchor=EP300_ANCHOR, nu_svc=nu, predict_cli_accuracy=pred_acc,
    )
    emit("cli", **fields)
    require(abs(c_svc["auc"] - EP300_ANCHOR) <= 0.005,
            f"CLI AUC {c_svc['auc']} is off the anchor {EP300_ANCHOR}")
    require(abs(pred_acc - nu["accuracy"]) <= 0.05,
            f"predict_cli accuracy {pred_acc} vs the CLI's {nu['accuracy']}")
    return fields


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; there is no CPU run")
    from fastsk_tpu_torch import FastSK, FastaUtility, KernelConfig, _build
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
    emit("build", seconds=build_s, library_dir=_build.BUILD_DIR, ptxas=regs)

    # --------------------------------------------------- kernel A vs plain
    rng = np.random.default_rng(0)
    X = [rng.integers(1, 5, size=int(rng.integers(12, 30))).tolist() for _ in range(13)]
    eng = PairsGkmEngine(encode_sequences(X), 6, 2, KernelConfig(device=dev))
    x = eng._build_x()
    got = pairs_cuda.pairs_counts(x, g=6, k=4, p_pad=eng.p_pad)[:13, :13]
    want = pairs.pairs_counts_plain(x, k=4, p_pad=eng.p_pad)[:13, :13]
    small_ok = torch.equal(got, want) and np.array_equal(
        got.cpu().numpy(), numpy_counts(X, 6, 4)
    )
    emit("pairs", shape="seeded 13 x <=30, g=6 m=2", equal=small_ok)
    require(small_ok, "kernel A differs from its plain version on the small shape")

    reader = FastaUtility()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        Xtr, Ytr = reader.read_data(read_split_fasta(KAT2B, "train", tmpdir))
        Xte, Yte = reader.read_data(read_split_fasta(KAT2B, "test", tmpdir))
    dna = np.random.default_rng(1).integers(1, 5, size=(7230, 200)).tolist()
    pairs_times = {}
    kat2b_counts = None
    for name, seqs, g, m in (
        ("KAT2B", (Xtr, Xte), 8, 4),
        ("dna7230x200", (dna, None), 16, 10),
    ):
        eng = PairsGkmEngine(encode_sequences(*seqs), g, m, KernelConfig(device=dev))
        x = eng._build_x()
        kw = dict(g=g, k=g - m, p_pad=eng.p_pad)
        pairs_cuda.pairs_counts(x, **kw)  # warm-up launch
        got, ms = cuda_ms(pairs_cuda.pairs_counts, x, **kw)
        want, plain_ms = cuda_ms(pairs.pairs_counts_plain, x, k=g - m, p_pad=eng.p_pad)
        err = int((got.long() - want.long()).abs().max())
        emit(
            "pairs", shape=name, n=eng.n, p_pad=eng.p_pad, width=x.shape[1],
            tile=pairs_cuda.tile_sequences(eng.n_pad, eng.p_pad, pairs_cuda.padded_width(x.shape[1])),
            kernel_ms=ms, plain_ms=plain_ms, max_abs_err=err,
            checksum=int(got.long().sum()),
        )
        require(err == 0, f"kernel A differs from its plain version on {name}")
        pairs_times[name] = (ms, plain_ms, err)
        if name == "KAT2B":
            kat2b_counts = got[: eng.n, : eng.n].clone()
        del x, got, want
    torch.cuda.empty_cache()

    # --------------------------------------------------- kernel B vs twin
    ntr = len(Xtr)
    K = DeviceCounts(kat2b_counts).normalized_f32()
    rows = K[:ntr, :ntr]
    with pairs.full_f32_matmul():
        gram = rows @ rows.T
    smo_kat2b = smo_twin("KAT2B", gram, Ytr, np.ones(ntr))
    del rows, K, kat2b_counts  # the Gram stays for kernel C (phase 10)
    torch.cuda.empty_cache()

    # --------------------------------------------------------- main path
    pairs_cuda.pairs_counts.launches = 0
    smo_cuda.smo_solve.launches = 0
    fsk = FastSK(g=8, m=4, config=KernelConfig(device=dev, device_resident=True))
    _, kernel_s = wall(fsk.compute_kernel, Xtr, Xte, Ytr, Yte)
    _, fit_s = wall(fsk.fit, C=1.0)
    auc, score_s = wall(fsk.score, "auc")
    launches = {
        "pairs_counts": pairs_cuda.pairs_counts.launches,
        "smo_solve": smo_cuda.smo_solve.launches,
    }
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
        svm_iters=fsk._model.iters_, launches=launches, outputs_ok=outputs_ok,
    )
    require(outputs_ok, "the slice's kernel or decision values are malformed")
    require(all(v > 0 for v in launches.values()), f"a kernel did not launch: {launches}")
    require(abs(auc - AUC_ANCHOR) <= 0.005, f"AUC {auc} is off the anchor {AUC_ANCHOR}")

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

    packed_rec, smo_219, rfsk = packed_phases(dev)

    # ------------------------------------------------ kernel C vs its twin
    nu_kat2b = smo_nu_twin("KAT2B nu-SVC main solve", gram, Ytr, 0.5, 20_000)
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

    record = {
        "kernels": [
            {
                "name": "pairs_counts", "route": "cuda",
                "source": "fastsk_tpu_torch/csrc/pairs.cu",
                "replaces": "fastsk_tpu/ops/pairs_pallas.py:108",
                "launches": launches["pairs_counts"],
                "max_abs_err": pairs_times["KAT2B"][2],
                "ms": pairs_times["KAT2B"][0], "plain_ms": pairs_times["KAT2B"][1],
            },
            {
                "name": "smo_solve", "route": "cuda",
                "source": "fastsk_tpu_torch/csrc/smo.cu",
                "replaces": "fastsk_tpu/svm/smo_pallas.py:118",
                "launches": launches["smo_solve"],
                "max_abs_err": smo_kat2b["max_abs_dalpha"],
                "ms": smo_kat2b["kernel_ms"], "plain_ms": smo_kat2b["plain_ms"],
                "max_abs_err_2_19": smo_219["max_abs_dalpha"],
                "ms_2_19": smo_219["kernel_ms"], "plain_ms_2_19": smo_219["plain_ms"],
                **svr_record(svr["epsilon_svr"]),
            },
            *packed_rec,
            {
                "name": "smo_nu_solve", "route": "cuda",
                "source": "fastsk_tpu_torch/csrc/smo.cu",
                "replaces": "fastsk_tpu/svm/smo_pallas.py:254",
                "launches": family["nu_svc"]["launches"]["smo_nu_solve"],
                "max_abs_err": nu_kat2b["max_abs_dalpha"],
                "ms": nu_kat2b["kernel_ms"], "plain_ms": nu_kat2b["plain_ms"],
                "iters": nu_kat2b["iters_kernel"],
                "max_abs_err_2_19": nu_219["max_abs_dalpha"],
                "ms_2_19": nu_219["kernel_ms"], "plain_ms_2_19": nu_219["plain_ms"],
                "iters_2_19": nu_219["iters_kernel"],
                **svr_record(svr["nu_svr"]),
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
