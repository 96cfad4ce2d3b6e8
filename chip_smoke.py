"""Drive fastsk_tpu_torch's exact path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and the CUDA toolkit. Phases, one JSON line each; the first failure
raises and the exit code is non-zero:

1. env    torch / CUDA / card / nvcc / triton facts; refuses to run
          without a CUDA device.
2. build  compiles kernels A and B (csrc/pairs.cu, csrc/smo.cu) from the
          checkout with nvcc; prints the seconds.
3. pairs  kernel A against its plain PyTorch version: a small seeded shape
          (also against inline numpy counts), the full KAT2B shape
          (g=8, m=4) and 7230 seeded length-200 DNA at g=16, m=10.
          Integers must be equal.
4. smo    kernel B against its plain twin on the KAT2B linear Gram (the
          main solve of phase 5): same eps-KKT stop, max|dalpha| <= 1e-4*C,
          equal decision signs; iteration counts are reported.
5. slice  KAT2B g=8 m=4 C=1 through FastaUtility -> FastSK.compute_kernel
          (device_resident=True) -> fit -> score("auc"), with the launch
          counters zeroed just before; both kernels must have launched,
          and |AUC - 0.903321| <= 0.005.
6. golden tests/golden/ep_sl at g=6, m=2 with device_resident=False on the
          card: the f64 kernel equals ep_sl_g6m2.txt bit for bit.

The last three lines are the card's name and power limit (nvidia-smi),
the per-kernel JSON record, and the result line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KAT2B = os.path.join(HERE, "experiments", "results_baselines", "tmp", "KAT2B")
GOLDEN = os.path.join(HERE, "tests", "golden")
AUC_ANCHOR = 0.903321  # experiments/results_baselines/oracle_comparison.csv, KAT2B g8 m4


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; there is no CPU run")
    from fastsk_tpu_torch import FastSK, FastaUtility, KernelConfig, _build
    from fastsk_tpu_torch.kernel.device_counts import DeviceCounts
    from fastsk_tpu_torch.kernel.pairs_engine import PairsGkmEngine
    from fastsk_tpu_torch.ops import pairs, pairs_cuda
    from fastsk_tpu_torch.ops.encode import encode_sequences
    from fastsk_tpu_torch.svm import smo_cuda
    from fastsk_tpu_torch.svm.kernel_svm import _finalize_rho, _smo_solve_general

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
    classes = np.unique(Ytr)
    y = torch.as_tensor(np.where(np.asarray(Ytr) == classes[1], 1.0, -1.0), dtype=torch.float32, device=dev)
    Q = gram * torch.outer(y, y)
    C = torch.ones(ntr, device=dev)
    p = -torch.ones(ntr, device=dev)
    a0 = torch.zeros(ntr, device=dev)
    max_iter = max(10_000_000, 100 * ntr)
    (a_k, g_k, it_k), ms_b = cuda_ms(smo_cuda.smo_solve, Q, y, C, p, a0, 1e-3, max_iter)
    a_k, rho_k = _finalize_rho(a_k, g_k, y, C)
    (a_p, rho_p, it_p), plain_b = cuda_ms(_smo_solve_general, Q, y, C, p, a0, 1e-3, max_iter)
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
    emit(
        "smo", n=ntr, kernel_ms=ms_b, plain_ms=plain_b, iters_kernel=it_k,
        iters_plain=it_p, iters_equal=it_k == it_p, max_abs_dalpha=dalpha,
        rho_kernel=float(rho_k), rho_plain=float(rho_p),
        kkt_violation_f64=kkt, decision_signs_equal=signs_equal,
        note=None if it_k == it_p else "f32 trajectories parted; both met the eps-KKT stop",
    )
    require(dalpha <= 1e-4 * 1.0, "kernel B's alpha is off its twin's by more than 1e-4*C")
    require(signs_equal, "kernel B's decision signs differ from its twin's")
    require(it_k < max_iter and it_p < max_iter, "an SMO run hit max_iter before the eps stop")
    del Q, gram, rows, K, kat2b_counts
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
                "launches": launches["smo_solve"], "max_abs_err": dalpha,
                "ms": ms_b, "plain_ms": plain_b,
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
