"""The plain reference against brute force and against the port at tiny
sizes on the CPU."""

import math

import numpy as np
import pytest
import torch

from gkmbench import reference as ref


def brute_counts(X, g, k):
    """Window pairs compared letter by letter (another algorithm than the
    reference's one-hot products)."""
    wins = [np.array([s[p : p + g] for p in range(len(s) - g + 1)]) for s in X]
    comb = np.array([math.comb(d, k) for d in range(g + 1)])
    n = len(X)
    out = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(n):
            out[i, j] = comb[(wins[i][:, None, :] == wins[j][None, :, :]).sum(-1)].sum()
    return out


def seqs(seed, n, lo, hi, alpha):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, alpha + 1, size=int(rng.integers(lo, hi + 1))).tolist() for _ in range(n)]


@pytest.mark.parametrize("block", [7, 64, 16384])
@pytest.mark.parametrize("shape", [(9, 20, 20, 4, 6, 3), (11, 8, 40, 24, 5, 2)])
def test_allpairs_counts_match_brute_force(block, shape):
    n, lo, hi, alpha, g, m = shape
    X = seqs(n + block, n, lo, hi, alpha)
    got = ref.allpairs_counts(X, g, m, "cpu", block=block).numpy()
    assert np.array_equal(got, brute_counts(X, g, g - m))


def test_theta_counts_sum_to_the_exact_kernel():
    X = seqs(3, 7, 10, 30, 4)
    g, m = 6, 3
    count = ref.ThetaCounter(X, g, "cpu")
    total = sum(count(t) for t in ref.theta_stream(g, g - m, 5))
    assert np.array_equal(total.to(torch.int64).numpy(), brute_counts(X, g, g - m))


def test_theta_stream_is_the_ports():
    from fastsk_tpu_torch.kernel.engine import theta_stream

    for seed in (0, 9, 2**31 + 3):
        assert np.array_equal(ref.theta_stream(13, 6, seed), theta_stream(13, 6, seed))


def test_approx_reference_follows_the_ports_stop():
    from fastsk_tpu_torch import FastSK, KernelConfig

    X = seqs(4, 40, 30, 30, 4)
    y = np.array([0, 1] * 20)
    for seed in (1, 2):
        f = FastSK(8, 5, approx=True, delta=0.05, seed=seed, config=KernelConfig(device="cpu"))
        f.compute_kernel(X[:30], X[30:], y[:30], y[30:])
        r = ref.approx_reference(X, 30, 8, 5, seed, 0.05, None, -1, "cpu")
        assert r["iters"] == f.iterations
        judged = ref.approx_reference(X, 30, 8, 5, seed, 0.05, f.iterations, -1, "cpu")
        assert judged["stop"] == 0
        assert np.array_equal(judged["counts"].numpy(), f.kernel_counts)
        assert ref.sd_gap(f.get_stdevs(), judged["sd"]) < 1e-5
        late = ref.approx_reference(X, 30, 8, 5, seed, 0.05, f.iterations + 1, -1, "cpu")
        assert late["stop"] >= 1


def test_smo_and_judge_against_the_ports_svm():
    from fastsk_tpu_torch.metrics import auc_pairwise
    from fastsk_tpu_torch.svm.kernel_svm import KernelSVC
    from fastsk_tpu_torch.svm.platt import sigmoid_train

    X = seqs(6, 40, 30, 40, 4)
    y = np.array([0, 1] * 20)
    counts = ref.allpairs_counts(X, 6, 3, "cpu")
    nt = 30
    judge = ref.SvmJudge(counts, nt, y[:nt], y[nt:], 1.0)
    ys = np.where(y[:nt] == 1, 1.0, -1.0)
    a, rho, it = ref.smo(judge.gram, ys, 1.0)
    assert it > 0
    dec = judge.test_gram @ (a * ys) - rho
    v = judge.judge(a * ys, rho)
    assert v["svm_gap"] < 1e-3 and v["rho"] < 1e-9
    port = KernelSVC(C=1.0, probability=True).fit(judge.gram, y[:nt])
    w = judge.judge(port.alpha_y_, port.rho_)
    assert w["svm_gap"] < 2e-3 and w["rho"] < 1e-3
    assert np.allclose(port.decision_function(judge.test_gram), dec, atol=1e-2)
    proba = port.predict_proba(judge.test_gram)[:, 1]
    assert judge.proba_gap(port.alpha_y_, port.rho_, port.platt_, proba) < 1e-12
    assert ref.auc(y[nt:], proba) == auc_pairwise(y[nt:], proba)
    train_dec = port.decision_function(judge.gram)
    assert np.allclose(ref.sigmoid_train(train_dec, ys), sigmoid_train(train_dec, ys))
    off = judge.judge(np.zeros(nt), 0.0)
    assert off["svm_gap"] == pytest.approx(2.0)


@pytest.mark.parametrize("y", [[0, 1] * 20, [1] * 7 + [0] * 11 + [1] * 5, [3, 3, 1, 3, 1, 1, 1, 3, 3, 3, 1, 3, 3]])
def test_stratified_folds_are_the_ports(y):
    from fastsk_tpu_torch.svm.linear import stratified_kfold_indices

    want = stratified_kfold_indices(np.array(y), 5)
    got = ref.stratified_folds(np.array(y), 5)
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_platt_and_auc_judged_against_the_reference():
    from fastsk_tpu_torch.svm.kernel_svm import KernelSVC

    from gkmbench.loaders.ragged_fixed import ragged_set

    X, y = ragged_set(8, 80, 20, 40, 4, [1, 2, 3, 4, 1, 2, 3, 4])
    nt = 60
    judge = ref.SvmJudge(ref.allpairs_counts(X, 6, 3, "cpu"), nt, y[:nt], y[nt:], 1.0)
    port = KernelSVC(C=1.0, probability=True).fit(judge.gram, y[:nt])
    A, B = port.platt_
    assert A < 0
    assert abs(judge.platt_gap((A, B))) < 1e-3
    assert judge.platt_gap((-A, B)) > 0.3 and judge.platt_gap((0.0, B)) > 0.05
    proba = port.predict_proba(judge.test_gram)[:, 1]
    assert judge.test_auc(port.alpha_y_, port.rho_) == ref.auc(y[nt:], proba)


def test_auc_counts_ties_wrong():
    assert ref.auc([0, 1, 0, 1], [0.1, 0.2, 0.2, 0.3]) == pytest.approx(0.75)
    assert ref.auc([1, 0], [0.0, 1.0]) == 0.0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pooled_fold_solves_are_the_serial_ones(dtype):
    from gkmbench.loaders.ragged_fixed import ragged_set

    X, y = ragged_set(9, 70, 20, 40, 4, [1, 2, 3, 4, 1, 2, 3, 4])
    K = ref.normalize(ref.allpairs_counts(X, 6, 3, "cpu")).numpy()
    gram = (K @ K.T).astype(dtype)
    ys = np.where(y == 1, 1.0, -1.0).astype(dtype)
    folds = ref.stratified_folds(ys, 5)
    Cs = [0.01, 1.0, 100.0]
    serial = [ref.cv_decisions(gram, ys, C, folds) for C in Cs]
    pooled = ref.cv_decisions_at(gram, ys, Cs, folds, workers=3)
    assert all(np.array_equal(a, b) for a, b in zip(serial, pooled))


def test_judges_at_other_Cs_share_the_problem():
    X, y = seqs(8, 50, 30, 40, 4), np.array([0, 1] * 25)
    nt = 40
    base = ref.SvmJudge(ref.allpairs_counts(X, 6, 3, "cpu"), nt, y[:nt], y[nt:], 1.0)
    judges = [base, base.at(0.1), base.at(10.0)]
    ref.cv_sigmoids(judges)
    for j in judges:
        alone = ref.SvmJudge(ref.allpairs_counts(X, 6, 3, "cpu"), nt, y[:nt], y[nt:], j.C)
        assert j.gram is base.gram
        dec, A, B, nll = alone.cv_sigmoid()
        assert np.array_equal(j.cv_sigmoid()[0], dec) and j.cv_sigmoid()[1:] == (A, B, nll)
