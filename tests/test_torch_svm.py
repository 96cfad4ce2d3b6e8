"""The port's SVM family against the JAX package on the CPU.

Solver_NU's plain twin (kernel C's, ``fastsk_tpu_torch/svm/smo_cuda.py``)
against ``fastsk_tpu``'s ``_smo_solve_nu`` and its Pallas kernel in
interpret mode; NuSVC, NuSVR, EpsilonSVR, OneClassSVM, KernelSVC's
class weights, warm Platt folds and one-vs-one; ``FastSK.fit`` for every
``svm_type``; numpy state and LIBSVM files across the packages; the
``fastsk-torch`` CLI against ``fastsk``.

Tolerances, as in ``tests/test_torch_smo.py``: the two frameworks' CPU
float paths agree to a few f32 ulps, not bit for bit, so a solve must
take the same number of iterations with max|dalpha| <= 1e-4 and rho / r
within 1e-6; decision values and probabilities agree within 1e-4,
predictions wherever |decision| > 1e-3; scores within 1e-6.
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fastsk_tpu as J
import fastsk_tpu_torch as T
from fastsk_tpu import cli as jcli
from fastsk_tpu.svm import kernel_svm as jk
from fastsk_tpu.svm import libsvm_io as jio
from fastsk_tpu.svm import ovo as jovo
from fastsk_tpu.svm.smo_pallas import smo_solve_nu_fused
from fastsk_tpu_torch import cli as tcli
from fastsk_tpu_torch.svm import kernel_svm as tk
from fastsk_tpu_torch.svm import libsvm_io as tio
from fastsk_tpu_torch.svm import ovo as tovo
from fastsk_tpu_torch.svm import smo_cuda
from fastsk_tpu_torch.utils.observe import counters

# The model-level tests solve to this stopping tolerance: their RBF Grams
# are full rank, so the optimum is unique, and near it the packages' few-ulp
# trajectory differences no longer decide which eps-approximate point each
# stops at (at eps=1e-3, a free SV snapped to a bound on one side moves a
# nu-SVC's r, and so every coefficient, by ~1e-3).
EPS = 1e-5

ORACLE_DIR = os.path.join(os.path.dirname(__file__), "..", "tools", "reference_oracle")
ORACLE = os.path.join(ORACLE_DIR, "svm_oracle")


# ----------------------------------------------------------- Solver_NU


def _ridge_gram(X):
    n = len(X)
    K = (X @ X.T + n * np.eye(n)).astype(np.float32)
    d = np.sqrt(np.diag(K))
    return (K / np.outer(d, d)).astype(np.float32)


def _nu_problem(rng, kind):
    """(Q, y, C, p, alpha0): tests/test_svm.py::
    test_fused_nu_smo_matches_while_loop's nu-SVC problem, or the 2n dual
    of a nu-SVR (nonzero p) of 30 rows on the same kind of Gram. The ridge
    keeps the problem well conditioned: on a rank-4 X X^T the two
    frameworks' few-ulp differences pick other pairs after some hundred
    iterations (the JAX while_loop and its Pallas kernel still agree with
    each other there, both being XLA), and only kernel C against its twin
    is held bit for bit (tests/test_torch_cuda.py)."""
    if kind == "nu_svc":
        n = 40
        K = _ridge_gram(rng.normal(size=(n, 4)).astype(np.float32))
        y = np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32)
        return K * np.outer(y, y), y, np.ones(n, np.float32), np.zeros(n, np.float32), tk.nu_svc_start(y, 0.5)
    m = 30
    X = rng.normal(size=(m, 4)).astype(np.float32)
    t = (X[:, 0] + 0.2 * rng.normal(size=m)).astype(np.float32)
    Q2, y2 = tk.svr_dual(torch.from_numpy(_ridge_gram(X)))
    p = np.concatenate([-t, t]).astype(np.float32)
    return Q2.numpy(), y2.numpy(), np.ones(2 * m, np.float32), p, tk.nu_svr_start(m, 1.0, 0.5)


@pytest.mark.parametrize("kind", ["nu_svc", "nu_svr"])
def test_nu_twin_matches_jax_solvers(rng, kind):
    Q, y, C, p, a0 = _nu_problem(rng, kind)
    jargs = [jnp.asarray(v) for v in (Q, y, C, p, a0)]
    a_j, rho_j, r_j, it_j = jk._smo_solve_nu(*jargs, 1e-3, 100000)
    a_f, g_f, it_f = smo_solve_nu_fused(*jargs, 1e-3, 100000, interpret=True)
    a_f, _, _ = jk._finalize_nu(a_f, g_f, jargs[1], jargs[2])
    targs = [torch.from_numpy(np.ascontiguousarray(v)) for v in (Q, y, C, p, a0)]
    a_t, rho_t, r_t, it_t = tk._smo_solve_nu(*targs, 1e-3, 100000)
    assert it_t == int(it_j) == int(it_f)
    a_t = a_t.numpy()
    assert np.abs(a_t - np.asarray(a_j)).max() <= 1e-4
    assert np.abs(a_t - np.asarray(a_f)).max() <= 1e-4
    assert abs(float(rho_t) - float(rho_j)) <= 1e-6
    assert abs(float(r_t) - float(r_j)) <= 1e-6
    for cls in (1.0, -1.0):  # each class's sum is conserved
        assert abs(a_t[y == cls].sum() - a0[y == cls].sum()) <= 1e-4 * len(y)


def test_nu_wrapper_takes_twin_on_cpu_and_checks_inputs(rng):
    Q, y, C, p, a0 = (torch.from_numpy(np.ascontiguousarray(v)) for v in _nu_problem(rng, "nu_svc"))
    before = counters()["smo_nu_solve.launches"]
    a, g, it = smo_cuda.smo_nu_solve(Q, y, C, p, a0, 1e-3, 100000)
    assert counters()["smo_nu_solve.launches"] == before
    grad0, qd = smo_cuda.initial_state(Q, p, a0)
    a2, g2, it2 = smo_cuda.smo_nu_loop_plain(Q, y, C, qd, a0, grad0, 1e-3, 100000)
    assert it == it2
    np.testing.assert_array_equal(a.numpy(), a2.numpy())
    np.testing.assert_array_equal(g.numpy(), g2.numpy())
    assert smo_cuda.smo_nu_solve(Q, y, C, p, a0, 1e-3, 3)[2] == 3
    with pytest.raises(ValueError, match="f32"):
        smo_cuda.smo_nu_solve(Q.double(), y, C, p, a0, 1e-3, 10)
    with pytest.raises(ValueError, match="shape"):
        smo_cuda.smo_nu_solve(Q, y[:-1], C, p, a0, 1e-3, 10)
    with pytest.raises(ValueError, match="contiguous"):
        smo_cuda.smo_nu_solve(Q.T, y, C, p, a0, 1e-3, 10)


def test_nu_wrapper_checks_cluster(rng):
    """``cluster`` (CTAs of kernel C's cluster) must be 1 to 16, checked on
    every device; on the CPU it does not change the twin's result."""
    Q, y, C, p, a0 = (torch.from_numpy(np.ascontiguousarray(v)) for v in _nu_problem(rng, "nu_svc"))
    for bad in (0, 17, -1):
        with pytest.raises(ValueError, match="cluster"):
            smo_cuda.smo_nu_solve(Q, y, C, p, a0, 1e-3, 10, cluster=bad)
    a1, g1, it1 = smo_cuda.smo_nu_solve(Q, y, C, p, a0, 1e-3, 500, cluster=8)
    a2, g2, it2 = smo_cuda.smo_nu_solve(Q, y, C, p, a0, 1e-3, 500)
    assert it1 == it2
    np.testing.assert_array_equal(a1.numpy(), a2.numpy())
    np.testing.assert_array_equal(g1.numpy(), g2.numpy())
    with pytest.raises(ValueError, match="solver"):
        smo_cuda.smo_smem_path(700, 16, solver="D")


def test_nu_empty_candidate_set_takes_index_0():
    """With the negative class held at a zero sum, upN is empty in every
    iteration: the twin's argmax gives row 0, as jnp.argmax does, and the
    two solvers still agree."""
    rng = np.random.default_rng(8)
    n = 30
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = np.where(np.arange(n) % 3 == 0, 1.0, -1.0).astype(np.float32)
    Q = (X @ X.T) * np.outer(y, y)
    a0 = np.where(y > 0, 0.5, 0.0).astype(np.float32)
    C, p = np.ones(n, np.float32), np.zeros(n, np.float32)
    a_j, _, _, it_j = jk._smo_solve_nu(*(jnp.asarray(v) for v in (Q, y, C, p, a0)), 1e-3, 100000)
    a_t, _, _, it_t = tk._smo_solve_nu(*(torch.from_numpy(v) for v in (Q, y, C, p, a0)), 1e-3, 100000)
    assert it_t == int(it_j) > 0
    assert np.abs(a_t.numpy() - np.asarray(a_j)).max() <= 1e-4
    assert np.all(a_t.numpy()[y < 0] == 0)


def test_restrict_feasible_is_a_copy(rng):
    a = rng.random(30)
    ys = np.where(rng.random(30) > 0.4, 1.0, -1.0).astype(np.float32)
    c = np.where(np.arange(30) % 5 == 0, 0.0, 1.0).astype(np.float32)
    np.testing.assert_array_equal(
        tk._restrict_feasible(a, ys, c), jk._restrict_feasible(a, ys, c)
    )


# ----------------------------------------------------------- models


def _rbf(A, B, gamma=0.1):
    """An RBF Gram: full rank, so the solvers' trajectories do not hinge on
    few-ulp ties as on a low-rank X X^T."""
    d2 = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * A @ B.T
    return np.exp(-gamma * np.maximum(d2, 0.0))


def _blobs(rng, n=60, d=5, sep=0.6):
    X = np.concatenate(
        [rng.normal(sep, 1.0, (n // 2, d)), rng.normal(-sep, 1.0, (n - n // 2, d))]
    )
    y = np.array([1] * (n // 2) + [0] * (n - n // 2))
    perm = rng.permutation(n)
    return X[perm], y[perm]


def _multiclass(rng, nc, n_per=14, d=5, sep=2.5):
    """``nc`` classes of ``n_per`` rows each, or of the sizes in ``nc``
    where it is a tuple."""
    sizes = nc if isinstance(nc, tuple) else (n_per,) * nc
    X = np.concatenate([rng.normal(size=(m, d)) + rng.normal(size=d) * sep for m in sizes])
    return X, np.repeat(np.arange(len(sizes)), sizes)


def _assert_same_decisions(pm, jm, gram):
    dp = np.asarray(pm.decision_function(gram) if hasattr(pm, "decision_function") else pm.predict(gram))
    dj = np.asarray(jm.decision_function(gram) if hasattr(jm, "decision_function") else jm.predict(gram))
    np.testing.assert_allclose(dp, dj, atol=1e-4)
    return dp


def _assert_same_classifier(pm, jm, gram):
    d = _assert_same_decisions(pm, jm, gram)
    sure = np.abs(d).min(axis=1) > 1e-3 if d.ndim == 2 else np.abs(d) > 1e-3
    np.testing.assert_array_equal(pm.predict(gram)[sure], jm.predict(gram)[sure])
    if pm.probability:
        np.testing.assert_allclose(pm.predict_proba(gram), jm.predict_proba(gram), atol=1e-4)


@pytest.mark.parametrize(
    "name,make",
    [
        ("nu_svc", lambda m: m.NuSVC(nu=0.4, eps=EPS)),
        ("nu_svc_proba", lambda m: m.NuSVC(nu=0.4, probability=True, eps=EPS)),
        ("balanced", lambda m: m.KernelSVC(C=0.5, class_weight="balanced", eps=EPS)),
        ("platt_warm", lambda m: m.KernelSVC(
            C=1.0, probability=True, platt_warm_start=True, eps=EPS)),
    ],
)
def test_binary_classifier_matches_jax(rng, name, make):
    X, y = _blobs(rng)
    if name == "balanced":
        y[: 14] = 1  # unbalance the classes
    K = _rbf(X, X)
    pm = make(tk).fit(K, y)
    # the JAX package's device branch folds as the port does (C=0 rows on
    # the full Gram) — a JAX array Gram takes it
    jm = make(jk).fit(jnp.asarray(K, jnp.float32) if name == "platt_warm" else K, y)
    Xt = rng.normal(size=(20, X.shape[1]))
    _assert_same_classifier(pm, jm, _rbf(Xt, X))


# the unequal case gives C-SVC balanced class weights, which each Platt
# fold takes from its own training rows (as the reference refits a fold)
@pytest.mark.parametrize("nc", [3, 4, pytest.param((9, 23, 31), id="9-23-31-balanced")])
@pytest.mark.parametrize("solver", ["KernelSVC", "NuSVC"])
def test_one_vs_one_matches_jax(rng, nc, solver):
    X, y = _multiclass(rng, nc)
    K = _rbf(X, X)
    kw = dict(C=1.0, eps=EPS) if solver == "KernelSVC" else dict(nu=0.3, eps=EPS)
    if solver == "KernelSVC" and isinstance(nc, tuple):
        kw.update(C=0.3, class_weight="balanced")  # bounded SVs: the box shows
    pm = getattr(tk, solver)(probability=True, **kw).fit(K, y)
    jm = getattr(jk, solver)(probability=True, **kw).fit(K, y)
    np.testing.assert_allclose(pm._ovo.platt_, jm._ovo.platt_, atol=1e-3)
    Xt, _ = _multiclass(rng, nc)
    gt = _rbf(Xt, X)
    _assert_same_classifier(pm, jm, gt)
    # a tensor Gram gives the same decisions (gathered where it lies)
    Kt = torch.from_numpy(gt.astype(np.float32))
    np.testing.assert_allclose(pm.decision_function(Kt), jm.decision_function(gt), atol=1e-4)


@pytest.mark.parametrize("solver", ["EpsilonSVR", "NuSVR", "OneClassSVM"])
def test_regressors_and_one_class_match_jax(rng, solver):
    X = rng.normal(size=(40, 4))
    t = X[:, 0] * 2.0 + 0.1 * rng.normal(size=40)
    K = _rbf(X, X)
    if solver == "OneClassSVM":
        pm, jm = tk.OneClassSVM(nu=0.3, eps=EPS).fit(K), jk.OneClassSVM(nu=0.3, eps=EPS).fit(K)
    else:
        kw = dict(C=1.0, eps=EPS) if solver == "EpsilonSVR" else dict(C=1.0, nu=0.5, eps=EPS)
        pm = getattr(tk, solver)(**kw).fit(K, t)
        jm = getattr(jk, solver)(**kw).fit(K, t)
    assert abs(pm.rho_ - jm.rho_) <= 1e-5
    np.testing.assert_allclose(pm.coef_, jm.coef_, atol=1e-4)
    Xt = rng.normal(size=(15, 4))
    gt = _rbf(Xt, X)
    d = _assert_same_decisions(pm, jm, gt)
    if solver == "OneClassSVM":
        sure = np.abs(d) > 1e-3
        np.testing.assert_array_equal(pm.predict(gt)[sure], jm.predict(gt)[sure])
        assert abs(pm.coef_.sum() - 0.3 * 40) <= 1e-3 * 0.3 * 40
    else:
        assert abs(pm.score(gt, 2.0 * Xt[:, 0]) - jm.score(gt, 2.0 * Xt[:, 0])) <= 1e-6


def test_svr_dual_assembled_on_the_gram_device(rng):
    """The 2n dual is the JAX package's host assembly, value for value."""
    K = rng.normal(size=(7, 7)).astype(np.float32)
    Q2, y2 = tk.svr_dual(torch.from_numpy(K))
    y2_np = np.concatenate([np.ones(7), -np.ones(7)]).astype(np.float32)
    np.testing.assert_array_equal(Q2.numpy(), np.block([[K, K], [K, K]]) * np.outer(y2_np, y2_np))
    np.testing.assert_array_equal(y2.numpy(), y2_np)


def test_group_labels_and_coupling_are_copies(rng):
    for y in ([3, 1, 3, 2], [-1, 1, -1], [1, -1, 1], [0, 1, 0], list(rng.integers(0, 5, 30))):
        assert tovo.group_labels(y) == jovo.group_labels(y)
    for k in (2, 3, 5):
        r = rng.random((k, k))
        r = r / (r + r.T)
        np.testing.assert_array_equal(tovo.multiclass_probability(r), jovo.multiclass_probability(r))


# ----------------------------------------------------------- state, files


def _fitted_pairs(rng):
    """(name, port model, JAX model, test Gram) for every model type."""
    X, y = _blobs(rng, n=40)
    Xm, ym = _multiclass(rng, 3, n_per=10)
    t = X[:, 0] + 0.1 * rng.normal(size=40)
    K, Km = _rbf(X, X), _rbf(Xm, Xm)
    gt, gmt = _rbf(rng.normal(size=(9, 5)), X), _rbf(rng.normal(size=(9, 5)), Xm)
    return [
        ("c_svc", tk.KernelSVC(probability=True).fit(K, y), jk.KernelSVC(probability=True).fit(K, y), gt),
        ("nu_svc", tk.NuSVC(probability=True).fit(K, y), jk.NuSVC(probability=True).fit(K, y), gt),
        ("one_class", tk.OneClassSVM(nu=0.3).fit(K), jk.OneClassSVM(nu=0.3).fit(K), gt),
        ("epsilon_svr", tk.EpsilonSVR().fit(K, t), jk.EpsilonSVR().fit(K, t), gt),
        ("nu_svr", tk.NuSVR().fit(K, t), jk.NuSVR().fit(K, t), gt),
        ("c_svc", tk.KernelSVC(probability=True).fit(Km, ym), jk.KernelSVC(probability=True).fit(Km, ym), gmt),
        ("nu_svc", tk.NuSVC(nu=0.3).fit(Km, ym), jk.NuSVC(nu=0.3).fit(Km, ym), gmt),
    ]


def _outputs(model, gram):
    out = [model.predict(gram)]
    if hasattr(model, "decision_function"):
        out.append(model.decision_function(gram))
    if getattr(model, "probability", False):
        out.append(model.predict_proba(gram))
    return out


def test_state_round_trip_and_jax_models_in_port(rng):
    """Every model type: the port's state rebuilds a model with equal
    outputs, and a JAX-fitted model carried over as numpy state gives the
    JAX model's outputs in the port (the same f64 host arithmetic)."""
    for name, pm, jm, gt in _fitted_pairs(rng):
        state = pm.to_numpy_state()
        back = type(pm).from_numpy_state(state)
        for a, b in zip(_outputs(back, gt), _outputs(pm, gt)):
            np.testing.assert_array_equal(a, b)
        carried = type(pm).from_numpy_state(tk.numpy_state(jm))
        for a, b in zip(_outputs(carried, gt), _outputs(jm, gt)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        assert carried.to_numpy_state().keys() == tk.numpy_state(jm).keys(), name


def test_libsvm_files_cross_the_packages(rng, tmp_path):
    """A model file written by either package loads in the other and
    gives the writer's decisions."""
    for k, (name, pm, jm, gt) in enumerate(_fitted_pairs(rng)):
        for model, save, load in ((pm, tk.save_svm_model, jio.load_libsvm_model),
                                  (jm, jk.save_svm_model, tio.load_libsvm_model)):
            path = str(tmp_path / f"{k}_{type(model).__module__.split('.')[0]}.model")
            save(path, model, fmt="libsvm", svm_type=name)
            loaded = load(path)
            if name in ("epsilon_svr", "nu_svr"):
                np.testing.assert_allclose(loaded.predict(gt), model.predict(gt), rtol=1e-12)
                continue
            np.testing.assert_array_equal(loaded.predict(gt), model.predict(gt))
            if name != "one_class":
                dec = loaded.decision_function(gt)
                want = model.decision_function(gt)
                np.testing.assert_allclose(dec if want.ndim == 2 else dec[:, 0], want, rtol=1e-10, atol=1e-10)


def test_npz_model_round_trip(rng, tmp_path):
    X, y = _blobs(rng, n=40)
    K = _rbf(X, X)
    pm = tk.KernelSVC(probability=True).fit(K, y)
    tk.save_svm_model(str(tmp_path / "m"), pm)
    for load in (tk.load_svm_model, jk.load_svm_model):
        back = load(str(tmp_path / "m"))
        np.testing.assert_array_equal(back.predict_proba(K), pm.predict_proba(K))


@pytest.fixture(scope="module")
def oracle():
    if not os.path.exists(ORACLE):
        subprocess.run(["sh", os.path.join(ORACLE_DIR, "build.sh")], check=True)
    return ORACLE


def _run_oracle(oracle, model_path, gram_test, tmp_path):
    rows = str(tmp_path / "rows.csv")
    np.savetxt(rows, np.asarray(gram_test, dtype=np.float64), delimiter=",", fmt="%.17g")
    res = subprocess.run([oracle, str(model_path), rows], check=True, capture_output=True, text=True)
    return np.array([[float(v) for v in ln.split()] for ln in res.stdout.splitlines()])


def test_reference_libsvm_predicts_port_models(oracle, rng, tmp_path):
    """The reference's unmodified LIBSVM (tools/reference_oracle) loads
    the port's model files and predicts what the port predicts, as
    tests/test_libsvm_interop.py holds the JAX package's."""
    for k, (name, pm, _, gt) in enumerate(_fitted_pairs(rng)):
        path = tmp_path / f"{k}.model"
        tk.save_svm_model(str(path), pm, fmt="libsvm", svm_type=name)
        out = _run_oracle(oracle, path, gt, tmp_path)
        if name in ("epsilon_svr", "nu_svr"):
            np.testing.assert_allclose(out[:, 0], pm.predict(gt), rtol=1e-12, atol=1e-12)
            continue
        np.testing.assert_array_equal(out[:, 0].astype(int), pm.predict(gt))
        if name == "one_class":
            continue
        dec = pm.decision_function(gt)
        ncol = 1 if dec.ndim == 1 else dec.shape[1]
        np.testing.assert_allclose(out[:, 1 : 1 + ncol], dec.reshape(len(gt), ncol), rtol=1e-10, atol=1e-10)
        if pm.probability and dec.ndim == 1:
            np.testing.assert_allclose(out[:, 2], pm.predict_proba(gt)[:, 1], rtol=1e-9, atol=1e-9)


# ----------------------------------------------------------- FastSK, CLI


# regression targets spread over the test split too (the last 6 rows)
SVR_LABELS = list(np.random.default_rng(3).permutation(np.linspace(-1.0, 1.0, 24)))


def _tiny(rng, labels):
    """tests/test_multiclass_svm.py::_tiny_fastsk's inputs: random DNA of
    length 30, the last 6 sequences as the test split."""
    X = [rng.integers(1, 5, size=30).tolist() for _ in range(len(labels))]
    n = len(labels) - 6
    return X[:n], X[n:], labels[:n], labels[n:]


@pytest.mark.parametrize(
    "svm_type,labels",
    [
        ("c_svc", [1, -1] * 12),
        ("nu_svc", [1, -1] * 12),
        ("one_class", [1, -1] * 12),
        ("epsilon_svr", SVR_LABELS),
        ("nu_svr", SVR_LABELS),
        ("c_svc", [0, 1, 2] * 8),
        ("nu_svc", [0, 1, 2, 3] * 8),
    ],
)
@pytest.mark.parametrize("kernel_type", ["fastsk", "linear"])
def test_fastsk_fit_matches_jax(rng, tmp_path, svm_type, labels, kernel_type):
    data = _tiny(rng, labels)
    j = J.FastSK(4, 1)
    t = T.FastSK(4, 1, config=T.KernelConfig(device="cpu"))
    for f in (j, t):
        f.compute_kernel(*data)
        f.fit(svm_type=svm_type, nu=0.3, eps=EPS, kernel_type=kernel_type)
    regression = svm_type in ("epsilon_svr", "nu_svr")
    binary = len(set(labels)) == 2 and svm_type != "one_class"
    metrics = ["r2"] if regression else ["accuracy"] + (["auc"] if binary else [])
    for metric in metrics:
        assert abs(t.score(metric) - j.score(metric)) <= 1e-6, metric
    if not regression and not binary:
        for f in (j, t):
            with pytest.raises(ValueError, match="binary"):
                f.score("auc")
    with pytest.raises(ValueError):
        t.score("accuracy" if regression else "r2")
    rt, rj = t.score_report(), j.score_report()
    assert rt.keys() == rj.keys()
    for key in rt:
        assert abs(rt[key] - rj[key]) <= 1e-6, key
    t.save_predictions(str(tmp_path / "t.txt"))
    j.save_predictions(str(tmp_path / "j.txt"))
    pt, pj = np.loadtxt(tmp_path / "t.txt"), np.loadtxt(tmp_path / "j.txt")
    np.testing.assert_array_equal(pt[:, 0], pj[:, 0])
    np.testing.assert_allclose(pt[:, 1], pj[:, 1], atol=1e-4 if regression or binary else 0)


def test_one_class_needs_no_labels(rng):
    X = [rng.integers(1, 5, size=30).tolist() for _ in range(20)]
    t = T.FastSK(4, 1, config=T.KernelConfig(device="cpu"))
    t.compute_train(X)
    t.fit(svm_type="one_class", nu=0.3)
    with pytest.raises(RuntimeError, match="labels"):
        t.fit(svm_type="nu_svc")


def test_iterations_and_stdevs_match_jax(rng):
    """Exact mode: 0 iterations and an empty sd trace, in both packages."""
    data = _tiny(rng, [1, -1] * 8)
    j = J.FastSK(4, 1)
    t = T.FastSK(4, 1, config=T.KernelConfig(device="cpu", device_resident=True))
    for f in (j, t):
        f.compute_kernel(*data)
    assert t.iterations == j.iterations == 0
    assert t.get_stdevs() == j.get_stdevs() == []


def _labelled_fasta(path, rng, n, pos_motif="ACGTAC"):
    with open(path, "w") as f:
        for i in range(n):
            seq = "".join(rng.choice(list("ACGT"), size=40))
            label = i % 2
            if label:
                at = int(rng.integers(0, 34))
                seq = seq[:at] + pos_motif + seq[at + 6:]
            f.write(f">{label}\n{seq}\n")
    return str(path)


@pytest.mark.parametrize(
    "extra",
    [[], ["-s", "nu_svc"], ["-s", "one_class"], ["-s", "epsilon_svr", "-r", "fastsk"]],
)
def test_cli_matches_jax_cli(rng, tmp_path, capsys, extra):
    tr = _labelled_fasta(tmp_path / "tr.fasta", rng, 40)
    te = _labelled_fasta(tmp_path / "te.fasta", rng, 16)
    args = ["-g", "5", "-m", "2", "--json", "-q", *extra, tr, te]
    assert jcli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["--device", "cpu", *args]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys()
    for key in got:
        if not key.endswith("_time_s"):
            assert abs(got[key] - want[key]) <= 1e-6, key


def test_cli_model_file_and_predict_cli(rng, tmp_path, capsys):
    """fastsk-torch writes a LIBSVM model and the kernel; the port's
    predict tool reproduces the CLI's accuracy from them."""
    from fastsk_tpu_torch import predict_cli

    tr = _labelled_fasta(tmp_path / "tr.fasta", rng, 40)
    te = _labelled_fasta(tmp_path / "te.fasta", rng, 16)
    model, kernel = str(tmp_path / "m.model"), str(tmp_path / "k.npz")
    assert tcli.main([
        "-g", "5", "-m", "2", "--json", "-q", "--device", "cpu", "-s", "nu_svc",
        "-r", "fastsk", "--save-model", model, "--model-format", "libsvm",
        "--save-kernel", kernel, tr, te,
    ]) == 0
    acc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["accuracy"]
    assert predict_cli.main([model, kernel, str(tmp_path / "p.txt"), "--test-file", te]) == 0
    line = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("Accuracy")][0]
    assert abs(float(line.split()[2].rstrip("%")) - acc) <= 1e-4


def test_cli_unported_flags_raise(tmp_path, rng, capsys):
    """The flags this test once refused run: ``-a`` (slice 3) gives the JAX
    CLI's JSON, and so does ``--checkpoint`` (slice 5) with it, each CLI
    writing its own checkpoint."""
    tr = _labelled_fasta(tmp_path / "tr.fasta", rng, 10)
    te = _labelled_fasta(tmp_path / "te.fasta", rng, 8)
    args = ["-g", "5", "-m", "2", "-a", "--json", "-q", tr, te]
    assert jcli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["--device", "cpu", *args]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(got["auc"] - want["auc"]) <= 1e-6
    for cli, dev in ((jcli, []), (tcli, ["--device", "cpu"])):
        ck = str(tmp_path / f"{cli.__name__}.npz")
        assert cli.main([*dev, "--checkpoint", ck, "--checkpoint-every", "1", *args]) == 0
        assert os.path.exists(ck)
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert abs(got["auc"] - want["auc"]) <= 1e-6
    assert "the CPU runs only with --device cpu" in " ".join(tcli.build_parser().format_help().split())


@pytest.mark.parametrize(
    "flag,slice_",
    [
        (["-I", "5"], "slice 3"),
        (["--delta", "0.1"], "slice 3"),
        (["--skip-variance"], "slice 3"),
        (["--seed", "1"], "slice 3"),
        (["--checkpoint-every", "64"], "slice 5"),
    ],
)
def test_cli_unported_options_raise_when_set(tmp_path, rng, capsys, flag, slice_):
    """The options this test once refused reach FastSK: the approx options
    (slice 3) with ``-a``, and ``--checkpoint-every`` (slice 5) with
    ``-a`` and ``--checkpoint``; each gives the JAX CLI's kernel."""
    tr = _labelled_fasta(tmp_path / "tr.fasta", rng, 10)
    extra = ["-I", "4"] if flag == ["--skip-variance"] else []
    args = ["-g", "5", "-m", "2", "-a", "-q", "--no-svm", *extra, *flag]
    kernels = []
    for cli, dev in ((jcli, []), (tcli, ["--device", "cpu"])):
        out = str(tmp_path / f"{cli.__name__}.npy")
        ck = ["--checkpoint", str(tmp_path / f"{cli.__name__}.npz")] if slice_ == "slice 5" else []
        assert cli.main([*dev, *args, *ck, "--save-kernel", out, tr]) == 0
        kernels.append(np.load(out))
    np.testing.assert_array_equal(kernels[1], kernels[0])


def test_cli_without_a_card_needs_device_cpu(tmp_path, rng, capsys, monkeypatch):
    """The CLI runs on the card by default: with no card and no --device
    cpu it exits with an error naming the flag instead of running on the
    CPU; with --device cpu it runs the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = _labelled_fasta(tmp_path / "tr.fasta", rng, 20)
    te = _labelled_fasta(tmp_path / "te.fasta", rng, 8)
    args = ["-g", "5", "-m", "2", "--json", "-q", tr, te]
    with pytest.raises(SystemExit) as exc:
        tcli.main(args)
    assert exc.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    assert tcli.build_parser().get_default("device") == "cuda"
    assert tcli.main(["--device", "cpu", *args]) == 0
    assert "auc" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_fold_boxes_follow_each_folds_training_rows(rng, monkeypatch):
    """cv_platt boxes fold r with ``_box`` of its own training rows (the
    balanced weights of the fold's class counts) and 0 on its held-out
    rows, all in one [folds, n] launch; the binary Platt fit keeps the
    full-label box on every fold."""
    from fastsk_tpu_torch.svm.linear import stratified_kfold_indices

    boxes = []
    real = tk.smo_solve

    def spy(Q, y, C_vec, *args, **kwargs):
        boxes.append(C_vec.numpy().copy())
        return real(Q, y, C_vec, *args, **kwargs)

    monkeypatch.setattr(tk, "smo_solve", spy)
    X, y01 = _blobs(rng, n=32)
    y01[:10] = 1  # unequal classes
    ys = np.where(y01 == 1, 1.0, -1.0)
    K = _rbf(X, X)
    m = tk.KernelSVC(C=0.5, class_weight="balanced")
    m.cv_platt(K, ys, 5)
    folds = stratified_kfold_indices(ys, 5)
    assert len(boxes) == 1 and boxes[0].shape == (5, len(ys))
    for r, f in enumerate(folds):
        tr = np.setdiff1d(np.arange(len(ys)), f)
        pos, neg = (ys[tr] > 0).sum(), (ys[tr] < 0).sum()
        want = np.zeros(len(ys), np.float32)
        want[tr] = np.where(ys[tr] > 0, len(tr) / (2.0 * pos), len(tr) / (2.0 * neg)) * 0.5
        np.testing.assert_array_equal(boxes[0][r], want)
    # the binary fit: the full-label weights on every fold's training rows
    boxes.clear()
    tk.KernelSVC(C=0.5, class_weight="balanced", probability=True).fit(K, y01)
    full = m._box(y01, np.array([0, 1]))
    for r, f in enumerate(stratified_kfold_indices(y01, 5)):
        want = full.copy()
        want[f] = 0.0
        np.testing.assert_array_equal(boxes[1][r], want)


def test_one_vs_one_c_svc_batches_each_pairs_folds(rng, monkeypatch):
    """One-vs-one C-SVC with probabilities calls the kernel B wrapper twice
    a pair (the pair's solve, then its five Platt folds as one batch);
    nu-SVC keeps its sub-Gram folds."""
    calls = []
    real = tk.smo_solve

    def spy(Q, y, C_vec, *args, **kwargs):
        calls.append(tuple(C_vec.shape))
        return real(Q, y, C_vec, *args, **kwargs)

    monkeypatch.setattr(tk, "smo_solve", spy)
    X, y = _multiclass(rng, 3)
    K = _rbf(X, X)
    tk.KernelSVC(C=1.0, probability=True, eps=EPS).fit(K, y)
    m = 2 * 14  # rows of a pair
    assert calls == [(m,), (5, m)] * 3
    assert sum(c[0] if len(c) == 2 else 1 for c in calls) == 18
