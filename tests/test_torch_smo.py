"""The port's C-SVC solver against the JAX package on the CPU.

The plain twin of kernel B (``fastsk_tpu_torch/svm/smo_cuda.py``) runs the
same selection and update, op for op, as ``fastsk_tpu``'s
``_smo_solve_general``. Across the two frameworks' CPU float paths the
trajectories agree to the last few ulps, not bit for bit (XLA may fuse
and contract where PyTorch rounds every op), so the tolerance asserted is:
equal iteration counts, ``max|dalpha| <= 1e-4 * C``, rho within 1e-6 and
equal decision signs. Bit-identical trajectories are only required
between kernel B and its twin (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastsk_tpu.svm.kernel_svm import KernelSVC as JKernelSVC
from fastsk_tpu.svm.kernel_svm import _smo_solve_general as j_smo_general
from fastsk_tpu.svm.smo_pallas import smo_solve_fused
from fastsk_tpu_torch.svm import smo_cuda
from fastsk_tpu_torch.svm.kernel_svm import KernelSVC, _smo_solve_general


def _problem(rng, n=40):
    """tests/test_svm.py::test_fused_smo_matches_while_loop's problem."""
    X = rng.normal(size=(n, 4)).astype(np.float32)
    K = (X @ X.T + n * np.eye(n)).astype(np.float32)
    d = np.sqrt(np.diag(K))
    K = (K / np.outer(d, d)).astype(np.float32)
    y = np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32)
    return K, y


def _solve_both(K, y, C):
    n = len(y)
    Q = (K * np.outer(y, y)).astype(np.float32)
    a_j, rho_j, it_j = j_smo_general(
        jnp.asarray(Q), jnp.asarray(y), jnp.asarray(C),
        -jnp.ones(n, jnp.float32), jnp.zeros(n, jnp.float32), 1e-3, 100000,
    )
    a_f, _, it_f = smo_solve_fused(
        jnp.asarray(Q), jnp.asarray(y), jnp.asarray(C),
        -jnp.ones(n, jnp.float32), jnp.zeros(n, jnp.float32), 1e-3, 100000,
        interpret=True,
    )
    a_t, rho_t, it_t = _smo_solve_general(
        torch.from_numpy(Q), torch.from_numpy(y), torch.from_numpy(C),
        -torch.ones(n), torch.zeros(n), 1e-3, 100000,
    )
    return (
        (np.asarray(a_j), float(rho_j), int(it_j)),
        (np.asarray(a_f), int(it_f)),
        (a_t.numpy(), float(rho_t), it_t),
    )


def _kkt_violation(K, y, C, alpha):
    """gmax + gmax2 of the solution (f64): the eps-KKT stop quantity."""
    grad = (K * np.outer(y, y)).astype(np.float64) @ alpha - 1.0
    up = np.where(y > 0, alpha < C, alpha > 0)
    low = np.where(y > 0, alpha > 0, alpha < C)
    return np.max(-y[up] * grad[up]) + np.max(y[low] * grad[low])


@pytest.mark.parametrize("masked", [False, True])
def test_twin_matches_jax_solvers(rng, masked):
    K, y = _problem(rng)
    n = len(y)
    C = np.ones(n, np.float32)
    if masked:
        C[::5] = 0.0  # Platt-fold style inert rows
    (a_j, rho_j, it_j), (a_f, it_f), (a_t, rho_t, it_t) = _solve_both(K, y, C)
    assert it_t == it_j == it_f
    assert np.abs(a_t - a_j).max() <= 1e-4
    assert np.abs(a_t - a_f).max() <= 1e-4
    assert abs(rho_t - rho_j) <= 1e-6
    assert np.all(a_t[C == 0] == 0)
    np.testing.assert_array_equal(
        np.sign(K @ (a_t * y) - rho_t), np.sign(K @ (a_j * y) - rho_j)
    )
    assert _kkt_violation(K, y, C, a_t.astype(np.float64)) < 1e-3 + 1e-5


def test_masked_rows_solve_the_fold_subproblem(rng):
    """C=0 rows on the full Gram give the same solution as the submatrix
    (the Platt fold form of the port's _fit_platt)."""
    K, y = _problem(rng)
    n = len(y)
    keep = np.arange(n) % 4 != 0
    C = np.where(keep, 1.0, 0.0).astype(np.float32)
    full = _solve_both(K, y, C)[2]
    sub = _solve_both(K[np.ix_(keep, keep)], y[keep], np.ones(keep.sum(), np.float32))[2]
    assert full[2] == sub[2]
    np.testing.assert_array_equal(full[0][keep], sub[0])
    assert abs(full[1] - sub[1]) <= 1e-6


def test_wrapper_takes_twin_on_cpu_and_checks_inputs(rng):
    K, y = _problem(rng, n=24)
    n = len(y)
    Q = torch.from_numpy(K * np.outer(y, y))
    args = (torch.from_numpy(y), torch.ones(n), -torch.ones(n), torch.zeros(n))
    before = smo_cuda.smo_solve.launches
    a, g, it = smo_cuda.smo_solve(Q, *args, 1e-3, 100000)
    assert smo_cuda.smo_solve.launches == before
    qd = torch.diagonal(Q).contiguous()
    a2, g2, it2 = smo_cuda.smo_loop_plain(
        Q, args[0], args[1], qd, args[3], -torch.ones(n), 1e-3, 100000
    )
    assert it == it2
    np.testing.assert_array_equal(a.numpy(), a2.numpy())
    np.testing.assert_array_equal(g.numpy(), g2.numpy())
    with pytest.raises(ValueError, match="f32"):
        smo_cuda.smo_solve(Q.double(), *args, 1e-3, 10)
    with pytest.raises(ValueError, match="shape"):
        smo_cuda.smo_solve(Q, args[0][:-1], *args[1:], 1e-3, 10)
    with pytest.raises(ValueError, match="square"):
        smo_cuda.smo_solve(Q[:, :-1], *args, 1e-3, 10)
    with pytest.raises(ValueError, match="contiguous"):
        smo_cuda.smo_solve(Q.T, *args, 1e-3, 10)


def test_max_iter_caps_the_loop(rng):
    K, y = _problem(rng)
    n = len(y)
    Q = torch.from_numpy(K * np.outer(y, y))
    _, _, it = smo_cuda.smo_solve(
        Q, torch.from_numpy(y), torch.ones(n), -torch.ones(n), torch.zeros(n),
        1e-3, 5,
    )
    assert it == 5


def _blobs(rng, n=60):
    X = np.concatenate(
        [rng.normal(0.6, 1.0, (n // 2, 5)), rng.normal(-0.6, 1.0, (n - n // 2, 5))]
    )
    y = np.array([1] * (n // 2) + [0] * (n - n // 2))
    perm = rng.permutation(n)
    return (X @ X.T)[np.ix_(perm, perm)], y[perm]


def test_numpy_state_round_trip(rng):
    K, y = _blobs(rng)
    model = KernelSVC(C=1.0, probability=True).fit(K, y)
    state = model.to_numpy_state()
    assert all(isinstance(v, (np.ndarray, float, tuple)) for v in state.values())
    back = KernelSVC.from_numpy_state(state)
    np.testing.assert_array_equal(back.decision_function(K), model.decision_function(K))
    np.testing.assert_array_equal(back.predict_proba(K), model.predict_proba(K))
    np.testing.assert_array_equal(back.predict(K), model.predict(K))


def test_jax_fitted_model_scores_in_port(rng):
    """A fastsk_tpu KernelSVC fitted on the CPU, carried over as numpy
    state, scores the same Gram in the port: decision values within 1e-5."""
    K, y = _blobs(rng)
    jm = JKernelSVC(C=1.0, probability=True).fit(K, y)
    state = {
        "classes_": np.asarray(jm.classes_),
        "alpha_y_": np.asarray(jm.alpha_y_),
        "rho_": float(jm.rho_),
        "platt_": tuple(jm.platt_),
        "support_": np.asarray(jm.support_),
    }
    pm = KernelSVC.from_numpy_state(state)
    np.testing.assert_allclose(pm.decision_function(K), jm.decision_function(K), atol=1e-5)
    np.testing.assert_allclose(pm.predict_proba(K), jm.predict_proba(K), atol=1e-5)
    Kt = torch.from_numpy(K.astype(np.float32))
    np.testing.assert_allclose(pm.decision_function(Kt), jm.decision_function(K), atol=1e-4)


def test_port_fit_matches_jax_fit(rng):
    """Whole binary fit with Platt folds: the port (full-Gram C=0 folds)
    against the JAX package's host path (submatrix folds)."""
    K, y = _blobs(rng)
    jm = JKernelSVC(C=1.0, probability=True).fit(K, y)
    pm = KernelSVC(C=1.0, probability=True).fit(K, y)
    assert pm.iters_ == jm.iters_
    np.testing.assert_allclose(pm.alpha_y_, jm.alpha_y_, atol=1e-4)
    np.testing.assert_allclose(pm.decision_function(K), jm.decision_function(K), atol=1e-4)
    np.testing.assert_allclose(pm.platt_, jm.platt_, atol=1e-3)


def test_multiclass_refused(rng):
    """Multiclass labels, which the port once refused, now train
    one-vs-one as the JAX package does: the same per-pair decision values
    (within 1e-4) and the same votes."""
    centers = rng.normal(size=(3, 5)) * 2.5
    X = np.concatenate([rng.normal(size=(12, 5)) + c for c in centers])
    y = np.repeat([0, 1, 2], 12)
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    K = np.exp(-0.1 * d2)  # full rank: a unique optimum (see test_torch_svm.py)
    jm = JKernelSVC(C=1.0, eps=1e-5).fit(K, y)
    pm = KernelSVC(C=1.0, eps=1e-5).fit(K, y)
    np.testing.assert_allclose(pm.decision_function(K), jm.decision_function(K), atol=1e-4)
    np.testing.assert_array_equal(pm.predict(K), jm.predict(K))
