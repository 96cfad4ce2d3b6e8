"""The port's Lasso and LassoCV against the JAX package and sklearn on the CPU.

``fastsk_tpu_torch/svm/lasso.py`` against ``fastsk_tpu/svm/lasso.py`` on the
same seeded inputs, both in f32.

Tolerances: ``n_iter_`` within 1% of JAX's at stopping tolerances above
the f32 noise floor (1e-6, 1e-5; at 1e-8 the stop waits for the iterate to
stop moving in its last ulp, which the two frameworks' reduction orders
reach a few iterations apart), and equal between the port's chunked loop
and a one-iteration loop; coefficients within 1e-4 of max |coef|;
``LassoCV``'s alpha grid to 1e-12 relative, its CV errors within 2e-3
relative (a fold's fit at a small alpha may stop a few iterations from
JAX's, within its tol of 1e-5) and its ``alpha_`` equal. Against sklearn the bounds of
``tests/test_harness.py`` hold (2e-3).
"""

import numpy as np
import pytest
import torch

from fastsk_tpu.svm import lasso as jla
from fastsk_tpu_torch.svm import lasso as tla


def _sparse_problem(seed, n=60, d=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    w_true = np.zeros(d)
    w_true[[1, 4, 7]] = [2.0, -1.5, 0.7]
    return X, X @ w_true + 0.05 * rng.normal(size=n) + 0.3


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("alpha,tol", [(0.003, 1e-6), (0.01, 1e-5), (0.1, 1e-6)])
def test_lasso_matches_jax(seed, alpha, tol):
    X, y = _sparse_problem(seed)
    ours = tla.Lasso(alpha=alpha, tol=tol, device="cpu").fit(X, y)
    theirs = jla.Lasso(alpha=alpha, tol=tol).fit(X, y)
    assert abs(ours.n_iter_ - int(theirs.n_iter_)) <= 0.01 * int(theirs.n_iter_)
    scale = np.abs(theirs.coef_).max()
    np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=0, atol=1e-4 * scale)
    assert abs(ours.intercept_ - theirs.intercept_) <= 1e-4 * scale
    np.testing.assert_allclose(ours.predict(X), theirs.predict(X), rtol=0, atol=1e-4 * scale)
    assert ours.coef_.dtype == np.float64 and isinstance(ours.intercept_, float)


def test_lasso_matches_sklearn(rng):
    from sklearn.linear_model import Lasso as SkLasso

    X = rng.normal(size=(60, 12))
    w_true = np.zeros(12)
    w_true[[1, 4, 7]] = [2.0, -1.5, 0.7]
    y = X @ w_true + 0.05 * rng.normal(size=60) + 0.3
    for alpha in (0.01, 0.1):
        ours = tla.Lasso(alpha=alpha, max_iter=20000, tol=1e-8, device="cpu").fit(X, y)
        sk = SkLasso(alpha=alpha, max_iter=100000, tol=1e-10).fit(X, y)
        np.testing.assert_allclose(ours.coef_, sk.coef_, atol=2e-3)
        np.testing.assert_allclose(ours.intercept_, sk.intercept_, atol=2e-3)


def test_lasso_cv_matches_jax(rng):
    X = rng.normal(size=(80, 20))
    y = 3.0 * X[:, 2] - 2.0 * X[:, 11] + 0.1 * rng.normal(size=80)
    ours = tla.LassoCV(cv=5, n_alphas=20, device="cpu").fit(X, y)
    theirs = jla.LassoCV(cv=5, n_alphas=20).fit(X, y)
    np.testing.assert_allclose(ours.alphas_, theirs.alphas_, rtol=1e-12, atol=0)
    np.testing.assert_allclose(ours.mse_path_, theirs.mse_path_, rtol=2e-3, atol=0)
    assert ours.alpha_ == theirs.alpha_
    Xte = rng.normal(size=(40, 20))
    yte = 3.0 * Xte[:, 2] - 2.0 * Xte[:, 11] + 0.1 * rng.normal(size=40)
    assert ours.score(Xte, yte) > 0.95
    assert abs(ours.score(Xte, yte) - theirs.score(Xte, yte)) < 1e-6
    # one (fold, alpha) entry a fit; a fold's alphas run as one FISTA, one
    # host read a chunk of its slowest alpha's iterations
    assert ours.n_iter_path_.shape == (5, 20) and ours.n_iter_path_.min() > 0
    chunks = -(-ours.n_iter_path_.max(axis=1) // tla.CHUNK)
    assert ours.host_reads_ == chunks.sum() + -(-ours._model.n_iter_ // tla.CHUNK)


def _one_at_a_time(Xc, yc, alpha, L, max_iter, tol):
    """FISTA one iteration and one host read at a time (the JAX loop)."""
    n = Xc.shape[0]
    w = z = torch.zeros(Xc.shape[1])
    tk, it, delta = torch.tensor(1.0), 0, float("inf")
    while it < max_iter and delta > tol:
        grad = Xc.T @ (Xc @ z - yc) / n
        u = z - grad / L
        w_new = torch.sign(u) * torch.clamp_min(torch.abs(u) - alpha / L, 0.0)
        t_new = (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk)) / 2.0
        z = w_new + ((tk - 1.0) / t_new) * (w_new - w)
        delta = float(torch.max(torch.abs(w_new - w)))
        w, tk, it = w_new, t_new, it + 1
    return w, it


@pytest.mark.parametrize("max_iter,chunk", [(5000, 64), (5000, 7), (37, 64), (64, 64), (65, 64)])
def test_chunked_fista_matches_one_iteration_loop(max_iter, chunk):
    """The same n_iter_ and bit-identical coefficients, whether the stop
    falls inside a chunk, on its last iteration, or at max_iter."""
    X, y = _sparse_problem(3)
    X = torch.from_numpy(X.astype(np.float32))
    y = torch.from_numpy(y.astype(np.float32))
    Xc, yc = X - X.mean(0), y - y.mean()
    L = torch.linalg.vector_norm(Xc, ord=2) ** 2 / len(y)
    info = {}
    w, it = tla._fista(Xc, yc, 0.01, L, max_iter, 1e-6, chunk=chunk, info=info)
    w_ref, it_ref = _one_at_a_time(Xc, yc, 0.01, L, max_iter, 1e-6)
    assert it == it_ref == min(it_ref, max_iter)
    assert torch.equal(w, w_ref)
    assert info["host_reads"] == -(-it // chunk)
