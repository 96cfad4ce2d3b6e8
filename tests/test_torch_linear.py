"""The port's linear SVMs against the JAX package and sklearn on the CPU.

``fastsk_tpu_torch/svm/linear.py`` against ``fastsk_tpu/svm/linear.py`` on
the same seeded inputs: ``_solve_squared_hinge``, ``LinearSVC`` (also
balanced), ``CalibratedLinearSVC``, ``train_eval_linear`` and
``MulticlassLinearSVC``; the batched line search against a plain
backtracking loop; the tiny-data fallback; fitted state moving between the
packages as numpy.

Tolerances: the two frameworks' f32 matvecs agree to a few ulps, not bit
for bit, so weights agree within 1e-5, decision values and probabilities
within 1e-4, predictions, accuracies and AUCs exactly, and the batched
line search picks the loop's t exactly. Against sklearn the bounds of
``tests/test_svm.py`` and ``tests/test_harness.py`` hold (2e-3 on weights,
0.02 on probabilities).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastsk_tpu.svm import linear as jl
from fastsk_tpu_torch.svm import linear as tl


def make_blobs(rng, n=120, d=6, sep=1.5):
    y = rng.integers(0, 2, size=n)
    X = rng.normal(size=(n, d)) + sep * (2 * y - 1)[:, None] * rng.normal(size=d)
    return X.astype(np.float64), y


def _multiclass(rng, n=160, d=6):
    y = rng.integers(0, 4, n)
    centers = rng.normal(size=(4, d)) * 3
    return centers[y] + rng.normal(size=(n, d)), centers[y] + rng.normal(size=(n, d)), y


@pytest.mark.parametrize("C,balanced", [(1.0, False), (0.5, True), (10.0, False)])
def test_solve_squared_hinge_matches_jax(rng, C, balanced):
    X, y = make_blobs(rng, n=90, d=7)
    Xi = np.concatenate([X, np.ones((len(X), 1))], axis=1).astype(np.float32)
    ys = np.where(y == 1, 1.0, -1.0).astype(np.float32)
    sw = (np.where(y == 1, 0.7, 1.6) if balanced else np.ones(len(y))).astype(np.float32)
    want = np.asarray(jl._solve_squared_hinge(
        jnp.asarray(Xi), jnp.asarray(ys), jnp.float32(C), jnp.asarray(sw)))
    info = {}
    got = tl._solve_squared_hinge(
        torch.from_numpy(Xi), torch.from_numpy(ys), C, torch.from_numpy(sw), info=info)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert info["host_reads"] == info["newton_steps"] + 1
    assert 0 < info["newton_steps"] <= 50


@pytest.mark.parametrize("class_weight", [None, "balanced"])
def test_linear_svc_matches_jax_and_sklearn(rng, class_weight):
    from sklearn.svm import LinearSVC as SkLinearSVC

    X, y = make_blobs(rng, n=150)
    y[:100] = 0  # imbalance
    Xt, _ = make_blobs(rng)
    ours = tl.LinearSVC(C=0.5, class_weight=class_weight, device="cpu").fit(X, y)
    theirs = jl.LinearSVC(C=0.5, class_weight=class_weight).fit(X, y)
    np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.intercept_, theirs.intercept_, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        ours.decision_function(Xt), theirs.decision_function(Xt), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours.predict(Xt), theirs.predict(Xt))
    sk = SkLinearSVC(C=0.5, class_weight=class_weight, loss="squared_hinge", tol=1e-8,
                     max_iter=100000).fit(X, y)
    np.testing.assert_allclose(ours.coef_, sk.coef_, rtol=0, atol=5e-3)
    # the decision on a tensor stays on its device and equals the numpy one
    np.testing.assert_allclose(
        ours.decision_function(torch.from_numpy(Xt)), ours.decision_function(Xt),
        rtol=0, atol=1e-12)


def test_calibrated_matches_jax_and_sklearn(rng):
    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.svm import LinearSVC as SkLinearSVC

    from fastsk_tpu_torch.metrics import roc_auc

    X, y = make_blobs(rng, n=200)
    Xt, yt = make_blobs(rng, n=80)
    ours = tl.CalibratedLinearSVC(C=1.0, device="cpu").fit(X, y)
    theirs = jl.CalibratedLinearSVC(C=1.0).fit(X, y)
    p_ours = ours.predict_proba(Xt)[:, 1]
    np.testing.assert_allclose(p_ours, theirs.predict_proba(Xt)[:, 1], rtol=0, atol=1e-4)
    assert ours.score(Xt, yt) == theirs.score(Xt, yt)
    sk = CalibratedClassifierCV(SkLinearSVC(C=1.0, max_iter=100000), cv=5).fit(X, y)
    p_sk = sk.predict_proba(Xt)[:, 1]
    np.testing.assert_allclose(p_ours, p_sk, atol=0.02)
    assert abs(roc_auc(yt, p_ours) - roc_auc(yt, p_sk)) < 0.01
    # every fold took a few Newton steps, each with one host read
    assert all(m.host_reads_ == m.n_iter_ + 1 for m, _, _ in ours._models)


def test_calibrated_balanced_on_a_tensor(rng):
    """Rows given as a tensor are fitted where they lie; the balanced
    calibrated fit equals JAX's."""
    X, y = make_blobs(rng, n=160)
    y[:90] = 0
    Xt, _ = make_blobs(rng, n=50)
    ours = tl.CalibratedLinearSVC(C=1.0, class_weight="balanced").fit(torch.from_numpy(X), y)
    theirs = jl.CalibratedLinearSVC(C=1.0, class_weight="balanced").fit(X, y)
    np.testing.assert_allclose(
        ours.predict_proba(torch.from_numpy(Xt)), theirs.predict_proba(Xt), rtol=0, atol=1e-4)


def test_train_eval_linear_matches_jax(rng):
    X, y = make_blobs(rng, n=150, d=8)
    Xt, yt = make_blobs(rng, n=60, d=8)
    ours = tl.train_eval_linear(X, Xt, y, yt, C=1.0, device="cpu")
    theirs = jl.train_eval_linear(X, Xt, y, yt, C=1.0)
    assert ours == theirs
    assert ours["auc"] > 0.9 and ours["acc"] > 0.85


def test_multiclass_linear_svc_matches_jax(rng):
    X, Xt, y = _multiclass(rng)
    ours = tl.MulticlassLinearSVC(C=1.0, device="cpu").fit(X, y)
    theirs = jl.MulticlassLinearSVC(C=1.0).fit(X, y)
    np.testing.assert_allclose(
        ours.decision_function(Xt), theirs.decision_function(Xt), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours.predict(Xt), theirs.predict(Xt))
    assert ours.score(Xt, y) > 0.9
    assert ours.decision_function(Xt).shape == (len(y), 4)


def _loop_t(X, y, C, sw, w, step, f0, gd):
    """The JAX package's backtracking loop, one objective at a time."""
    obj = lambda v: tl._objective(X, y, C, sw, v)  # noqa: E731
    t, fv = 1.0, obj(w + step)
    while bool(fv > f0 + 1e-4 * t * gd) and t > 1e-8:
        t, fv = t * 0.5, obj(w + t * 0.5 * step)
    return t


@pytest.mark.parametrize("scale,lower", [(1.0, 0.0), (3.0, 0.0), (-1.0, 0.0), (1e9, 0.0),
                                         (1.0, 1e6)])
def test_batched_line_search_takes_the_loops_step(rng, scale, lower):
    """The [n, 28] evaluation picks the loop's t: 1 for the Newton step,
    some 2**-j for a step that overshoots (scales 3 and 1e9) or an ascent
    direction (scale -1), and 2**-27 where no t passes (f0 lowered by 1e6,
    so that the Armijo bound is out of reach)."""
    X, y = make_blobs(rng, n=70, d=5)
    Xi = torch.from_numpy(np.concatenate([X, np.ones((70, 1))], axis=1).astype(np.float32))
    ys = torch.from_numpy(np.where(y == 1, 1.0, -1.0).astype(np.float32))
    sw = torch.ones(70)
    w = torch.from_numpy(rng.normal(size=6).astype(np.float32)) * 0.1
    g, margins = tl._grad(Xi, ys, 1.0, sw, w)
    step = tl._cg(Xi, 1.0, sw, (margins > 0).float(), g, 64) * scale
    f0 = tl._objective(Xi, ys, 1.0, sw, w) - lower
    gd = g @ step
    got = float(tl._line_search(Xi, ys, 1.0, sw, w, step, f0, gd))
    assert got == _loop_t(Xi, ys, 1.0, sw, w, step, f0, gd)
    if lower:
        assert got == 2.0**-27
    if scale == 1.0 and not lower:
        assert got == 1.0


def test_tiny_data_fallback_matches_jax():
    """One sample in a class: no folds, one uncalibrated model, as in JAX."""
    X = np.array([[0.0, 1.0], [1.0, 0.5], [0.2, 0.9], [2.0, 0.1], [1.8, 0.3]])
    y = np.array([0, 1, 0, 0, 0])
    ours = tl.CalibratedLinearSVC(C=1.0, device="cpu").fit(X, y)
    theirs = jl.CalibratedLinearSVC(C=1.0).fit(X, y)
    assert len(ours._models) == len(theirs._models) == 1
    np.testing.assert_allclose(ours.predict_proba(X), theirs.predict_proba(X), rtol=0, atol=1e-4)
    # two samples in the smaller class: two folds
    y2 = np.array([0, 1, 0, 1, 0])
    assert len(tl.CalibratedLinearSVC(C=1.0, device="cpu").fit(X, y2)._models) == 2


def test_fitted_state_moves_between_packages(rng):
    """coef_, intercept_ and classes_ are numpy: a model fitted by either
    package predicts with the other's decision function."""
    X, y = make_blobs(rng, n=100)
    Xt, _ = make_blobs(rng, n=40)
    ours = tl.LinearSVC(device="cpu").fit(X, y)
    theirs = jl.LinearSVC().fit(X, y)
    for a, b in ((ours, jl.LinearSVC()), (theirs, tl.LinearSVC(device="cpu"))):
        b.coef_, b.intercept_, b.classes_ = a.coef_, a.intercept_, a.classes_
        assert isinstance(a.coef_, np.ndarray) and a.coef_.dtype == np.float64
        np.testing.assert_array_equal(b.decision_function(Xt), a.decision_function(Xt))
        np.testing.assert_array_equal(b.predict(Xt), a.predict(Xt))
