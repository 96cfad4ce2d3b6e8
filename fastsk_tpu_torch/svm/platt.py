"""Platt sigmoid probability calibration.

Copied from ``fastsk_tpu/svm/platt.py`` (numpy only).

Same algorithm family as the reference's LIBSVM ``sigmoid_train``
(libsvm-code/svm.cpp:1725-1848) and sklearn's ``_SigmoidCalibration`` — the
Lin-Weng-Lin (2007) Newton method with backtracking on regularized targets.
Small fixed-size problem, solved in float64 numpy on host.
"""

from __future__ import annotations

import numpy as np


def sigmoid_train(decision_values, y_true, max_iter: int = 100) -> tuple:
    """Fit (A, B) such that P(y=1 | f) = 1 / (1 + exp(A f + B))."""
    f = np.asarray(decision_values, dtype=np.float64)
    t_pos = np.asarray(y_true) > 0
    prior1 = float(t_pos.sum())
    prior0 = float(len(f) - prior1)

    # regularized targets
    hi = (prior1 + 1.0) / (prior1 + 2.0)
    lo = 1.0 / (prior0 + 2.0)
    t = np.where(t_pos, hi, lo)

    min_step = 1e-10
    sigma = 1e-12
    eps = 1e-5

    A = 0.0
    B = np.log((prior0 + 1.0) / (prior1 + 1.0))

    def nll(A, B):
        fApB = f * A + B
        # numerically stable log(1 + exp(.))
        pos = fApB >= 0
        val = np.where(
            pos,
            t * fApB + np.log1p(np.exp(-fApB)),
            (t - 1.0) * fApB + np.log1p(np.exp(fApB)),
        )
        return val.sum()

    fval = nll(A, B)
    for _ in range(max_iter):
        fApB = f * A + B
        pos = fApB >= 0
        p = np.where(pos, np.exp(-fApB) / (1.0 + np.exp(-fApB)), 1.0 / (1.0 + np.exp(fApB)))
        q = 1.0 - p
        d1 = t - p
        d2 = p * q
        h11 = float(np.sum(f * f * d2)) + sigma
        h22 = float(np.sum(d2)) + sigma
        h21 = float(np.sum(f * d2))
        g1 = float(np.sum(f * d1))
        g2 = float(np.sum(d1))

        if abs(g1) < eps and abs(g2) < eps:
            break

        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB

        stepsize = 1.0
        while stepsize >= min_step:
            newA = A + stepsize * dA
            newB = B + stepsize * dB
            newf = nll(newA, newB)
            if newf < fval + 1e-4 * stepsize * gd:
                A, B, fval = newA, newB, newf
                break
            stepsize /= 2.0
        else:
            break  # line search failed

    return float(A), float(B)


def sigmoid_predict(decision_values, A: float, B: float) -> np.ndarray:
    """P(y=1 | f) with the fitted sigmoid, numerically stable."""
    f = np.asarray(decision_values, dtype=np.float64)
    fApB = f * A + B
    pos = fApB >= 0
    return np.where(
        pos,
        np.exp(-fApB) / (1.0 + np.exp(-fApB)),
        1.0 / (1.0 + np.exp(fApB)),
    )
