"""Lasso / LassoCV for regression on gkm kernel rows.

Counterpart of ``fastsk_tpu/svm/lasso.py``, replacing the reference's
sklearn ``LassoCV(cv=5)`` on kernel rows: FISTA (accelerated proximal
gradient) with a 20-step power-iteration Lipschitz estimate, and a CV alpha
path on sklearn's eps/n_alphas grid with the same seeded folds.

Everything is float32, as in the JAX package: neither it nor its tests turn
on x64, so its ``jnp`` arrays are f32. The JAX FISTA is one
``lax.while_loop``; here iterations run in chunks of ``CHUNK`` on the
device with one host read a chunk, and inside a chunk the state freezes
(``torch.where``) as soon as ``delta <= tol or it >= max_iter``, so
``coef_`` and ``n_iter_`` are those of the one-iteration-at-a-time loop.
``LassoCV`` fits a fold's whole alpha grid at once, one column of one
product an alpha, each column stopping on its own; the JAX package fits
them one after another (the same iterations, other rounding).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from ..kernel.config import resolve_device

CHUNK = 64  # FISTA iterations between host reads


def _fista(Xc, yc, alpha, L, max_iter: int, tol: float, chunk: int = CHUNK,
           info: Optional[dict] = None):
    """min_w (1/2n)||yc - Xc w||^2 + alpha ||w||_1 (centered data), for one
    ``alpha`` or, as columns of one product, for each of a 1-D array of
    them, each column with its own stop.

    Returns ``(w, iters)``: ``[d]`` and an int for a scalar ``alpha``,
    ``[d, a]`` and an int array otherwise; ``info``, when given, receives
    ``host_reads``."""
    n = Xc.shape[0]
    one = np.ndim(alpha) == 0
    alphas = torch.as_tensor(np.array(np.atleast_1d(alpha), dtype=np.float32), device=Xc.device)
    a = alphas.shape[0]
    w = torch.zeros((Xc.shape[1], a), dtype=Xc.dtype, device=Xc.device)
    z = w
    tk = torch.ones(a, dtype=Xc.dtype, device=Xc.device)
    it = torch.zeros(a, dtype=torch.int32, device=Xc.device)
    delta = torch.full((a,), float("inf"), dtype=Xc.dtype, device=Xc.device)
    thresh = alphas / L
    reads = 0
    while True:
        for _ in range(chunk):
            live = (it < max_iter) & (delta > tol)
            grad = Xc.T @ (Xc @ z - yc[:, None]) / n
            u = z - grad / L
            w_new = torch.sign(u) * torch.clamp_min(torch.abs(u) - thresh, 0.0)
            t_new = (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk)) / 2.0
            z_new = w_new + ((tk - 1.0) / t_new) * (w_new - w)
            d_new = torch.amax(torch.abs(w_new - w), dim=0)
            w = torch.where(live, w_new, w)
            z = torch.where(live, z_new, z)
            tk = torch.where(live, t_new, tk)
            delta = torch.where(live, d_new, delta)
            it = it + live.to(torch.int32)
        reads += 1
        if not bool(((it < max_iter) & (delta > tol)).any()):
            break
    if info is not None:
        info["host_reads"] = reads
    iters = it.cpu().numpy()
    return (w[:, 0], int(iters[0])) if one else (w, iters)


def _fit(X: torch.Tensor, y, alpha, max_iter: int, tol: float):
    """``(coef, intercept, n_iter, host_reads)`` of the Lasso at ``alpha``
    (a float, or a 1-D array: then one column of coef, intercept and
    n_iter an alpha) on rows ``X`` (a tensor), targets ``y``."""
    X = X.to(torch.float32)
    y = torch.as_tensor(
        y.to(torch.float32) if isinstance(y, torch.Tensor) else np.asarray(y, dtype=np.float32),
        device=X.device,
    )
    x_mean = X.mean(dim=0)
    y_mean = y.mean()
    Xc = X - x_mean
    yc = y - y_mean
    # Lipschitz constant of the quadratic part via power iteration
    v = torch.ones(X.shape[1], dtype=X.dtype, device=X.device) / float(np.sqrt(X.shape[1]))
    for _ in range(20):
        v = Xc.T @ (Xc @ v)
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
    L = torch.linalg.vector_norm(Xc.T @ (Xc @ v)) / X.shape[0] + 1e-8
    info: dict = {}
    w, iters = _fista(Xc, yc, alpha, L, max_iter, tol, info=info)
    intercept = (y_mean - x_mean @ w).cpu().numpy()
    coef = w.cpu().numpy().astype(np.float64)
    if np.ndim(alpha) == 0:
        intercept = float(intercept)
    return coef, intercept, iters, info["host_reads"]


@dataclass
class Lasso:
    alpha: float = 1.0
    max_iter: int = 5000
    tol: float = 1e-6
    device: Union[str, torch.device] = "cuda"

    def fit(self, X, y) -> "Lasso":
        """``X``, ``y``: numpy (moved to ``device``) or tensors (kept on
        their device). After the fit, ``host_reads_`` counts FISTA's host
        reads."""
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(np.asarray(X, dtype=np.float32), device=resolve_device(self.device))
        fit = _fit(X, y, float(self.alpha), self.max_iter, self.tol)
        self.coef_, self.intercept_, self.n_iter_, self.host_reads_ = fit
        return self

    def predict(self, X) -> np.ndarray:
        if isinstance(X, torch.Tensor):
            X = X.cpu().numpy()
        return np.asarray(X, dtype=np.float64) @ self.coef_ + self.intercept_

    def score(self, X, y) -> float:
        from ..metrics import r2_score

        return r2_score(np.asarray(y, dtype=np.float64), self.predict(X))


@dataclass
class LassoCV:
    """5-fold CV over an eps-grid of alphas (sklearn LassoCV semantics).

    The rows go to ``device`` once; every fold's fits take theirs there,
    the fold's alphas in one FISTA run. After the fit, ``n_iter_path_``
    holds each (fold, alpha) fit's FISTA iterations and ``host_reads_``
    all fits' host reads."""

    cv: int = 5
    n_alphas: int = 30
    eps: float = 1e-3
    max_iter: int = 5000
    tol: float = 1e-5
    random_state: int = 0
    alphas_: Optional[np.ndarray] = field(default=None, repr=False)
    device: Union[str, torch.device] = "cuda"

    def fit(self, X, y) -> "LassoCV":
        dev = resolve_device(self.device)
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = len(y)
        Xc = X - X.mean(axis=0)
        yc = y - y.mean()
        alpha_max = np.max(np.abs(Xc.T @ yc)) / n
        alpha_max = max(alpha_max, 1e-12)
        self.alphas_ = np.logspace(
            np.log10(alpha_max * self.eps), np.log10(alpha_max), self.n_alphas
        )[::-1]

        X_dev = torch.as_tensor(X.astype(np.float32), device=dev)
        y_dev = torch.as_tensor(y.astype(np.float32), device=dev)
        rng = np.random.default_rng(self.random_state)
        order = rng.permutation(n)
        folds = np.array_split(order, self.cv)
        mse = np.zeros(len(self.alphas_))
        self.n_iter_path_ = np.zeros((len(folds), len(self.alphas_)), dtype=np.int64)
        self.host_reads_ = 0
        for fi, f in enumerate(folds):
            tr = torch.as_tensor(np.setdiff1d(np.arange(n), f), device=dev)
            coef, intercept, iters, reads = _fit(
                X_dev[tr], y_dev[tr], self.alphas_, self.max_iter, self.tol
            )
            self.n_iter_path_[fi] = iters
            self.host_reads_ += reads
            pred = X[f] @ coef + intercept.astype(np.float64)
            mse += np.mean((pred - y[f][:, None]) ** 2, axis=0)
        self.mse_path_ = mse / self.cv
        self.alpha_ = float(self.alphas_[int(np.argmin(self.mse_path_))])
        best = Lasso(alpha=self.alpha_, max_iter=self.max_iter, tol=self.tol)
        best.fit(X_dev, y_dev)
        self.host_reads_ += best.host_reads_
        self.coef_ = best.coef_
        self.intercept_ = best.intercept_
        self._model = best
        return self

    def predict(self, X) -> np.ndarray:
        return self._model.predict(X)

    def score(self, X, y) -> float:
        return self._model.score(X, y)
