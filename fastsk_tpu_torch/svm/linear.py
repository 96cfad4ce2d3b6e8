"""Linear SVM (squared hinge, L2) and the calibrated-CV classifier.

Counterpart of ``fastsk_tpu/svm/linear.py``, with the same classes and
results. The reference's published numbers come from sklearn
``LinearSVC(C)`` wrapped in ``CalibratedClassifierCV(cv=5)`` over kernel
rows used as an empirical kernel map; this module implements that pair: a
Newton-CG on the primal squared-hinge objective and Platt-sigmoid
calibration over deterministic stratified folds.

The JAX package runs the solver as nested ``lax.while_loop``s with no host
read. Here the Newton loop reads its stopping test from the device once a
step, and everything inside a step stays on the device:

- CG runs all ``max_cg`` iterations; once its residual test fails the state
  is frozen with ``torch.where``, so ``x`` is the early-exiting loop's;
- the backtracking line search can only take t in {1, 1/2, ..., 2**-27}
  (it stops at t <= 1e-8), so the objective is evaluated at all 28 steps in
  one ``[n, 28]`` product and the first step meeting the Armijo test is
  taken, or 2**-27 if none does: the loop's t.

The solve is float32 and the decision function float64, as in JAX. The
estimators take a numpy array (moved to ``device``, default the card) or a
tensor, which stays on its own device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..kernel.config import resolve_device
from ..metrics import roc_auc
from .platt import sigmoid_predict, sigmoid_train

LS_STEPS = 28  # t = 2**-j, j = 0..27: the backtracking loop stops at t <= 1e-8


def _as_rows(X, device) -> torch.Tensor:
    """``X`` as float32 rows: a tensor stays on its device, anything else
    goes to ``device``."""
    if isinstance(X, torch.Tensor):
        return X.to(torch.float32)
    return torch.as_tensor(np.asarray(X, dtype=np.float32), device=resolve_device(device))


def _grad(X, y, C, sw, w):
    margins = 1.0 - y * (X @ w)
    active = torch.clamp_min(margins, 0.0)
    return w - 2.0 * C * (X.T @ (sw * y * active)), margins


def _objective(X, y, C, sw, W):
    """The primal objective at each column of ``W`` ([d] or [d, s])."""
    wide = W if W.dim() == 2 else W[:, None]
    margins = torch.clamp_min(1.0 - y[:, None] * (X @ wide), 0.0)
    f = 0.5 * (wide * wide).sum(0) + C * (sw[:, None] * margins**2).sum(0)
    return f if W.dim() == 2 else f[0]


def _cg(X, C, sw, mask, g, max_cg: int):
    """Solve H x = -g by ``max_cg`` conjugate-gradient iterations, frozen
    from the first that fails the residual test (the JAX loop's exit)."""

    def hvp(v):
        return v + 2.0 * C * (X.T @ (sw * mask * (X @ v)))

    x = torch.zeros_like(g)
    r = -g
    p = r
    rs = r @ r
    stop = 1e-12 * torch.clamp_min(rs, 1e-30)
    for _ in range(max_cg):
        live = rs > stop
        hp = hvp(p)
        alpha = rs / torch.clamp_min(p @ hp, 1e-30)
        r_new = r - alpha * hp
        rs_new = r_new @ r_new
        p_new = r_new + (rs_new / torch.clamp_min(rs, 1e-30)) * p
        x = torch.where(live, x + alpha * p, x)
        r = torch.where(live, r_new, r)
        p = torch.where(live, p_new, p)
        rs = torch.where(live, rs_new, rs)
    return x


def _line_search(X, y, C, sw, w, step, f0, gd) -> torch.Tensor:
    """The backtracking loop's step t (a 0-d tensor): the first of 1, 1/2,
    ..., 2**-26 whose objective passes the Armijo test, else 2**-27."""
    ts = 0.5 ** torch.arange(LS_STEPS, device=w.device, dtype=w.dtype)
    f = _objective(X, y, C, sw, w[:, None] + ts[None, :] * step[:, None])
    accept = ~(f > f0 + 1e-4 * ts * gd)
    accept[-1] = True
    return ts[torch.argmax(accept.to(torch.int32))]


def _solve_squared_hinge(
    X: torch.Tensor,  # [n, d] float32 (intercept column appended by caller)
    y: torch.Tensor,  # [n] float32 in {-1, +1}
    C: float,
    sample_weight: torch.Tensor,  # [n] float32
    tol: float = 1e-6,
    max_newton: int = 50,
    max_cg: int = 64,
    info: Optional[dict] = None,
) -> torch.Tensor:
    """min_w 0.5 ||w||^2 + C * sum_i s_i * max(0, 1 - y_i x_i.w)^2.

    ``info``, when given, receives ``newton_steps`` and ``host_reads``
    (one a step, plus the first test)."""
    n, d = X.shape
    w = torch.zeros(d, dtype=X.dtype, device=X.device)
    g, margins = _grad(X, y, C, sample_weight, w)
    gnorm = torch.linalg.vector_norm(g)
    it = reads = 0
    while it < max_newton:
        reads += 1
        if not bool(gnorm > tol * n):
            break
        mask = (margins > 0).to(X.dtype)
        step = _cg(X, C, sample_weight, mask, g, max_cg)
        f0 = _objective(X, y, C, sample_weight, w)
        t = _line_search(X, y, C, sample_weight, w, step, f0, g @ step)
        w = w + t * step
        # the JAX body recomputes the gradient at the top of the next step
        # from the same w; it is reused here
        g, margins = _grad(X, y, C, sample_weight, w)
        gnorm = torch.linalg.vector_norm(g)
        it += 1
    if info is not None:
        info.update(newton_steps=it, host_reads=reads)
    return w


@dataclass
class LinearSVC:
    """Binary linear SVM with squared-hinge loss (sklearn-LinearSVC parity).

    ``class_weight="balanced"`` reweights C per class by
    ``n_samples / (n_classes * class_count)``. After ``fit``, ``n_iter_``
    holds the Newton steps and ``host_reads_`` the device reads.
    """

    C: float = 1.0
    class_weight: Optional[str] = None
    tol: float = 1e-6
    device: Union[str, torch.device] = "cuda"

    def fit(self, X, y) -> "LinearSVC":
        X = _as_rows(X, self.device)
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) != 2:
            raise ValueError(f"binary classification only; got classes {classes}")
        self.classes_ = classes
        y_signed = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)

        if self.class_weight == "balanced":
            counts = np.array([(y == c).sum() for c in classes], dtype=np.float64)
            cw = len(y) / (2.0 * counts)
            sw = np.where(y == classes[1], cw[1], cw[0]).astype(np.float32)
        else:
            sw = np.ones_like(y_signed)

        dev = X.device
        Xi = torch.cat([X, torch.ones(len(X), 1, dtype=X.dtype, device=dev)], dim=1)
        info: dict = {}
        w = _solve_squared_hinge(
            Xi,
            torch.as_tensor(y_signed, device=dev),
            float(np.float32(self.C)),
            torch.as_tensor(sw, device=dev),
            tol=self.tol,
            info=info,
        )
        w = w.cpu().numpy().astype(np.float64)
        self.coef_ = w[:-1][None, :]
        self.intercept_ = w[-1:]
        self.n_iter_ = info["newton_steps"]
        self.host_reads_ = info["host_reads"]
        return self

    def decision_function(self, X) -> np.ndarray:
        if isinstance(X, torch.Tensor):
            coef = torch.as_tensor(self.coef_[0], device=X.device)
            return (X.to(torch.float64) @ coef + float(self.intercept_[0])).cpu().numpy()
        X = np.asarray(X, dtype=np.float64)
        return X @ self.coef_[0] + self.intercept_[0]

    def predict(self, X) -> np.ndarray:
        d = self.decision_function(X)
        return np.where(d > 0, self.classes_[1], self.classes_[0])

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))


def stratified_kfold_indices(y, n_splits: int = 5) -> List[np.ndarray]:
    """Deterministic stratified folds, bit-matching sklearn's unshuffled
    StratifiedKFold: per-fold class allocations come from n_splits-strided
    slices of the sorted labels, and each class's samples are assigned to
    folds in contiguous encounter-order blocks of those sizes."""
    y = np.asarray(y)
    classes, y_enc = np.unique(y, return_inverse=True)
    n_classes = len(classes)
    y_sorted = np.sort(y_enc)
    allocation = np.array(
        [
            np.bincount(y_sorted[i::n_splits], minlength=n_classes)
            for i in range(n_splits)
        ]
    )
    test_folds = np.empty(len(y), dtype=np.int64)
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        test_folds[y_enc == k] = folds_for_class
    return [np.flatnonzero(test_folds == i) for i in range(n_splits)]


@dataclass
class CalibratedLinearSVC:
    """LinearSVC + per-fold Platt calibration, averaged over folds.

    Equivalent estimator to sklearn ``CalibratedClassifierCV(LinearSVC(C),
    cv=5)``: 5 stratified folds, each fold's model calibrated on its
    held-out decisions, probabilities averaged. The rows go to the device
    once; each fold takes its rows there.
    """

    C: float = 1.0
    cv: int = 5
    class_weight: Optional[str] = None
    device: Union[str, torch.device] = "cuda"

    def fit(self, X, y) -> "CalibratedLinearSVC":
        X = _as_rows(X, self.device)
        y = np.asarray(y)
        self.classes_ = np.unique(y)

        def svc(rows, labels):
            return LinearSVC(
                C=self.C, class_weight=self.class_weight, device=X.device
            ).fit(rows, labels)

        # degrade gracefully on tiny data: every fold's training split must
        # still contain both classes
        min_class = int(min(np.bincount(np.searchsorted(self.classes_, y))))
        cv = max(2, min(self.cv, min_class)) if min_class >= 2 else 0
        if cv == 0:
            # toy-sized data (one sample in a class): uncalibrated fallback
            model = svc(X, y)
            dec = model.decision_function(X)
            A, B = sigmoid_train(dec, np.where(y == self.classes_[1], 1, -1))
            self._models = [(model, A, B)]
            return self
        folds = stratified_kfold_indices(y, cv)
        all_idx = np.arange(len(y))
        self._models: List[Tuple[LinearSVC, float, float]] = []
        for f in folds:
            train_idx = np.setdiff1d(all_idx, f)
            model = svc(X[torch.as_tensor(train_idx, device=X.device)], y[train_idx])
            dec = model.decision_function(X[torch.as_tensor(f, device=X.device)])
            A, B = sigmoid_train(dec, np.where(y[f] == self.classes_[1], 1, -1))
            self._models.append((model, A, B))
        return self

    def predict_proba(self, X) -> np.ndarray:
        if not isinstance(X, torch.Tensor):
            X = np.asarray(X, dtype=np.float64)
        probs = np.zeros(len(X), dtype=np.float64)
        for svc, A, B in self._models:
            probs += sigmoid_predict(svc.decision_function(X), A, B)
        probs /= len(self._models)
        return np.stack([1.0 - probs, probs], axis=1)

    def predict(self, X) -> np.ndarray:
        p = self.predict_proba(X)[:, 1]
        return np.where(p > 0.5, self.classes_[1], self.classes_[0])

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))


def train_eval_linear(
    K_train: np.ndarray,
    K_test: np.ndarray,
    Ytrain,
    Ytest,
    C: float = 1.0,
    device: Union[str, torch.device] = "cuda",
) -> dict:
    """The reference validation pipeline in one call: calibrated linear SVM
    on kernel rows; returns accuracy and AUROC."""
    clf = CalibratedLinearSVC(C=C, device=device).fit(K_train, np.asarray(Ytrain))
    probs = clf.predict_proba(K_test)[:, 1]
    acc = clf.score(K_test, np.asarray(Ytest))
    return {"acc": acc, "auc": roc_auc(np.asarray(Ytest), probs)}


@dataclass
class MulticlassLinearSVC:
    """One-vs-rest linear SVC for multiclass workloads (the MADAR Arabic
    dialect task; the reference leans on sklearn's built-in OvR there)."""

    C: float = 1.0
    class_weight: Optional[str] = None
    device: Union[str, torch.device] = "cuda"

    def fit(self, X, y) -> "MulticlassLinearSVC":
        X = _as_rows(X, self.device)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) < 2:
            raise ValueError("need at least two classes")
        self._models = []
        for c in self.classes_:
            yc = (y == c).astype(int)
            self._models.append(
                LinearSVC(C=self.C, class_weight=self.class_weight, device=X.device).fit(X, yc)
            )
        return self

    def decision_function(self, X) -> np.ndarray:
        if not isinstance(X, torch.Tensor):
            X = np.asarray(X, dtype=np.float64)
        return np.stack([m.decision_function(X) for m in self._models], axis=1)

    def predict(self, X) -> np.ndarray:
        return self.classes_[self.decision_function(X).argmax(axis=1)]

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))
