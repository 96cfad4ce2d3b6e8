"""Kernel SVMs on a precomputed Gram matrix, in PyTorch.

Counterpart of ``fastsk_tpu/svm/kernel_svm.py``: ``KernelSVC`` (C-SVC,
binary or one-vs-one, with Platt probabilities), ``NuSVC``, ``NuSVR``,
``EpsilonSVR`` and ``OneClassSVM``. Two solvers carry them
(``svm/smo_cuda.py``; a kernel on the card, its plain twin on the CPU):

- LIBSVM's Solver::Solve, kernel B, for C-SVC, epsilon-SVR and one-class:

      min 0.5 a^T Q a + p^T a,  0 <= a_i <= C_i,  y^T a = const,

  with second-order working-set selection and the ``gmax + gmax2 < eps``
  stop, then the f32 bound snap and rho;
- Solver_NU, kernel C, for nu-SVC and nu-SVR: the same problem with the
  sum of alpha conserved in each class separately, then the class-wise
  bias split into rho and r.

Probability estimates use Platt scaling on 5-fold cross-validated
decision values. A C-SVC fit's main solve and its Platt folds are the
spans ``fit.solve`` and ``fit.platt`` (``utils/observe.py``).

A Gram given as a numpy array is solved on the CPU; a torch tensor is
solved where it lies, so a CUDA Gram never leaves the card and only O(n)
results come back. The SVR types assemble their 2n-row dual on the
Gram's device too (the JAX package builds it on the host).

Every fitted model carries the JAX package's attribute names
(``alpha_y_`` or ``coef_``, ``rho_``, ``classes_``, ``support_``,
``platt_``, ``_ovo``), so ``svm/libsvm_io.py`` writes it and
``to_numpy_state`` / ``from_numpy_state`` carry it between the packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.pairs import full_f32_matmul
from ..utils.observe import span
from .linear import stratified_kfold_indices
from .platt import sigmoid_predict, sigmoid_train
from .smo_cuda import (
    _NEG_INF,
    initial_state,
    smo_loop_plain,
    smo_nu_loop_plain,
    smo_nu_solve,
    smo_solve,
)


def _gram_f32(gram) -> torch.Tensor:
    """A host Gram becomes a CPU f32 tensor; a tensor stays on its device."""
    if isinstance(gram, torch.Tensor):
        return gram.to(torch.float32)
    return torch.from_numpy(np.asarray(gram, dtype=np.float32))


def _decision_values(gram_rows, coef: np.ndarray, rho: float) -> np.ndarray:
    """``gram_rows @ coef - rho`` pulling only the O(n) result: tensor rows
    dot where they lie in f32; host rows keep the f64 numpy path."""
    if isinstance(gram_rows, torch.Tensor):
        c = torch.as_tensor(coef, dtype=torch.float32, device=gram_rows.device)
        with full_f32_matmul():
            d = gram_rows.to(torch.float32) @ c
        return d.cpu().numpy().astype(np.float64) - rho
    return np.asarray(gram_rows, np.float64) @ coef - rho


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def _snap_bounds(alpha: torch.Tensor, C_vec: torch.Tensor) -> torch.Tensor:
    """Clamp alphas within 1e-6*C of a bound exactly onto it (f32 pair
    updates leave machine-epsilon residues where LIBSVM's doubles are
    exact; the free-SV averages of the bias must agree on the active
    set)."""
    thr = 1e-6 * C_vec
    return torch.where(
        alpha < thr, 0.0, torch.where(alpha > C_vec - thr, C_vec, alpha)
    )


def _finalize_rho(alpha, grad, y, C_vec):
    """Snap f32 bound residues and compute the bias: the average of y*grad
    over free SVs, else the midpoint of the bounds (libsvm
    Solver::calculate_rho, svm.cpp:974-1004)."""
    alpha = _snap_bounds(alpha, C_vec)
    free = (alpha > 0) & (alpha < C_vec)
    yg = y * grad
    nfree = torch.sum(free)
    up = torch.where(y > 0, alpha < C_vec, alpha > 0)
    low = torch.where(y > 0, alpha > 0, alpha < C_vec)
    ub = torch.min(torch.where(up, yg, -_NEG_INF))
    lb = torch.max(torch.where(low, yg, _NEG_INF))
    rho = torch.where(
        nfree > 0,
        torch.sum(torch.where(free, yg, 0.0)) / nfree,
        (ub + lb) / 2.0,
    )
    return alpha, rho


def _smo_solve_general(Q, y, C_vec, p, alpha0, eps: float, max_iter: int):
    """The plain twin of kernel B with rho: ``(alpha, rho, iters)`` —
    ``fastsk_tpu/svm/kernel_svm.py:_smo_solve_general`` in PyTorch."""
    grad0, qd = initial_state(Q, p, alpha0)
    alpha, grad, iters = smo_loop_plain(Q, y, C_vec, qd, alpha0, grad0, eps, max_iter)
    alpha, rho = _finalize_rho(alpha, grad, y, C_vec)
    return alpha, rho, iters


def _solve_general(Q, y, C_vec, p, alpha0, eps: float, max_iter: int):
    """One generalized SMO solve through the kernel B wrapper (the kernel
    on a CUDA tensor, the twin on a CPU one), then rho."""
    alpha, grad, iters = smo_solve(Q, y, C_vec, p, alpha0, eps, max_iter)
    alpha, rho = _finalize_rho(alpha, grad, y, C_vec)
    return alpha, rho, iters


def _finalize_nu(alpha, grad, y, C_vec):
    """Snap bound residues, then the class-wise bias split: per-class r
    from free-SV gradient averages, falling back to the midpoint of the
    strict bound sets — raw G for BOTH classes, exactly libsvm
    Solver_NU::calculate_rho (svm.cpp:1229-1280): ub from the lower-bound
    set (alpha == 0), lb from the upper-bound set (== C)."""
    alpha = _snap_bounds(alpha, C_vec)

    def class_r(cls):
        mask = y == cls
        free = mask & (alpha > 0) & (alpha < C_vec)
        nfree = torch.sum(free)
        gsum = torch.sum(torch.where(free, grad, 0.0))
        ub = torch.min(torch.where(mask & (alpha <= 0), grad, -_NEG_INF))
        lb = torch.max(torch.where(mask & (alpha >= C_vec), grad, _NEG_INF))
        return torch.where(nfree > 0, gsum / nfree, (ub + lb) / 2.0)

    r1 = class_r(1.0)
    r2 = class_r(-1.0)
    # svm.cpp:1276-1279: si->rho = (r1 - r2)/2, si->r = (r1 + r2)/2
    rho = (r1 - r2) / 2.0
    r = (r1 + r2) / 2.0
    return alpha, rho, r


def _smo_solve_nu(Q, y, C_vec, p, alpha0, eps: float, max_iter: int):
    """The plain twin of kernel C with the bias: ``(alpha, rho, r, iters)``
    — ``fastsk_tpu/svm/kernel_svm.py:_smo_solve_nu`` in PyTorch."""
    grad0, qd = initial_state(Q, p, alpha0)
    alpha, grad, iters = smo_nu_loop_plain(
        Q, y, C_vec, qd, alpha0, grad0, eps, max_iter
    )
    alpha, rho, r = _finalize_nu(alpha, grad, y, C_vec)
    return alpha, rho, r, iters


def _solve_nu(Q, y, C_vec, p, alpha0, eps: float, max_iter: int):
    """One Solver_NU solve through the kernel C wrapper (the kernel on a
    CUDA tensor, the twin on a CPU one), then rho and r."""
    alpha, grad, iters = smo_nu_solve(Q, y, C_vec, p, alpha0, eps, max_iter)
    alpha, rho, r = _finalize_nu(alpha, grad, y, C_vec)
    return alpha, rho, r, iters


def _restrict_feasible(
    alpha: np.ndarray, y_signed: np.ndarray, c_vec: np.ndarray
) -> np.ndarray:
    """Project a restriction of a feasible alpha back onto the SMO
    feasible set: 0 <= a <= C and y^T a = 0.

    Dropping rows from a full-problem solution leaves a residual
    r = y^T a != 0. Repair by greedily shrinking alphas of the class with
    the surplus (largest first), which keeps every coordinate in its box;
    the surplus class's alpha mass always covers |r| because the other
    class's mass (>= 0) equals it minus r. Exact in f64; the f32 cast
    residual (~sqrt(n) * C * eps_f32) is far below the solver's stopping
    tolerance and the f32 drift of the pair updates themselves.
    """
    a = np.asarray(alpha, np.float64).copy()
    a = np.clip(a, 0.0, np.asarray(c_vec, np.float64))
    r = float(np.dot(a, y_signed))
    if r != 0.0:
        sign = 1.0 if r > 0 else -1.0
        idx = np.flatnonzero((y_signed == sign) & (a > 0))
        order = idx[np.argsort(-a[idx], kind="stable")]
        cum = np.cumsum(a[order])
        take = np.minimum(a[order], np.maximum(0.0, abs(r) - (cum - a[order])))
        a[order] -= take
    return a.astype(np.float32)


def nu_svc_start(ys: np.ndarray, nu: float) -> np.ndarray:
    """LIBSVM's nu-SVC initial point: each class filled greedily up to
    nu * n / 2 (svm.cpp:1496-1524)."""
    n = len(ys)
    budget = nu * n / 2.0
    alpha0 = np.zeros(n, dtype=np.float32)
    for cls in (1.0, -1.0):
        left = budget
        for idx in np.flatnonzero(ys == cls):
            take = min(1.0, left)
            alpha0[idx] = take
            left -= take
            if left <= 0:
                break
    return alpha0


def nu_svr_start(n: int, C: float, nu: float) -> np.ndarray:
    """LIBSVM's nu-SVR initial point over the 2n dual: C * nu * n / 2
    spread over the first rows of both halves (svm.cpp:1611-1655)."""
    alpha0 = np.zeros(2 * n, dtype=np.float32)
    left = C * nu * n / 2.0
    for i in range(n):
        take = min(C, left)
        alpha0[i] = alpha0[n + i] = take
        left -= take
        if left <= 0:
            break
    return alpha0


def svr_dual(gram: torch.Tensor):
    """``(Q2, y2)`` of the 2n-row SVR dual, assembled on the Gram's device:
    ``Q2 = [[K, K], [K, K]] * outer(y2, y2)`` with ``y2 = [1]*n + [-1]*n``
    (the same f32 products as the JAX package's host assembly)."""
    n = gram.shape[0]
    y2 = torch.cat([torch.ones(n), -torch.ones(n)]).to(gram.device)
    Q2 = gram.repeat(2, 2)
    Q2.mul_(torch.outer(y2, y2))
    return Q2, y2


def _max_iter(cap: int, n: int, per_row: int = 100) -> int:
    return min(cap, max(10_000_000, per_row * n))


# ----------------------------------------------------------------- state


def numpy_state(model) -> dict:
    """The fitted attributes of any model of the family as numpy values
    (no tensors), under the JAX package's names: ``classes_``,
    ``alpha_y_`` / ``coef_``, ``rho_``, ``support_`` and ``platt_`` where
    the model has them; a one-vs-one model keeps ``classes_`` and an
    ``"ovo"`` dict with its grouping order, index sets, per-pair Platt
    sigmoids and per-pair states. It reads attributes only, so it takes a
    model fitted by either package."""
    ovo = getattr(model, "_ovo", None)
    if ovo is not None:
        return {
            "classes_": np.asarray(model.classes_),
            "ovo": {
                "classes_": np.asarray(ovo.classes_),
                "idx_by_class_": [np.asarray(i, np.int64) for i in ovo.idx_by_class_],
                "pair_idx_": [np.asarray(i, np.int64) for i in ovo.pair_idx_],
                "platt_": [tuple(float(v) for v in p) for p in ovo.platt_],
                "models_": [numpy_state(m) for m in ovo.models_],
            },
        }
    state = {"rho_": float(model.rho_)}
    for key, dtype in (
        ("classes_", None), ("alpha_y_", np.float64), ("coef_", np.float64),
        ("support_", np.int64),
    ):
        if hasattr(model, key):
            state[key] = np.asarray(getattr(model, key), dtype)
    if getattr(model, "platt_", None) is not None:
        state["platt_"] = tuple(float(v) for v in model.platt_)
    return state


class _NumpyState:
    """``to_numpy_state`` / ``from_numpy_state`` for every model below."""

    def to_numpy_state(self) -> dict:
        """The fitted model as numpy values (``numpy_state``)."""
        return numpy_state(self)

    @classmethod
    def from_numpy_state(cls, state: dict, **params):
        """A fitted model from a ``numpy_state`` dict (of either package's
        model); ``params`` are the constructor's. A classifier whose state
        carries Platt sigmoids becomes a probability model."""
        fields = cls.__dataclass_fields__
        ovo = state.get("ovo")
        if "probability" in fields and "probability" not in params:
            params["probability"] = (
                bool(ovo["platt_"]) if ovo is not None else "platt_" in state
            )
        model = cls(**params)
        if ovo is None:
            for key, value in state.items():
                setattr(model, key, tuple(value) if key == "platt_" else value)
            return model
        from .ovo import OneVsOneSVC

        o = OneVsOneSVC(None, probability=bool(ovo["platt_"]), cv_folds=model.cv_folds)
        o.classes_ = list(ovo["classes_"])
        nc = len(o.classes_)
        o.idx_by_class_ = [np.asarray(i, np.int64) for i in ovo["idx_by_class_"]]
        o.pairs_ = [(i, j) for i in range(nc) for j in range(i + 1, nc)]
        o.pair_idx_ = [np.asarray(i, np.int64) for i in ovo["pair_idx_"]]
        o.platt_ = [tuple(p) for p in ovo["platt_"]]
        o.models_ = [cls.from_numpy_state(m) for m in ovo["models_"]]
        model._ovo = o
        model.classes_ = np.asarray(state["classes_"])
        model._proba_order = np.array([o.classes_.index(c) for c in model.classes_])
        return model


class _Classifier(_NumpyState):
    """Decision, prediction and probabilities of a fitted binary or
    one-vs-one classifier (``alpha_y_``, ``rho_``, ``classes_``,
    ``platt_``, ``_ovo``)."""

    def _fit_ovo(self, gram, y, classes, factory) -> None:
        from .ovo import OneVsOneSVC

        self._ovo = OneVsOneSVC(
            factory, probability=self.probability, cv_folds=self.cv_folds
        ).fit(gram, y)
        self.classes_ = classes
        self._proba_order = np.array([self._ovo.classes_.index(c) for c in classes])

    def decision_function(self, gram_rows) -> np.ndarray:
        """gram_rows: K[new, train]. Multiclass: [n, C(nc,2)] pair
        decisions in LIBSVM pair order."""
        if getattr(self, "_ovo", None) is not None:
            return self._ovo.decision_function(gram_rows)
        return _decision_values(gram_rows, self.alpha_y_, self.rho_)

    def predict(self, gram_rows) -> np.ndarray:
        if getattr(self, "_ovo", None) is not None:
            return self._ovo.predict(gram_rows)
        d = self.decision_function(gram_rows)
        return np.where(d > 0, self.classes_[1], self.classes_[0])

    def predict_proba(self, gram_rows) -> np.ndarray:
        if not self.probability:
            raise RuntimeError("fit with probability=True for predict_proba")
        if getattr(self, "_ovo", None) is not None:
            return self._ovo.predict_proba(gram_rows)[:, self._proba_order]
        A, B = self.platt_
        p = sigmoid_predict(self.decision_function(gram_rows), A, B)
        return np.stack([1.0 - p, p], axis=1)

    def score(self, gram_rows, y) -> float:
        return float(np.mean(self.predict(gram_rows) == np.asarray(y)))


# ----------------------------------------------------------------- models


@dataclass
class KernelSVC(_Classifier):
    """C-SVC on a precomputed kernel, with optional Platt probabilities.

    fit(gram, y): gram is K[train, train]. predict/decision take
    K[new, train] rows against the same training set. More than two
    classes train one-vs-one (svm.cpp:2163-2358).
    """

    C: float = 1.0
    eps: float = 1e-3
    probability: bool = False
    max_iter: int = 10_000_000
    class_weight: Optional[str] = None
    cv_folds: int = 5
    # Platt CV folds: False (default) reproduces the reference's
    # cold-start svm_binary_svc_probability folds (svm.cpp:1913-1999).
    # True warm-starts each fold from the full-problem optimum restricted
    # to the fold's rows — faster, but that optimum saw the held-out rows
    # (a mild calibration leak, bounded by the solver tolerance). Opt in
    # for speed only.
    platt_warm_start: bool = False

    def fit(self, gram, y) -> "KernelSVC":
        gram = _gram_f32(gram)
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) < 2:
            raise ValueError(f"need at least two classes; got {classes}")
        if len(classes) > 2:
            self._fit_ovo(gram, y, classes, lambda: KernelSVC(
                C=self.C, eps=self.eps, probability=False,
                max_iter=self.max_iter, class_weight=self.class_weight,
            ))
            return self
        self._ovo = None
        self.classes_ = classes
        y_signed = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)

        c_vec = self._box(y, classes)

        with span("fit.solve"):
            alpha, rho, iters = self._solve(gram, y_signed, c_vec)
        self.alpha_y_ = alpha * y_signed
        self.rho_ = float(rho)
        self.iters_ = int(iters)
        self.support_ = np.flatnonzero(alpha > 0)

        if self.probability:
            with span("fit.platt"):
                self._fit_platt(gram, y, y_signed, c_vec)
        return self

    def _solve(self, gram: torch.Tensor, y_signed, c_vec, alpha0=None):
        n = len(y_signed)
        dev = gram.device
        ys = torch.as_tensor(y_signed, device=dev)
        Q = gram * torch.outer(ys, ys)
        if alpha0 is None:
            alpha0 = np.zeros(n, np.float32)
        alpha, rho, iters = _solve_general(
            Q,
            ys,
            torch.as_tensor(c_vec, device=dev),
            -torch.ones(n, dtype=torch.float32, device=dev),
            torch.as_tensor(alpha0, dtype=torch.float32, device=dev),
            self.eps,
            _max_iter(self.max_iter, n),
        )
        return _to_host(alpha), float(rho), int(iters)

    def _box(self, y, classes) -> np.ndarray:
        """Per-row C: ``C``, times the class weight under ``balanced``."""
        if self.class_weight == "balanced":
            counts = np.array([(y == c).sum() for c in classes], dtype=np.float64)
            cw = len(y) / (2.0 * counts)
            c_vec = np.where(y == classes[1], cw[1], cw[0]) * self.C
        else:
            c_vec = np.full(len(y), self.C)
        return c_vec.astype(np.float32)

    def _fit_platt(self, gram: torch.Tensor, y, y_signed, c_vec):
        """Cross-validated decision values -> sigmoid (svm.cpp:1913-1999).

        This is the JAX package's device branch
        (``fastsk_tpu/svm/kernel_svm.py:_fit_platt``, ``:497-520``), used
        here for every device: each fold is solved ON THE FULL GRAM with
        the held-out rows' box collapsed to C_i = 0. A zero-box row can
        join neither I_up nor I_low (for y=+1, alpha < C reads 0 < 0; for
        y=-1, alpha > 0 reads 0 > 0), so it is inert and the solve IS the
        fold subproblem, under the same eps-KKT contract, with no O(n^2)
        fold-submatrix gathers. With ``platt_warm_start`` each fold starts
        from the full optimum repaired by ``_restrict_feasible``.
        """
        folds = stratified_kfold_indices(y, self.cv_folds)
        alpha_full = self.alpha_y_ * y_signed if self.platt_warm_start else None
        c_masks = np.tile(np.asarray(c_vec, np.float32), (len(folds), 1))
        for r, f in enumerate(folds):
            c_masks[r, f] = 0.0
        dec = self._fold_decisions(gram, y_signed, c_masks, folds, alpha_full)
        self.platt_ = sigmoid_train(dec, y_signed)

    def _fold_decisions(self, gram: torch.Tensor, y_signed, c_masks, folds, alpha_full=None):
        """Each row's decision value from the fold that holds it out (0 for
        a row of no fold). ``c_masks [len(folds), n]`` is each fold's box,
        0 on its held-out rows. The folds depend on nothing but
        ``alpha_full``, so they are one batched solve over one Q (one
        launch of kernel B on the card), each bit for bit the solve of that
        fold alone."""
        n = len(y_signed)
        dec = np.zeros(n, dtype=np.float64)
        if not folds:
            return dec
        dev = gram.device
        c_masks = np.asarray(c_masks, np.float32)
        a0 = np.zeros_like(c_masks)
        if alpha_full is not None:
            a0 = np.stack([_restrict_feasible(alpha_full, y_signed, c) for c in c_masks])
        ys = torch.as_tensor(y_signed, device=dev)
        C = torch.as_tensor(c_masks, device=dev)
        alpha, grad, _ = smo_solve(
            gram * torch.outer(ys, ys), ys, C,
            -torch.ones(n, dtype=torch.float32, device=dev),
            torch.as_tensor(a0, device=dev), self.eps, _max_iter(self.max_iter, n),
        )
        for r, f in enumerate(folds):
            a, rho = _finalize_rho(alpha[r], grad[r], ys, C[r])
            with full_f32_matmul():
                d = gram @ (a * ys)  # a is 0 on the held-out rows
            dec[f] = _to_host(d)[f] - float(rho)
        return dec

    def cv_platt(self, gram, y, cv_folds: int) -> tuple:
        """The Platt sigmoid of a two-class ``y`` on ``gram`` under this
        model's settings, from ``ovo.py:platt_cv_binary``'s folds (at most
        ``len(y)``; a fold whose training rows hold one class gives 0),
        each solved on the full ``gram`` with its held-out rows boxed at 0,
        all in one batched solve. Each fold's box is ``_box`` of its own
        training rows, as ``ovo.py:platt_cv_binary`` fits a fresh model on
        them (the class weights under ``balanced`` follow the fold's
        counts). One-vs-one C-SVC takes this instead of fitting each fold's
        sub-Gram."""
        gram = _gram_f32(gram)
        y = np.asarray(y)
        classes = np.unique(y)
        y_signed = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)
        folds = [
            f for f in stratified_kfold_indices(y, min(cv_folds, len(y)))
            if len(np.unique(np.delete(y, f))) == 2
        ]
        c_masks = np.zeros((len(folds), len(y)), np.float32)
        for r, f in enumerate(folds):
            tr = np.setdiff1d(np.arange(len(y)), f)
            c_masks[r, tr] = self._box(y[tr], classes)
        dec = self._fold_decisions(gram, y_signed, c_masks, folds)
        return sigmoid_train(dec, y_signed)


@dataclass
class NuSVC(_Classifier):
    """nu-SVC on a precomputed kernel (LIBSVM solve_nu_svc,
    svm.cpp:1496-1524: Solver_NU, kernel C on the card, then the dual
    rescaled by 1/r)."""

    nu: float = 0.5
    eps: float = 1e-3
    probability: bool = False
    max_iter: int = 10_000_000
    cv_folds: int = 5

    def fit(self, gram, y) -> "NuSVC":
        gram = _gram_f32(gram)
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) < 2:
            raise ValueError(f"need at least two classes; got {classes}")
        factory = lambda: NuSVC(nu=self.nu, eps=self.eps, max_iter=self.max_iter)  # noqa: E731
        if len(classes) > 2:
            self._fit_ovo(gram, y, classes, factory)
            return self
        self._ovo = None
        if self.probability:
            # the JAX package's form: sub-Gram folds through the generic
            # CV (not the C=0 full-Gram folds of KernelSVC)
            from .ovo import platt_cv_binary

            ys01 = np.where(y == classes[1], 1.0, -1.0)
            self.platt_ = platt_cv_binary(factory, gram, ys01, self.cv_folds)
        self.classes_ = classes
        ys = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)
        n = len(y)
        n_pos = int((ys > 0).sum())
        if self.nu * n / 2.0 > min(n_pos, n - n_pos):
            raise ValueError("nu is infeasible for this class balance")

        dev = gram.device
        ys_t = torch.as_tensor(ys, device=dev)
        alpha, rho, r, iters = _solve_nu(
            gram * torch.outer(ys_t, ys_t),
            ys_t,
            torch.ones(n, dtype=torch.float32, device=dev),
            torch.zeros(n, dtype=torch.float32, device=dev),
            torch.as_tensor(nu_svc_start(ys, self.nu), device=dev),
            self.eps,
            _max_iter(self.max_iter, n),
        )
        r = float(r)
        scale = 1.0 / r if r != 0 else 1.0
        alpha = _to_host(alpha)
        self.dual_ = alpha  # Solver_NU's alpha: each class sums to nu * n / 2
        self.alpha_y_ = alpha * ys * scale
        self.rho_ = float(rho) * scale
        self.iters_ = int(iters)
        self.support_ = np.flatnonzero(alpha > 0)
        return self


class _Regressor(_NumpyState):
    def predict(self, gram_rows) -> np.ndarray:
        return _decision_values(gram_rows, self.coef_, self.rho_)

    def score(self, gram_rows, y) -> float:
        from ..metrics import r2_score

        return r2_score(np.asarray(y, np.float64), self.predict(gram_rows))


@dataclass
class EpsilonSVR(_Regressor):
    """epsilon-SVR on a precomputed kernel (LIBSVM solve_epsilon_svr,
    svm.cpp:1560-1610: the 2n-variable dual, Solver::Solve — kernel B)."""

    C: float = 1.0
    epsilon: float = 0.1  # tube width (LIBSVM's -p)
    eps: float = 1e-3  # stopping tolerance
    max_iter: int = 10_000_000

    def fit(self, gram, y) -> "EpsilonSVR":
        gram = _gram_f32(gram)
        y = np.asarray(y, dtype=np.float32)
        n = len(y)
        dev = gram.device
        Q2, y2 = svr_dual(gram)
        p2 = np.concatenate([self.epsilon - y, self.epsilon + y]).astype(np.float32)
        alpha, rho, iters = _solve_general(
            Q2,
            y2,
            torch.full((2 * n,), self.C, dtype=torch.float32, device=dev),
            torch.as_tensor(p2, device=dev),
            torch.zeros(2 * n, dtype=torch.float32, device=dev),
            self.eps,
            _max_iter(self.max_iter, n),
        )
        del Q2
        alpha = _to_host(alpha)
        self.coef_ = alpha[:n] - alpha[n:]  # a - a*
        self.rho_ = float(rho)
        self.iters_ = int(iters)
        return self


@dataclass
class NuSVR(_Regressor):
    """nu-SVR on a precomputed kernel (LIBSVM solve_nu_svr,
    svm.cpp:1611-1655: the 2n-variable dual, Solver_NU — kernel C)."""

    C: float = 1.0
    nu: float = 0.5
    eps: float = 1e-3
    max_iter: int = 10_000_000

    def fit(self, gram, y) -> "NuSVR":
        gram = _gram_f32(gram)
        y = np.asarray(y, dtype=np.float32)
        n = len(y)
        dev = gram.device
        Q2, y2 = svr_dual(gram)
        p2 = np.concatenate([-y, y]).astype(np.float32)
        alpha, rho, r, iters = _solve_nu(
            Q2,
            y2,
            torch.full((2 * n,), self.C, dtype=torch.float32, device=dev),
            torch.as_tensor(p2, device=dev),
            torch.as_tensor(nu_svr_start(n, self.C, self.nu), device=dev),
            self.eps,
            _max_iter(self.max_iter, n, per_row=200),
        )
        del Q2
        alpha = _to_host(alpha)
        self.dual_ = alpha  # Solver_NU's alpha: each half sums to C * nu * n / 2
        self.coef_ = alpha[:n] - alpha[n:]
        self.rho_ = float(rho)
        self.iters_ = int(iters)
        return self


@dataclass
class OneClassSVM(_NumpyState):
    """One-class SVM on a precomputed kernel (LIBSVM solve_one_class,
    svm.cpp:1526-1558: bounds 1, sum(alpha) = nu * l, warm-started at the
    LIBSVM initial point; Solver::Solve — kernel B)."""

    nu: float = 0.5
    eps: float = 1e-3
    max_iter: int = 10_000_000

    def fit(self, gram) -> "OneClassSVM":
        gram = _gram_f32(gram).contiguous()
        n = gram.shape[0]
        dev = gram.device
        alpha0 = np.zeros(n, dtype=np.float32)
        budget = self.nu * n
        full = int(budget)
        alpha0[:full] = 1.0
        if full < n:
            alpha0[full] = budget - full
        ones = torch.ones(n, dtype=torch.float32, device=dev)
        alpha, rho, iters = _solve_general(
            gram,
            ones,
            ones,
            torch.zeros(n, dtype=torch.float32, device=dev),
            torch.as_tensor(alpha0, device=dev),
            self.eps,
            _max_iter(self.max_iter, n),
        )
        self.coef_ = _to_host(alpha)
        self.rho_ = float(rho)
        self.iters_ = int(iters)
        return self

    def decision_function(self, gram_rows) -> np.ndarray:
        return _decision_values(gram_rows, self.coef_, self.rho_)

    def predict(self, gram_rows) -> np.ndarray:
        return np.where(self.decision_function(gram_rows) > 0, 1, -1)


# ----------------------------------------------------------------- files


def save_svm_model(
    path: str, model, fmt: str = "npz", svm_type: str = "c_svc"
) -> None:
    """Persist a fitted model: ``npz`` (default; binary KernelSVC only) or
    the LIBSVM text format (``fmt="libsvm"``, svm.cpp:2672-2758; every
    solver type), in the JAX package's file layouts."""
    if fmt == "libsvm":
        from .libsvm_io import save_libsvm_model

        save_libsvm_model(path, model, svm_type)
        return
    if fmt != "npz":
        raise ValueError("fmt must be 'npz' or 'libsvm'")
    if getattr(model, "_ovo", None) is not None:
        raise ValueError("multiclass models persist via fmt='libsvm'")
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        kind=np.bytes_(b"kernel_svc"),
        alpha_y=model.alpha_y_,
        rho=np.float64(model.rho_),
        classes=model.classes_,
        C=np.float64(model.C),
        eps=np.float64(model.eps),
        probability=np.bool_(model.probability),
        platt=np.asarray(getattr(model, "platt_", (0.0, 0.0)), dtype=np.float64),
    )


def load_svm_model(path: str) -> KernelSVC:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        if z["kind"].item() != b"kernel_svc":
            raise ValueError(f"not a kernel_svc model file: {path}")
        model = KernelSVC(
            C=float(z["C"]), eps=float(z["eps"]), probability=bool(z["probability"])
        )
        model.alpha_y_ = z["alpha_y"]
        model.rho_ = float(z["rho"])
        model.classes_ = z["classes"]
        model.support_ = np.flatnonzero(model.alpha_y_ != 0)
        if model.probability:
            model.platt_ = tuple(z["platt"])
    return model
