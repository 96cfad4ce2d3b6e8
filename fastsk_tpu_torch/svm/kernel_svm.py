"""Binary kernel C-SVC on a precomputed Gram matrix, in PyTorch.

Counterpart of ``fastsk_tpu/svm/kernel_svm.py:KernelSVC`` (binary case).
The solver is LIBSVM's Solver::Solve problem

    min 0.5 a^T Q a - e^T a,  0 <= a_i <= C_i,  y^T a = 0,
    Q_ij = y_i y_j K_ij

with second-order working-set selection and the ``gmax + gmax2 < eps``
stop (svm/smo_cuda.py: kernel B on the card, its plain twin on the CPU),
then the f32 bound snap and rho. Probability estimates use Platt scaling
on 5-fold cross-validated decision values.

A Gram given as a numpy array is solved on the CPU; a torch tensor is
solved where it lies, so a CUDA Gram never leaves the card and only O(n)
results come back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.pairs import full_f32_matmul
from .linear import stratified_kfold_indices
from .platt import sigmoid_predict, sigmoid_train
from .smo_cuda import _NEG_INF, initial_state, smo_loop_plain, smo_solve


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


def _snap_bounds(alpha: torch.Tensor, C_vec: torch.Tensor) -> torch.Tensor:
    """Clamp alphas within 1e-6*C of a bound exactly onto it (f32 pair
    updates leave machine-epsilon residues where LIBSVM's doubles are
    exact; the rho free-SV average must agree on the active set)."""
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


@dataclass
class KernelSVC:
    """C-SVC on a precomputed kernel, with optional Platt probabilities.

    fit(gram, y): gram is K[train, train]. predict/decision take
    K[new, train] rows against the same training set.
    """

    C: float = 1.0
    eps: float = 1e-3
    probability: bool = False
    max_iter: int = 10_000_000
    cv_folds: int = 5

    def fit(self, gram, y) -> "KernelSVC":
        gram = _gram_f32(gram)
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) < 2:
            raise ValueError(f"need at least two classes; got {classes}")
        if len(classes) > 2:
            raise NotImplementedError(
                "multiclass (one-vs-one) SVC is not ported yet: ROADMAP.md "
                "slice 4, the rest of the SVM family"
            )
        self.classes_ = classes
        y_signed = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)
        c_vec = np.full(len(y), self.C, dtype=np.float32)

        alpha, rho, iters = self._solve(gram, y_signed, c_vec)
        self.alpha_y_ = alpha * y_signed
        self.rho_ = float(rho)
        self.iters_ = int(iters)
        self.support_ = np.flatnonzero(alpha > 0)

        if self.probability:
            self._fit_platt(gram, y, y_signed, c_vec)
        return self

    def _solve(self, gram: torch.Tensor, y_signed, c_vec):
        max_iter = min(self.max_iter, max(10_000_000, 100 * len(y_signed)))
        n = len(y_signed)
        dev = gram.device
        ys = torch.as_tensor(y_signed, device=dev)
        Q = gram * torch.outer(ys, ys)
        alpha, rho, iters = _solve_general(
            Q,
            ys,
            torch.as_tensor(c_vec, device=dev),
            -torch.ones(n, dtype=torch.float32, device=dev),
            torch.zeros(n, dtype=torch.float32, device=dev),
            self.eps,
            max_iter,
        )
        return alpha.cpu().numpy().astype(np.float64), float(rho), int(iters)

    def _fit_platt(self, gram: torch.Tensor, y, y_signed, c_vec):
        """Cross-validated decision values -> sigmoid (svm.cpp:1913-1999).

        This is the JAX package's device branch
        (``fastsk_tpu/svm/kernel_svm.py:_fit_platt``, ``:497-520``), used
        here for every device: each fold is solved ON THE FULL GRAM with
        the held-out rows' box collapsed to C_i = 0. A zero-box row can
        join neither I_up nor I_low (for y=+1, alpha < C reads 0 < 0; for
        y=-1, alpha > 0 reads 0 > 0), so it is inert and the solve IS the
        fold subproblem, under the same eps-KKT contract, with no O(n^2)
        fold-submatrix gathers.
        """
        folds = stratified_kfold_indices(y, self.cv_folds)
        n = len(y)
        dec = np.zeros(n, dtype=np.float64)
        for f in folds:
            c_mask = np.asarray(c_vec, np.float32).copy()
            c_mask[f] = 0.0
            a, rho, _ = self._solve(gram, y_signed, c_mask)
            coef = torch.as_tensor(a * y_signed, dtype=torch.float32, device=gram.device)
            with full_f32_matmul():
                d = gram @ coef  # coef is 0 on the held-out rows
            dec[f] = d.cpu().numpy().astype(np.float64)[f] - rho
        self.platt_ = sigmoid_train(dec, y_signed)

    def decision_function(self, gram_rows) -> np.ndarray:
        """gram_rows: K[new, train]."""
        return _decision_values(gram_rows, self.alpha_y_, self.rho_)

    def predict(self, gram_rows) -> np.ndarray:
        d = self.decision_function(gram_rows)
        return np.where(d > 0, self.classes_[1], self.classes_[0])

    def predict_proba(self, gram_rows) -> np.ndarray:
        if not self.probability:
            raise RuntimeError("fit with probability=True for predict_proba")
        A, B = self.platt_
        p = sigmoid_predict(self.decision_function(gram_rows), A, B)
        return np.stack([1.0 - p, p], axis=1)

    def score(self, gram_rows, y) -> float:
        return float(np.mean(self.predict(gram_rows) == np.asarray(y)))

    # ------------------------------------------------------------ state

    def to_numpy_state(self) -> dict:
        """The fitted model as numpy values (no tensors): ``classes_``,
        ``alpha_y_``, ``rho_``, ``support_`` and, when fitted with
        probability, ``platt_``. The JAX package's KernelSVC carries the
        same attributes, so a model moves between the packages through
        this dict."""
        state = {
            "classes_": np.asarray(self.classes_),
            "alpha_y_": np.asarray(self.alpha_y_, np.float64),
            "rho_": float(self.rho_),
            "support_": np.asarray(self.support_, np.int64),
        }
        if hasattr(self, "platt_"):
            state["platt_"] = tuple(float(v) for v in self.platt_)
        return state

    @classmethod
    def from_numpy_state(
        cls, state: dict, C: float = 1.0, eps: float = 1e-3
    ) -> "KernelSVC":
        """A fitted model from ``to_numpy_state``'s dict (``platt_`` present
        makes it a probability model)."""
        model = cls(C=C, eps=eps, probability="platt_" in state)
        model.classes_ = np.asarray(state["classes_"])
        model.alpha_y_ = np.asarray(state["alpha_y_"], np.float64)
        model.rho_ = float(state["rho_"])
        model.support_ = np.asarray(state["support_"], np.int64)
        if "platt_" in state:
            model.platt_ = tuple(float(v) for v in state["platt_"])
        return model
