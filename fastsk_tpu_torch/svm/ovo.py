"""One-vs-one multiclass SVM on a precomputed kernel.

Counterpart of ``fastsk_tpu/svm/ovo.py``: LIBSVM's multiclass machinery
on top of the binary solvers of ``svm/kernel_svm.py``. Class grouping in
first-occurrence order with the -1/+1 swap quirk (svm.cpp:2034-2110),
C(nc, 2) one-vs-one binary problems (svm.cpp:2198-2249), voting
prediction (svm.cpp:2563-2594), per-pair Platt sigmoids on
cross-validated decision values (svm_binary_svc_probability,
svm.cpp:1913-1999, with deterministic folds), and the pairwise-coupling
solve for multiclass probabilities (multiclass_probability,
svm.cpp:1840-1911). ``group_labels`` and ``multiclass_probability`` are
numpy and copied.

A Gram given as a tensor stays on its device: the sub-Grams of the pairs
and folds are gathered there (``take_block``), so a CUDA Gram is solved
by the kernels on the card; a host Gram is coerced to f64 numpy.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from .linear import stratified_kfold_indices
from .platt import sigmoid_predict, sigmoid_train


def _as_host_or_device(gram, dtype=np.float64):
    """Tensors pass through untouched (the gathers below run on their
    device and the binary solvers are device-aware); host inputs are
    coerced to numpy."""
    if isinstance(gram, torch.Tensor):
        return gram
    return np.asarray(gram, dtype=dtype)


def take_block(gram, rows, cols):
    """``gram[np.ix_(rows, cols)]`` for a numpy array, or the same block of
    a tensor gathered on its device."""
    if isinstance(gram, torch.Tensor):
        r = torch.as_tensor(np.asarray(rows), dtype=torch.long, device=gram.device)
        c = torch.as_tensor(np.asarray(cols), dtype=torch.long, device=gram.device)
        return gram.index_select(0, r).index_select(1, c)
    return gram[np.ix_(rows, cols)]


def group_labels(y: Sequence) -> List:
    """Class labels in first-occurrence order, with LIBSVM's special case:
    a {-1, +1} problem where -1 appears first is reordered to [+1, -1] so
    the internal positive class is the +1 instances (svm.cpp:2073-2086)."""
    labels: List = []
    for v in y:
        if v not in labels:
            labels.append(v)
    if len(labels) == 2 and labels[0] == -1 and labels[1] == 1:
        labels = [1, -1]
    return labels


def multiclass_probability(r: np.ndarray) -> np.ndarray:
    """Pairwise coupling: solve for p given r[i, j] ~= p_i / (p_i + p_j).

    The iteration is LIBSVM's multiclass_probability (svm.cpp:1840-1911):
    minimize sum_i sum_{j != i} (r[j, i] p_i - r[i, j] p_j)^2 over the
    simplex, via the fixed-point update with renormalization.
    """
    k = r.shape[0]
    p = np.full(k, 1.0 / k)
    Q = np.zeros((k, k))
    for t in range(k):
        for j in range(k):
            if j < t:
                Q[t, t] += r[j, t] ** 2
                Q[t, j] = Q[j, t]
            elif j > t:
                Q[t, t] += r[j, t] ** 2
                Q[t, j] = -r[j, t] * r[t, j]
    eps = 0.005 / k
    max_iter = max(100, k)
    for _ in range(max_iter):
        Qp = Q @ p
        pQp = p @ Qp
        if np.max(np.abs(Qp - pQp)) < eps:
            break
        for t in range(k):
            diff = (-Qp[t] + pQp) / Q[t, t]
            p[t] += diff
            pQp = (pQp + diff * (diff * Q[t, t] + 2 * Qp[t])) / (1 + diff) ** 2
            Qp = (Qp + diff * Q[t]) / (1 + diff)
            p /= 1 + diff
    return p


def platt_cv_binary(
    factory: Callable, gram, ys: np.ndarray, cv_folds: int = 5
) -> tuple:
    """Sigmoid (A, B) from cross-validated decision values of a binary
    solver (svm_binary_svc_probability, svm.cpp:1913-1999 — deterministic
    stratified folds instead of rand()). Each fold fits on its own
    sub-Gram."""
    folds = stratified_kfold_indices(ys, min(cv_folds, len(ys)))
    n = len(ys)
    dec = np.zeros(n)
    all_idx = np.arange(n)
    for f in folds:
        tr = np.setdiff1d(all_idx, f)
        if len(np.unique(ys[tr])) < 2:
            dec[f] = 0.0
            continue
        m = factory().fit(take_block(gram, tr, tr), ys[tr])
        dec[f] = m.decision_function(take_block(gram, f, tr))
    return sigmoid_train(dec, ys)


class OneVsOneSVC:
    """OvO wrapper over a binary precomputed-kernel solver factory.

    ``binary_factory()`` must return an object with ``fit(gram, y)`` (y in
    {-1, +1}) and ``decision_function(gram_rows)`` — KernelSVC and NuSVC
    both qualify. Pair (i, j) trains with class i as +1, exactly like
    svm_train's sub-problem construction (svm.cpp:2216-2230).
    """

    MIN_PROB = 1e-7  # LIBSVM's clamp in svm_predict_probability

    def __init__(
        self,
        binary_factory: Callable,
        probability: bool = False,
        cv_folds: int = 5,
    ):
        self.binary_factory = binary_factory
        self.probability = probability
        self.cv_folds = cv_folds

    def fit(self, gram, y) -> "OneVsOneSVC":
        gram = _as_host_or_device(gram)
        y = np.asarray(y)
        self.classes_ = group_labels(y)
        nc = len(self.classes_)
        if nc < 2:
            raise ValueError("need at least two classes")
        idx_by_class = [np.flatnonzero(y == c) for c in self.classes_]
        self.idx_by_class_ = idx_by_class

        self.pairs_: List[tuple] = []
        self.models_: List = []
        self.pair_idx_: List[np.ndarray] = []
        self.platt_: List[tuple] = []
        for i in range(nc):
            for j in range(i + 1, nc):
                idx = np.concatenate([idx_by_class[i], idx_by_class[j]])
                ys = np.concatenate(
                    [
                        np.ones(len(idx_by_class[i])),
                        -np.ones(len(idx_by_class[j])),
                    ]
                )
                sub = take_block(gram, idx, idx)
                model = self.binary_factory().fit(sub, ys)
                if self.probability:
                    # C-SVC solves its folds in one batch on the pair's
                    # Gram (KernelSVC.cv_platt); nu-SVC on fold sub-Grams
                    self.platt_.append(
                        model.cv_platt(sub, ys, self.cv_folds)
                        if hasattr(model, "cv_platt")
                        else platt_cv_binary(self.binary_factory, sub, ys, self.cv_folds)
                    )
                self.pairs_.append((i, j))
                self.models_.append(model)
                self.pair_idx_.append(idx)
        return self

    def decision_function(self, gram_rows) -> np.ndarray:
        """Per-pair decision values ``[n, C(nc, 2)]`` in LIBSVM pair
        order ((0,1), (0,2), ..., (1,2), ...)."""
        gram_rows = _as_host_or_device(gram_rows)
        all_rows = np.arange(gram_rows.shape[0])
        cols = [
            m.decision_function(take_block(gram_rows, all_rows, idx))
            for m, idx in zip(self.models_, self.pair_idx_)
        ]
        return np.stack(cols, axis=1)

    def predict(self, gram_rows) -> np.ndarray:
        """Majority vote; ties resolve to the earliest class in grouping
        order, matching svm_predict's argmax scan (svm.cpp:2590-2594)."""
        dec = self.decision_function(gram_rows)
        n = dec.shape[0]
        nc = len(self.classes_)
        votes = np.zeros((n, nc), dtype=np.int64)
        for p, (i, j) in enumerate(self.pairs_):
            win_i = dec[:, p] > 0
            votes[win_i, i] += 1
            votes[~win_i, j] += 1
        out = np.asarray(self.classes_, dtype=object)[np.argmax(votes, axis=1)]
        try:
            return out.astype(np.asarray(self.classes_).dtype)
        except (TypeError, ValueError):
            return out

    def predict_proba(self, gram_rows) -> np.ndarray:
        """Class probabilities via per-pair sigmoids + pairwise coupling
        (svm_predict_probability, svm.cpp:2617-2660). Columns follow
        ``self.classes_`` order."""
        if not self.probability:
            raise RuntimeError("fit with probability=True for predict_proba")
        dec = self.decision_function(gram_rows)
        n = dec.shape[0]
        nc = len(self.classes_)
        out = np.zeros((n, nc))
        lo, hi = self.MIN_PROB, 1.0 - self.MIN_PROB
        for row in range(n):
            r = np.zeros((nc, nc))
            for p, (i, j) in enumerate(self.pairs_):
                A, B = self.platt_[p]
                pr = float(np.clip(sigmoid_predict(dec[row, p], A, B), lo, hi))
                r[i, j] = pr
                r[j, i] = 1.0 - pr
            out[row] = multiclass_probability(r)
        return out
