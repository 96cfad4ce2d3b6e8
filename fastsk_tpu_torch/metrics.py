"""Classification metrics.

Copied from ``fastsk_tpu/metrics.py`` (numpy only).

Includes both the reference's strict pairwise AUROC (shared.cpp:414-426 —
ties between a positive and negative score earn zero credit) and the standard
Mann-Whitney AUROC with 0.5 tie credit (equivalent to sklearn's
roc_auc_score), since the published workflow scored with the latter
(test/run_check.py:61) while FastSK::score used the former.
"""

from __future__ import annotations

import numpy as np


def _binarize(y_true: np.ndarray) -> np.ndarray:
    """Positive class is label > 0 (labels live in {-1, 0, 1})."""
    return np.asarray(y_true) > 0


def auc_pairwise(y_true, scores) -> float:
    """Reference parity AUROC: fraction of (pos, neg) pairs with
    score_pos > score_neg; ties count as incorrect (shared.cpp:414-426)."""
    pos_mask = _binarize(y_true)
    scores = np.asarray(scores, dtype=np.float64)
    pos = np.sort(scores[pos_mask])
    neg = np.sort(scores[~pos_mask])
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    # For each positive, count negatives strictly below it.
    correct = np.searchsorted(neg, pos, side="left").sum()
    return float(correct) / (len(pos) * len(neg))


def roc_auc(y_true, scores) -> float:
    """Standard AUROC (ties get half credit); matches sklearn roc_auc_score."""
    pos_mask = _binarize(y_true)
    scores = np.asarray(scores, dtype=np.float64)
    pos = scores[pos_mask]
    neg = np.sort(scores[~pos_mask])
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    below = np.searchsorted(neg, pos, side="left")
    below_or_eq = np.searchsorted(neg, pos, side="right")
    return float((below + 0.5 * (below_or_eq - below)).sum()) / (
        len(pos) * len(neg)
    )


def accuracy_score(y_true, y_pred) -> float:
    y_true = _binarize(y_true)
    y_pred = _binarize(y_pred)
    return float(np.mean(y_true == y_pred))


def confusion_rates(y_true, y_pred) -> dict:
    """TPR/TNR/FNR/FPR as printed by FastSK::score (fastsk.cpp:508-521)."""
    t = _binarize(y_true)
    p = _binarize(y_pred)
    npos = int(t.sum())
    nneg = int((~t).sum())
    tp = int((t & p).sum())
    tn = int((~t & ~p).sum())
    return {
        "tpr": tp / npos if npos else float("nan"),
        "tnr": tn / nneg if nneg else float("nan"),
        "fnr": (npos - tp) / npos if npos else float("nan"),
        "fpr": (nneg - tn) / nneg if nneg else float("nan"),
    }


def precision_recall_f1(y_true, y_pred) -> dict:
    """Precision / recall / F1 / balanced accuracy (eval.cpp metric set)."""
    t = _binarize(y_true)
    p = _binarize(y_pred)
    tp = int((t & p).sum())
    fp = int((~t & p).sum())
    fn = int((t & ~p).sum())
    tn = int((~t & ~p).sum())
    precision = tp / (tp + fp) if (tp + fp) else 0.0
    recall = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if (precision + recall)
        else 0.0
    )
    tnr = tn / (tn + fp) if (tn + fp) else 0.0
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "balanced_accuracy": 0.5 * (recall + tnr),
    }


def r2_score(y_true, y_pred) -> float:
    """Coefficient of determination (regression parity, old_utils.py:452-499)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    return float(1.0 - ss_res / ss_tot) if ss_tot else 0.0


def balanced_accuracy(y_true, y_pred) -> float:
    """BAC = (TPR + TNR) / 2 (eval.cpp's bac metric)."""
    rates = confusion_rates(y_true, y_pred)
    return 0.5 * (rates["tpr"] + rates["tnr"])


def average_precision(y_true, scores) -> float:
    """Area under the precision-recall curve (step interpolation, the
    eval.cpp ap_score semantics)."""
    y = _binarize(np.asarray(y_true))
    s = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-s, kind="stable")
    y = y[order]
    tp = np.cumsum(y == 1)
    fp = np.cumsum(y != 1)
    n_pos = int((y == 1).sum())
    if n_pos == 0:
        return 0.0
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / n_pos
    # sum precision at each new positive (step-wise AP)
    d_recall = np.diff(np.concatenate([[0.0], recall]))
    return float(np.sum(precision * d_recall))


def binary_class_cross_validation(
    gram: np.ndarray, y, n_folds: int = 5, C: float = 1.0, eps: float = 1e-3
) -> dict:
    """Stratified k-fold CV of the kernel C-SVC on a precomputed Gram
    matrix, reporting pooled decision-value metrics — the equivalent of
    eval.cpp:273+ (binary_class_cross_validation driving svm_train +
    svm_predict_values)."""
    from .svm.kernel_svm import KernelSVC
    from .svm.linear import stratified_kfold_indices

    gram = np.asarray(gram, dtype=np.float64)
    y = np.asarray(y)
    folds = stratified_kfold_indices(y, n_folds)
    n = len(y)
    dec = np.zeros(n)
    pred = np.zeros(n, dtype=y.dtype)
    for f in folds:
        tr = np.setdiff1d(np.arange(n), f)
        model = KernelSVC(C=C, eps=eps).fit(gram[np.ix_(tr, tr)], y[tr])
        dec[f] = model.decision_function(gram[np.ix_(f, tr)])
        pred[f] = model.predict(gram[np.ix_(f, tr)])
    out = {
        "auc": roc_auc(y, dec),
        "accuracy": accuracy_score(y, pred),
        "bac": balanced_accuracy(y, pred),
        "ap": average_precision(y, dec),
    }
    out.update(precision_recall_f1(y, pred))
    return out
