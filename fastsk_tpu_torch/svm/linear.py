"""Deterministic stratified folds for the Platt cross-validation.

Copied from ``fastsk_tpu/svm/linear.py:stratified_kfold_indices`` (numpy
only). The linear SVMs of that module are not ported yet (ROADMAP.md
slice 4).
"""

from __future__ import annotations

from typing import List

import numpy as np


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
