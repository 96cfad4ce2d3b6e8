"""Seeded ragged sequences of a fixed shape (the protein set 2.19's).

``ragged_set`` is a frozen copy of the bring-up check's generator: codes
1..alpha, lengths uniform in [lmin, lmax], 0/1 labels, a positive carrying
one copy of the motif with 0-3 substitutions. The shape (every length and
the number of positives) is that of ``ragged_set(shape_seed, n, lmin,
lmax)``; each ``--seed`` deals those lengths and labels in another order
and draws new letters and motif copies, so every seed has the same
windows and the same work. The first ``train_share`` of the dealt
sequences train, the rest test.
"""

from __future__ import annotations

import numpy as np

from gkmbench.data_types import Data


def ragged_set(seed: int, n: int, lmin: int, lmax: int, alpha: int, motif):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n)
    X = []
    for label in y:
        s = rng.integers(1, alpha + 1, size=int(rng.integers(lmin, lmax + 1)))
        if label:
            m = np.array(motif)
            subs = rng.choice(8, size=int(rng.integers(0, 4)), replace=False)
            m[subs] = rng.integers(1, alpha + 1, size=len(subs))
            at = int(rng.integers(0, len(s) - 8 + 1))
            s[at : at + 8] = m
        X.append(s.tolist())
    return X, y


def dealt_set(seed: int, lengths, labels, alpha: int, motif):
    """Sequences of the given lengths and labels, dealt in a seeded order,
    with seeded letters and motif copies (``ragged_set``'s planting)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(lengths))
    X, y = [], np.asarray(labels)[order]
    for i in order:
        s = rng.integers(1, alpha + 1, size=int(lengths[i]))
        if labels[i]:
            m = np.array(motif)
            subs = rng.choice(len(m), size=int(rng.integers(0, 4)), replace=False)
            m[subs] = rng.integers(1, alpha + 1, size=len(subs))
            at = int(rng.integers(0, len(s) - len(m) + 1))
            s[at : at + len(m)] = m
        X.append(s.tolist())
    return X, y


def load(config: dict, seed: int, here: str) -> Data:
    d = config["data"]
    shape_X, shape_y = ragged_set(d["shape_seed"], d["n"], d["lmin"], d["lmax"], d["alpha"], d["motif"])
    X, y = dealt_set(seed, [len(s) for s in shape_X], shape_y, d["alpha"], d["motif"])
    n_tr = int(d["train_share"] * len(X))
    return Data(X[:n_tr], X[n_tr:], y[:n_tr], y[n_tr:], alpha=d["alpha"])
