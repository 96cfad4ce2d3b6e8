"""A labelled FASTA set in its published split, dealt in a seeded order.

The configuration's ``data`` names the positive and negative files of each
side (relative to the benchmark's folder). Each seed shuffles the order of
the sequences within the training side and within the test side: the same
sequences and the same work every seed, as the benchmark asks. Letters are
coded 1..alpha in the order of the configuration's ``alphabet``.
"""

from __future__ import annotations

import os

import numpy as np

from gkmbench.data_types import Data


def read_fasta(path: str):
    """The sequences of a FASTA file, lower case, headers dropped."""
    with open(path) as f:
        return [line.strip().lower() for line in f if line.strip() and not line.startswith(">")]


def load(config: dict, seed: int, here: str) -> Data:
    code = {c: i + 1 for i, c in enumerate(config["alphabet"])}
    rng = np.random.default_rng(seed)
    sides = []
    for side in ("train", "test"):
        X, y = [], []
        for label, part in ((1, "pos"), (0, "neg")):
            for name in config["data"][side][part]:
                seqs = read_fasta(os.path.join(here, name))
                X += [[code[c] for c in s] for s in seqs]
                y += [label] * len(seqs)
        order = rng.permutation(len(X))
        sides.append(([X[i] for i in order], np.asarray(y)[order]))
    (Xtr, ytr), (Xte, yte) = sides
    return Data(Xtr, Xte, ytr, yte, alpha=len(config["alphabet"]))
