"""The inputs a run hands to the program and to the reference alike."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Data:
    Xtr: List[List[int]]  # integer-coded training sequences (codes 1..alpha)
    Xte: List[List[int]]
    ytr: np.ndarray  # 0/1 labels
    yte: np.ndarray
    alpha: int  # letters in the configuration's alphabet

    def windows(self, g: int) -> int:
        """g-mer windows of all sequences, train and test."""
        return sum(max(len(s) - g + 1, 0) for s in self.Xtr + self.Xte)

    @property
    def n(self) -> int:
        return len(self.Xtr) + len(self.Xte)
