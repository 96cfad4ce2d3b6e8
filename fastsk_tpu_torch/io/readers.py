"""Extra dataset readers mirrored from the reference's runner library.

Copied from ``fastsk_tpu/io/readers.py`` (framework-free), on the port's
``Vocabulary``.

- ArabicUtility: MADAR Arabic-dialect TSV (sequence<TAB>3-letter city
  code), six-city subset (test/utils.py:307-369).
- DslUtility: generic sequence<TAB>label TSV (test/utils.py:371-391).

Both lower tokens through the shared Vocabulary (0 reserved-unknown) and
map string labels to dense class ids via a second Vocabulary, exactly as
the reference does (labels therefore start at 1).
"""

from __future__ import annotations

from typing import List, Tuple

from .fasta import Vocabulary


class ArabicUtility:
    LABELS_TO_USE = ["RAB", "BEI", "DOH", "CAI", "TUN", "MSA"]
    MIN_LEN = 10

    def __init__(self, vocab: Vocabulary | None = None):
        self._vocab = Vocabulary() if vocab is None else vocab
        self._classes = Vocabulary()

    @property
    def vocab(self) -> Vocabulary:
        return self._vocab

    @property
    def classes(self) -> Vocabulary:
        return self._classes

    def read_data(self, data_file: str) -> Tuple[List[List[int]], List[int]]:
        X, Y = [], []
        with open(data_file, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                seq, label = line.split("\t")
                if len(label) != 3:
                    raise ValueError(f"expected 3-letter city code, got {label!r}")
                if label not in self.LABELS_TO_USE:
                    continue
                if len(seq) < self.MIN_LEN:
                    continue
                X.append([self._vocab.add(tok) for tok in seq])
                Y.append(self._classes.add(label))
        return X, Y


class DslUtility:
    MIN_LEN = 10

    def __init__(self, vocab: Vocabulary | None = None):
        self._vocab = Vocabulary() if vocab is None else vocab
        self._classes = Vocabulary()

    @property
    def vocab(self) -> Vocabulary:
        return self._vocab

    @property
    def classes(self) -> Vocabulary:
        return self._classes

    def read_data(self, data_file: str) -> Tuple[List[List[int]], List[int]]:
        X, Y = [], []
        with open(data_file, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                seq, label = line.split("\t")
                if len(seq) < self.MIN_LEN:
                    continue
                X.append([self._vocab.add(tok) for tok in seq])
                Y.append(self._classes.add(label))
        return X, Y
