"""Host-side encoding of ragged integer sequences into dense device layouts.

Copied from ``fastsk_tpu/ops/encode.py`` (numpy only): both packages take
the same ``EncodedSeqs`` object.

The TPU engine wants static shapes: a padded ``[N, Lmax]`` int32 matrix plus a
lengths vector. Windows that would cross a sequence's end are masked out of
the histogram, so padding never contributes counts — this reproduces the
reference's ragged g-mer extraction (shared.cpp:17-53: ``nfeat = sum
max(len - g + 1, 0)``) with dense shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass(frozen=True)
class EncodedSeqs:
    """Dense encoding of a sequence set.

    Attributes:
      ids: ``[N, Lmax]`` int32, vocabulary codes, zero padded.
      lengths: ``[N]`` int32 true lengths.
      n_train: number of leading rows that are training sequences.
      dict_size: hash base = |observed codes ∪ {0}| (fastsk.cpp:70-84).
    """

    ids: np.ndarray
    lengths: np.ndarray
    n_train: int
    dict_size: int
    # observed code range: hashing uses digits ``code - code_min`` in base
    # ``hash_base = code_max - code_min + 1``, which is injective on observed
    # g-mers and shrinks the bucket space vs the reference's dict_size base
    # (vocabulary code 0 is reserved-unknown and never appears in data read
    # through FastaUtility, so base 4 DNA stays base 4, not 6).
    code_min: int = 0
    code_max: int = 0

    @property
    def hash_base(self) -> int:
        return max(self.code_max - self.code_min + 1, 1)

    @property
    def n(self) -> int:
        return int(self.ids.shape[0])

    @property
    def n_test(self) -> int:
        return self.n - self.n_train

    @property
    def max_len(self) -> int:
        return int(self.ids.shape[1])

    def num_windows(self, g: int) -> np.ndarray:
        """Per-sequence count of valid g-mers, ``max(len - g + 1, 0)``."""
        return np.maximum(self.lengths - g + 1, 0)

    def nfeat(self, g: int) -> int:
        return int(self.num_windows(g).sum())


def encode_sequences(
    Xtrain: Sequence[Sequence[int]],
    Xtest: Sequence[Sequence[int]] | None = None,
    pad_multiple: int = 8,
) -> EncodedSeqs:
    """Pack train (+ optional test) sequences into one padded matrix.

    Train rows come first, then test rows, matching the reference's combined
    ``S`` array ordering (fastsk.cpp:68-83); the kernel matrix row order is
    therefore train-then-test as well. ``pad_multiple`` rounds ``Lmax`` up so
    downstream window counts land on friendlier lane sizes.
    """
    Xtest = Xtest if Xtest is not None else []
    seqs: List[np.ndarray] = [
        np.asarray(list(s), dtype=np.int32) for s in list(Xtrain) + list(Xtest)
    ]
    if not seqs:
        raise ValueError("no sequences provided")
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    lmax = int(lengths.max())
    lmax = ((lmax + pad_multiple - 1) // pad_multiple) * pad_multiple
    ids = np.zeros((len(seqs), lmax), dtype=np.int32)
    codes = {0}
    code_min, code_max = None, None
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        if len(s):
            lo, hi = int(s.min()), int(s.max())
            code_min = lo if code_min is None else min(code_min, lo)
            code_max = hi if code_max is None else max(code_max, hi)
        codes.update(np.unique(s).tolist())
    if code_min is None:
        code_min = code_max = 0
    if code_min < 0:
        raise ValueError(f"negative sequence codes are not supported (min={code_min})")
    return EncodedSeqs(
        ids=ids,
        lengths=lengths,
        n_train=len(list(Xtrain)),
        dict_size=len(codes),
        code_min=code_min,
        code_max=code_max,
    )


def validate_g(enc: EncodedSeqs, g: int, m: int) -> None:
    """Enforce the reference's hard constraints (shared.cpp:380-412)."""
    if g <= m:
        raise ValueError(f"g must be greater than m (g={g}, m={m})")
    if g > 20:
        raise ValueError(f"g must be at most 20 (g={g})")
    shortest_train = int(enc.lengths[: enc.n_train].min())
    if g > shortest_train:
        raise ValueError(
            "g cannot be longer than the shortest sequence: "
            f"g={g}, shortest train sequence length={shortest_train}"
        )
    if enc.n_test:
        shortest_test = int(enc.lengths[enc.n_train :].min())
        if g > shortest_test:
            raise ValueError(
                "g cannot be longer than the shortest sequence: "
                f"g={g}, shortest test sequence length={shortest_test}"
            )
