"""FASTA-like sequence reading and vocabulary handling.

Copied from ``fastsk_tpu/io/fasta.py`` (framework-free; importing it from
there would pull in jax through ``fastsk_tpu/__init__.py``).

Behavioral parity with the reference Python data layer
(the original FastSK's ``src/fastsk/utils.py:5-104``): a ``Vocabulary`` maps tokens
to integer ids with id 0 reserved for "unknown", and ``FastaUtility.read_data``
parses the alternating ``>label`` / sequence format, lowercasing lines and
restricting classification labels to {-1, 0, 1}.

This module is pure host-side Python/numpy; device encoding lives in
``fastsk_tpu_torch.ops.encode``. A fast C++ parser with the same semantics
is available in ``fastsk_tpu_torch.native`` and used automatically when
built.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

Label = Union[int, str]


class Vocabulary:
    """Token -> integer-id map with index 0 reserved for the unknown token.

    Mirrors the reference vocabulary semantics (utils.py:11-14): the map is
    seeded with ``{0: 0}`` so real tokens receive ids starting at 1 and the
    vocabulary size always counts the reserved slot.
    """

    def __init__(self) -> None:
        self._token2idx: Dict[object, int] = {0: 0}
        self._size = len(self._token2idx)

    def add(self, token: object) -> int:
        """Return the id for ``token``, inserting it if unseen."""
        if token not in self._token2idx:
            self._token2idx[token] = self._size
            self._size += 1
        return self._token2idx[token]

    def get(self, token: object, default: int = 0) -> int:
        """Look up a token without inserting; unknown tokens map to 0."""
        return self._token2idx.get(token, default)

    def size(self) -> int:
        return self._size

    def __len__(self) -> int:
        return self._size

    def __contains__(self, token: object) -> bool:
        return token in self._token2idx

    def __str__(self) -> str:
        return str(self._token2idx)

    @classmethod
    def from_dictionary_file(cls, path: str) -> "Vocabulary":
        """Build a vocabulary from a whitespace/newline separated token file.

        Supports the reference's ``data/*.dictionary.txt`` files so encodings
        can be pinned across datasets instead of inferred.
        """
        vocab = cls()
        with open(path, "r") as f:
            for line in f:
                for token in line.strip().lower().split():
                    vocab.add(token)
        return vocab


class FastaUtility:
    """Reader for the FASTA-like alternating label/sequence format.

    Format (reference ``docs/1start/data_in_out.md``)::

        >1
        ACGTACGT
        >0
        TTTTACGT

    Labels are integers in {-1, 0, 1} for classification, or raw strings when
    ``regression=True``. Sequences are lowercased and encoded per-character
    through the shared :class:`Vocabulary`.
    """

    def __init__(
        self, vocab: Vocabulary | None = None, use_native: bool = True
    ) -> None:
        self._vocab = Vocabulary() if vocab is None else vocab
        self._use_native = use_native
        self._native_reader = None

    @property
    def vocab(self) -> Vocabulary:
        return self._vocab

    def _try_native(self, data_file: str):
        """Read via the C++ parser when possible (ASCII classification data
        with a single-ASCII-char vocabulary); returns None to fall back."""
        if not self._use_native:
            return None
        try:
            from ..native import loader
        except ImportError:
            return None
        if not loader.available():
            return None
        if self._native_reader is None:
            reader = loader.NativeFastaReader()
            # seed the byte table from any pre-populated vocabulary
            for token, code in self._vocab._token2idx.items():
                if token == 0:
                    continue
                if not (isinstance(token, str) and len(token) == 1 and ord(token) < 128):
                    return None  # multi-char/unicode vocab: Python path
                reader._vocab[ord(token)] = code
            reader._next.value = self._vocab.size()
            self._native_reader = reader
        try:
            X, Y = self._native_reader.read_data(data_file)
        except ValueError:
            return None  # non-ASCII or malformed: let the Python path report
        # sync newly discovered tokens back into the shared Vocabulary
        for ch, code in sorted(
            self._native_reader.vocab_items().items(), key=lambda kv: kv[1]
        ):
            self._vocab._token2idx.setdefault(ch, code)
        self._vocab._size = self._native_reader.vocab_size
        return X, Y

    def read_data(
        self,
        data_file: str,
        vocab: str = "inferred",
        regression: bool = False,
        multiclass: bool = False,
    ) -> Tuple[List[List[int]], List[Label]]:
        """Read a FASTA-like file into integer-encoded sequences and labels.

        Returns ``(X, Y)`` where ``X`` is a list of per-character id lists and
        ``Y`` the label list. Repeated calls with the same utility share one
        vocabulary, which is how train/test files get a consistent encoding.

        ``multiclass=True`` lifts the reference's {-1, 0, 1} label
        restriction (utils.py:78-82) to any integer label — the format the
        shipped ``webkb``/``sentiment`` corpora use (labels 0-3 / 1-2),
        which no reference reader can actually load.
        """
        assert vocab.lower() in ("dna", "protein", "inferred")
        if not regression and not multiclass:
            native = self._try_native(data_file)
            if native is not None:
                return native
        X: List[List[int]] = []
        Y: List[Label] = []
        with open(data_file, "r") as f:
            label_line = True
            for line in f:
                line = line.strip().lower()
                if not line:
                    continue
                if label_line:
                    split = line.split(">")
                    assert len(split) == 2, f"malformed label line: {line!r}"
                    if regression:
                        Y.append(split[1])
                    else:
                        label = int(split[1])
                        if not multiclass:
                            assert label in (-1, 0, 1), f"bad label {label}"
                        Y.append(label)
                    label_line = False
                else:
                    X.append([self._vocab.add(ch) for ch in line])
                    label_line = True
        assert len(X) == len(Y), "unequal number of labels and sequences"
        return X, Y

    def shortest_seq(self, data_file: str) -> int:
        X, _ = self.read_data(data_file)
        return min(len(x) for x in X)


def dict_size_for(Xs: Sequence[Sequence[Sequence[int]]]) -> int:
    """Alphabet size used as the k-mer hash base.

    Parity with the reference model layer (fastsk.cpp:70-84): the dictionary
    is the set of all integer codes appearing in train+test plus the reserved
    0, so the hash base equals ``|codes ∪ {0}|``.
    """
    codes = {0}
    for X in Xs:
        for seq in X:
            codes.update(int(c) for c in seq)
    return len(codes)


def load_kernel(kernel_file: str) -> "np.ndarray":
    """Read a kernel saved in the reference text format
    (``col:value`` pairs per row, 1-indexed — fastsk.cpp:223-237)."""
    import numpy as np

    rows = []
    with open(kernel_file) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            row = np.zeros(len(toks))
            for tok in toks:
                col, val = tok.split(":")
                row[int(col) - 1] = float(val)
            rows.append(row)
    return np.asarray(rows)
