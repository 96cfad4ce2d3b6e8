"""ctypes bindings + lazy build for the native FASTA parser.

Copied from ``fastsk_tpu/native/loader.py``; the one change is where the
library goes: ``build/fastsk_tpu_torch/`` (``_build.native_library``),
beside the CUDA kernels, instead of next to the source.

The shared library is compiled on first use with g++ (keyed by a source
hash) — no pybind11 or build-system dependency.
``NativeFastaReader`` mirrors FastaUtility.read_data semantics exactly for
ASCII inputs; non-ASCII files raise and callers fall back to the Python
reader.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fasta_parser.cpp")
_LOCK = threading.Lock()
_LIB = None
_BUILD_ERROR: Optional[str] = None


class _FastaResult(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_int32)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("labels", ctypes.POINTER(ctypes.c_double)),
        ("n_seqs", ctypes.c_int64),
        ("total_len", ctypes.c_int64),
        ("status", ctypes.c_int32),
        ("err", ctypes.c_char * 256),
    ]


def _build_library() -> Optional[str]:
    """Compile (or reuse) the shared library; returns its path or None."""
    from .._build import native_library

    try:
        return native_library(_SRC, "fasta_parser")
    except (OSError, RuntimeError) as exc:  # toolchain missing / compile error
        global _BUILD_ERROR
        _BUILD_ERROR = str(exc)
        return None


def get_library():
    """The loaded shared library, or None when native parsing is
    unavailable (no toolchain)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = _build_library()
            if path is None:
                return None
            lib = ctypes.CDLL(path)
            lib.fasta_parse.restype = ctypes.POINTER(_FastaResult)
            lib.fasta_parse.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            lib.fasta_free.argtypes = [ctypes.POINTER(_FastaResult)]
            lib.fasta_free.restype = None
            _LIB = lib
    return _LIB


def available() -> bool:
    return get_library() is not None


class NativeFastaReader:
    """Drop-in for FastaUtility.read_data on ASCII inputs.

    Maintains the same shared vocabulary semantics (code 0 reserved
    unknown; first-seen order) across repeated calls, so train/test files
    read through one reader share an encoding.
    """

    def __init__(self):
        self._vocab = np.zeros(256, dtype=np.int32)
        self._next = ctypes.c_int32(1)

    @property
    def vocab_size(self) -> int:
        """Number of assigned codes + the reserved unknown."""
        return int(self._next.value)

    def vocab_items(self) -> dict:
        return {
            chr(b): int(code)
            for b, code in enumerate(self._vocab)
            if code != 0
        }

    def read_data(
        self, data_file: str, regression: bool = False
    ) -> Tuple[List[List[int]], List]:
        lib = get_library()
        if lib is None:
            raise RuntimeError(f"native parser unavailable: {_BUILD_ERROR}")
        res = lib.fasta_parse(
            data_file.encode(),
            self._vocab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(self._next),
            1 if regression else 0,
        )
        try:
            r = res.contents
            if r.status != 0:
                raise ValueError(
                    f"{data_file}: {r.err.decode(errors='replace')}"
                )
            n = r.n_seqs
            data = np.ctypeslib.as_array(r.data, shape=(r.total_len,)).copy()
            offsets = np.ctypeslib.as_array(r.offsets, shape=(n + 1,)).copy()
            labels = np.ctypeslib.as_array(r.labels, shape=(n,)).copy()
        finally:
            lib.fasta_free(res)
        X = [data[offsets[i] : offsets[i + 1]].tolist() for i in range(n)]
        if regression:
            Y = [float(v) for v in labels]
        else:
            Y = [int(v) for v in labels]
        return X, Y
