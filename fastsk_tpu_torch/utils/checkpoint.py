"""Mid-computation checkpoint/resume for kernel accumulation.

A copy of ``fastsk_tpu/utils/checkpoint.py``, with the same ``.npz``
layout, digest and atomic rename, so that a checkpoint one package writes
the other resumes. The reference can save finished kernels
(fastsk.cpp:223-237) but cannot resume a partly computed one. Here the
dense theta engine persists its integer accumulator plus the work-queue
cursor (and, in Monte-Carlo mode, the Welford state), keyed by a digest
of the inputs so that a stale checkpoint is never reused.

Format: a single .npz written atomically (tmp + rename).
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Dict, Optional

import numpy as np


def problem_digest(ids: np.ndarray, lengths: np.ndarray, g: int, m: int, extra: str = "") -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(ids).tobytes())
    h.update(np.ascontiguousarray(lengths).tobytes())
    h.update(f"g={g};m={m};{extra}".encode())
    return h.hexdigest()[:32]


def theta_tag(thetas: np.ndarray) -> str:
    """The digest part that pins a theta stream, content and order: approx
    runs of other seeds, or an exact run of the same length, never resume
    each other's checkpoints."""
    return hashlib.sha256(np.ascontiguousarray(thetas, dtype=np.int64).tobytes()).hexdigest()[:16]


class KernelCheckpoint:
    def __init__(self, path: str, digest: str):
        self.path = path
        self.digest = digest

    def save(self, **arrays) -> None:
        tmp = self.path + ".tmp"
        np.savez(tmp, __digest__=np.bytes_(self.digest), **arrays)
        # np.savez appends .npz to names without it
        tmp_real = tmp if tmp.endswith(".npz") else tmp + ".npz"
        os.replace(tmp_real, self.path)

    def load(self) -> Optional[Dict[str, np.ndarray]]:
        """Returns the saved arrays, or None if absent or of another problem."""
        if not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                if z["__digest__"].item().decode() != self.digest:
                    return None
                return {k: z[k] for k in z.files if k != "__digest__"}
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            # unreadable or not a checkpoint: start afresh, as for a stale one
            return None
