"""Time kernel D on the card at the 2.19 shape and on a wide alphabet.

Builds the packed window table of a seeded ragged set and times
``packed_band`` (kernel D, through its wrapper, with its default
arguments), best of ``--reps`` with CUDA events after one warm-up call:

- by default the protein 2.19 shape (``profile_mesh.ragged_split``: 2564
  sequences, lengths 16-905, 24 letters) at g=8, m=4 (192 bytes of
  one-hot a row);
- with ``--wide`` ``wide_set()``: 400 sequences, lengths 16-905, over 100
  letters, at g=12, m=7 (1,200 bytes of one-hot a row).

It uses nothing but ``packed_band``, so copied into an older checkout of
the package it times that checkout's default body of kernel D the same
way. One JSON line::

    python -m fastsk_tpu_torch.experiments.probe_band [--reps 3] [--wide]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..kernel.config import KernelConfig
from ..kernel.pairs_engine import PackedPairsEngine
from ..ops.encode import encode_sequences
from ..ops.pairs_packed_cuda import packed_band
from .profile_mesh import ragged_split


def best_ms(fn, reps: int) -> float:
    fn()  # warm-up
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return min(times)


def wide_set(n: int = 400):
    """``n`` seeded sequences, lengths 16-905, over codes 1..100; the first
    holds every code, so the alphabet is 100."""
    rng = np.random.default_rng(100)
    X = [rng.integers(1, 101, size=int(rng.integers(16, 906))).tolist() for _ in range(n)]
    X[0] = list(range(1, 101)) + X[0]
    return X


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--wide", action="store_true", help="wide_set() at g=12, m=7")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_band: needs a CUDA device")
    if args.wide:
        X, g, m = wide_set(), 12, 7
    else:
        tr, te = ragged_split()
        X, g, m = tr + te, 8, 4
    eng = PackedPairsEngine(encode_sequences(X), g, m, KernelConfig(device="cuda"))
    rows = eng.rows()
    ms = best_ms(lambda: packed_band(rows, k=eng.k, n_out=eng.n), args.reps)
    print(json.dumps({
        "device_name": torch.cuda.get_device_name(0), "n": eng.n, "rows": eng.total_rows,
        "windows": int(eng.pack["p"].sum()), "g": g, "m": m, "alpha": eng.alpha,
        "reps": args.reps, "best_ms": ms,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
