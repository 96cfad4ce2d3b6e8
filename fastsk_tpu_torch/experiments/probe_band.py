"""Time the parts of kernel D's tensor-core body on the card.

Builds the packed window table of a seeded ragged set of the protein 2.19
shape (``profile_mesh.ragged_split``: 2564 sequences, lengths 16-905, 24
letters) at g=8, m=4, then times, best of ``--reps`` with CUDA events:

- ``mma``: D's tensor-core body (``packed_block_mma_kernel<0, ...>``, the
  walk that kernels F and G share);
- ``no_epilogue``: the same without the weight lookup and bin sums;
- ``no_mma``: without the tensor-core products (every count 0);
- ``no_expand``: without expanding the column tiles' codes to one-hot
  (the column tiles stay zero, so the epilogue finds nothing either);
- ``bytes``: D's byte-code body, through ``packed_band``.

The variants compute no count matrix and launch the C entry point
directly, so no wrapper counts them; ``mma`` is held to ``bytes``. One
JSON line::

    python -m fastsk_tpu_torch.experiments.probe_band [--reps 3]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import _build
from ..kernel.config import KernelConfig
from ..kernel.pairs_engine import PackedPairsEngine
from ..ops.encode import encode_sequences
from ..ops.pairs_packed_cuda import ROW_TILE, onehot_depth, packed_band
from .profile_mesh import ragged_split

VARIANTS = {"mma": 0, "no_epilogue": 1, "no_mma": 2, "no_expand": 3}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_band: needs a CUDA device")
    tr, te = ragged_split()
    eng = PackedPairsEngine(encode_sequences(tr + te), 8, 4, KernelConfig(device="cuda"))
    rows = eng.rows()
    words, meta = rows.words, rows.meta(ROW_TILE)
    lib = _build.kernels()
    out = torch.zeros((eng.n, eng.n), dtype=torch.int64, device="cuda")

    def variant(v):
        def run():
            out.zero_()
            status = lib.packed_band_launch(
                words.data_ptr(), rows.seq_padded.data_ptr(), meta.tile_first.data_ptr(),
                out.data_ptr(), words.shape[0] // ROW_TILE, eng.n, words.shape[1], rows.g,
                rows.alpha, onehot_depth(rows.g, rows.alpha), meta.cb, eng.k, 0, v,
                torch.cuda.current_stream().cuda_stream,
            )
            _build.check_launch(status, "packed_band_mma probe")
        return run

    ms = {name: best_ms(variant(v), args.reps) for name, v in VARIANTS.items()}
    variant(0)()
    mma_counts = out.clone()
    ms["bytes"] = best_ms(lambda: packed_band(rows, k=eng.k, n_out=eng.n, body="bytes"), args.reps)
    equal = bool(torch.equal(mma_counts, packed_band(rows, k=eng.k, n_out=eng.n, body="bytes")))
    print(json.dumps({
        "device_name": torch.cuda.get_device_name(0), "n": eng.n, "rows": eng.total_rows,
        "tile_pairs": (words.shape[0] // ROW_TILE) * (words.shape[0] // ROW_TILE + 1) // 2,
        "depth": onehot_depth(rows.g, rows.alpha), "reps": args.reps, "best_ms": ms,
        "mma_equals_bytes": equal,
    }))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
