"""Variant-attribution probe of kernel A on the card (kernel H).

Counterpart of ``experiments/probe_pairs.py``: it times kernel A's whole
launch for variants of its body that differ only in the per-pair work
(``csrc/pairs.cu``), so the cost of the weight chain is the difference of
their times:

    noop      tile set-up and output writes only (launch and grid cost)
    matmul    the __dp4a match counts only (no weight, no sums)
    skeleton  match counts summed with weight d (adds the reduction)
    current   kernel A: the C(d, k) table
    int32     the falling-factorial chain in int32 with an exact /k!

Each variant is checked against its plain version (``ops/pairs.py:
pairs_probe_plain``), and every repetition must give the same checksum.

``--body mma`` times the parts of kernel A's tensor-core body instead
(``ops/pairs_cuda.py:pairs_mma_parts``, on the card only):

    current      the body itself (held to the plain counts)
    no_epilogue  the wgmma products, consumed but not looked up
    no_mma       the epilogue on opaque zero counts (every lookup runs)
    loads        the tiles' loads, barriers and output writes only

so the product costs about current - no_mma, the epilogue current -
no_epilogue, and the loads the last.
The default shape is 7230 seeded length-200 DNA sequences at g=16, m=10;
``--dataset KAT2B`` reads the in-repo KAT2B split (g=8, m=4 there)::

    python -m fastsk_tpu_torch.experiments.probe_pairs --variants skeleton,current,int32 --reps 3
    python -m fastsk_tpu_torch.experiments.probe_pairs --dataset KAT2B --g 8 --m 4
    python -m fastsk_tpu_torch.experiments.probe_pairs --dataset KAT2B --g 8 --m 4 --body mma

Progress goes to stderr; the last line of stdout is one JSON object with
each variant's best time, the chain cost against ``skeleton`` and the
checks. Times come from CUDA events on a card and from the host clock with
``--device cpu`` (a rehearsal at a tiny size, not a device measurement).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..io.fasta import Vocabulary
from ..kernel.config import KernelConfig
from ..kernel.pairs_engine import PairsGkmEngine
from ..ops.encode import encode_sequences
from ..ops.pairs import PROBE_VARIANTS, pairs_counts_plain, pairs_probe_plain
from ..ops.pairs_cuda import MMA_PARTS, padded_width, pairs_mma_parts, pairs_probe, tile_sequences

SPLITS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "experiments", "results_baselines", "tmp",
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def read_split(name: str):
    """(train, test) integer sequences of an in-repo pos/neg split
    (``<name>.{train,test}.{pos,neg}.fasta``), one vocabulary."""
    vocab = Vocabulary()
    out = []
    for split in ("train", "test"):
        seqs = []
        for part in ("pos", "neg"):
            with open(os.path.join(SPLITS, f"{name}.{split}.{part}.fasta")) as f:
                for line in f:
                    line = line.strip().lower()
                    if line and not line.startswith(">"):
                        seqs.append([vocab.add(ch) for ch in line])
        out.append(seqs)
    return out[0], out[1]


def timed(fn, device: torch.device):
    """(result, ms) of one call: CUDA events on a card, else the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(stop)


def run_probe(
    x: torch.Tensor,
    *,
    g: int,
    k: int,
    p_pad: int,
    variants: Sequence[str] = PROBE_VARIANTS,
    reps: int = 3,
    counts_plain: Optional[torch.Tensor] = None,
) -> Dict[str, dict]:
    """Each variant of kernel H on ``x`` (kernel A's operand), ``reps``
    times, against its plain version. ``counts_plain`` is
    ``pairs_counts_plain(x)`` where the caller has it (``current`` and
    ``int32`` are held to it). Returns {variant: fields}."""
    tile = tile_sequences(x.shape[0] // p_pad, p_pad, padded_width(x.shape[1]))
    results = {}
    for variant in variants:
        outs, times = [], []
        for _ in range(reps):
            out, ms = timed(
                lambda: pairs_probe(x, g=g, k=k, p_pad=p_pad, variant=variant), x.device
            )
            outs.append(int(out.long().sum()))
            times.append(ms)
            if len(outs) == 1:
                first = out
            del out
        if variant in ("current", "int32"):
            if counts_plain is None:
                counts_plain = pairs_counts_plain(x, k=k, p_pad=p_pad)
            want = counts_plain
        else:
            want = pairs_probe_plain(x, k=k, p_pad=p_pad, variant=variant, tile=tile)
        err = int((first.long() - want.long()).abs().max())
        del first, want
        results[variant] = dict(
            best_ms=min(times), ms=times, checksum=outs[0],
            checksums_equal=len(set(outs)) == 1, max_abs_err=err,
        )
        log(f"{variant}: best {min(times):.3f} ms of {reps}, max|err| {err}, checksum {outs[0]}")
    base = results.get("skeleton")
    for variant in ("current", "int32"):
        if base is not None and variant in results:
            results[variant]["chain_ms_vs_skeleton"] = (
                results[variant]["best_ms"] - base["best_ms"]
            )
    return results


def run_mma_parts(
    x: torch.Tensor,
    *,
    g: int,
    k: int,
    p_pad: int,
    reps: int = 3,
    counts_plain: Optional[torch.Tensor] = None,
) -> Dict[str, dict]:
    """Each part of kernel A's tensor-core body (``MMA_PARTS``) on ``x``,
    best of ``reps``; "current" is held to ``counts_plain`` (computed
    here where not given). Returns {part: fields} and a "split" entry:
    product, epilogue and loads in ms."""
    results = {}
    for part in MMA_PARTS:
        times = []
        for rep in range(reps):
            out, ms = timed(
                lambda: pairs_mma_parts(x, g=g, k=k, p_pad=p_pad, variant=part),
                x.device,
            )
            times.append(ms)
            if part == "current" and rep == 0:
                if counts_plain is None:
                    counts_plain = pairs_counts_plain(x, k=k, p_pad=p_pad)
                err = int((out.long() - counts_plain.long()).abs().max())
            del out
        results[part] = dict(best_ms=min(times), ms=times)
        log(f"mma {part}: best {min(times):.3f} ms of {reps}")
    results["current"]["max_abs_err"] = err
    best = {part: results[part]["best_ms"] for part in MMA_PARTS}
    results["split"] = dict(
        product_ms=best["current"] - best["no_mma"],
        epilogue_ms=best["current"] - best["no_epilogue"],
        loads_ms=best["loads"],
    )
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="", help="KAT2B: the in-repo split; default: seeded DNA")
    ap.add_argument("--g", type=int, default=16)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--n", type=int, default=7230, help="seeded sequences")
    ap.add_argument("--length", type=int, default=200, help="seeded sequence length")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default=",".join(PROBE_VARIANTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--body", default="dp4a", choices=("dp4a", "mma"),
                    help="dp4a: kernel H's variants; mma: the tensor-core body's parts (card only)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if args.dataset:
        train, test = read_split(args.dataset)
        shape = f"{args.dataset} g={args.g} m={args.m}"
    else:
        rng = np.random.default_rng(args.seed)
        train = rng.integers(1, 5, size=(args.n, args.length)).tolist()
        test = None
        shape = f"seeded DNA {args.n}x{args.length} g={args.g} m={args.m}"
    eng = PairsGkmEngine(encode_sequences(train, test), args.g, args.m, KernelConfig(device=device))
    x = eng._build_x()
    log(f"{shape}: n_pad={eng.n_pad} p_pad={eng.p_pad} width={x.shape[1]} on {device}")
    if args.body == "mma":
        results = run_mma_parts(x, g=args.g, k=eng.k, p_pad=eng.p_pad, reps=args.reps)
        ok = results["current"]["max_abs_err"] == 0
    else:
        variants = [v.strip() for v in args.variants.split(",") if v.strip()]
        results = run_probe(
            x, g=args.g, k=eng.k, p_pad=eng.p_pad, variants=variants, reps=args.reps
        )
        ok = all(r["max_abs_err"] == 0 and r["checksums_equal"] for r in results.values())
    print(json.dumps({
        "shape": shape, "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "timer": "cuda_events" if device.type == "cuda" else "host_clock",
        "n_pad": eng.n_pad, "p_pad": eng.p_pad, "width": x.shape[1], "body": args.body,
        "variants": results, "ok": ok,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
