"""Variant-attribution probe of kernel A on the card (kernel H).

Counterpart of ``experiments/probe_pairs.py``: it times kernel A's whole
launch for variants of its one body, the int8 tensor-core one
(``csrc/pairs.cu``), in the layout ``ops/pairs_cuda.py:mma_plan`` gives
the shape (resident, windows, depth or slabs). Every variant runs A's grid,
plan, loads, ring and writes and differs only in the per-pair work:

    noop      tile set-up and output writes only (launch and grid cost)
    loads     A's loads and ring, no products
    matmul    the wgmma products, kept live by a per-thread sum, no lookup
    skeleton  the products summed into A's bins with weight d (no table)
    no_mma    A's epilogue on opaque zero counts (every lookup runs)
    current   kernel A: the C(d, k) table
    int32     the falling-factorial chain in int32 with an exact /k!

Each variant is checked against its plain version (``ops/pairs.py:
pairs_probe_plain``), and every repetition must give the same checksum.
The split of A's time:

    products ~ current - no_mma      epilogue ~ current - matmul
    loads    ~ loads - noop          overlap  = matmul + no_mma - loads - current

The default shape is 7230 seeded length-200 DNA sequences at g=16, m=10;
``--dataset KAT2B`` reads the in-repo KAT2B split (g=8, m=4 there)::

    python -m fastsk_tpu_torch.experiments.probe_pairs --variants skeleton,current,int32 --reps 3
    python -m fastsk_tpu_torch.experiments.probe_pairs --dataset KAT2B --g 8 --m 4
    python -m fastsk_tpu_torch.experiments.probe_pairs --n 1024 --length 300 --alpha 130 --g 12 --m 6

Progress goes to stderr; the last line of stdout is one JSON object with
the layout, each variant's best time and checks, and the split. Times
come from CUDA events on a card and from the host clock with ``--device
cpu`` (a rehearsal at a tiny size, not a device measurement).
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
from ..ops.pairs import PROBE_VARIANTS, pairs_probe_plain
from ..ops.pairs_cuda import mma_plan, pairs_probe

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


def split_of(best: Dict[str, float]) -> Optional[Dict[str, float]]:
    """Where A's time goes, from each variant's best ms (None unless
    noop, loads, matmul, no_mma and current all ran)."""
    if not {"noop", "loads", "matmul", "no_mma", "current"} <= best.keys():
        return None
    return dict(
        products_ms=best["current"] - best["no_mma"],
        epilogue_ms=best["current"] - best["matmul"],
        loads_ms=best["loads"] - best["noop"],
        overlap_ms=best["matmul"] + best["no_mma"] - best["loads"] - best["current"],
    )


def run_probe(
    x: torch.Tensor,
    *,
    g: int,
    k: int,
    p_pad: int,
    variants: Sequence[str] = PROBE_VARIANTS,
    reps: int = 3,
    counts_plain: Optional[torch.Tensor] = None,
) -> dict:
    """Each variant of kernel H on ``x`` (kernel A's operand), ``reps``
    times, against its plain version. ``counts_plain`` is
    ``pairs_counts_plain(x)`` where the caller has it (``current`` and
    ``int32`` are held to it; else to their plain versions). Returns
    {"layout", "plan", "variants": {variant: fields}, "split"}."""
    plan = mma_plan(x.shape[0] // p_pad, p_pad, x.shape[1], g)
    results = {}
    for variant in variants:
        sums, times = [], []
        for rep in range(reps):
            out, ms = timed(
                lambda: pairs_probe(x, g=g, k=k, p_pad=p_pad, variant=variant), x.device
            )
            sums.append(int(out.long().sum()))
            times.append(ms)
            if rep == 0:
                first = out
            del out
        if variant in ("current", "int32") and counts_plain is not None:
            want = counts_plain
        else:
            want = pairs_probe_plain(x, k=k, p_pad=p_pad, variant=variant, plan=plan, g=g)
        err = int((first.long() - want.long()).abs().max())
        del first, want
        results[variant] = dict(
            best_ms=min(times), ms=times, checksum=sums[0],
            checksums_equal=len(set(sums)) == 1, max_abs_err=err,
        )
        log(f"{plan.layout} {variant}: best {min(times):.3f} ms of {reps}, max|err| {err}, "
            f"checksum {sums[0]}")
    split = split_of({v: r["best_ms"] for v, r in results.items()})
    return dict(layout=plan.layout, plan=plan._asdict(), variants=results, split=split)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="", help="KAT2B: the in-repo split; default: a seeded set")
    ap.add_argument("--g", type=int, default=16)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--n", type=int, default=7230, help="seeded sequences")
    ap.add_argument("--length", type=int, default=200, help="seeded sequence length")
    ap.add_argument("--alpha", type=int, default=4, help="seeded letters")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default=",".join(PROBE_VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if args.dataset:
        train, test = read_split(args.dataset)
        shape = f"{args.dataset} g={args.g} m={args.m}"
    else:
        rng = np.random.default_rng(args.seed)
        train = rng.integers(1, args.alpha + 1, size=(args.n, args.length))
        train[0, : args.alpha] = np.arange(1, args.alpha + 1)  # every letter
        train, test = train.tolist(), None
        shape = f"seeded {args.alpha} letters {args.n}x{args.length} g={args.g} m={args.m}"
    eng = PairsGkmEngine(encode_sequences(train, test), args.g, args.m, KernelConfig(device=device))
    x = eng._build_x()
    log(f"{shape}: n_pad={eng.n_pad} p_pad={eng.p_pad} width={x.shape[1]} on {device}")
    variants = [v.strip() for v in args.variants.split(",") if v.strip()]
    res = run_probe(x, g=args.g, k=eng.k, p_pad=eng.p_pad, variants=variants, reps=args.reps)
    ok = all(r["max_abs_err"] == 0 and r["checksums_equal"] for r in res["variants"].values())
    print(json.dumps({
        "shape": shape, "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "timer": "cuda_events" if device.type == "cuda" else "host_clock",
        "n_pad": eng.n_pad, "p_pad": eng.p_pad, "width": x.shape[1], **res, "ok": ok,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
