"""The control of a cell's comparison, and the readings its limits are set
from.

    python3 gkmbench/control.py --workload kat2b.train --seeds 11,12,13 --program 1 --control 1

For each seed: ``--program 1`` runs one job of the cell through the timed
path (``harness.run_job``) and judges it as a run does (the lower
readings); ``--control 1`` puts the plain reference in the program's place
one precision step down and judges that the same way (the upper
readings): the normalized kernel in bf16 (f32 in the configuration), the
kernel-row Grams with TF32 (f32 without TF32), the SMO in f32 on them at
each C the mix fits at; its Platt sigmoid on its own 5-fold
cross-validation, each fold's SMO in f32; in approx mode the stop rule's
statistics in bf16 (f32). Counts are exact integers in both. ``--fault
NAME`` plants one of ``faults.py``'s faults in the program's timed path
for the program's runs.
``--stream-seeds 1`` gives approx mode's stream the run's seed instead of
the mix's, so that the stop and sd readings cover many streams. One JSON
line a seed and side. Needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gkmbench import faults, harness  # noqa: E402


def control_outputs(cell, data, seed: int, device: str):
    """The control's outputs: (the last job's outputs as
    ``harness.last_job_outputs`` gives them, its JobOut) from the
    reference run one precision step down, one fit for each ``fit`` of the
    mix at its C."""
    import numpy as np
    import torch

    from gkmbench import reference as ref

    cfg = cell.config
    g, m, nt = cfg["g"], cfg["m"], len(data.Xtr)
    seqs = list(data.Xtr) + list(data.Xte)
    out = harness.JobOut()
    construct = harness.resolve(cell.traffic.get("construct", {}), cfg, seed)
    if construct.get("approx"):
        r = ref.approx_reference(seqs, nt, g, m, construct["seed"], construct.get("delta", 0.025),
                                 None, construct.get("max_iters", -1), device,
                                 stat_dtype=torch.bfloat16)
        counts, out.iterations, out.stdevs = r["counts"], r["iters"], r["sd"]
    else:
        counts = ref.allpairs_counts(seqs, g, m, device)
    K = ref.normalize(counts, torch.float32).to(torch.bfloat16).to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rows = K[:nt, :nt]
        gram = (rows @ rows.T).cpu().numpy()
        test_gram = (K[nt:, :nt] @ rows.T).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    y = np.where(np.asarray(data.ytr) == np.unique(data.ytr)[-1], 1.0, -1.0).astype(np.float32)
    Cs = harness.fit_Cs(cell, seed)
    C32s = [float(np.float32(C)) for C in Cs]
    decs = ref.cv_decisions_at(gram, y, C32s, ref.stratified_folds(y, 5))
    for C, C32, dec in zip(Cs, C32s, decs):
        a, rho, _ = ref.smo(gram, y, C32)
        fit = harness.FitOut(C, (a * y).astype(np.float64), rho, ref.sigmoid_train(dec, y))
        proba = ref.sigmoid(test_gram @ fit.alpha_y - rho, *fit.platt)
        fit.auc = ref.auc(data.yte, proba)
        out.fits.append(fit)
    out.digest = int(counts.sum())
    return {"counts": counts.cpu().numpy(), "proba": proba}, out


def log(msg: str) -> None:
    print(f"control: {msg}", file=sys.stderr, flush=True)


def fits_seen(job):
    """Each fit's C, AUC and sigmoid, for the readings' lines."""
    return [{"C": f.C, "auc": f.auc, "platt": f.platt} for f in job.fits]


def with_stream_seed(cell):
    """``cell`` with approx mode's stream seed drawn from the run's seed."""
    construct = dict(cell.traffic.get("construct", {}), seed="$seed")
    return dataclasses.replace(cell, traffic=dict(cell.traffic, construct=construct))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--fault", default="", choices=("",) + tuple(faults.FAULTS))
    ap.add_argument("--stream-seeds", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if args.stream_seeds:
        cell = with_stream_seed(cell)
    api = harness.import_program()
    loader = harness.load_module("loaders", cell.config["loader"])
    for seed in (int(s) for s in args.seeds.split(",")):
        data = loader.load(cell.config, seed, HERE)
        if args.program:
            t0 = time.perf_counter()
            with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
                fsk, job = harness.run_job(api, cell, data, seed, "cuda", harness.no_span)
                last = harness.last_job_outputs(fsk, os.path.join(ROOT, "build", "gkmbench"))
            fsk = None
            window = harness.Window(time.perf_counter() - t0, [job], 0, [])
            numbers = harness.compare(cell, data, seed, last, window, "cuda", log)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": "program" + (f"+{args.fault}" if args.fault else ""),
                              "iterations": job.iterations, "fits": fits_seen(job),
                              "numbers": numbers}), flush=True)
        if args.control:
            last, job = control_outputs(cell, data, seed, "cuda")
            window = harness.Window(0.0, [job], 0, [])
            numbers = harness.compare(cell, data, seed, last, window, "cuda", log)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": "control",
                              "iterations": job.iterations, "fits": fits_seen(job),
                              "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
