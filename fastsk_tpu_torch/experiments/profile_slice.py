"""Profile one run of a single-device slice: where its device time goes.

``kat2b`` runs the KAT2B C-SVC slice (g=8, m=4, C=1, device-resident):
``compute_kernel``, ``fit`` (the main solve and the Platt folds) and
``score("auc")``; ``ragged`` runs ``compute_kernel`` on a seeded ragged
set of the protein 2.19 shape (``profile_mesh.ragged_split``), through
the packed engine's default route (kernel D) or, with ``--backend
pallas_grouped``, its grouped route (kernel G and its landing). Each slice
runs once to warm up, then once under ``torch.profiler``; one JSON line
gives the host walls of the steps, the device busy time and idle share of
the profiled window, and the device time of the top kernels::

    python -m fastsk_tpu_torch.experiments.profile_slice --slice kat2b
    python -m fastsk_tpu_torch.experiments.profile_slice --slice ragged
    python -m fastsk_tpu_torch.experiments.profile_slice --slice ragged --backend pallas_grouped

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from .. import FastaUtility, FastSK, KernelConfig
from .profile_mesh import ragged_split

KAT2B = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "experiments", "results_baselines", "tmp", "KAT2B",
)


def read_splits(prefix: str):
    """The train and test pos/neg split files of ``prefix`` (their headers
    are sequence ids), rewritten with >1 / >0 labels, positives first, and
    read through one FastaUtility: ((X, y) train, (X, y) test)."""
    reader = FastaUtility()
    out = []
    with tempfile.TemporaryDirectory(prefix="profile_slice_") as tmp:
        for split in ("train", "test"):
            path = os.path.join(tmp, f"{split}.fasta")
            with open(path, "w") as f:
                for part, label in (("pos", 1), ("neg", 0)):
                    with open(f"{prefix}.{split}.{part}.fasta") as src:
                        for line in src:
                            line = line.strip()
                            if line and not line.startswith(">"):
                                f.write(f">{label}\n{line}\n")
            out.append(reader.read_data(path))
    return out


def run(slice_: str, data: str, backend: str = "auto") -> dict:
    """Host seconds of each step of one run of the slice."""
    cfg = KernelConfig(device="cuda", device_resident=True, pairs_backend=backend)
    fsk = FastSK(g=8, m=4, config=cfg)
    steps = {}

    def step(name, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    if slice_ == "kat2b":
        (Xtr, ytr), (Xte, yte) = read_splits(data)
        step("kernel_s", fsk.compute_kernel, Xtr, Xte, ytr, yte)
        step("fit_s", fsk.fit, C=1.0)
        steps["auc"] = step("score_s", fsk.score, "auc")
    else:
        tr, te = ragged_split()
        step("kernel_s", fsk.compute_kernel, tr, te)
    return steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slice", default="kat2b", choices=("kat2b", "ragged"))
    ap.add_argument("--data", default=KAT2B, help="prefix of the KAT2B split files")
    ap.add_argument("--backend", default="auto", choices=("auto", "pallas_grouped"),
                    help="the packed engine's route (KernelConfig.pairs_backend)")
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    run(args.slice, args.data, args.backend)  # warm-up: the build, the context, caches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = run(args.slice, args.data, args.backend)
        wall = time.perf_counter() - t0
    # device kernels only (their names carry no aten:: prefix): the sum of
    # their self times is the device's busy time, as kernels of one stream
    # do not overlap
    kernels = [
        e for e in prof.key_averages()
        if e.self_device_time_total > 0
        and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[: args.top]
    print(json.dumps({
        "slice": args.slice, "backend": args.backend,
        "device_name": torch.cuda.get_device_name(0),
        "wall_s": wall, "steps": steps, "device_busy_s": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall),
        "top_device": [
            {"name": e.key, "calls": e.count, "device_ms": e.self_device_time_total / 1e3,
             "share_of_busy": e.self_device_time_total / 1e6 / busy if busy else None}
            for e in top
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
