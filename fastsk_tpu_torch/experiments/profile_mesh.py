"""Profile one exact-kernel run of the packed engine over a mesh.

Runs ``FastSK.compute_kernel`` on a seeded ragged set of the protein 2.19
shape (``chip_smoke.py``'s ragged slice) once to warm up, then once under
``torch.profiler``, and prints one JSON line: the host wall, the kernel
launches the host made (torch's and the port's own, counted from the
CUDA runtime's launch calls), the top operators by host time and by
device time, and the calls that make the host wait on the device::

    python -m fastsk_tpu_torch.experiments.profile_mesh --mesh 2,2 --state sharded
    python -m fastsk_tpu_torch.experiments.profile_mesh --mesh 1,4 --cards   # distinct cards

``--mesh r,t`` names the first card r * t times unless ``--cards`` spreads
it over r * t cards. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import FastSK, KernelConfig
from ..parallel import make_mesh

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy", "aten::item",
         "aten::_local_scalar_dense", "cudaEventSynchronize")


def ragged_split(n: int = 2564, lmin: int = 16, lmax: int = 905, seed: int = 219):
    """Seeded ragged sequences over 24 codes, lengths uniform in [lmin,
    lmax], split 80/20 (train, test)."""
    rng = np.random.default_rng(seed)
    X = [rng.integers(1, 25, size=int(rng.integers(lmin, lmax + 1))).tolist() for _ in range(n)]
    n_tr = int(0.8 * n)
    return X[:n_tr], X[n_tr:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="2,2", help="rows,theta")
    ap.add_argument("--state", default="sharded", choices=("sharded", "replicated"))
    ap.add_argument("--cards", action="store_true", help="distinct cards, not the first card repeated")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mesh: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    r, t = (int(v) for v in args.mesh.split(","))
    devices = (
        [torch.device("cuda", i) for i in range(r * t)] if args.cards
        else [torch.device("cuda", 0)] * (r * t)
    )
    mesh = make_mesh(r, t, devices=devices)
    tr, te = ragged_split()
    cfg = KernelConfig(device="cuda", mesh=mesh, mesh_state=args.state)
    FastSK(8, 4, config=cfg).compute_kernel(tr, te)  # warm-up: contexts, kernels
    for d in set(devices):
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        FastSK(8, 4, config=cfg).compute_kernel(tr, te)
        for d in set(devices):
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def top(key):
        rows = sorted(events, key=lambda e: getattr(e, key), reverse=True)[: args.top]
        return [
            {"name": e.key, "calls": e.count, "host_ms": e.self_cpu_time_total / 1e3,
             "device_ms": e.self_device_time_total / 1e3}
            for e in rows
        ]

    print(json.dumps({
        "mesh": [r, t], "devices": [str(d) for d in devices], "mesh_state": args.state,
        "device_name": torch.cuda.get_device_name(0), "wall_s": wall,
        "launches": sum(e.count for e in events if e.key in LAUNCHES),
        "host_ms_total": sum(e.self_cpu_time_total for e in events) / 1e3,
        "device_ms_total": sum(e.self_device_time_total for e in events) / 1e3,
        "top_host": top("self_cpu_time_total"), "top_device": top("self_device_time_total"),
        "waits": {e.key: e.count for e in events if e.key in SYNCS},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
