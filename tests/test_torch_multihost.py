"""The port's multi-process runs (``fastsk_tpu_torch/parallel/multihost.py``)
against the JAX package in one process, on the CPU.

Two worker processes join one gloo group over a local TCP address and build
``global_mesh(rows=2, theta=2)`` from two CPU entries each, so every row
block belongs to one process and the rows' gathers cross processes, then
``global_mesh(rows=1, theta=4)``, whose one row block both processes
hold, so the merge over theta crosses them. The
workers import torch and the port only. On the same numpy-seeded
sequences: the dense theta engine's exact counts, a device-resident fit and
score, approx mode and the sorted engine (both mesh states) must equal
``fastsk_tpu`` run in one process. Counts and iterations are integers:
equality; the score's decision values come from the same f32 kernel on
every rank and the same solver, so the AUC must equal the port's
single-process AUC and lie within 1e-6 of JAX's (the tolerance of
``tests/test_torch_slice.py``).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

import fastsk_tpu as J
from fastsk_tpu.ops.encode import encode_sequences

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import json, sys
import numpy as np
import torch

from fastsk_tpu_torch import FastSK, KernelConfig
from fastsk_tpu_torch.parallel import multihost

coord, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
multihost.initialize(coordinator_address=coord, num_processes=2, process_id=pid,
                     backend="gloo")
mesh = multihost.global_mesh(rows=2, theta=2, local_devices=["cpu", "cpu"])
assert mesh.ranks == (0, 0, 1, 1), mesh.ranks
Xtr, Xte, ytr, yte, Xs = (json.loads(a) for a in sys.argv[4:9])
cfg = dict(device="cpu", mesh=mesh, exact_engine="theta")
res = {}
fsk = FastSK(5, 2, config=KernelConfig(**cfg))
fsk.compute_kernel(Xtr, Xte)
res["exact"] = fsk.kernel_counts.tolist()
dev = FastSK(5, 2, config=KernelConfig(device_resident=True, **cfg))
dev.compute_kernel(Xtr, Xte, ytr, yte)
assert dev._counts_dev is not None, "the mesh run must stay device-resident"
dev.fit(C=1.0)
res["auc"] = dev.score("auc")
res["dev_counts"] = dev.kernel_counts.tolist()
ap = FastSK(6, 3, approx=True, max_iters=9, seed=3, config=KernelConfig(**cfg))
ap.compute_kernel(Xtr, Xte)
res["approx"] = [ap.iterations, ap.kernel_counts.tolist(), ap.get_stdevs()]
for state in ("sharded", "replicated"):
    srt = FastSK(6, 2, config=KernelConfig(mesh_state=state, sorted_slab=64, **cfg))
    srt.compute_train(Xs)
    res[state] = srt.kernel_counts.tolist()
# one row block held by both processes: the psum over theta crosses them
cfg["mesh"] = multihost.global_mesh(rows=1, theta=4, local_devices=["cpu", "cpu"])
for resident in (False, True):
    span = FastSK(5, 2, config=KernelConfig(device_resident=resident, theta_batch=1, **cfg))
    span.compute_kernel(Xtr, Xte)
    res[f"span_{resident}"] = span.kernel_counts.tolist()
with open(f"{out}.{pid}", "w") as f:
    json.dump(res, f)
torch.distributed.destroy_process_group()
"""


def _data():
    rng = np.random.default_rng(42)
    X = [rng.integers(1, 5, size=int(rng.integers(12, 20))).tolist() for _ in range(14)]
    y = (np.arange(14) % 2).tolist()
    Xs = [rng.integers(1, 31, size=int(rng.integers(8, 16))).tolist() for _ in range(9)]
    return X[:10], X[10:], y[:10], y[10:], Xs


def _run_workers(tmp_path, data):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = str(tmp_path / "res")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    args = [json.dumps(d) for d in data]
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), f"127.0.0.1:{port}", str(pid), out, *args],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [json.loads(Path(f"{out}.{pid}").read_text()) for pid in range(2)]


def test_two_process_theta_mesh_equals_jax(tmp_path):
    Xtr, Xte, ytr, yte, Xs = data = _data()
    ranks = _run_workers(tmp_path, data)
    assert ranks[0] == ranks[1]  # every rank holds the whole result
    got = ranks[0]

    ref = J.FastSK(5, 2, config=J.KernelConfig(exact_engine="theta"))
    ref.compute_kernel(Xtr, Xte, ytr, yte)
    np.testing.assert_array_equal(np.asarray(got["exact"]), ref.kernel_counts)
    for key in ("dev_counts", "span_False", "span_True"):
        np.testing.assert_array_equal(np.asarray(got[key]), ref.kernel_counts)
    ref.fit(C=1.0)
    assert abs(got["auc"] - ref.score("auc")) <= 1e-6

    import fastsk_tpu_torch as T

    one = T.FastSK(5, 2, config=T.KernelConfig(device="cpu", device_resident=True,
                                              exact_engine="theta"))
    one.compute_kernel(Xtr, Xte, ytr, yte)
    one.fit(C=1.0)
    assert got["auc"] == one.score("auc")

    ap = J.FastSK(6, 3, approx=True, max_iters=9, seed=3)
    ap.compute_kernel(Xtr, Xte)
    iters, counts, sds = got["approx"]
    assert iters == ap.iterations == 9
    np.testing.assert_array_equal(np.asarray(counts), ap.kernel_counts)
    np.testing.assert_allclose(sds, ap.get_stdevs(), rtol=1e-4)

    srt = J.FastSK(6, 2, config=J.KernelConfig(exact_engine="theta", sorted_slab=64))
    srt.compute_train(Xs)
    assert type(srt._make_engine(encode_sequences(Xs))).__name__ == "SortedGkmEngine"
    for state in ("sharded", "replicated"):
        np.testing.assert_array_equal(np.asarray(got[state]), srt.kernel_counts)
