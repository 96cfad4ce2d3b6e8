"""The port's packed engine (kernel F's mesh routes) across two processes,
against the JAX package, on the CPU.

Two worker processes join one gloo group over a local TCP address and run
``PackedPairsEngine``'s ring (``mesh_state="sharded"``) and round-robin
strips (``"replicated"``) over three meshes: ``global_mesh(rows=2,
theta=2)`` from two CPU entries each (ranks 0, 0, 1, 1, so the ring's entry
1 takes entry 2's shard and entry 3 takes entry 0's from the other
process), ``(2, 1)`` with one entry each, and ``(1, 4)``. Strips are 64
rows, so every mesh has several of them. The workers import torch and the
port only; each wraps ``packed_block`` (kernel F's wrapper, its plain
composite on the CPU) to record the calls it makes.

On the same numpy-seeded sequences (ragged DNA, a ragged 24-letter set and
uniform DNA with labels), every rank's counts must equal ``fastsk_tpu``'s
packed engine in one process and ``tests/oracle.py`` (integers: equality);
each rank must call kernel F only for its own entries, and the ranks' calls
must add up to the one-process run's. ``exact_engine="auto"`` must pick
the packed engine on every rank, as ``fastsk_tpu/api.py:_make_exact_engine``
does under a mesh, and its ``fit(C=1)`` AUC must equal the port's
one-process AUC and lie within 1e-6 of JAX's (the tolerance of
``tests/test_torch_slice.py``). Last, ``fastsk_tpu``'s own two-process
packed run (``jax.distributed`` on the CPU) must give the port's counts.
"""

import json
import os
import socket
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

import fastsk_tpu as J
import fastsk_tpu_torch as T
from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine
from fastsk_tpu_torch.ops import pairs_packed_cuda
from fastsk_tpu_torch.ops.encode import encode_sequences
from fastsk_tpu_torch.parallel import make_mesh

import oracle

REPO = Path(__file__).resolve().parent.parent
G, M = 5, 2
TILE = 64
MESHES = {"2x2": (2, 2, 2), "2x1": (2, 1, 1), "1x4": (1, 4, 2)}  # rows, theta, entries a rank
STATES = ("sharded", "replicated")

WORKER = r"""
import json, sys
import torch

from fastsk_tpu_torch import FastSK, KernelConfig
from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine
from fastsk_tpu_torch.ops import pairs_packed_cuda
from fastsk_tpu_torch.ops.encode import encode_sequences
from fastsk_tpu_torch.parallel import multihost
from fastsk_tpu_torch.utils.observe import counters, reset_counters

coord, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
spec = json.loads(sys.argv[4])
multihost.initialize(coordinator_address=coord, num_processes=2, process_id=pid,
                     backend="gloo")
PackedPairsEngine.TILE = spec["tile"]
g, m = spec["g"], spec["m"]
calls = []
block = pairs_packed_cuda.packed_block


def spy(out, rows_i, strips_i, *, k, rows_j=None, strips_j=None, row_off=0):
    calls.append([rows_j is None, list(strips_i), list(strips_j or ()), row_off,
                  rows_i.first_seq.tolist(),
                  None if rows_j is None else rows_j.first_seq.tolist()])
    return block(out, rows_i, strips_i, k=k, rows_j=rows_j, strips_j=strips_j,
                 row_off=row_off)


pairs_packed_cuda.packed_block = spy
res = {}
for name, (rows, theta, per) in spec["meshes"].items():
    mesh = multihost.global_mesh(rows, theta, local_devices=["cpu"] * per)
    res[name] = {"ranks": list(mesh.ranks)}
    for state in spec["states"]:
        for data, X in spec["sets"].items():
            calls.clear()
            reset_counters()
            fsk = FastSK(g, m, config=KernelConfig(device="cpu", mesh=mesh, mesh_state=state,
                                                   exact_engine="packed"))
            fsk.compute_train(X)
            res[name][f"{state} {data}"] = dict(
                counts=fsk.kernel_counts.tolist(), calls=list(calls),
                ring_bytes=counters()["ring_shift.sent_bytes"],
                merge_bytes=counters()["reduce_across.bytes"],
            )
    Xtr, Xte, ytr, yte = spec["uniform"]
    fsk = FastSK(g, m, config=KernelConfig(device="cpu", mesh=mesh))
    engine = type(fsk._make_exact_engine(encode_sequences(Xtr, Xte))).__name__
    fsk.compute_kernel(Xtr, Xte, ytr, yte)
    fsk.fit(C=1.0)
    res[name]["auto"] = dict(engine=engine, counts=fsk.kernel_counts.tolist(),
                             auc=fsk.score("auc"))
with open(f"{out}.{pid}", "w") as f:
    json.dump(res, f)
torch.distributed.destroy_process_group()
"""

JAX_WORKER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")

coord, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
spec = json.loads(sys.argv[4])
from fastsk_tpu.parallel import multihost

multihost.initialize(coordinator_address=coord, num_processes=2, process_id=pid)

from fastsk_tpu import FastSK, KernelConfig
from fastsk_tpu.kernel.pairs_engine import PackedPairsEngine

assert jax.process_count() == 2, jax.process_count()
PackedPairsEngine.TILE = spec["tile"]
mesh = multihost.global_mesh(rows=2, theta=2)
res = {}
for state in spec["states"]:
    fsk = FastSK(spec["g"], spec["m"], config=KernelConfig(
        mesh=mesh, mesh_state=state, exact_engine="packed"))
    fsk.compute_train(spec["X"])
    res[state] = fsk.kernel_counts.tolist()
with open(f"{out}.{pid}", "w") as f:
    json.dump(res, f)
jax.distributed.shutdown()
"""


def _sets():
    rng = np.random.default_rng(12)
    dna = [rng.integers(1, 5, size=int(rng.integers(12, 41))).tolist() for _ in range(24)]
    protein = [rng.integers(1, 25, size=int(rng.integers(12, 41))).tolist() for _ in range(20)]
    y = (np.arange(32) % 2).tolist()
    uniform = []
    for label in y:
        s = rng.integers(1, 5, size=20)
        if label:
            at = int(rng.integers(0, 13))
            s[at : at + 8] = [1, 3, 2, 4, 4, 1, 2, 3]
        uniform.append(s.tolist())
    return {"dna": dna, "protein": protein}, (uniform[:24], uniform[24:], y[:24], y[24:])


def _run(tmp_path, source, spec, env_extra, timeout=120):
    """Two workers of ``source`` on one local coordinator; their JSON
    results, rank 0 first."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(source)
    out = str(tmp_path / "res")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **env_extra)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), f"127.0.0.1:{port}", str(pid), out, json.dumps(spec)],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [json.loads(Path(f"{out}.{pid}").read_text()) for pid in range(2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    sets, uniform = _sets()
    spec = dict(g=G, m=M, tile=TILE, meshes=MESHES, states=STATES, sets=sets, uniform=uniform)
    return _run(tmp_path_factory.mktemp("packed_mp"), WORKER, spec, {})


@pytest.fixture(scope="module")
def reference():
    """JAX's packed engine in one process and the numpy oracle, each set."""
    sets, _ = _sets()
    out = {}
    for data, X in sets.items():
        fsk = J.FastSK(G, M, config=J.KernelConfig(exact_engine="packed"))
        fsk.compute_train(X)
        want = oracle.exact_counts(X, G, M)
        np.testing.assert_array_equal(fsk.kernel_counts, want)
        out[data] = want
    return out


def _one_process_calls(monkeypatch, X, mesh_shape, state):
    """The calls kernel F's wrapper gets in the same run on a one-process
    mesh of the same shape, and a map from each calling entry's first_seq
    to the entry (the ring's shards) or the entry of each strip (the
    round-robin's)."""
    rows, theta, _ = mesh_shape
    n_dev = rows * theta
    monkeypatch.setattr(PackedPairsEngine, "TILE", TILE)
    calls = []
    block = pairs_packed_cuda.packed_block

    def spy(out, rows_i, strips_i, *, k, rows_j=None, strips_j=None, row_off=0):
        calls.append([rows_j is None, list(strips_i), list(strips_j or ()), row_off,
                      rows_i.first_seq.tolist(),
                      None if rows_j is None else rows_j.first_seq.tolist()])
        return block(out, rows_i, strips_i, k=k, rows_j=rows_j, strips_j=strips_j,
                     row_off=row_off)

    monkeypatch.setattr(pairs_packed_cuda, "packed_block", spy)
    cfg = T.KernelConfig(device="cpu", mesh=make_mesh(rows, theta, devices=["cpu"] * n_dev),
                         mesh_state=state, exact_engine="packed")
    fsk = T.FastSK(G, M, config=cfg)
    fsk.compute_train(X)
    eng = PackedPairsEngine(encode_sequences(X), G, M, cfg)
    spd = -(-eng.n_strips // n_dev)
    first = np.full(n_dev * spd, eng.n, dtype=np.int64)
    first[: eng.n_strips] = eng.pack["first_seq"]
    shard_of = {tuple(first[d * spd : (d + 1) * spd].tolist()): d for d in range(n_dev)}
    assert len(shard_of) == n_dev  # each shard's first_seq names its entry
    return calls, shard_of, eng.n_strips


def _entry(call, state, shard_of, n_dev):
    return call[1][0] % n_dev if state == "replicated" else shard_of[tuple(call[4])]


@pytest.mark.parametrize("data", ["dna", "protein"])
@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_two_process_packed_counts_equal_jax_and_oracle(ranks, reference, mesh, state, data):
    for rank in ranks:
        np.testing.assert_array_equal(
            np.asarray(rank[mesh][f"{state} {data}"]["counts"]), reference[data]
        )


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_launches_kernel_f_for_its_own_entries(ranks, monkeypatch, mesh, state):
    sets, _ = _sets()
    rows, theta, _ = MESHES[mesh]
    n_dev = rows * theta
    one, shard_of, n_strips = _one_process_calls(monkeypatch, sets["dna"], MESHES[mesh], state)
    assert n_strips > n_dev  # every entry has live strips
    owners = ranks[0][mesh]["ranks"]
    assert ranks[1][mesh]["ranks"] == owners
    seen = Counter()
    for pid, rank in enumerate(ranks):
        calls = rank[mesh][f"{state} dna"]["calls"]
        assert calls, f"rank {pid} launched nothing"
        for call in calls:
            assert owners[_entry(call, state, shard_of, n_dev)] == pid, call
        seen.update(json.dumps(c) for c in calls)
    assert seen == Counter(json.dumps(c) for c in one)
    # the ring: one call an entry and step whose own and visiting shards
    # hold live strips; round-robin: one a strip
    spd = -(-n_strips // n_dev)
    live = sum(d * spd < n_strips for d in range(n_dev))
    assert len(one) == (n_strips if state == "replicated" else live**2)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ring_shards_and_merge_cross_processes(ranks, monkeypatch, mesh):
    """The ring sends each rank's boundary shard to the other rank at
    every step after the first (int32 codes, seq_of and first_seq), and
    each route's merge is one sum of the host matrix over the processes."""
    sets, _ = _sets()
    rows, theta, per = MESHES[mesh]
    n_dev = rows * theta
    monkeypatch.setattr(PackedPairsEngine, "TILE", TILE)
    eng = PackedPairsEngine(encode_sequences(sets["dna"]), G, M, T.KernelConfig(device="cpu"))
    spd = -(-eng.n_strips // n_dev)
    shard = spd * TILE * (G + 1) * 4 + spd * 4
    n_pad = eng.n + eng.c_pad
    for rank in ranks:
        ring = rank[mesh]["sharded dna"]
        # each rank holds one boundary entry a neighbour in the other rank reads
        assert ring["ring_bytes"] == (n_dev - 1) * shard
        assert ring["merge_bytes"] >= n_pad * n_pad * 8
        rr = rank[mesh]["replicated dna"]
        assert rr["ring_bytes"] == 0
        assert rr["merge_bytes"] == n_pad * n_pad * 8


@pytest.mark.parametrize("mesh", list(MESHES))
def test_two_process_auto_route_takes_packed_and_fits(ranks, mesh):
    _, (Xtr, Xte, ytr, yte) = _sets()
    j = J.FastSK(G, M)
    j.compute_kernel(Xtr, Xte, ytr, yte)
    j.fit(C=1.0)
    one = T.FastSK(G, M, config=T.KernelConfig(device="cpu"))
    one.compute_kernel(Xtr, Xte, ytr, yte)
    one.fit(C=1.0)
    auc = one.score("auc")
    assert abs(auc - j.score("auc")) <= 1e-6
    for rank in ranks:
        auto = rank[mesh]["auto"]
        assert auto["engine"] == "PackedPairsEngine"
        np.testing.assert_array_equal(np.asarray(auto["counts"]), j.kernel_counts)
        np.testing.assert_array_equal(np.asarray(auto["counts"]), oracle.exact_counts(Xtr + Xte, G, M))
        assert auto["auc"] == auc


def test_jax_two_process_packed_run_equals_port(tmp_path, ranks):
    """``fastsk_tpu``'s own packed engine on ``jax.distributed`` (two CPU
    processes of two devices, the same 2x2 mesh and 64-row strips): the
    port's two-process counts equal it in both mesh states."""
    sets, _ = _sets()
    spec = dict(g=G, m=M, tile=TILE, states=STATES, X=sets["dna"])
    env = dict(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=2")
    jax_ranks = _run(tmp_path, JAX_WORKER, spec, env, timeout=240)
    for state in STATES:
        want = np.asarray(jax_ranks[0][state])
        np.testing.assert_array_equal(np.asarray(jax_ranks[1][state]), want)
        for rank in ranks:
            np.testing.assert_array_equal(np.asarray(rank["2x2"][f"{state} dna"]["counts"]), want)
