"""The port's checkpoint/resume (``fastsk_tpu_torch/utils/checkpoint.py``,
the dense theta engine's four checkpoint tags) against the JAX package, on
the CPU.

A run is interrupted mid-queue by an exception raised from its batch
update (as ``tests/test_cli_persistence.py`` does), then a fresh model
resumes it. Counterparts of the JAX package's checkpoint tests, a mesh
resume, both directions across the packages (JAX writes and the port
resumes, the port writes and JAX resumes) for every tag, and the CLI's
``--checkpoint``. The tolerance is equality for counts and iterations;
the CLI's scores within 1e-6 of the JAX CLI's (``tests/test_torch_svm.py``).
"""

import json
import os

import numpy as np
import pytest

import fastsk_tpu as J
import fastsk_tpu_torch as T
from fastsk_tpu import cli as jcli
from fastsk_tpu.ops import gkm as jgkm
from fastsk_tpu.ops.combinatorics import enumerate_combinations
from fastsk_tpu.parallel import make_mesh as j_make_mesh
from fastsk_tpu.parallel import sharding as jshd
from fastsk_tpu.utils import checkpoint as jck
from fastsk_tpu_torch import cli as tcli
from fastsk_tpu_torch.ops import gkm as tgkm
from fastsk_tpu_torch.parallel import make_mesh
from fastsk_tpu_torch.parallel import sharding as tshd
from fastsk_tpu_torch.utils import checkpoint as tck

import oracle
from conftest import random_ragged_seqs


class Stop(Exception):
    pass


def _counted(monkeypatch, module, name, stop_after=None):
    """Wrap ``module.name``: count its calls, and raise ``Stop`` past
    ``stop_after`` of them."""
    orig = getattr(module, name)
    calls = []

    def wrapped(*a, **kw):
        calls.append(1)
        if stop_after is not None and len(calls) > stop_after:
            raise Stop()
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def _tcfg(ck, **kw):
    return T.KernelConfig(device="cpu", checkpoint_path=ck, **kw)


def _interrupt(monkeypatch, module, name, after, run):
    with monkeypatch.context() as mp:
        _counted(mp, module, name, stop_after=after)
        with pytest.raises(Stop):
            run()


# ------------------------------------------------------------ the module


def test_digest_and_layout_equal_jax(tmp_path, rng):
    ids = rng.integers(0, 5, size=(4, 9)).astype(np.int32)
    lengths = np.array([9, 7, 8, 9], dtype=np.int32)
    for extra in ("", "sum:70:abc", "approx:0:0.025:-1"):
        assert tck.problem_digest(ids, lengths, 8, 4, extra) == jck.problem_digest(
            ids, lengths, 8, 4, extra)
    thetas = enumerate_combinations(8, 4)
    assert tck.problem_digest(ids, lengths, 8, 4, "a") != tck.problem_digest(ids, lengths, 8, 3, "a")
    path = str(tmp_path / "c.npz")
    tck.KernelCheckpoint(path, "d1").save(host_acc=np.arange(4), next_theta=np.int64(3))
    assert not os.path.exists(path + ".tmp.npz")
    saved = jck.KernelCheckpoint(path, "d1").load()
    assert saved["next_theta"] == 3 and saved["host_acc"].tolist() == [0, 1, 2, 3]
    assert jck.KernelCheckpoint(path, "d2").load() is None
    assert tck.KernelCheckpoint(path, "d2").load() is None
    assert tck.KernelCheckpoint(str(tmp_path / "absent.npz"), "d1").load() is None
    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    assert tck.KernelCheckpoint(str(tmp_path / "bad.npz"), "d1").load() is None
    import hashlib

    assert tck.theta_tag(thetas) == hashlib.sha256(
        np.ascontiguousarray(thetas, dtype=np.int64).tobytes()).hexdigest()[:16]


# ------------------------------------------------------------ counterparts


def test_exact_checkpoint_resume(tmp_path, rng, monkeypatch):
    """tests/test_cli_persistence.py:135: interrupt exact accumulation
    after 5 batches; a fresh model resumes to the identical kernel."""
    X = random_ragged_seqs(rng, 12, 10, 16, alphabet=4)
    ck = str(tmp_path / "ck.npz")
    cfg = _tcfg(ck, checkpoint_every=8, theta_batch=4, exact_engine="theta")
    ref = oracle.exact_counts(X, 8, 4)
    _interrupt(monkeypatch, tgkm, "exact_batch_update", 5,
               lambda: T.FastSK(8, 4, config=cfg).compute_train(X))
    assert os.path.exists(ck)
    calls = _counted(monkeypatch, tgkm, "exact_batch_update")
    fsk = T.FastSK(8, 4, config=cfg)
    fsk.compute_train(X)
    np.testing.assert_array_equal(fsk.kernel_counts, ref)
    assert len(calls) == 18 - 4  # 70 thetas in 18 batches, 4 saved


def test_approx_checkpoint_resume(tmp_path, rng, monkeypatch):
    """tests/test_cli_persistence.py:177."""
    X = random_ragged_seqs(rng, 12, 12, 18, alphabet=4)
    ck = str(tmp_path / "cka.npz")
    cfg = _tcfg(ck, checkpoint_every=4, theta_batch=4)
    ref = J.FastSK(8, 4, approx=True, max_iters=20, seed=3)
    ref.compute_train(X)
    _interrupt(monkeypatch, tgkm, "approx_batch_update", 2,
               lambda: T.FastSK(8, 4, approx=True, max_iters=20, seed=3, config=cfg).compute_train(X))
    fsk = T.FastSK(8, 4, approx=True, max_iters=20, seed=3, config=cfg)
    fsk.compute_train(X)
    assert fsk.iterations == ref.iterations == 20
    np.testing.assert_array_equal(fsk.kernel_counts, ref.kernel_counts)
    np.testing.assert_allclose(fsk.get_stdevs(), ref.get_stdevs(), rtol=1e-4)


def test_stale_checkpoint_ignored(tmp_path, rng):
    """tests/test_cli_persistence.py:213: a checkpoint of other data is not
    reused."""
    X1 = random_ragged_seqs(rng, 8, 10, 14, alphabet=4)
    X2 = random_ragged_seqs(rng, 8, 10, 14, alphabet=4)
    cfg = _tcfg(str(tmp_path / "ck2.npz"), checkpoint_every=1, theta_batch=2, exact_engine="theta")
    T.FastSK(6, 2, config=cfg).compute_train(X1)
    b = T.FastSK(6, 2, config=cfg)
    b.compute_train(X2)
    np.testing.assert_array_equal(b.kernel_counts, oracle.exact_counts(X2, 6, 2))


def test_checkpoint_digest_distinguishes_theta_streams(tmp_path, rng):
    """tests/test_overflow_guards.py:141: an exact run never resumes a
    seeded approx run's checkpoint of the same length, nor one of another
    seed."""
    X = random_ragged_seqs(rng, 6, 10, 20, alphabet=4)
    want = oracle.exact_counts(X, 6, 2)
    cfg = _tcfg(str(tmp_path / "k.npz"), checkpoint_every=1, exact_engine="theta")
    for approx, seed in ((True, 7), (False, 0), (True, 8)):
        fsk = T.FastSK(6, 2, approx=approx, skip_variance=approx, seed=seed, config=cfg)
        fsk.compute_train(X)
        np.testing.assert_array_equal(fsk.kernel_counts, want)


def test_device_resident_checkpoint_resume(tmp_path, rng, monkeypatch):
    """tests/test_device_resident.py:319: interrupt the device-resident
    accumulation; the resumed result is still device-resident."""
    X = random_ragged_seqs(rng, 12, 10, 16, alphabet=4)
    cfg = _tcfg(str(tmp_path / "ck.npz"), device_resident=True, checkpoint_every=8,
                theta_batch=4, exact_engine="theta")
    _interrupt(monkeypatch, tgkm, "exact_batch_update", 5,
               lambda: T.FastSK(8, 4, config=cfg).compute_train(X))
    fsk = T.FastSK(8, 4, config=cfg)
    fsk.compute_train(X)
    assert fsk._counts_dev is not None and fsk._counts_dev.hi is not None
    np.testing.assert_array_equal(fsk.kernel_counts, oracle.exact_counts(X, 8, 4))


@pytest.mark.parametrize("resident", [False, True])
def test_mesh_checkpoint_resume(tmp_path, rng, monkeypatch, resident):
    """A (2, 2) mesh run interrupted after 5 steps resumes from its
    checkpoint; a checkpoint takes even a device-resident mesh run to the
    host path, which is never quietly unsaved."""
    X = random_ragged_seqs(rng, 11, 10, 16, alphabet=4)
    ck = str(tmp_path / "ckm.npz")
    cfg = _tcfg(ck, checkpoint_every=8, theta_batch=2, exact_engine="theta",
                mesh=make_mesh(2, 2, devices=["cpu"] * 4), device_resident=resident)
    _interrupt(monkeypatch, tshd, "exact_batch_update_sharded", 5,
               lambda: T.FastSK(8, 4, config=cfg).compute_train(X))
    assert os.path.exists(ck)
    calls = _counted(monkeypatch, tshd, "exact_batch_update_sharded")
    fsk = T.FastSK(8, 4, config=cfg)
    fsk.compute_train(X)
    assert fsk._counts_dev is None
    np.testing.assert_array_equal(fsk.kernel_counts, oracle.exact_counts(X, 8, 4))
    assert len(calls) == 18 - 4  # 70 thetas in steps of 4, 4 saved


# ------------------------------------------------------------ across packages


def _case(kind, ck):
    """(model kwargs, JAX config kwargs, port config kwargs, JAX and port
    modules and names of the batch update) of a checkpoint tag."""
    base = dict(checkpoint_path=ck, checkpoint_every=8, theta_batch=4, exact_engine="theta")
    if kind == "sum":
        return {}, base, base, (jgkm, tgkm, "exact_batch_update")
    if kind == "sum_dev":
        kw = dict(base, device_resident=True)
        return {}, kw, kw, (jgkm, tgkm, "exact_batch_update")
    if kind == "sum_sharded":
        kw = dict(base, theta_batch=2)
        return ({}, dict(kw, mesh=j_make_mesh(2, 2)),
                dict(kw, mesh=make_mesh(2, 2, devices=["cpu"] * 4)),
                (jshd, tshd, "exact_batch_update_sharded"))
    kw = dict(base, checkpoint_every=4)
    return (dict(approx=True, max_iters=30, seed=5), kw, kw,
            (jgkm, tgkm, "approx_batch_update"))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", ["sum", "sum_dev", "sum_sharded", "approx"])
def test_checkpoints_cross_packages(tmp_path, monkeypatch, writer, kind):
    """One package writes a checkpoint mid-queue (interrupted after 5
    batches, or 3 in approx mode), the other resumes it (fewer batches
    than a whole run), counts and iterations equal to a whole run."""
    X = random_ragged_seqs(np.random.default_rng(21), 11, 10, 16, alphabet=4)
    ck = str(tmp_path / "x.npz")
    model_kw, j_kw, t_kw, (j_mod, t_mod, name) = _case(kind, ck)
    ref = J.FastSK(8, 4, **model_kw, config=J.KernelConfig(exact_engine="theta"))
    ref.compute_train(X)

    def jax_run():
        f = J.FastSK(8, 4, **model_kw, config=J.KernelConfig(**j_kw))
        f.compute_train(X)
        return f

    def torch_run():
        f = T.FastSK(8, 4, **model_kw, config=T.KernelConfig(device="cpu", **t_kw))
        f.compute_train(X)
        return f

    first, then = ((jax_run, torch_run) if writer == "jax" else (torch_run, jax_run))
    w_mod, r_mod = (j_mod, t_mod) if writer == "jax" else (t_mod, j_mod)
    stop = 3 if kind == "approx" else 5
    _interrupt(monkeypatch, w_mod, name, stop, first)
    assert os.path.exists(ck)
    calls = _counted(monkeypatch, r_mod, name)
    got = then()
    np.testing.assert_array_equal(got.kernel_counts, ref.kernel_counts)
    if kind == "approx":
        assert got.iterations == ref.iterations == 21  # a converged stop
        np.testing.assert_allclose(got.get_stdevs(), ref.get_stdevs(), rtol=1e-4)
        assert len(calls) == 6 - 3  # 21 iterations in batches of 4, 3 saved
    else:
        assert len(calls) == 18 - 4  # 70 thetas in steps of 4, 4 saved


# ------------------------------------------------------------ the CLI


def _labelled_fasta(path, rng, n):
    with open(path, "w") as f:
        for i in range(n):
            seq = "".join(rng.choice(list("ACGT"), size=40))
            if i % 2:
                at = int(rng.integers(0, 34))
                seq = seq[:at] + "ACGTAC" + seq[at + 6:]
            f.write(f">{i % 2}\n{seq}\n")
    return str(path)


def test_cli_checkpoint_run_then_resume(tmp_path, rng, capsys, monkeypatch):
    """``--checkpoint`` with approx mode: the port's CLI, at theta batches
    of 4, interrupted after 2 batches, then run again, resumes and prints
    the JAX CLI's scores."""
    from fastsk_tpu_torch.kernel.engine import DenseGkmEngine

    monkeypatch.setattr(DenseGkmEngine, "_auto_theta_batch", lambda self: 4)
    tr = _labelled_fasta(tmp_path / "tr.fasta", rng, 16)
    te = _labelled_fasta(tmp_path / "te.fasta", rng, 10)
    args = ["-g", "6", "-m", "3", "-a", "--json", "-q", "--checkpoint-every", "4"]
    assert jcli.main([*args, "--checkpoint", str(tmp_path / "j.npz"), tr, te]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    t_args = ["--device", "cpu", *args, "--checkpoint", str(tmp_path / "t.npz"), tr, te]
    _interrupt(monkeypatch, tgkm, "approx_batch_update", 2, lambda: tcli.main(t_args))
    assert os.path.exists(tmp_path / "t.npz")
    capsys.readouterr()
    calls = _counted(monkeypatch, tgkm, "approx_batch_update")
    assert tcli.main(t_args) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0 < len(calls) < 5  # 20 thetas in batches of 4
    for key in ("auc", "accuracy"):
        assert abs(got[key] - want[key]) <= 1e-6, (key, got, want)
