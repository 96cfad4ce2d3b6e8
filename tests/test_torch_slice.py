"""The port's whole exact path against the JAX package, on the CPU.

``FastSK(6, 2)``: compute_kernel -> fit -> score("auc") in both packages
on the same inputs, for both ``device_resident`` values. Tolerances:
counts equal; the host kernel bit-equal; the device kernel (f32 on the
device) within 1 f32 ulp of the f64 kernel, as the JAX package's is;
decision values within 1e-4 (the two CPU f32 paths round the Gram
products and the SMO updates differently); AUC within 1e-6.

``tests/golden/ep_sl`` holds only positive labels, so its fit uses labels
drawn from a numpy seed and given to both packages.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import fastsk_tpu as J
import fastsk_tpu_torch as T

import oracle

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ep_sl():
    reader = T.FastaUtility()
    Xtr, _ = reader.read_data(os.path.join(GOLDEN, "ep_sl.train.fasta"))
    Xte, _ = reader.read_data(os.path.join(GOLDEN, "ep_sl.test.fasta"))
    rng = np.random.default_rng(7)
    return Xtr, Xte, rng.permutation([1, 0] * 10), rng.permutation([1, 0] * 5)


def _seeded_dna():
    """64 uniform-length DNA sequences; labels follow a planted motif."""
    rng = np.random.default_rng(11)
    X = rng.integers(1, 5, size=(64, 40))
    y = rng.integers(0, 2, size=64)
    X[y == 1, 10:16] = [1, 2, 3, 4, 1, 2]
    flip = rng.random(64) < 0.2
    y = np.where(flip, 1 - y, y)
    return X[:48].tolist(), X[48:].tolist(), y[:48], y[48:]


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max()


@pytest.mark.parametrize("data", [_ep_sl, _seeded_dna], ids=["ep_sl", "dna64"])
@pytest.mark.parametrize("device_resident", [False, True])
@pytest.mark.parametrize("kernel_type", ["linear", "fastsk"])
def test_slice_matches_jax(data, device_resident, kernel_type):
    Xtr, Xte, ytr, yte = data()
    j = J.FastSK(6, 2, config=J.KernelConfig(device_resident=device_resident))
    t = T.FastSK(
        6, 2, config=T.KernelConfig(device="cpu", device_resident=device_resident)
    )
    for f in (j, t):
        f.compute_kernel(Xtr, Xte, ytr, yte)
    np.testing.assert_array_equal(t.kernel_counts, j.kernel_counts)
    if device_resident:
        # each f32 device kernel is within 1 ulp of the f64 kernel rounded
        # to f32; XLA's division by a square root rounds differently from
        # PyTorch's IEEE sqrt and divide, so the two are within 2 ulps
        exact = t.kernel.astype(np.float32)
        for dev_k in (t._K_dev.numpy(), np.asarray(j._K_dev)):
            assert dev_k.dtype == np.float32
            assert _ulps(dev_k, exact) <= 1
    np.testing.assert_array_equal(t.kernel, j.kernel)

    for f in (j, t):
        f.fit(C=1.0, kernel_type=kernel_type)
    np.testing.assert_allclose(
        t._model.decision_function(t._test_gram()),
        j._model.decision_function(j._test_gram()),
        atol=1e-4,
    )
    assert abs(t.score("auc") - j.score("auc")) <= 1e-6
    assert t.score("accuracy") == j.score("accuracy")
    rt, rj = t.score_report(), j.score_report()
    assert rt.keys() == rj.keys()
    assert abs(rt["auc"] - rj["auc"]) <= 1e-6


def test_rbf_gram_and_outputs(tmp_path):
    Xtr, Xte, ytr, yte = _seeded_dna()
    j = J.FastSK(6, 2)
    t = T.FastSK(6, 2, config=T.KernelConfig(device="cpu"))
    for f in (j, t):
        f.compute_kernel(Xtr, Xte, ytr, yte)
        f.fit(C=1.0, kernel_type="rbf")
    assert abs(t.score("auc") - j.score("auc")) <= 1e-6
    np.testing.assert_array_equal(t.get_train_kernel(), j.get_train_kernel())
    np.testing.assert_array_equal(t.get_test_kernel(), j.get_test_kernel())
    t.save_predictions(str(tmp_path / "t.txt"))
    j.save_predictions(str(tmp_path / "j.txt"))
    pt = np.loadtxt(tmp_path / "t.txt")
    pj = np.loadtxt(tmp_path / "j.txt")
    np.testing.assert_array_equal(pt[:, 0], pj[:, 0])
    np.testing.assert_allclose(pt[:, 1], pj[:, 1], atol=1e-4)
    t.save_kernel(str(tmp_path / "k.npz"))
    with np.load(tmp_path / "k.npz") as z:
        np.testing.assert_array_equal(z["kernel"], j.kernel)
        np.testing.assert_array_equal(z["counts"], j.kernel_counts)


def test_compute_train_matches_jax():
    Xtr, _, ytr, _ = _seeded_dna()
    j = J.FastSK(5, 2)
    t = T.FastSK(5, 2, config=T.KernelConfig(device="cpu", device_resident=True))
    j.compute_train(Xtr, ytr)
    t.compute_train(Xtr, ytr)
    np.testing.assert_array_equal(t.kernel, j.kernel)
    assert t.n_str_test == 0 and t.n_str_train == len(Xtr)


def test_unported_routes_raise():
    """The routes this test once refused now run and give the JAX
    package's results: approx mode and exact_engine="theta" (slice 3), both
    also under a mesh (slice 3c), the packed routes (packed, ragged auto,
    pallas_grouped) and the nu-SVC fit."""
    from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine
    from fastsk_tpu_torch.ops.encode import encode_sequences
    from fastsk_tpu_torch.parallel import make_mesh

    Xtr, Xte, ytr, yte = _seeded_dna()
    cpu = dict(device="cpu")
    want = oracle.exact_counts(Xtr + Xte, 6, 2)
    approx = T.FastSK(6, 2, approx=True, config=T.KernelConfig(**cpu))
    approx.compute_kernel(Xtr, Xte)
    j = J.FastSK(6, 2, approx=True)
    j.compute_kernel(Xtr, Xte)
    assert approx.iterations == j.iterations > 0
    np.testing.assert_array_equal(approx.kernel_counts, j.kernel_counts)
    theta = T.FastSK(6, 2, config=T.KernelConfig(exact_engine="theta", **cpu))
    theta.compute_kernel(Xtr, Xte)
    np.testing.assert_array_equal(theta.kernel_counts, want)
    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    theta_mesh = T.FastSK(6, 2, config=T.KernelConfig(exact_engine="theta", mesh=mesh, **cpu))
    theta_mesh.compute_kernel(Xtr, Xte)
    np.testing.assert_array_equal(theta_mesh.kernel_counts, want)
    approx_mesh = T.FastSK(6, 2, approx=True, config=T.KernelConfig(mesh=mesh, **cpu))
    approx_mesh.compute_kernel(Xtr, Xte)
    assert approx_mesh.iterations == j.iterations
    np.testing.assert_array_equal(approx_mesh.kernel_counts, j.kernel_counts)
    for backend in ("auto", "pallas_grouped"):
        packed = T.FastSK(
            6, 2, config=T.KernelConfig(exact_engine="packed", pairs_backend=backend, **cpu)
        )
        packed.compute_kernel(Xtr, Xte)
        np.testing.assert_array_equal(packed.kernel_counts, want)
    ragged = [[1, 2, 3, 4] * 10] + [[1, 3, 2, 4] * 2] * 3
    auto = T.FastSK(4, 2, config=T.KernelConfig(**cpu))
    assert isinstance(auto._make_exact_engine(encode_sequences(ragged)), PackedPairsEngine)
    auto.compute_train(ragged)
    forced = T.FastSK(4, 2, config=T.KernelConfig(exact_engine="pairs", **cpu))
    forced.compute_train(ragged)
    for f in (auto, forced):
        np.testing.assert_array_equal(f.kernel_counts, oracle.exact_counts(ragged, 4, 2))
    fsk = T.FastSK(6, 2, config=T.KernelConfig(**cpu))
    fsk.compute_kernel(Xtr, Xte, ytr, yte)
    fsk.fit(svm_type="nu_svc")  # the rest of the SVM family is ported
    assert 0.0 <= fsk.score("auc") <= 1.0


def test_import_leaves_jax_out():
    """The package, its two command-line modules, the theta engines'
    modules, multi-process runs and checkpoints load no jax."""
    code = (
        "import sys, fastsk_tpu_torch, fastsk_tpu_torch.cli, "
        "fastsk_tpu_torch.predict_cli, fastsk_tpu_torch.ops.combinatorics, "
        "fastsk_tpu_torch.ops.gkm, fastsk_tpu_torch.ops.sorted_theta, "
        "fastsk_tpu_torch.kernel.engine, fastsk_tpu_torch.kernel.sorted_engine, "
        "fastsk_tpu_torch.parallel.multihost, fastsk_tpu_torch.utils.checkpoint; "
        "print('jax' in sys.modules or 'fastsk_tpu' in sys.modules)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        check=True,
    )
    assert out.stdout.strip() == "False"
