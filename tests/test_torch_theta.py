"""The port's dense theta engine and approx mode against the JAX package.

``fastsk_tpu_torch/ops/combinatorics.py``, ``ops/gkm.py`` and
``kernel/engine.py:DenseGkmEngine`` on the CPU, on small seeded numpy
inputs given to both packages. Tolerances: theta streams, hashes, counts
and iteration counts equal; the sd trace within rtol 1e-4 (both trace the
reference's f32 Welford statistic, but torch and XLA sum a matrix in
different orders); AUC within 1e-6 and decision values within 1e-4, as
``tests/test_torch_slice.py`` holds the exact path. The seeds are ones
whose stop does not land on the 1.96 threshold.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fastsk_tpu as J
import fastsk_tpu_torch as T
from fastsk_tpu import cli as jcli
from fastsk_tpu.kernel.engine import DenseGkmEngine as JDense
from fastsk_tpu.ops import combinatorics as jcomb
from fastsk_tpu.ops import gkm as jgkm
from fastsk_tpu.ops.encode import encode_sequences
from fastsk_tpu_torch import cli as tcli
from fastsk_tpu_torch.kernel import device_counts
from fastsk_tpu_torch.kernel.engine import DenseGkmEngine as TDense
from fastsk_tpu_torch.kernel.sorted_engine import SortedGkmEngine as TSorted
from fastsk_tpu_torch.ops import combinatorics as tcomb
from fastsk_tpu_torch.ops import gkm as tgkm
from fastsk_tpu_torch.utils.observe import counters

import oracle
from conftest import random_ragged_seqs

CPU = T.KernelConfig(device="cpu")


def _t(x, dtype=torch.int32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _dna(seed, n=14, lmin=12, lmax=40, alphabet=4):
    return random_ragged_seqs(np.random.default_rng(seed), n, lmin, lmax, alphabet)


# ------------------------------------------------------------ combinatorics


@pytest.mark.parametrize("g,k,seed", [(6, 3, 0), (8, 4, 1), (10, 6, 7), (12, 1, 3), (5, 5, 2)])
def test_theta_streams_equal_jax(g, k, seed):
    assert tcomb.nchoosek(g, k) == jcomb.nchoosek(g, k)
    np.testing.assert_array_equal(tcomb.enumerate_combinations(g, k),
                                  jcomb.enumerate_combinations(g, k))
    np.testing.assert_array_equal(
        tcomb.sample_combinations(g, k, np.random.default_rng(seed)),
        jcomb.sample_combinations(g, k, np.random.default_rng(seed)),
    )


# ------------------------------------------------------------ ops/gkm.py


@pytest.mark.parametrize("g,m,alphabet", [(6, 3, 4), (5, 1, 4), (4, 1, 9), (3, 2, 20)])
def test_hashes_histograms_and_grams_equal_jax(g, m, alphabet):
    enc = encode_sequences(_dna(g * 10 + m, alphabet=alphabet))
    k = g - m
    k1, k2 = tgkm.split_k(k)
    assert (k1, k2) == jgkm.split_k(k)
    base = enc.hash_base
    b1, b2 = base**k1, base**k2
    thetas = jcomb.enumerate_combinations(g, k)[:5]
    p = enc.max_len - g + 1
    valid = np.arange(p)[None, :] <= (enc.lengths[:, None] - g)

    jw = jgkm.window_matrix(jnp.asarray(enc.ids), g)
    tw = tgkm.window_matrix(_t(enc.ids), g)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    jh1, jh2 = jgkm.theta_hashes(jw, jnp.asarray(thetas), base, enc.code_min, k1)
    th1, th2 = tgkm.theta_hashes(tw, _t(thetas, torch.int64), base, enc.code_min, k1)
    np.testing.assert_array_equal(th1.numpy(), np.asarray(jh1))
    np.testing.assert_array_equal(th2.numpy(), np.asarray(jh2))

    jc = jgkm.histogram_counts(jh1, jh2, jnp.asarray(valid), b1, b2, jnp.float32)
    tc = tgkm.histogram_counts(th1, th2, torch.as_tensor(valid), b1, b2)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))

    # the chunked batch (row_chunk below N) equals the unchunked JAX batch
    kw = dict(g=g, base=base, code_min=enc.code_min, k1=k1, b1=b1, b2=b2)
    tb = tgkm._counts_for_batch(_t(enc.ids), _t(enc.lengths), _t(thetas, torch.int64),
                                row_chunk=3, **kw)
    jb = jgkm._counts_for_batch(jnp.asarray(enc.ids), jnp.asarray(enc.lengths),
                                jnp.asarray(thetas), row_chunk=16, count_dtype=jnp.float32, **kw)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).astype(np.int64))

    for split, route in ((False, "f32"), (True, "f64")):
        want = np.asarray(jgkm.count_gram_int32(jb, split))
        got = tgkm.theta_gram(tgkm.theta_operand(tb, route), route)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_count_split_gram_past_f32():
    """Counts whose products pass 2^24: the split (f64) form is exact where
    an f32 sum would round, and equals the JAX 8-bit digit form."""
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 6000, size=(3, 5, 7)).astype(np.float32)
    want = np.einsum("tnb,tmb->nm", counts.astype(np.int64), counts.astype(np.int64))
    assert want.max() > 1 << 24
    got = tgkm.theta_gram(tgkm.theta_operand(torch.as_tensor(counts), "f64"), "f64").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jgkm.count_gram_int32(jnp.asarray(counts), True)))


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("g,m,seed", [(6, 3, 0), (5, 2, 1), (7, 2, 2)])
def test_dense_exact_matches_jax_and_oracle(g, m, seed):
    X = _dna(seed)
    enc = encode_sequences(X)
    want = oracle.exact_counts(X, g, m)
    np.testing.assert_array_equal(JDense(enc, g, m).exact(), want)
    # a small theta batch and row chunk: several batches and chunks
    for cfg in (CPU, T.KernelConfig(device="cpu", theta_batch=3, row_chunk=5)):
        eng = TDense(enc, g, m, cfg)
        np.testing.assert_array_equal(eng.exact(), want)
        dev = eng.exact_device()
        assert dev.hi is None
        np.testing.assert_array_equal(dev.to_host_int64(), want)


def test_dense_sizing_matches_jax():
    """The theta batch and spill cadence are the JAX engine's; the row
    chunk is the port's own, sized by its hash and index tensors."""
    enc = encode_sequences(_dna(3, n=40, lmax=300))
    for cfg, budget in (({}, 1 << 30), ({"counts_budget_bytes": 1 << 14}, 1 << 30),
                        ({}, 1 << 22), ({"max_theta_batch": 5}, 1 << 30)):
        j = JDense(enc, 8, 4, J.KernelConfig(**cfg))
        t = TDense(enc, 8, 4, T.KernelConfig(device="cpu", hash_budget_bytes=budget, **cfg))
        assert (t.theta_batch, t.spill_every_thetas, t.route == "f64") == (
            j.theta_batch, j.spill_every_thetas, j.count_split)
        per_row = t.p * t.theta_batch * tgkm.HASH_BYTES
        assert t.row_chunk == max(1, min(t.n, budget // per_row))
        assert (1 < t.row_chunk < t.n) if budget == 1 << 22 else t.row_chunk == t.n


def test_dense_count_split_exact_and_approx(rng):
    """p_max > 4095 (``tests/test_exact_engine.py``'s long repetitive
    documents): the f64 product path, exact and approx."""
    X = [([1, 2] * 2500)[:4600], rng.integers(1, 4, size=4300).tolist(),
         rng.integers(1, 4, size=4500).tolist()]
    g, m = 5, 2
    enc = encode_sequences(X)
    t = TDense(enc, g, m, CPU)
    j = JDense(enc, g, m)
    assert t.route == "f64" and j.count_split and t.matmul_dtype == torch.float64
    thetas = tcomb.enumerate_combinations(g, g - m)[:4]
    want = oracle.counts_for_thetas(X, g, thetas)
    np.testing.assert_array_equal(t._sum_thetas(thetas), want)
    np.testing.assert_array_equal(t._sum_thetas_device(thetas).to_host_int64(), want)
    for skip in (False, True):
        jr = j.approx(max_iters=3, skip_variance=skip, seed=1)
        tr = t.approx(max_iters=3, skip_variance=skip, seed=1)
        assert tr.iters == jr.iters == 3
        np.testing.assert_array_equal(tr.counts, jr.counts)
        np.testing.assert_allclose(tr.stdevs, jr.stdevs, rtol=1e-4)


@pytest.mark.parametrize("seed,delta,max_iters,batch", [
    (3, 0.025, -1, None),  # runs the whole stream
    (0, 0.6, -1, None),  # converges mid-stream
    (0, 0.6, -1, 4),  # the same, stopping inside a batch of 4
    (5, 0.025, 7, 3),  # max_iters inside the third batch
])
def test_dense_approx_welford_matches_jax(seed, delta, max_iters, batch):
    X = _dna(11, n=16, lmin=20, lmax=60)
    enc = encode_sequences(X)
    g, m = 8, 4
    cfg = {} if batch is None else {"theta_batch": batch}
    j = JDense(enc, g, m, J.KernelConfig(**cfg)).approx(
        conv_delta=delta, max_iters=max_iters, seed=seed)
    eng = TDense(enc, g, m, T.KernelConfig(device="cpu", **cfg))
    t = eng.approx(conv_delta=delta, max_iters=max_iters, seed=seed)
    assert t.iters == j.iters and t.converged == j.converged
    assert len(t.stdevs) == t.iters
    np.testing.assert_array_equal(t.counts, j.counts)
    np.testing.assert_allclose(t.stdevs, j.stdevs, rtol=1e-4)
    # every consumed theta, summed exactly
    stream = tcomb.sample_combinations(g, g - m, np.random.default_rng(seed))[: t.iters]
    np.testing.assert_array_equal(t.counts, oracle.counts_for_thetas(X, g, stream))
    dev = eng.approx(conv_delta=delta, max_iters=max_iters, seed=seed, device_out=True)
    assert isinstance(dev.counts, device_counts.DeviceCounts) and dev.iters == t.iters
    np.testing.assert_array_equal(dev.counts.to_host_int64(), j.counts)


def test_dense_skip_variance_matches_jax():
    X = _dna(4)
    enc = encode_sequences(X)
    for max_iters in (5, -1):
        j = JDense(enc, 6, 3).approx(max_iters=max_iters, skip_variance=True, seed=9)
        t = TDense(enc, 6, 3, CPU).approx(max_iters=max_iters, skip_variance=True, seed=9)
        assert (t.iters, t.stdevs, t.converged) == (j.iters, j.stdevs, j.converged)
        np.testing.assert_array_equal(t.counts, j.counts)
        d = TDense(enc, 6, 3, CPU).approx(max_iters=max_iters, skip_variance=True, seed=9,
                                          device_out=True)
        np.testing.assert_array_equal(d.counts.to_host_int64(), j.counts)


def test_device_spill_into_hi(monkeypatch):
    """A spill every batch with a carry unit of 2^3 (the real one, 2^30,
    needs counts far past a CPU test): the hi plane fills, and both planes
    read back the JAX package's counts, in integers and in f32."""
    monkeypatch.setattr(device_counts, "_CARRY_SHIFT", 3)
    X = _dna(6)
    enc = encode_sequences(X)
    want = JDense(enc, 6, 3).exact()
    for eng in (TDense(enc, 6, 3, T.KernelConfig(device="cpu", theta_batch=2)),
                TSorted(enc, 6, 3, CPU)):
        if isinstance(eng, TDense):
            eng.spill_every_thetas = 1
        else:
            # the adaptive spill, at an accumulator limit of 20
            eng._adaptive_spill = True
            eng._acc_limit, eng._per_theta_bound = 20, 1
        dev = eng.exact_device()
        assert dev.hi is not None and int(dev.hi.max()) > 0
        np.testing.assert_array_equal(dev.to_host_int64(), want)
        np.testing.assert_array_equal(dev.to_f32().numpy(), want.astype(np.float32))
        k = want.astype(np.float32)
        np.testing.assert_allclose(dev.normalized_f32().numpy(),
                                   k / np.sqrt(np.outer(np.diag(k), np.diag(k))), rtol=1e-6)


def test_theta_engines_on_a_mesh_match_jax():
    """Both theta engines run on a (1, 2) mesh, equal to the JAX engines on
    the same mesh."""
    from fastsk_tpu.kernel.sorted_engine import SortedGkmEngine as JSorted
    from fastsk_tpu.parallel import make_mesh as j_make_mesh
    from fastsk_tpu_torch.parallel import make_mesh

    enc = encode_sequences(_dna(1))
    cfg = T.KernelConfig(device="cpu", mesh=make_mesh(1, 2, devices=["cpu"] * 2))
    j_cfg = J.KernelConfig(mesh=j_make_mesh(1, 2))
    for engine, j_engine in ((TDense, JDense), (TSorted, JSorted)):
        np.testing.assert_array_equal(engine(enc, 6, 3, cfg).exact(),
                                      j_engine(enc, 6, 3, j_cfg).exact())


# ------------------------------------------------------------ the count product's route


@pytest.mark.parametrize("p_max,device,mesh,route", [
    (188, "cuda", False, "u8_wgmma"),  # KAT2B's windows
    (255, "cuda", False, "u8_wgmma"),
    (256, "cuda", False, "bf16"),  # one past u8: bf16 still holds it
    (257, "cuda", False, "f32"),
    (4095, "cuda", False, "f32"),
    (4096, "cuda", False, "f64"),  # the count split
    (188, "cuda", True, "bf16"),  # a mesh keeps today's path
    (255, "cpu", False, "f32"),
    (188, "cpu", True, "f32"),
    (4096, "cpu", False, "f64"),
])
def test_theta_route_rule(p_max, device, mesh, route):
    """The u8 kernel only on the card, without a mesh, while counts fit u8;
    every other case keeps ``matmul_dtype``'s operand."""
    assert tgkm.theta_route(p_max, torch.device(device), mesh=mesh) == route
    if route != tgkm.U8_ROUTE:
        assert tgkm.ROUTE_DTYPES[route] == tgkm.matmul_dtype(p_max, torch.device(device))


@pytest.mark.parametrize("t,n,b", [(1, 1, 1), (1, 9, 31), (1, 12, 33), (3, 7, 200), (2, 5, 625)])
def test_u8_operand_and_plain_gram(t, n, b):
    """The u8 route's operand pads each row to a multiple of 128 bytes with
    zeros, and its product (the plain int64 version on the CPU) equals the
    f64 route's (exact below 2^53) for counts up to 255, counted by
    subsets."""
    rng = np.random.default_rng(t * 1000 + n * 10 + b)
    counts = torch.as_tensor(rng.integers(0, 256, size=(t, n, b)), dtype=torch.int32)
    counts[:, 0] = 255
    c = tgkm.theta_operand(counts, tgkm.U8_ROUTE)
    assert c.dtype == torch.uint8 and c.shape == (t, n, -(-b // 128) * 128)
    np.testing.assert_array_equal(c[..., :b].numpy(), counts.numpy())
    assert not c[..., b:].any()
    before = counters()
    got = tgkm.theta_gram(c, tgkm.U8_ROUTE)
    assert counters()["theta_gram.routes.u8_wgmma"] - before["theta_gram.routes.u8_wgmma"] == t
    assert got.dtype == torch.int32
    want = tgkm.theta_gram(tgkm.theta_operand(counts, "f64"), "f64")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    x = counts.permute(1, 0, 2).reshape(n, -1).numpy().astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), x @ x.T)


def test_dense_engine_routes_what_it_observes(monkeypatch):
    """The engine asks ``theta_route`` with what it observes (its p_max,
    device and mesh); on the CPU it keeps today's f32 products with
    today's results, counted a subset each, and under a mesh no
    single-device product runs."""
    from fastsk_tpu_torch.parallel import make_mesh

    asked = []
    route = tgkm.theta_route
    monkeypatch.setattr(tgkm, "theta_route", lambda *a, **kw: asked.append((a, kw)) or route(*a, **kw))
    X = _dna(2)
    enc = encode_sequences(X)
    eng = TDense(enc, 6, 3, T.KernelConfig(device="cpu", theta_batch=3))
    assert eng.route == "f32" and asked[-1] == ((eng.p_max, eng.device), {"mesh": False})
    before = counters()
    np.testing.assert_array_equal(eng.exact(), oracle.exact_counts(X, 6, 3))
    delta = counters() - before
    assert delta["theta_gram.routes.f32"] == 20 and delta["theta_gram.routes.u8_wgmma"] == 0
    r = eng.approx(conv_delta=0.6, seed=0)
    delta = counters() - before
    assert delta["theta_gram.routes.f32"] == 20 + min(20, -(-r.iters // 3) * 3)
    np.testing.assert_array_equal(r.counts, JDense(enc, 6, 3).approx(conv_delta=0.6, seed=0).counts)

    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    meshed = TDense(enc, 6, 3, T.KernelConfig(device="cpu", mesh=mesh))
    assert meshed.route == "f32" and asked[-1][1] == {"mesh": True}
    before = counters()
    np.testing.assert_array_equal(meshed.exact(), oracle.exact_counts(X, 6, 3))
    assert not any(k.startswith("theta_gram.") for k in counters() - before)


def test_gram_callers_keep_gkm_gram(monkeypatch):
    """The sorted engine's slab products and the meshes' row blocks still
    call ``gkm.gram``, never the dense engine's own product."""
    from fastsk_tpu_torch.ops import sorted_theta
    from fastsk_tpu_torch.parallel import make_mesh

    calls = {"sorted": 0, "mesh": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def refuse(*a, **kw):
        raise AssertionError("theta_gram called off the dense engine's single-device path")

    monkeypatch.setattr(sorted_theta, "gram", spy("sorted", sorted_theta.gram))
    monkeypatch.setattr(tgkm, "gram", spy("mesh", tgkm.gram))
    monkeypatch.setattr(tgkm, "theta_gram", refuse)
    X = _dna(3, alphabet=20)
    enc = encode_sequences(X)
    want = oracle.exact_counts(X, 5, 2)
    np.testing.assert_array_equal(TSorted(enc, 5, 2, CPU).exact(), want)
    assert calls["sorted"] > 0
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    dense = TDense(enc, 5, 2, T.KernelConfig(device="cpu", mesh=mesh))
    np.testing.assert_array_equal(dense.exact(), want)
    dense.approx(max_iters=2, seed=0)
    assert calls["mesh"] > 0


# ------------------------------------------------------------ API and CLI


def _labelled(seed, n, length, alphabet, motif):
    rng = np.random.default_rng(seed)
    X = rng.integers(1, alphabet + 1, size=(n, length))
    y = np.arange(n) % 2
    X[y == 1, 5 : 5 + len(motif)] = motif
    return X.tolist(), y


@pytest.mark.parametrize("alphabet,engine,device_resident", [
    (4, "DenseGkmEngine", False),
    (4, "DenseGkmEngine", True),
    (24, "SortedGkmEngine", False),
    (24, "SortedGkmEngine", True),
])
def test_fastsk_approx_matches_jax(alphabet, engine, device_resident):
    X, y = _labelled(alphabet, 40, 30, alphabet, [1, 2, 3, 4, 1, 2])
    Xtr, Xte, ytr, yte = X[:28], X[28:], y[:28], y[28:]
    kw = dict(approx=True, delta=0.2, seed=2)
    j = J.FastSK(6, 2, **kw, config=J.KernelConfig(device_resident=device_resident))
    t = T.FastSK(6, 2, **kw, config=T.KernelConfig(device="cpu", device_resident=device_resident))
    assert type(t._make_engine(encode_sequences(Xtr, Xte))).__name__ == engine
    assert type(j._make_engine(encode_sequences(Xtr, Xte))).__name__ == engine
    j.compute_kernel(Xtr, Xte, ytr, yte)
    t.compute_kernel(Xtr, Xte, ytr, yte)
    assert t.iterations == j.iterations and 1 < t.iterations
    np.testing.assert_allclose(t.get_stdevs(), j.get_stdevs(), rtol=1e-4)
    np.testing.assert_array_equal(t.kernel_counts, j.kernel_counts)
    np.testing.assert_array_equal(t.kernel, j.kernel)
    j.fit(C=1.0)
    t.fit(C=1.0)
    np.testing.assert_allclose(
        t._model.decision_function(t._test_gram()),
        np.asarray(j._model.decision_function(j._test_gram())), atol=1e-4)
    assert abs(t.score("auc") - j.score("auc")) <= 1e-6


def test_exact_engine_theta_and_last_fallback(monkeypatch):
    """exact_engine="theta" runs the theta engine by bucket space; the
    all-pairs engines' last fallback (both refuse the shape) too."""
    from fastsk_tpu_torch.kernel import pairs_engine

    X = _dna(8)
    want = oracle.exact_counts(X, 5, 2)
    fsk = T.FastSK(5, 2, config=T.KernelConfig(device="cpu", exact_engine="theta"))
    assert isinstance(fsk._make_exact_engine(encode_sequences(X)), TDense)
    fsk.compute_train(X)
    np.testing.assert_array_equal(fsk.kernel_counts, want)

    def refuse(*args, **kwargs):
        raise ValueError("refused")

    monkeypatch.setattr(pairs_engine.PairsGkmEngine, "__init__", refuse)
    monkeypatch.setattr(pairs_engine.PackedPairsEngine, "__init__", refuse)
    small = T.FastSK(5, 2, config=T.KernelConfig(device="cpu", b_max_dense=8))
    assert isinstance(small._make_exact_engine(encode_sequences(X)), TSorted)
    small.compute_train(X)
    np.testing.assert_array_equal(small.kernel_counts, want)


def _fasta(path, X, y):
    letters = "ACGT"
    with open(path, "w") as f:
        for seq, label in zip(X, y):
            f.write(f">{label}\n{''.join(letters[c - 1] for c in seq)}\n")
    return str(path)


@pytest.mark.parametrize("extra", [
    ["-a", "--seed", "0", "--delta", "0.3"],
    ["-a", "-I", "6", "--skip-variance", "--seed", "4"],
])
def test_cli_approx_flags_match_jax(tmp_path, capsys, extra):
    X, y = _labelled(9, 48, 36, 4, [1, 2, 3, 4, 1, 2])
    tr = _fasta(tmp_path / "tr.fasta", X[:32], y[:32])
    te = _fasta(tmp_path / "te.fasta", X[32:], y[32:])
    args = ["-g", "6", "-m", "2", "--json", "-q", *extra, tr, te]
    assert jcli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["--device", "cpu", *args]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(got["auc"] - want["auc"]) <= 1e-6
    assert got["accuracy"] == want["accuracy"]
