"""The port's theta engines over a device mesh against the JAX package, on
the CPU.

``fastsk_tpu_torch/parallel/sharding.py``'s theta mesh functions, the
dense engine (exact, device-resident and approx) and the sorted engine
(``mesh_state`` "sharded" and "replicated") under ``KernelConfig.mesh``,
and ``ops/sorted_theta.py``'s row-strip pass. The repo's conftest gives
JAX 8 virtual CPU devices; the port's meshes name the CPU device several
times, its stand-in for them. The same numpy-seeded inputs go through
both packages. Tolerances: counts and iterations equal; the sd trace
within rtol 1e-4 (a sum of row-block partials is not the one-device sum
bit for bit, as ``tests/test_sharding.py`` holds JAX's own mesh); the
device-resident mesh fit's AUC within 1e-9 of the port's one-device fit
(the same f32 kernel feeds the same solver).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastsk_tpu as J
import fastsk_tpu_torch as T
from fastsk_tpu.kernel.engine import DenseGkmEngine as JDense
from fastsk_tpu.kernel.sorted_engine import SortedGkmEngine as JSorted
from fastsk_tpu.ops.combinatorics import enumerate_combinations
from fastsk_tpu.ops.encode import encode_sequences
from fastsk_tpu.parallel import make_mesh as j_make_mesh
from fastsk_tpu.parallel import sharding as jshd
from fastsk_tpu_torch.kernel import engine as engine_mod
from fastsk_tpu_torch.kernel.engine import DenseGkmEngine as TDense
from fastsk_tpu_torch.kernel.sorted_engine import SortedGkmEngine as TSorted
from fastsk_tpu_torch.ops.sorted_theta import sorted_theta_pass
from fastsk_tpu_torch.parallel import make_mesh
from fastsk_tpu_torch.parallel import sharding as shd

import oracle
from conftest import random_ragged_seqs

MESHES = [(1, 1), (2, 4), (2, 3), (4, 1)]


def cpu_mesh(n_rows, n_theta):
    return make_mesh(n_rows, n_theta, devices=["cpu"] * (n_rows * n_theta))


def _jax_mesh(n_rows, n_theta):
    if len(jax.devices()) < n_rows * n_theta:
        pytest.skip("needs the conftest's 8 virtual JAX devices")
    return j_make_mesh(n_rows, n_theta)


def _cfg(mesh=None, **kw):
    return T.KernelConfig(device="cpu", mesh=mesh, **kw)


def _seqs(seed, n=21, lmin=12, lmax=20, alphabet=4):
    return random_ragged_seqs(np.random.default_rng(seed), n, lmin, lmax, alphabet)


# ------------------------------------------------------------ dense, exact


@pytest.mark.parametrize("shape", MESHES)
def test_dense_exact_mesh_equals_jax(shape):
    X = _seqs(1)
    enc = encode_sequences(X)
    want = JDense(enc, 6, 2, J.KernelConfig(mesh=_jax_mesh(*shape))).exact()
    np.testing.assert_array_equal(want, oracle.exact_counts(X, 6, 2))
    one = TDense(enc, 6, 2, _cfg()).exact()
    # several steps: a theta batch of 2 a device
    for kw in ({}, {"theta_batch": 2, "row_chunk": 4}):
        eng = TDense(enc, 6, 2, _cfg(cpu_mesh(*shape), **kw))
        assert eng.n_padded == -(-enc.n // shape[0]) * shape[0]
        np.testing.assert_array_equal(eng.exact(), want)
        np.testing.assert_array_equal(eng.exact(), one)
        dev = TDense(enc, 6, 2, _cfg(cpu_mesh(*shape), **kw)).exact_device()
        assert dev.hi is None and tuple(dev.counts.shape) == (enc.n, enc.n)
        np.testing.assert_array_equal(dev.to_host_int64(), want)


def test_exact_batch_update_sharded_with_padded_thetas():
    """One call of the mesh function, 5 thetas on a theta axis of 2 (one
    padding theta, masked), equals JAX's on the same accumulator."""
    enc = encode_sequences(_seqs(2, n=11))
    thetas = enumerate_combinations(6, 4)[3:8]
    batch, mask = shd.pad_theta_batch(thetas.astype(np.int64), 2)
    j_batch, j_mask = jshd.pad_theta_batch(thetas.astype(np.int32), 2)
    np.testing.assert_array_equal(batch, j_batch)
    np.testing.assert_array_equal(mask, j_mask)
    assert mask.tolist() == [1, 1, 1, 1, 1, 0]

    je = JDense(enc, 6, 2, J.KernelConfig(mesh=_jax_mesh(2, 2)))
    rng = np.random.default_rng(0)
    start = rng.integers(0, 50, size=(je.n_padded, je.n_padded)).astype(np.int32)
    j_acc = jax.device_put(jnp.asarray(start), je._rows_sharding)
    want = np.asarray(jshd.exact_batch_update_sharded(
        j_acc, je._ids, je._lengths, jnp.asarray(j_batch), jnp.asarray(j_mask),
        mesh=je.mesh, **je._static_kwargs()))

    mesh = cpu_mesh(2, 2)
    te = TDense(enc, 6, 2, _cfg(mesh))
    assert te.n_padded == je.n_padded == 12
    nl = te.n_padded // 2
    acc = {r: torch.as_tensor(start[r * nl : (r + 1) * nl]) for r in range(2)}
    shd.exact_batch_update_sharded(acc, te._ids, te._lengths, batch, mask, mesh=mesh,
                                   **te._static_kwargs())
    got = shd.host_rows(acc, mesh, np.zeros(start.shape, np.int64), nl)
    np.testing.assert_array_equal(got, want)
    # the padding row counts zero
    np.testing.assert_array_equal(want[enc.n :], start[enc.n :])


def test_device_resident_mesh_fit_equals_one_device():
    X = _seqs(3, n=24, lmin=14, lmax=14)
    y = [i % 2 for i in range(24)]
    aucs, counts = [], []
    for mesh in (None, cpu_mesh(2, 2), cpu_mesh(4, 1)):
        fsk = T.FastSK(5, 2, config=_cfg(mesh, exact_engine="theta", device_resident=True))
        fsk.compute_kernel(X[:18], X[18:], y[:18], y[18:])
        assert fsk._counts_dev is not None
        fsk.fit(C=1.0)
        aucs.append(fsk.score("auc"))
        counts.append(fsk.kernel_counts)
    ref = J.FastSK(5, 2, config=J.KernelConfig(exact_engine="theta"))
    ref.compute_kernel(X[:18], X[18:])
    for a, c in zip(aucs, counts):
        np.testing.assert_array_equal(c, ref.kernel_counts)
        assert abs(a - aucs[0]) <= 1e-9


def test_sharded_batch_size_refuses_a_too_wide_theta_axis():
    enc = encode_sequences(_seqs(4, n=8))
    for eng in (TDense(enc, 6, 2, _cfg(cpu_mesh(1, 4))),
                JDense(enc, 6, 2, J.KernelConfig(mesh=_jax_mesh(1, 4)))):
        eng.spill_every_thetas = 1  # one theta a device already passes it
        with pytest.raises(ValueError, match="theta mesh axis too wide"):
            eng.exact()
        eng.spill_every_thetas = 2
        assert eng._sharded_batch_sz(4) == 4


@pytest.mark.parametrize("resident", [False, True])
def test_forced_spill_comes_before_the_add(monkeypatch, resident):
    """A spill cadence of 3 thetas with steps of 2 (a theta a device on a
    theta axis of 2): the JAX engine's pre-add rule spills before a step
    whose thetas would pass the cadence, so every such step lands on an
    emptied accumulator; 15 thetas make 8 steps, the last of one theta."""
    X = _seqs(5, n=9)
    enc = encode_sequences(X)
    want = oracle.exact_counts(X, 6, 2)
    eng = TDense(enc, 6, 2, _cfg(cpu_mesh(2, 2), theta_batch=2))
    eng.spill_every_thetas = 3
    assert eng._sharded_batch_sz(2) == 2
    # the JAX rule (fastsk_tpu/kernel/engine.py:406-415), step by step
    total, since, before = len(enumerate_combinations(6, 4)), 0, []
    for i in range(0, total, 2):
        t = min(2, total - i)
        before.append(since + t > 3)
        since = t if before[-1] else since + t
    assert before == [False] + [True] * 6 + [False]
    seen, spills = [], []
    orig = shd.exact_batch_update_sharded

    def update(acc, *a, **kw):
        seen.append(max(int(v.max()) for v in acc.values()))
        return orig(acc, *a, **kw)

    monkeypatch.setattr(shd, "exact_batch_update_sharded", update)
    if resident:
        carry = engine_mod._carry_spill

        def counted(lo, hi):
            spills.append(1)
            return carry(lo, hi)

        monkeypatch.setattr(engine_mod, "_carry_spill", counted)
        dev = eng.exact_device()
        np.testing.assert_array_equal(dev.to_host_int64(), want)
        assert len(spills) == 2 * sum(before)  # a carry a row block a spill
    else:
        rows = shd.host_rows
        monkeypatch.setattr(shd, "host_rows", lambda *a, **k: spills.append(1) or rows(*a, **k))
        np.testing.assert_array_equal(eng.exact(), want)
        assert len(spills) == sum(before) + 1  # and the final gather
        assert [s for s, b in zip(seen, before) if b] == [0] * sum(before)


# ------------------------------------------------------------ dense, approx


@pytest.mark.parametrize("shape", [(4, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("case", ["max_iters", "converged"])
def test_approx_mesh_equals_jax(shape, case):
    """tests/test_sharding.py's two approx cases: a max_iters stop mid
    batch (g8 m4, 17 iterations, seed 3) and a convergence stop (g10 m6,
    delta 0.5, seed 7)."""
    if case == "max_iters":
        X, g, m, kw = _seqs(6, n=18, lmin=14), 8, 4, dict(max_iters=17, seed=3)
    else:
        X, g, m, kw = _seqs(7, n=16, lmin=14), 10, 6, dict(delta=0.5, seed=7)
    ref = J.FastSK(g, m, approx=True, **kw)
    ref.compute_train(X)
    j_mesh = J.FastSK(g, m, approx=True, config=J.KernelConfig(mesh=_jax_mesh(*shape)), **kw)
    j_mesh.compute_train(X)
    got = T.FastSK(g, m, approx=True, config=_cfg(cpu_mesh(*shape)), **kw)
    got.compute_train(X)
    assert got.iterations == ref.iterations == j_mesh.iterations
    if case == "max_iters":
        assert got.iterations == 17
    np.testing.assert_array_equal(got.kernel_counts, ref.kernel_counts)
    np.testing.assert_allclose(got.get_stdevs(), ref.get_stdevs(), rtol=1e-4)
    np.testing.assert_allclose(got.get_stdevs(), j_mesh.get_stdevs(), rtol=1e-4)


def test_approx_mesh_refuses_device_out():
    enc = encode_sequences(_seqs(8, n=6))
    with pytest.raises(ValueError, match="single device"):
        TDense(enc, 6, 2, _cfg(cpu_mesh(2, 1))).approx(device_out=True)
    with pytest.raises(ValueError, match="single device"):
        TSorted(enc, 6, 2, _cfg(cpu_mesh(2, 1))).approx(device_out=True)


# ------------------------------------------------------------ sorted


@pytest.mark.parametrize("state", ["sharded", "replicated"])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 1)])
def test_sorted_mesh_equals_jax(state, shape):
    X = _seqs(9, n=10, lmin=8, lmax=20, alphabet=25)
    enc = encode_sequences(X)
    want = JSorted(enc, 8, 3, J.KernelConfig(sorted_slab=128, mesh=_jax_mesh(*shape),
                                             mesh_state=state)).exact()
    np.testing.assert_array_equal(want, oracle.exact_counts(X, 8, 3))
    eng = TSorted(enc, 8, 3, _cfg(cpu_mesh(*shape), sorted_slab=128, mesh_state=state))
    assert eng.theta_batch == JSorted(enc, 8, 3, J.KernelConfig(mesh=_jax_mesh(*shape))).theta_batch
    np.testing.assert_array_equal(eng.exact(), want)
    # the adaptive spill, forced: a limit of a batch and two passes
    eng = TSorted(enc, 8, 3, _cfg(cpu_mesh(*shape), sorted_slab=128, mesh_state=state))
    eng._adaptive_spill = True
    eng._acc_limit = eng._per_theta_bound * (eng.theta_batch + 2)
    np.testing.assert_array_equal(eng.exact(), want)


def test_sorted_mesh_skip_variance_and_welford():
    """approx: skip_variance sums over the mesh; the Welford path runs on
    config.device, as the JAX engine's (which never reads the mesh)."""
    X = _seqs(10, n=9, lmin=10, lmax=18, alphabet=25)
    enc = encode_sequences(X)
    for kw in (dict(max_iters=7, skip_variance=True, seed=2), dict(max_iters=5, seed=4)):
        want = JSorted(enc, 7, 3, J.KernelConfig(sorted_slab=64)).approx(**kw)
        for state in ("sharded", "replicated"):
            got = TSorted(enc, 7, 3, _cfg(cpu_mesh(2, 2), sorted_slab=64, mesh_state=state)
                          ).approx(**kw)
            assert got.iters == want.iters
            np.testing.assert_array_equal(got.counts, want.counts)
            np.testing.assert_allclose(got.stdevs, want.stdevs, rtol=1e-4)


@pytest.mark.parametrize("n_rows", [3, 4, 10])
def test_row_strip_pass_equals_jax(n_rows):
    """ops/sorted_theta.py's row strip ``[row0, row0 + n_rows)`` of one
    pass against ``sorted_theta_pass_batch_sum_rows`` (layout "runs"), the
    last strip's rows past n zero; the strips stack to the whole pass."""
    from fastsk_tpu.ops.sorted_theta import sorted_theta_pass_batch_sum_rows

    X = _seqs(11, n=10, lmin=8, lmax=30, alphabet=25)
    enc = encode_sequences(X)
    je = JSorted(enc, 8, 3, J.KernelConfig(sorted_slab=64))
    te = TSorted(enc, 8, 3, _cfg(sorted_slab=64, sorted_run_width=16))
    st = je._static_kwargs()
    st.pop("tri_blocks")
    assert st["layout"] == "runs"
    n = enc.n
    n_strips = -(-n // n_rows)
    n_pad = n_strips * n_rows
    for theta in enumerate_combinations(8, 5)[::11]:
        th = torch.as_tensor(theta, dtype=torch.int64)
        whole = sorted_theta_pass(te._windows, te._seq_of, th, **te._static_kwargs())
        strips = []
        for s in range(n_strips):
            row0 = s * n_rows
            want = np.asarray(sorted_theta_pass_batch_sum_rows(
                jnp.zeros((n_rows, n), jnp.int32), je._windows, je._valid, je._seq_of,
                jnp.asarray(theta[None], jnp.int32), jnp.ones(1, jnp.int32), jnp.int32(row0),
                n_pad=n_pad, n_rows=n_rows, **st))
            got = sorted_theta_pass(te._windows, te._seq_of, th, row0=row0, n_rows=n_rows,
                                    **te._static_kwargs())
            assert got.dtype == torch.int32 and tuple(got.shape) == (n_rows, n)
            np.testing.assert_array_equal(got.numpy(), want)
            strips.append(got)
        np.testing.assert_array_equal(torch.cat(strips)[:n].numpy(), whole.numpy())
        assert not torch.cat(strips)[n:].any()


# ------------------------------------------------------------ the API


def test_all_pairs_fallback_to_theta_under_a_mesh():
    """Under a mesh the sequence-aligned engine refuses; with a 300-letter
    alphabet so does the packed one (one-byte codes), and the auto route
    lands on the theta engine (sorted: 301^4 buckets) over the mesh."""
    from fastsk_tpu_torch.ops.encode import encode_sequences as t_encode

    X = _seqs(12, n=9, lmin=8, lmax=14, alphabet=300)
    fsk = T.FastSK(6, 2, config=_cfg(cpu_mesh(2, 2), sorted_slab=64))
    assert isinstance(fsk._make_exact_engine(t_encode(X)), TSorted)
    fsk.compute_train(X)
    ref = J.FastSK(6, 2, config=J.KernelConfig(exact_engine="theta"))
    ref.compute_train(X)
    np.testing.assert_array_equal(fsk.kernel_counts, ref.kernel_counts)
    np.testing.assert_array_equal(fsk.kernel_counts, oracle.exact_counts(X, 6, 2))
