"""The port's sorted theta engine against the JAX package and the oracle.

``fastsk_tpu_torch/ops/sorted_theta.py`` and
``kernel/sorted_engine.py:SortedGkmEngine`` on the CPU, on small seeded
numpy inputs given to both packages: every pass, exact sum and approx
count integer-equal, iterations equal, the sd trace within rtol 1e-4 (the
f32 Welford statistic summed in another order, as in
``tests/test_torch_theta.py``). ``FastSK``'s approx job on protein
letters, which takes this engine, against the benchmark's plain
reference, and the engine's spans and counters.
"""

import os
import sys

import numpy as np
import pytest

import fastsk_tpu as J
import fastsk_tpu_torch as T
from fastsk_tpu.kernel.sorted_engine import SortedGkmEngine as JSorted
from fastsk_tpu.ops.encode import encode_sequences
from fastsk_tpu_torch.kernel.sorted_engine import SortedGkmEngine as TSorted
from fastsk_tpu_torch.ops import sorted_theta
from fastsk_tpu_torch.ops.combinatorics import enumerate_combinations, sample_combinations

import oracle
from conftest import random_ragged_seqs

# the benchmark's plain reference (``gkmbench/``) lies at the repo root
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _engines(X, g, m, **cfg):
    enc = encode_sequences(X)
    return (JSorted(enc, g, m, J.KernelConfig(**cfg)),
            TSorted(enc, g, m, T.KernelConfig(device="cpu", **cfg)))


@pytest.mark.parametrize(
    "g,m,n,lmin,lmax,alpha,slab,width",
    [
        (6, 3, 9, 8, 20, 4, 64, 2048),
        (6, 3, 9, 8, 20, 4, 3, 4),  # tiny chunks and slabs: many bounds
        (8, 2, 10, 9, 24, 25, 128, 16),  # protein-sized alphabet, k=6
        (5, 2, 7, 6, 14, 30, 64, 2048),  # text-sized alphabet
        (7, 3, 12, 8, 18, 4, 32, 1),  # one run a slab
    ],
)
def test_sorted_exact_matches_oracle_and_jax(rng, g, m, n, lmin, lmax, alpha, slab, width):
    X = random_ragged_seqs(rng, n, lmin, lmax, alphabet=alpha)
    want = oracle.exact_counts(X, g, m)
    j, t = _engines(X, g, m, sorted_slab=slab, sorted_run_width=width)
    np.testing.assert_array_equal(t.exact(), want)
    np.testing.assert_array_equal(t.exact_device().to_host_int64(), want)
    # every pass integer-equal to the JAX pass
    for theta in enumerate_combinations(g, g - m)[:4]:
        np.testing.assert_array_equal(t._pass(theta).numpy(), np.asarray(j._pass(theta)))


def test_sorted_heavy_runs(rng):
    """Identical and repetitive sequences: runs of many pairs across slab
    bounds and scatter chunks; singleton runs on the diagonal."""
    X = [[1] * 14, [1] * 14, [1] * 12, [1, 2] * 7, [2, 1] * 7]
    X += random_ragged_seqs(rng, 5, 10, 14, alphabet=2)
    _, t = _engines(X, 4, 2, sorted_slab=4, sorted_run_width=2)
    np.testing.assert_array_equal(t.exact(), oracle.exact_counts(X, 4, 2))


@pytest.mark.parametrize("g,m,alpha,words,packed", [
    (14, 4, 30, 1, True),  # k=10: one 62-bit word, the sequence id packed in
    (14, 2, 30, 1, False),  # k=12 fills the word: the id is a key of its own
    (16, 2, 30, 2, True),  # k=14: two words
])
def test_sorted_multiword_hash(rng, g, m, alpha, words, packed):
    X = random_ragged_seqs(rng, 8, 16, 24, alphabet=alpha)
    _, t = _engines(X, g, m)
    assert t.n_words == words
    k = g - m
    last = k - (words - 1) * t.dpw
    assert ((t.base**last) << max(t.n, 2).bit_length() <= 1 << 62) == packed
    thetas = enumerate_combinations(g, k)[::7]
    got = sum(t._pass(th).numpy().astype(np.int64) for th in thetas)
    np.testing.assert_array_equal(got, oracle.counts_for_thetas(X, g, thetas))


def test_sorted_counts_past_bf16_and_f32(rng):
    """Counts above 256 (f32 products) and p_max > 4095 (f64 products, the
    JAX package's int8 digit range) stay exact."""
    rep = [1, 2, 1, 1, 2, 2] * 50
    X = [rep, rep[:-6], [2, 1] * 140] + random_ragged_seqs(rng, 4, 260, 300, alphabet=2)
    j, t = _engines(X, 4, 2, sorted_slab=256)
    assert t.p_max > 255 and not t._static_kwargs()["count_split"]
    want = oracle.exact_counts(X, 4, 2)
    assert want.max() // 3 > 255 * 255
    np.testing.assert_array_equal(t.exact(), want)

    L = 4400
    X = [[1] * L, [1] * (L - 8), list(rng.integers(1, 3, L - 16))]
    j, t = _engines(X, 4, 1, sorted_slab=512)
    assert t.p_max > 4095 and t._static_kwargs()["count_split"]
    want = oracle.exact_counts(X, 4, 1)
    assert want.max() > 1 << 24
    np.testing.assert_array_equal(t.exact(), want)
    np.testing.assert_array_equal(t.exact_device().to_host_int64(), want)
    np.testing.assert_array_equal(t.exact(), j.exact())


def test_sorted_tri_blocks_at_1536_sequences(rng):
    """At n >= 1536 the JAX engine takes its upper-block-triangle products
    (two row blocks) and mirrors them; the port's full products give the
    same integers."""
    X = random_ragged_seqs(rng, 1536, 6, 10, alphabet=24)
    j, t = _engines(X, 4, 1)
    assert j._tri_blocks == 2
    want = j.exact()
    np.testing.assert_array_equal(t.exact(), want)
    np.testing.assert_array_equal(t.exact_device().to_host_int64(), want)


def test_sorted_batches_equal_single_passes(rng):
    """A batch of three passes a spill check: the stream's sum equals its
    single passes summed, and the JAX engine's."""
    X = random_ragged_seqs(rng, 8, 8, 20, alphabet=20)
    j, t = _engines(X, 6, 3, sorted_slab=64, theta_batch=3)
    assert t.theta_batch == 3
    thetas = enumerate_combinations(6, 3)[:5]
    single = sum(t._pass(th).numpy().astype(np.int64) for th in thetas)
    np.testing.assert_array_equal(t._sum_stream(thetas), single)
    np.testing.assert_array_equal(t._sum_stream_device(thetas).to_host_int64(), single)
    np.testing.assert_array_equal(t.exact(), j.exact())
    np.testing.assert_array_equal(t.exact_device().to_host_int64(), j.exact())


@pytest.mark.parametrize("seed,delta,max_iters,batch", [
    (3, 0.025, 6, 1),
    (1, 0.2, -1, 1),  # converges mid-stream
    (1, 0.2, -1, 4),  # the same, inside a batch of 4
])
def test_sorted_approx_matches_jax(rng, seed, delta, max_iters, batch):
    X = random_ragged_seqs(rng, 10, 14, 30, alphabet=3)
    j, t = _engines(X, 8, 4, theta_batch=batch)
    jr = j.approx(conv_delta=delta, max_iters=max_iters, seed=seed)
    tr = t.approx(conv_delta=delta, max_iters=max_iters, seed=seed)
    assert tr.iters == jr.iters and tr.converged == jr.converged
    assert max_iters != -1 or tr.converged
    np.testing.assert_array_equal(tr.counts, jr.counts)
    np.testing.assert_allclose(tr.stdevs, jr.stdevs, rtol=1e-4)
    assert tr.stdevs[0] == pytest.approx(np.sqrt(9999999), rel=1e-5)
    stream = sample_combinations(8, 4, np.random.default_rng(seed))[: tr.iters]
    np.testing.assert_array_equal(tr.counts, oracle.counts_for_thetas(X, 8, stream))
    dev = t.approx(conv_delta=delta, max_iters=max_iters, seed=seed, device_out=True)
    assert dev.iters == jr.iters
    np.testing.assert_array_equal(dev.counts.to_host_int64(), jr.counts)


def test_sorted_skip_variance_matches_jax(rng):
    X = random_ragged_seqs(rng, 8, 10, 16, alphabet=20)
    j, t = _engines(X, 7, 3, sorted_slab=64)
    for max_iters in (9, -1):
        jr = j.approx(max_iters=max_iters, skip_variance=True, seed=11)
        tr = t.approx(max_iters=max_iters, skip_variance=True, seed=11)
        assert (tr.iters, tr.stdevs, tr.converged) == (jr.iters, jr.stdevs, jr.converged)
        np.testing.assert_array_equal(tr.counts, jr.counts)
        dr = t.approx(max_iters=max_iters, skip_variance=True, seed=11, device_out=True)
        np.testing.assert_array_equal(dr.counts.to_host_int64(), jr.counts)


def test_sorted_adaptive_spill_forced(rng):
    """A shrunken accumulator limit forces the adaptive max-check spill:
    counts and the Welford trajectory are unchanged, as in the JAX test."""
    X = random_ragged_seqs(rng, 6, 40, 60, alphabet=4)
    j, t = _engines(X, 6, 2)
    want = j.exact()
    ref = j.approx(max_iters=9, seed=3)
    t._adaptive_spill = True
    t._acc_limit = t._per_theta_bound * (t.theta_batch + 1)
    np.testing.assert_array_equal(t.exact(), want)
    res = t.approx(max_iters=9, seed=3)
    assert res.iters == ref.iters
    np.testing.assert_array_equal(res.counts, ref.counts)
    np.testing.assert_allclose(res.stdevs, ref.stdevs, rtol=1e-4)


def test_hash_plan_and_refusals():
    assert sorted_theta.hash_plan(4, 20) == (20, 1)
    assert sorted_theta.hash_plan(24, 8) == (8, 1)
    assert sorted_theta.hash_plan(100, 20) == (9, 3)
    with pytest.raises(ValueError, match="16384"):
        TSorted(encode_sequences([[1, 2] * 8200]), 4, 2, T.KernelConfig(device="cpu"))


# ------------------------------------------------ the API's approx job


def _protein_set(seed):
    """A protein-shaped ragged set: 40 sequences of 16-60 letters over 24,
    so ``hash_base**k`` at g 8, m 4 (24^4) passes ``b_max_dense`` and
    ``FastSK`` takes the sorted engine by the alphabet alone."""
    rng = np.random.default_rng(seed)
    X = random_ragged_seqs(rng, 40, 16, 60, alphabet=24)
    X[0] = list(range(1, 25))  # every letter observed: hash_base 24
    return X, np.array([0, 1] * 20)


def _approx_job(X, y, seed, **fsk_kw):
    fsk = T.FastSK(8, 4, approx=True, delta=0.025, seed=seed,
                   config=T.KernelConfig(device="cpu", device_resident=True), **fsk_kw)
    built = []
    real = fsk._make_engine
    fsk._make_engine = lambda enc: built.append(real(enc)) or built[-1]
    fsk.compute_kernel(X[:30], X[30:], y[:30], y[30:])
    assert [type(e) for e in built] == [TSorted]
    return fsk


@pytest.mark.parametrize("seed", [1, 2])
def test_sorted_approx_job_follows_the_plain_reference(seed):
    """FastSK's default approx call on protein letters against the
    benchmark's plain reference (``gkmbench/reference.py``: PyTorch and
    NumPy, nothing of the program): the same iterations by the reference's
    own stop rule, bit-equal counts, no step that contradicts the rule, and
    the sd trace within 1e-5."""
    from gkmbench import reference as ref

    X, y = _protein_set(seed)
    fsk = _approx_job(X, y, seed)
    r = ref.approx_reference(X, 30, 8, 4, seed, 0.025, None, -1, "cpu")
    assert r["iters"] == fsk.iterations
    judged = ref.approx_reference(X, 30, 8, 4, seed, 0.025, fsk.iterations, -1, "cpu")
    assert judged["stop"] == 0
    np.testing.assert_array_equal(judged["counts"].numpy(), fsk.kernel_counts)
    assert ref.sd_gap(fsk.get_stdevs(), judged["sd"]) < 1e-5
    if fsk.iterations < len(enumerate_combinations(8, 4)):
        late = ref.approx_reference(X, 30, 8, 4, seed, 0.025, fsk.iterations + 1, -1, "cpu")
        assert late["stop"] >= 1


def test_sorted_passes_slabs_and_spans_are_counted():
    """The counters ``sorted.passes`` (one a pass) and ``sorted.slabs``
    (the slab products) are always on; under a recording profiler the
    spans ``sorted.sort``, ``sorted.products`` and ``theta.pull`` are
    entered once a pass; neither changes the counts or the sd trace."""
    from torch.profiler import ProfilerActivity, profile

    from fastsk_tpu_torch.utils import observe

    X, y = _protein_set(3)
    before = observe.counters()
    plain = _approx_job(X, y, 3)
    moved = observe.counters() - before
    passes = plain.iterations
    assert moved["sorted.passes"] == passes and moved["sorted.slabs"] >= 1
    assert not [k for k in moved if k.endswith((".span_s", ".spans"))]

    before = observe.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _approx_job(X, y, 3)
    moved = observe.counters() - before
    assert moved["sorted.passes"] == passes
    for name in ("sorted.sort", "sorted.products", "theta.pull"):
        assert moved[f"{name}.spans"] == passes and moved[f"{name}.span_s"] > 0, name
    np.testing.assert_array_equal(traced.kernel_counts, plain.kernel_counts)
    assert traced.get_stdevs() == plain.get_stdevs()
