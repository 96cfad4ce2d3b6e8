"""Kernel A at every shape ``fastsk_tpu``'s sequence-aligned engine takes.

Kernel A's tensor-core body streams the j windows (the windows layout)
and the one-hot depth (the depth and slabs layouts) where a tile does
not fit, so ``PairsGkmEngine`` refuses only what the JAX engine refuses:
the int32 bound. Same numpy-seeded uniform sets through ``fastsk_tpu`` (the XLA
backend, as its own tests run it on the CPU) and ``fastsk_tpu_torch`` on
the CPU, where kernel A's wrapper runs its plain version in the plan's
partition (``ops/pairs.py:_counts_as_planned``). Counts are integers:
the tolerance is equality.
"""

import functools

import numpy as np
import pytest
import torch

import fastsk_tpu as J
import fastsk_tpu_torch as T
from fastsk_tpu.kernel.pairs_engine import PairsGkmEngine as JPairsGkmEngine
from fastsk_tpu_torch.kernel.pairs_engine import PairsGkmEngine
from fastsk_tpu_torch.ops import pairs, pairs_cuda
from fastsk_tpu_torch.ops.encode import encode_sequences
from fastsk_tpu_torch.utils.observe import counters

CPU = T.KernelConfig(device="cpu")

# name: (seed, sequences, length, letters, g, m, kernel A's layout); the
# first four are the shapes kernel A once refused (windows past shared
# memory, one-hot rows past 512 bytes), then one past the resident
# layout at DNA g8 (3,400 windows; it took the dp4a body before) and one
# whose j chunk does not fit at full depth (1,820-byte rows)
SETS = {
    "21x1300": (1, 5, 1300, 21, 8, 4, "windows"),
    "21x2000": (2, 4, 2000, 21, 8, 4, "windows"),
    "60x300": (3, 6, 300, 60, 10, 4, "depth"),
    "100x300": (4, 5, 300, 100, 8, 4, "depth"),
    "dna3400": (5, 4, 3407, 4, 8, 4, "windows"),
    "130x150": (6, 5, 150, 130, 14, 7, "slabs"),
}


@functools.lru_cache(maxsize=None)
def _set(name):
    seed, n, length, alpha, g, m, _ = SETS[name]
    X = np.random.default_rng(seed).integers(1, alpha + 1, size=(n, length))
    X[0, :alpha] = np.arange(1, alpha + 1)  # every letter, so hash_base = alpha
    X = X.tolist()
    enc = encode_sequences(X)
    assert enc.hash_base == alpha
    return X, enc, g, m, JPairsGkmEngine(enc, g, m).exact()


@pytest.mark.parametrize("name", list(SETS))
def test_engine_builds_and_counts_equal_jax(name):
    X, enc, g, m, want = _set(name)
    eng = PairsGkmEngine(enc, g, m, CPU)
    plan = pairs_cuda.mma_plan(eng.n_pad, eng.p_pad, pairs_cuda.mma_depth(g * eng.alpha))
    assert plan.layout == SETS[name][-1]
    got = eng.exact()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(SETS))
def test_auto_picks_the_jax_engine(name):
    X, enc, g, m, _ = _set(name)
    port = T.FastSK(g, m, config=CPU)._make_exact_engine(enc)
    ref = J.FastSK(g, m)._make_exact_engine(enc)
    assert type(port).__name__ == type(ref).__name__ == "PairsGkmEngine"


@pytest.mark.parametrize("name", list(SETS))
def test_forced_pairs_computes(name):
    """``exact_engine="pairs"`` computes where ``fastsk_tpu`` computes:
    the API's counts equal the JAX engine's."""
    X, enc, g, m, want = _set(name)
    fsk = T.FastSK(g, m, config=T.KernelConfig(device="cpu", exact_engine="pairs"))
    fsk.compute_train(X)
    np.testing.assert_array_equal(fsk.kernel_counts, want)


def _onehot(rng, n_pad, p_pad, g, alpha, valid):
    """Seeded one-hot window rows: g codes a row, a share ``valid`` of the
    rows live (the others all-zero, as padding is)."""
    codes = rng.integers(0, alpha, size=(n_pad * p_pad, g))
    x = np.zeros((n_pad * p_pad, g * alpha), np.int8)
    for j in range(g):
        x[np.arange(len(x)), j * alpha + codes[:, j]] = 1
    x[rng.random(len(x)) > valid] = 0
    return torch.from_numpy(x)


def _plan(layout, tile, range_chunks, slab):
    return pairs_cuda.MmaPlan(layout, tile, range_chunks, 0, slab, 0, 0)


# plans forced at small shapes, each with boundaries the kernel must get
# right: ranges ending inside a sequence and on a diagonal tile, 64-row
# halves across sequences (p_pad not a multiple of 64, and p_pad < 64),
# several sequences a tile, k-slabs and a last slab shorter than 64
@pytest.mark.parametrize(
    "n_pad,p_pad,g,alpha,plan",
    [
        (8, 200, 8, 5, _plan("windows", 1, 1, 64)),
        (8, 200, 8, 5, _plan("windows", 1, 2, 64)),
        (16, 96, 5, 20, _plan("depth", 4, 2, 64)),
        (8, 200, 8, 5, _plan("slabs", 2, 1, 16)),
        (16, 40, 10, 13, _plan("slabs", 8, 1, 64)),
        (8, 48, 10, 13, _plan("resident", 8, 3, 130)),
        (8, 1304, 8, 21, pairs_cuda.mma_plan(8, 1304, 192)),
        (8, 296, 10, 60, pairs_cuda.mma_plan(8, 296, 640)),
        (8, 3400, 8, 4, pairs_cuda.mma_plan(8, 3400, 64)),
    ],
)
def test_plain_partition_equals_unpartitioned(n_pad, p_pad, g, alpha, plan):
    """``pairs_counts_plain``'s windows-range and k-slab partition (the
    plan's) equals its unpartitioned product, and is symmetric."""
    rng = np.random.default_rng(n_pad * p_pad + alpha)
    x = _onehot(rng, n_pad, p_pad, g, alpha, 0.9)
    want = pairs.pairs_counts_plain(x, k=3, p_pad=p_pad)
    got = pairs.pairs_counts_plain(x, k=3, p_pad=p_pad, plan=plan)
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, got.T, rtol=0, atol=0)


@pytest.mark.parametrize(
    "n_pad,p_pad,depth,layout,tile,ranges",
    [
        (7024, 200, 64, "resident", 4, 1),  # KAT2B g8 m4
        (7232, 192, 64, "resident", 8, 1),  # 7230 x 200 DNA, g16 m10
        (512, 4000, 64, "windows", 1, 3),  # chip_smoke.py's DNA set
        (1024, 1304, 192, "windows", 1, 2),  # its 21-letter set
        (2048, 296, 640, "depth", 8, 1),  # its 60-letter set
        (8, 296, 640, "depth", 8, 19),  # few tile pairs: ranges for the grid
        (8, 200, 5120, "slabs", 8, 13),  # 256 letters at g20
        (8, 200, 1536, "depth", 8, 13),  # the deepest depth layout
        (24, 2000, 576, "windows", 1, 16),  # the deepest windows layout
    ],
)
def test_mma_plan_layouts(n_pad, p_pad, depth, layout, tile, ranges):
    """``mma_plan``'s layout at each shape, its ranges covering the tile's
    j chunks, its block within shared memory and its grid."""
    plan = pairs_cuda.mma_plan(n_pad, p_pad, depth)
    assert (plan.layout, plan.tile, plan.ranges) == (layout, tile, ranges)
    nc = -(-tile * p_pad // 128)
    assert (plan.ranges - 1) * plan.range_chunks < nc <= plan.ranges * plan.range_chunks
    assert plan.smem <= 227 * 1024
    assert plan.slab == (64 if layout in ("depth", "slabs") else depth)
    nt = n_pad // tile
    assert plan.blocks == nt * (nt + 1) // 2 * plan.ranges


def test_mma_plan_refuses_past_the_launch_limit():
    with pytest.raises(ValueError, match="launch limit"):
        pairs_cuda.mma_plan(8 * 65536, 200, 64)


def test_engine_refuses_past_kernel_a_s_table():
    """g=24, m=2: kernel A's C(d, k) table stops at g=20 (the API's limit
    too), so the port's engine refuses at construction instead of in
    ``exact()``."""
    X = np.random.default_rng(9).integers(1, 5, size=(3, 40)).tolist()
    with pytest.raises(ValueError, match="g <= 20"):
        PairsGkmEngine(encode_sequences(X), 24, 2, CPU)


@pytest.mark.parametrize("name", ["21x1300", "60x300"])
def test_cpu_wrapper_follows_the_plan(name):
    """On the CPU, ``pairs_counts`` takes the plain version in the plan's
    partition (the default body) or unpartitioned (``body="dp4a"``); both
    equal the JAX engine's counts, and nothing launches."""
    X, enc, g, m, want = _set(name)
    eng = PairsGkmEngine(enc, g, m, CPU)
    x = eng._build_x()
    before = counters()
    for body in (None, "dp4a"):
        got = pairs_cuda.pairs_counts(x, g=g, k=g - m, p_pad=eng.p_pad, body=body)
        np.testing.assert_array_equal(got[: eng.n, : eng.n].numpy(), want)
    assert counters() == before
