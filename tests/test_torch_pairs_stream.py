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
# memory, one-hot rows past 512 bytes; 21 letters at 1,300 windows fit
# one sequence a resident tile since its j rows hold two windows each),
# then DNA g8 at 3,400 windows (it took the dp4a body before) and one
# whose j chunk does not fit at full depth (1,820-byte rows)
SETS = {
    "21x1300": (1, 5, 1300, 21, 8, 4, "resident"),
    "21x2000": (2, 4, 2000, 21, 8, 4, "windows"),
    "60x300": (3, 6, 300, 60, 10, 4, "depth"),
    "100x300": (4, 5, 300, 100, 8, 4, "depth"),
    "dna3400": (5, 4, 3407, 4, 8, 4, "resident"),
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
    plan = pairs_cuda.mma_plan(eng.n_pad, eng.p_pad, g * eng.alpha, g)
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
        (8, 1304, 8, 21, pairs_cuda.mma_plan(8, 1304, 192, 8)),
        (8, 296, 10, 60, pairs_cuda.mma_plan(8, 296, 640, 10)),
        (8, 3400, 8, 4, pairs_cuda.mma_plan(8, 3400, 64, 8)),
        (16, 192, 13, 5, pairs_cuda.mma_plan(16, 192, 65, 13)),
        (16, 56, 8, 5, pairs_cuda.mma_plan(16, 56, 40, 8)),
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
    "n_pad,p_pad,width,g,layout,tile,ranges,stages,epilogue",
    [
        (7024, 192, 65, 13, "resident", 8, 1, 4, "one"),  # KAT2B g13 m7 (the benchmark's)
        (7024, 200, 40, 8, "resident", 8, 1, 4, "two"),  # KAT2B g8 m4 (chip_smoke.py's)
        (7232, 192, 64, 16, "resident", 8, 1, 4, "one"),  # 7230 x 200 DNA, g16 m10
        (512, 4000, 32, 8, "resident", 1, 1, 4, "one"),  # chip_smoke.py's DNA set
        (1024, 1304, 168, 8, "resident", 1, 1, 3, "one"),  # its 21-letter set
        (512, 4000, 80, 8, "windows", 1, 2, 4, "one"),  # 10 letters: 96-byte rows
        (32, 56, 40, 8, "resident", 8, 1, 4, "one"),  # 64 windows a sequence
        (16, 8, 24, 6, "resident", 8, 1, 4, "runs"),  # short sequences
        (24, 200, 40, 8, "resident", 8, 1, 4, "two"),  # 208 windows a sequence
        (2048, 296, 600, 10, "depth", 8, 1, 0, ""),  # its 60-letter set
        (8, 296, 640, 20, "depth", 8, 19, 0, ""),  # few tile pairs: ranges for the grid
        (8, 200, 5120, 20, "slabs", 8, 13, 0, ""),  # 256 letters at g20
        (8, 200, 1536, 20, "depth", 8, 13, 0, ""),  # the deepest depth layout
        (24, 2000, 168, 8, "windows", 1, 2, 4, "one"),  # two ranges of 4 paired chunks
        (1000, 200, 448, 8, "resident", 1, 1, 2, "one"),  # 56 letters: a ring of two
        (1000, 200, 512, 8, "resident", 1, 1, 2, "one"),  # 64 letters, likewise
        (24, 2000, 576, 8, "windows", 1, 8, 2, "one"),  # a ring of two beside one paired chunk
        (24, 2000, 640, 8, "depth", 8, 125, 0, ""),  # past a ring of two
        (1000, 200, 512, 20, "depth", 8, 1, 0, ""),  # g20's pair table leaves no room
    ],
)
def test_mma_plan_layouts(n_pad, p_pad, width, g, layout, tile, ranges, stages, epilogue):
    """``mma_plan``'s layout at each shape, its ranges covering the tile's
    j chunks, its rows' padding, ring and epilogue, its block within the
    card's 227 KB of shared memory and its grid (the resident and windows
    layouts' one block an SM)."""
    plan = pairs_cuda.mma_plan(n_pad, p_pad, width, g)
    assert (plan.layout, plan.tile, plan.ranges) == (layout, tile, ranges)
    assert (plan.stages, plan.epilogue) == (stages, epilogue)
    paired = layout in ("resident", "windows")  # j rows hold two windows
    nc = -(-tile * (pairs_cuda.ws_windows(p_pad) if paired else p_pad) // (256 if paired else 128))
    assert (plan.ranges - 1) * plan.range_chunks < nc <= plan.ranges * plan.range_chunks
    assert plan.smem <= 227 * 1024
    nt = n_pad // tile
    units = nt * (nt + 1) // 2 * plan.ranges
    if layout in ("depth", "slabs"):
        assert plan.slab == 64 and plan.blocks == units
    else:
        # rows padded to one k-step; the ring, the resident chunks, the pair
        # table and both bin sets are the block's shared memory
        assert plan.slab == -(-width // 32) * 32 and plan.blocks == min(units, 132)
        # a ring of two only where three leave one sequence no room
        assert 3 <= plan.stages <= 4 or (plan.stages == 2 and tile == 1 and pairs_cuda._ws_smem(
            1, plan.range_chunks, 3, plan.slab, g) > 227 * 1024)
        assert plan.epilogue == pairs_cuda.mma_epilogue(tile, p_pad)
        assert plan.smem == pairs_cuda._ws_smem(tile, plan.range_chunks, stages, plan.slab, g)
        assert pairs_cuda._ws_smem(tile, plan.range_chunks, stages + 1, plan.slab, g) > (
            227 * 1024) or stages == 4


@pytest.mark.parametrize("n_pad,p_pad,s,f,depth,g", [
    (16, 192, 8, 65, 96, 13), (8, 200, 4, 40, 64, 8), (3, 4000, 1, 32, 32, 8),
    (6, 8, 2, 24, 32, 6),
])
def test_ws_operands_are_the_core_matrix_order(n_pad, p_pad, s, f, depth, g):
    """The resident and windows layouts' operands: each sequence re-padded
    to a multiple of 16 windows, chunk c of tile t the contiguous 128 x
    depth bytes at (t chunks + c) 128 depth, row r and byte b of the chunk
    at csrc/hopper.cuh:onehot_at(r, b, depth), rows past the tile and bytes
    past the row zero; the paired rows (g + 1) x_2q + x_2q+1."""
    rng = np.random.default_rng(n_pad + f)
    x = torch.from_numpy(rng.integers(0, 2, size=(n_pad * p_pad, f)).astype(np.int8))
    rows, paired = pairs_cuda.ws_operands(x, p_pad, s, depth, g)
    pw = pairs_cuda.ws_windows(p_pad)
    assert pw % 16 == 0 and pw - 16 < p_pad <= pw
    padded = torch.zeros((n_pad, pw, depth), dtype=torch.int8)
    padded[:, :p_pad, :f] = x.view(n_pad, p_pad, f)
    padded = padded.view(n_pad // s, s * pw, depth)
    r = torch.arange(128)[:, None]
    b = torch.arange(depth)[None, :]
    at = (r // 8) * (depth * 8) + (b // 16) * 128 + (r % 8) * 16 + b % 16
    for got, want in ((rows, padded), (paired, padded[:, 0::2] * (g + 1) + padded[:, 1::2])):
        nc = -(-want.shape[1] // 128)
        assert got.shape == (n_pad // s, nc * 128, depth) and got.is_contiguous()
        full = torch.zeros_like(got)
        full[:, : want.shape[1]] = want
        flat = got.reshape(n_pad // s, nc, 128 * depth)
        for c in range(nc):
            torch.testing.assert_close(flat[:, c][:, at], full[:, c * 128 : (c + 1) * 128],
                                       rtol=0, atol=0)


def test_mma_plan_refuses_past_the_launch_limit():
    """The depth and slabs layouts launch a block a unit; the resident
    layout's persistent grid has no such limit."""
    with pytest.raises(ValueError, match="launch limit"):
        pairs_cuda.mma_plan(8 * 65536, 200, 5120, 20)
    assert pairs_cuda.mma_plan(8 * 65536, 200, 64, 20).layout == "resident"


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
