"""The PyTorch port's exact counts against the JAX package and the oracle.

Same numpy-seeded inputs through ``fastsk_tpu`` (XLA backend, and the
Pallas kernel in interpret mode) and ``fastsk_tpu_torch`` on the CPU,
where kernel A's wrapper runs its plain version. Counts are integers:
the tolerance is equality.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fastsk_tpu_torch as T
from fastsk_tpu import FastSK as JFastSK
from fastsk_tpu import FastaUtility as JFastaUtility
from fastsk_tpu import KernelConfig as JKernelConfig
from fastsk_tpu.kernel.pairs_engine import PairsGkmEngine as JPairsGkmEngine
from fastsk_tpu.kernel.pairs_engine import _pairs_full_device_jit
from fastsk_tpu.ops.pairs import onehot_windows as j_onehot_windows
from fastsk_tpu_torch.kernel.pairs_engine import PairsGkmEngine
from fastsk_tpu_torch.ops import pairs, pairs_cuda
from fastsk_tpu_torch.ops.encode import encode_sequences
from fastsk_tpu_torch.utils.observe import counters

import oracle
from conftest import random_ragged_seqs

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CPU = T.KernelConfig(device="cpu")


# the shapes of tests/test_pairs_engine.py::test_pairs_matches_oracle
@pytest.mark.parametrize(
    "g,m,n,lmin,lmax,alpha",
    [
        (6, 3, 9, 8, 20, 4),
        (5, 1, 7, 6, 14, 3),
        (8, 4, 12, 10, 22, 4),
        (4, 2, 5, 4, 9, 20),
        (6, 5, 8, 7, 15, 30),
        (5, 0, 6, 6, 12, 4),
        (7, 3, 10, 7, 7, 4),
    ],
)
def test_counts_match_jax_and_oracle(rng, g, m, n, lmin, lmax, alpha):
    X = random_ragged_seqs(rng, n, lmin, lmax, alphabet=alpha)
    enc = encode_sequences(X)
    got = PairsGkmEngine(enc, g, m, CPU).exact()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, oracle.exact_counts(X, g, m))
    np.testing.assert_array_equal(got, JPairsGkmEngine(enc, g, m).exact())


def test_counts_match_pallas_interpret(rng):
    X = random_ragged_seqs(rng, 11, 9, 18, alphabet=4)
    enc = encode_sequences(X)
    jeng = JPairsGkmEngine(enc, 6, 3, JKernelConfig(pairs_backend="pallas"))
    full = np.asarray(
        _pairs_full_device_jit(
            jeng._build_x(), g=6, k=3, p_pad=jeng.p_pad, c_ti=jeng.c_i,
            c_tj=jeng.c_j, n=jeng.n, interpret=True,
        )
    )
    dev = PairsGkmEngine(enc, 6, 3, CPU).exact_device()
    assert dev.counts.dtype == torch.int32
    np.testing.assert_array_equal(dev.to_host_int64(), full)


def test_onehot_windows_match_jax(rng):
    X = random_ragged_seqs(rng, 6, 7, 15, alphabet=5)
    enc = encode_sequences(X)
    g, p_pad = 5, 16
    kw = dict(g=g, alpha=enc.hash_base, code_min=enc.code_min, p_pad=p_pad)
    want = j_onehot_windows(
        jnp.asarray(enc.ids), jnp.asarray(enc.lengths), dtype=jnp.int8, **kw
    )
    got = pairs.onehot_windows(
        torch.from_numpy(enc.ids), torch.from_numpy(enc.lengths), **kw
    )
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_duplicate_and_uniform_seqs(rng):
    X = [[1] * 12, [1] * 12, [1, 2] * 6, rng.integers(1, 5, size=12).tolist()]
    got = PairsGkmEngine(encode_sequences(X), 5, 2, CPU).exact()
    np.testing.assert_array_equal(got, oracle.exact_counts(X, 5, 2))


def test_int32_bound_guard():
    """The same refusal as the JAX engine; the port's FastSK then routes
    to the packed engine, as the JAX package does, and an explicit
    ``exact_engine="pairs"`` still raises."""
    from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine

    X = [[1, 2, 3, 4] * 200 for _ in range(3)]  # len 800 -> huge p_pad
    enc = encode_sequences(X)
    with pytest.raises(ValueError):
        PairsGkmEngine(enc, 16, 10, CPU)
    engine = T.FastSK(g=16, m=10, config=CPU)._make_exact_engine(enc)
    assert isinstance(engine, PackedPairsEngine)
    with pytest.raises(ValueError, match="int32"):
        T.FastSK(
            g=16, m=10, config=T.KernelConfig(device="cpu", exact_engine="pairs")
        )._make_exact_engine(enc)


def test_binom_exact_integer_table():
    x = torch.arange(0, 21, dtype=torch.float32)
    for k in range(1, 11):
        want = np.array([math.comb(v, k) for v in range(21)], dtype=np.float64)
        np.testing.assert_array_equal(pairs.binom_exact(x, k).numpy(), want)


def test_plain_strips_match_one_strip(rng):
    """The strip loop of the plain version (forced to one sequence per
    strip) gives the same matrix as one strip over everything."""
    X = [rng.integers(1, 5, size=20).tolist() for _ in range(10)]
    eng = PairsGkmEngine(encode_sequences(X), 6, 2, CPU)
    x = eng._build_x()
    one = pairs.pairs_counts_plain(x, k=4, p_pad=eng.p_pad)
    many = pairs.pairs_counts_plain(x, k=4, p_pad=eng.p_pad, strip_rows=eng.p_pad)
    np.testing.assert_array_equal(one.numpy(), many.numpy())
    np.testing.assert_array_equal(one.numpy(), one.numpy().T)


def test_kernel_a_wrapper_checks_inputs():
    x = torch.zeros((16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        pairs_cuda.pairs_counts(x.float(), g=4, k=2, p_pad=8)
    with pytest.raises(ValueError, match="multiple"):
        pairs_cuda.pairs_counts(x[:12], g=4, k=2, p_pad=8)
    with pytest.raises(ValueError, match="contiguous"):
        pairs_cuda.pairs_counts(x[:, ::2], g=4, k=2, p_pad=8)
    with pytest.raises(ValueError, match="k <= g"):
        pairs_cuda.pairs_counts(x, g=4, k=0, p_pad=8)
    before = counters()["pairs_counts.launches"]
    pairs_cuda.pairs_counts(x, g=4, k=2, p_pad=8)
    assert counters()["pairs_counts.launches"] == before  # CPU path: no launch


@pytest.mark.parametrize(
    "n_pad,p_pad,f,width,tile",
    [
        (7024, 200, 40, 40, 8),  # KAT2B g=8 over {a,c,g,n,t}
        (7232, 192, 64, 64, 8),  # 7230 x 200 DNA, g=16
        (24, 96, 24, 24, 8),
        (12, 8, 21, 24, 4),
        (7, 256, 400, 512, 1),
    ],
)
def test_kernel_a_tiling(n_pad, p_pad, f, width, tile):
    assert pairs_cuda.padded_width(f) == width
    s = pairs_cuda.tile_sequences(n_pad, p_pad, width)
    assert s == tile and n_pad % s == 0
    assert s * p_pad * width <= 227 * 1024


@pytest.mark.parametrize(
    "g,alpha,depth",
    [
        (8, 5, 64),     # KAT2B: 40 one-hot bytes pad to 64
        (16, 4, 64),    # 7230 x 200 DNA, g=16
        (8, 16, 128),
        (8, 24, 192),
        (8, 40, 320),
        (8, 41, 384),
        (8, 56, 448),   # the deepest tensor-core tile at p_pad = 200
        (10, 40, 448),
        (6, 3, 64),
    ],
)
def test_kernel_a_mma_depth_padding(rng, g, alpha, depth):
    """The tensor-core body's depth: g * alpha rounded up to 64 bytes; the
    zero bytes it pads with add no matches."""
    assert pairs_cuda.mma_depth(g * alpha) == depth
    assert depth % 64 == 0 and depth - 64 < g * alpha <= depth
    X = [rng.integers(1, alpha + 1, size=g + 5).tolist() for _ in range(4)]
    X[0][: min(alpha, g + 5)] = list(range(1, min(alpha, g + 5) + 1))
    eng = PairsGkmEngine(encode_sequences(X), g, g // 2, CPU)
    x = eng._build_x()
    padded = torch.nn.functional.pad(x, (0, depth - x.shape[1]))
    k = g - g // 2
    np.testing.assert_array_equal(
        pairs.pairs_counts_plain(padded, k=k, p_pad=eng.p_pad).numpy(),
        pairs.pairs_counts_plain(x, k=k, p_pad=eng.p_pad).numpy(),
    )


# the alphabets of chip_smoke.py's phase-3 depth sweep (one-hot depths
# 128 to 448 bytes at g=8) and 64 letters (512 bytes), on uniform and
# ragged lengths
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("alpha", [16, 24, 40, 48, 56, 64])
def test_counts_match_jax_at_sweep_alphabets(rng, alpha, ragged):
    X = (
        random_ragged_seqs(rng, 5, 9, 16, alphabet=alpha)
        if ragged
        else [rng.integers(1, alpha + 1, size=14).tolist() for _ in range(5)]
    )
    enc = encode_sequences(X)
    got = PairsGkmEngine(enc, 8, 4, CPU).exact()
    np.testing.assert_array_equal(got, oracle.exact_counts(X, 8, 4))
    np.testing.assert_array_equal(got, JPairsGkmEngine(enc, 8, 4).exact())


def test_kernel_a_body_argument_checked_and_cpu_plain():
    x = torch.zeros((16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="body"):
        pairs_cuda.pairs_counts(x, g=4, k=2, p_pad=8, body="wgmma")
    before = counters()
    for body in ("mma", "dp4a", None):
        pairs_cuda.pairs_counts(x, g=4, k=2, p_pad=8, body=body)
    assert counters() == before  # CPU path: no launch
    # kernel H's variants of the same body: the plain versions on the CPU
    before = counters()["pairs_probe.launches"]
    current = pairs_cuda.pairs_probe(x, g=4, k=2, p_pad=8, variant="current")
    torch.testing.assert_close(current, pairs_cuda.pairs_counts(x, g=4, k=2, p_pad=8), rtol=0, atol=0)
    assert counters()["pairs_probe.launches"] == before


def _load_tri(path):
    with open(path) as f:
        header = f.readline()
        while not header.startswith("n="):
            header = f.readline()
        n = int(header.split()[0].split("=")[1])
        K = np.zeros((n, n))
        for i in range(n):
            vals = [float(v) for v in f.readline().split()]
            K[i, : i + 1] = vals
            K[: i + 1, i] = vals
    return K


@pytest.mark.parametrize("device_resident", [False, True])
def test_golden_ep_sl_bit_identical(device_resident):
    """f64 cosine normalization of the port's counts reproduces the
    reference C++ engine's doubles bit for bit (the device-resident run
    pulls its int32 counts and normalizes on the host)."""
    golden = _load_tri(os.path.join(GOLDEN, "ep_sl_g6m2.txt"))
    reader = T.FastaUtility()
    Xtr, _ = reader.read_data(os.path.join(GOLDEN, "ep_sl.train.fasta"))
    Xte, _ = reader.read_data(os.path.join(GOLDEN, "ep_sl.test.fasta"))
    fsk = T.FastSK(
        g=6, m=2, config=T.KernelConfig(device="cpu", device_resident=device_resident)
    )
    fsk.compute_kernel(Xtr, Xte)
    np.testing.assert_array_equal(fsk.kernel, golden)

    jreader = JFastaUtility()
    jfsk = JFastSK(g=6, m=2)
    jfsk.compute_kernel(
        jreader.read_data(os.path.join(GOLDEN, "ep_sl.train.fasta"))[0],
        jreader.read_data(os.path.join(GOLDEN, "ep_sl.test.fasta"))[0],
    )
    np.testing.assert_array_equal(fsk.kernel_counts, jfsk.kernel_counts)
