"""The port's mesh paths (kernel F) and kernel-A probe (kernel H) against
the JAX package, on the CPU.

The repo's conftest gives JAX 8 virtual CPU devices; the port's meshes
name the CPU device several times, its stand-in for them. The same
numpy-seeded inputs go through ``fastsk_tpu``'s ``PackedPairsEngine``
(XLA backend on a CPU mesh; kernel F, ``packed_s1_pallas``, in interpret
mode) and ``fastsk_tpu_torch``'s, whose kernel wrappers take their plain
versions on CPU tensors. Counts are integers: the tolerance is equality;
the whole-path test holds the AUC to the port's single-device run within
1e-9 (the same host int64 counts feed the same fit).
"""

import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastsk_tpu as J
import fastsk_tpu_torch as T
from fastsk_tpu.kernel.pairs_engine import PackedPairsEngine as JPacked
from fastsk_tpu.kernel.pairs_engine import PairsGkmEngine as JPairs
from fastsk_tpu.parallel import make_mesh as j_make_mesh
from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine, PairsGkmEngine
from fastsk_tpu_torch.ops import pairs, pairs_cuda, pairs_packed, pairs_packed_cuda
from fastsk_tpu_torch.ops.encode import encode_sequences
from fastsk_tpu_torch.parallel import default_mesh_shape, make_mesh
from fastsk_tpu_torch.parallel import sharding as shd
from fastsk_tpu_torch.utils.observe import counters

import oracle
from conftest import random_ragged_seqs

REPO = Path(__file__).resolve().parent.parent
CPU = dict(device="cpu")
MESHES = [(1, 1), (2, 4), (2, 3)]


@pytest.fixture
def small_tile(monkeypatch):
    """64-row strips in both packages, as tests/test_sharding.py does."""
    monkeypatch.setattr(JPacked, "TILE", 64)
    monkeypatch.setattr(PackedPairsEngine, "TILE", 64)


def cpu_mesh(n_rows, n_theta):
    return make_mesh(n_rows, n_theta, devices=["cpu"] * (n_rows * n_theta))


def _jax_mesh(n_rows, n_theta):
    if len(jax.devices()) < n_rows * n_theta:
        pytest.skip("needs the conftest's 8 virtual JAX devices")
    return j_make_mesh(n_rows, n_theta)


# ---------------------------------------------------------------- the mesh


@pytest.mark.parametrize("n", range(1, 9))
def test_default_mesh_shape_matches_jax(n):
    from fastsk_tpu.parallel import default_mesh_shape as j_shape

    assert default_mesh_shape(n) == j_shape(n)


def test_make_mesh_repeated_devices_and_too_few():
    mesh = make_mesh(2, 3, devices=["cpu"] * 7)
    assert mesh.shape == {shd.ROWS_AXIS: 2, shd.THETA_AXIS: 3}
    assert mesh.size == 6 and mesh.devices == (torch.device("cpu"),) * 6
    with pytest.raises(ValueError, match="need 8 devices, have 3"):
        make_mesh(2, 4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 1 devices, have 0"):
            make_mesh(1, 1)  # the default: every visible CUDA device


@pytest.mark.parametrize("size,multiple", [(5, 4), (8, 4), (1, 3), (6, 1)])
def test_pad_to_multiple_matches_jax(size, multiple):
    from fastsk_tpu.parallel.sharding import pad_to_multiple as j_pad

    from fastsk_tpu_torch.parallel import pad_to_multiple

    x = np.arange(size * 3).reshape(size, 3)
    for axis in (0, 1):
        np.testing.assert_array_equal(pad_to_multiple(x, axis, multiple), j_pad(x, axis, multiple))


def test_config_checks_mesh():
    with pytest.raises(ValueError, match="mesh_state"):
        T.KernelConfig(mesh_state="rows", **CPU)
    with pytest.raises(ValueError, match="fit device's type"):
        T.KernelConfig(mesh=cpu_mesh(1, 2), device="cuda")
    cfg = T.KernelConfig(mesh=cpu_mesh(1, 2), mesh_state="replicated", **CPU)
    assert cfg.mesh.size == 2 and cfg.mesh_state == "replicated"


# ------------------------------------------------- kernel F and stage 2


def _jax_operands(enc, g, m):
    """The JAX engine and its bf16 one-hot table (TILE=64)."""
    from fastsk_tpu.kernel.pairs_engine import _build_packed_x_jit

    je = JPacked(enc, g, m)
    x = _build_packed_x_jit(
        je._ids, je._seq_of, je._win_of, g=g, alpha=je.alpha,
        code_min=je.code_min, dtype=jnp.bfloat16,
    )
    return je, x


def _strip_pairs(eng):
    """(a, b) pairs with a == b, a < b, and a strip whose sequences
    straddle its borders."""
    first = eng.pack["row0"]
    last = first + (eng.pack["p"] + 7) // 8 * 8 - 1
    cross = np.flatnonzero(first // eng.tile != last // eng.tile)
    assert len(cross), "no sequence straddles a strip border"
    a = int(first[cross[0]] // eng.tile)
    ns = eng.n_strips
    return [(0, 0), (a, a), (a, min(a + 1, ns - 1)), (0, ns - 1), (a, ns - 1)]


@pytest.mark.parametrize("g,m,n_digits", [(6, 3, 1), (12, 6, 2)])
def test_packed_s1_matches_jax_pallas_interpret(rng, small_tile, g, m, n_digits):
    """Kernel F's plain version (through its wrapper) equals the JAX
    Pallas kernel F in interpret mode, its digit planes recombined as
    ``sum_d base^d * s1_d``."""
    from fastsk_tpu.ops.pairs_packed import _strip_a_operands
    from fastsk_tpu.ops.pairs_packed_pallas import packed_s1_pallas

    X = random_ragged_seqs(rng, 8, 40, 150, alphabet=4)
    enc = encode_sequences(X)
    eng = PackedPairsEngine(enc, g, m, T.KernelConfig(**CPU))
    je, x = _jax_operands(enc, g, m)
    assert je.n_digits == n_digits and je.c_pad == eng.c_pad
    rows = eng.rows()
    for a, b in _strip_pairs(eng):
        _, _, ga_pad = _strip_a_operands(
            x, je._seq_of, je._first_seq, jnp.int32(a),
            tile=je.tile, c_max=je.c_max, backend="pallas",
        )
        s1_j = np.asarray(packed_s1_pallas(
            x, ga_pad, jnp.int32(a), jnp.int32(b), g=g, k=g - m, tile=je.tile,
            c_pad=je.c_pad, n_digits=je.n_digits, digit_base=je.digit_base,
            interpret=True,
        ), dtype=np.int64)
        want = sum(je.digit_base**d * s1_j[d] for d in range(je.n_digits))
        got = pairs_packed_cuda.packed_s1(rows, a, rows, b, 1, k=g - m)
        assert got.dtype == torch.int32 and got.shape == (1, eng.c_pad, eng.tile)
        np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("g,m", [(6, 3), (12, 6)])
def test_parts_from_s1_matches_jax_pair_parts(rng, small_tile, g, m):
    """Stage 2 on kernel F's output equals JAX's ``_pair_parts`` (XLA
    backend), digit planes recombined."""
    from fastsk_tpu.ops.pairs_packed import _pair_parts, _strip_a_operands

    X = random_ragged_seqs(rng, 8, 40, 150, alphabet=4)
    enc = encode_sequences(X)
    eng = PackedPairsEngine(enc, g, m, T.KernelConfig(**CPU))
    je, x = _jax_operands(enc, g, m)
    rows = eng.rows()
    bounds = torch.from_numpy(eng.pack["bounds"])
    for a, b in _strip_pairs(eng):
        xa, ga, _ = _strip_a_operands(
            x, je._seq_of, je._first_seq, jnp.int32(a),
            tile=je.tile, c_max=je.c_max, backend="xla",
        )
        parts_j = np.asarray(_pair_parts(
            x, xa, ga, None, jnp.int32(a), jnp.int32(b), je._bounds, g=g, k=g - m,
            tile=je.tile, c_max=je.c_max, n_digits=je.n_digits,
            digit_base=je.digit_base, backend="xla", interpret=False,
        ), dtype=np.int64)
        want = sum(je.digit_base**d * parts_j[d] for d in range(je.n_digits))
        got = pairs_packed.parts_from_s1(
            pairs_packed_cuda.packed_s1(rows, a, rows, b, 1, k=g - m), bounds[b : b + 1],
            c_max=eng.c_max,
        )
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got[0].numpy(), want)


def _emulate_kernel_f(rows, a, b0, n_b, k):
    """numpy model of what kernel F computes from the operands its wrapper
    passes (byte words, padded seq_of, first_seq): byte compares including
    the padding bytes, the C(t - pad, k) table, the i sequence's run
    flushed to s1[b, li, c] and nothing for padding columns."""
    by = rows.words.numpy().view(np.uint8).reshape(rows.words.shape[0], -1)
    pad = by.shape[1] - rows.g
    seq = rows.seq_padded.numpy()
    tbl = np.array([math.comb(t - pad, k) if t - pad >= k else 0 for t in range(by.shape[1] + 1)])
    tile = rows.tile
    fa = int(rows.first_seq[a])
    out = np.zeros((n_b, rows.c_pad, tile), np.int64)
    cols = np.arange(b0 * tile, (b0 + n_b) * tile)
    for r in range(a * tile, (a + 1) * tile):
        if seq[r] < 0:
            continue
        w = tbl[(by[r][None, :] == by[cols]).sum(-1)] * (seq[cols] >= 0)
        out[:, seq[r] - fa, :] += w.reshape(n_b, tile)
    assert out.max() < 2**31
    return out


@pytest.mark.parametrize("tile", [64, 256])
def test_kernel_f_model_matches_plain(rng, monkeypatch, tile):
    """Kernel F's operands and landing rule, modelled in numpy, equal its
    plain version on straddling sequences (g=7: one padding byte a word);
    64-row strips are narrower than the kernel's 128-thread blocks."""
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = random_ragged_seqs(rng, 7, 20, 300, alphabet=5)
    eng = PackedPairsEngine(encode_sequences(X), 7, 3, T.KernelConfig(**CPU))
    rows = eng.rows()
    ns = eng.n_strips
    for a, b0, n_b in ((0, 0, ns), (ns // 2, ns // 2, ns - ns // 2), (ns - 1, 0, 2)):
        want = _emulate_kernel_f(rows, a, b0, n_b, 4)
        got = pairs_packed_cuda.packed_s1(rows, a, rows, b0, n_b, k=4)
        np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_f_wrapper_checks_inputs(rng, small_tile):
    eng = PackedPairsEngine(
        encode_sequences(random_ragged_seqs(rng, 5, 20, 90, alphabet=4)), 6, 3,
        T.KernelConfig(**CPU),
    )
    rows = eng.rows()
    before = counters()["packed_s1.launches"]
    pairs_packed_cuda.packed_s1(rows, 0, rows, 0, eng.n_strips, k=3)
    assert counters()["packed_s1.launches"] == before  # CPU path: no launch
    with pytest.raises(ValueError, match="out of range"):
        pairs_packed_cuda.packed_s1(rows, 0, rows, 1, eng.n_strips, k=3)
    with pytest.raises(ValueError, match="k <= g"):
        pairs_packed_cuda.packed_s1(rows, 0, rows, 0, 1, k=7)
    wide = pairs_packed_cuda.PackedRows(
        torch.zeros((2**14, 20), dtype=torch.int32), torch.zeros(2**14, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), tile=2**14, c_pad=16, alpha=4,
    )
    with pytest.raises(ValueError, match="int32 sums"):
        pairs_packed_cuda.packed_s1(wide, 0, wide, 0, 1, k=10)


@pytest.mark.parametrize("tile", [64, 256])
def test_strip_bounds_match_pack_windows(rng, monkeypatch, tile):
    """The plain composite's bounds, from a table's seq_of and first_seq
    alone, are ``pack_windows``'s (which the JAX stage 2 reads)."""
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    eng = PackedPairsEngine(
        encode_sequences(random_ragged_seqs(rng, 9, 20, 300, alphabet=5)), 7, 3,
        T.KernelConfig(**CPU),
    )
    rows = eng.rows()
    assert pairs_packed.strip_span(rows.seq_of, rows.first_seq, tile) == eng.c_max
    got = pairs_packed.strip_bounds(rows.seq_of, rows.first_seq, tile, eng.c_max)
    np.testing.assert_array_equal(got.numpy(), eng.pack["bounds"])


@pytest.mark.parametrize("tile", [64, 256])
def test_kernel_f_block_plain_walks_match_oracle(rng, monkeypatch, tile):
    """``packed_block`` on the CPU (its plain composite): the triangles of
    every strip add up to the oracle, and rectangles of the row strips
    split in two, each landed into its own row block, add up to it too."""
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = random_ragged_seqs(rng, 7, 20, 300, alphabet=5)
    eng = PackedPairsEngine(encode_sequences(X), 7, 3, T.KernelConfig(**CPU))
    rows, ns, n_pad = eng.rows(), eng.n_strips, eng.n + eng.c_pad
    want = oracle.exact_counts(X, 7, 3)[np.ix_(eng.order, eng.order)]
    tri = torch.zeros((n_pad, n_pad), dtype=torch.int64)
    for a in range(ns):
        pairs_packed_cuda.packed_block(tri, rows, (a, a + 1), k=4)
    np.testing.assert_array_equal(tri[: eng.n, : eng.n].numpy(), want)
    fs = rows.first_seq
    rect = np.zeros((n_pad, n_pad), np.int64)
    for a0, a1 in ((0, ns // 2), (ns // 2, ns)):
        row0 = int(fs[a0])
        blk = torch.zeros((int(fs[a1 - 1]) + eng.c_max - row0, n_pad), dtype=torch.int64)
        pairs_packed_cuda.packed_block(
            blk, rows, (a0, a1), k=4, rows_j=rows, strips_j=(0, ns), row_off=row0
        )
        rect[row0 : row0 + blk.shape[0]] += blk.numpy()
    np.testing.assert_array_equal(rect[: eng.n, : eng.n], want)


@pytest.mark.parametrize("tile", [64, 256])
def test_kernel_f_ring_diagonal_triangle_matches_oracle(rng, monkeypatch, tile):
    """The ring's steps on the CPU (``packed_block``'s plain composite):
    each half of the strips against itself as a triangle with its mirror,
    landed at the half's row offset, and against the other half as a
    rectangle, add up to the oracle; the triangle's mirror stays in the
    half's own rows."""
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = random_ragged_seqs(rng, 7, 20, 300, alphabet=5)
    eng = PackedPairsEngine(encode_sequences(X), 7, 3, T.KernelConfig(**CPU))
    rows, ns, n_pad = eng.rows(), eng.n_strips, eng.n + eng.c_pad
    fs = rows.first_seq
    halves = ((0, ns // 2), (ns // 2, ns))
    got = np.zeros((n_pad, n_pad), np.int64)
    for own in halves:
        row0 = int(fs[own[0]])
        blk = torch.zeros((int(fs[own[1] - 1]) + eng.c_max - row0, n_pad), dtype=torch.int64)
        pairs_packed_cuda.packed_block(blk, rows, own, k=4, strips_j=own, row_off=row0)
        diag = blk.clone()
        for other in halves:
            if other != own:
                pairs_packed_cuda.packed_block(
                    blk, rows, own, k=4, rows_j=rows, strips_j=other, row_off=row0
                )
        cols = diag.abs().sum(0).nonzero().flatten()
        assert int(cols.min()) >= row0 and int(cols.max()) < row0 + blk.shape[0]
        got[row0 : row0 + blk.shape[0]] += blk.numpy()
    want = oracle.exact_counts(X, 7, 3)[np.ix_(eng.order, eng.order)]
    np.testing.assert_array_equal(got[: eng.n, : eng.n], want)


def test_kernel_f_block_wrapper_checks_inputs(rng, small_tile):
    eng = PackedPairsEngine(
        encode_sequences(random_ragged_seqs(rng, 5, 20, 90, alphabet=4)), 6, 3,
        T.KernelConfig(**CPU),
    )
    rows, ns = eng.rows(), eng.n_strips
    out = torch.zeros((eng.n + eng.c_pad,) * 2, dtype=torch.int64)
    pc = pairs_packed_cuda
    before = counters()["packed_block.launches"]
    pc.packed_block(out, rows, (0, ns), k=3)
    pc.packed_block(out, rows, (0, 1), k=3, rows_j=rows, strips_j=(0, ns))
    assert counters()["packed_block.launches"] == before  # CPU path: no launch
    with pytest.raises(ValueError, match="come together"):
        pc.packed_block(out, rows, (0, 1), k=3, rows_j=rows)
    with pytest.raises(ValueError, match="must start at its rows"):
        pc.packed_block(out, rows, (1, 2), k=3, strips_j=(0, ns))
    with pytest.raises(ValueError, match="must start at its rows"):
        pc.packed_block(out, rows, (0, 2), k=3, strips_j=(0, 1))
    with pytest.raises(ValueError, match="out of range"):
        pc.packed_block(out, rows, (0, ns + 1), k=3)
    with pytest.raises(ValueError, match="out of range"):
        pc.packed_block(out, rows, (1, 1), k=3, rows_j=rows, strips_j=(0, 1))
    with pytest.raises(ValueError, match="k <= g"):
        pc.packed_block(out, rows, (0, 1), k=7)
    with pytest.raises(ValueError, match="int64"):
        pc.packed_block(out.int(), rows, (0, 1), k=3)
    other = PackedPairsEngine(
        encode_sequences(random_ragged_seqs(rng, 5, 20, 90, alphabet=4)), 7, 3,
        T.KernelConfig(**CPU),
    ).rows()
    with pytest.raises(ValueError, match="share g"):
        pc.packed_block(out, rows, (0, 1), k=3, rows_j=other, strips_j=(0, 1))


def test_kernel_g_wrapper_checks_groups(rng, small_tile):
    eng = PackedPairsEngine(
        encode_sequences(random_ragged_seqs(rng, 9, 40, 120, alphabet=4)), 6, 3,
        T.KernelConfig(pairs_backend="pallas_grouped", **CPU),
    )
    rows, group = eng.rows(), eng.group
    pc = pairs_packed_cuda
    assert eng.n_strips == 2 * group and rows.tile == 64  # narrower than a 128-row tile
    before = counters()["packed_grouped.launches"]
    both = pc.packed_grouped(rows, 3, 0, k=3, group=group, n_groups=2)
    assert both.shape == (2 * group, eng.c_pad, eng.c_pad)
    assert counters()["packed_grouped.launches"] == before
    second = pc.packed_grouped(rows, 3, 1, k=3, group=group)
    np.testing.assert_array_equal(both[group:].numpy(), second.numpy())
    with pytest.raises(ValueError, match="outside"):
        pc.packed_grouped(rows, 3, 1, k=3, group=group, n_groups=2)
    with pytest.raises(ValueError, match="outside"):
        pc.packed_grouped(rows, 3, 0, k=3, group=group, n_groups=0)


# ------------------------------------------------------ the mesh routes


@pytest.mark.parametrize("state", ["sharded", "replicated"])
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_routes_match_jax_and_single_device(rng, small_tile, shape, state):
    X = random_ragged_seqs(rng, 18, 10, 60, alphabet=4)
    enc = encode_sequences(X)
    eng = PackedPairsEngine(
        enc, 6, 3, T.KernelConfig(mesh=cpu_mesh(*shape), mesh_state=state, **CPU)
    )
    assert eng.route == ("ring" if state == "sharded" else "round-robin")
    assert eng.n_strips > 8  # several rounds and ring steps
    got = eng.exact()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, PackedPairsEngine(enc, 6, 3, T.KernelConfig(**CPU)).exact())
    ref = JPacked(enc, 6, 3, J.KernelConfig(mesh=_jax_mesh(*shape), mesh_state=state)).exact()
    np.testing.assert_array_equal(got, ref)


def test_mesh_two_digit_weights(rng, small_tile):
    """C(12, 6) = 924: two JAX digit planes, one int64 sum here."""
    X = random_ragged_seqs(rng, 8, 18, 40, alphabet=4)
    enc = encode_sequences(X)
    want = oracle.exact_counts(X, 12, 6)
    for state in ("sharded", "replicated"):
        cfg = T.KernelConfig(mesh=cpu_mesh(2, 4), mesh_state=state, **CPU)
        np.testing.assert_array_equal(PackedPairsEngine(enc, 12, 6, cfg).exact(), want)


def test_ring_row_block_matches_jax(rng, small_tile, monkeypatch):
    """mesh_state="sharded" gives each device a kernel ROW BLOCK [blk, Np]
    with the JAX engine's blk (tests/test_sharding.py's layout test)."""
    import fastsk_tpu.parallel.sharding as j_shd

    X = random_ragged_seqs(rng, 24, 10, 60, alphabet=4)
    enc = encode_sequences(X)
    seen = {}
    j_ring, t_ring = j_shd.packed_ring_rowsharded, shd.packed_ring_rowsharded

    def j_spy(blocks, *a, **kw):
        out = j_ring(blocks, *a, **kw)
        seen["jax"] = out.shape  # [n_dev, n_digits, blk, Np]
        return out

    def t_spy(blocks, *a, **kw):
        out = t_ring(blocks, *a, **kw)
        seen["port"] = [tuple(b.shape) for b in out.values()]
        return out

    monkeypatch.setattr(j_shd, "packed_ring_rowsharded", j_spy)
    monkeypatch.setattr(shd, "packed_ring_rowsharded", t_spy)
    k_j = JPacked(enc, 6, 3, J.KernelConfig(mesh=_jax_mesh(2, 4))).exact()
    eng = PackedPairsEngine(enc, 6, 3, T.KernelConfig(mesh=cpu_mesh(2, 4), **CPU))
    np.testing.assert_array_equal(eng.exact(), k_j)
    n_pad = eng.n + eng.c_pad
    blk = seen["jax"][2]
    assert blk < n_pad and seen["jax"][3] == n_pad
    assert seen["port"] == [(blk, n_pad)] * 8


def test_pairs_engine_refuses_mesh(rng):
    enc = encode_sequences(random_ragged_seqs(rng, 27, 12, 20, alphabet=4))
    with pytest.raises(ValueError, match="single-device"):
        PairsGkmEngine(enc, 6, 2, T.KernelConfig(mesh=cpu_mesh(2, 4), **CPU))


def test_exact_device_raises_under_mesh(rng, small_tile):
    enc = encode_sequences(random_ragged_seqs(rng, 6, 10, 40, alphabet=4))
    eng = PackedPairsEngine(enc, 6, 3, T.KernelConfig(mesh=cpu_mesh(1, 2), **CPU))
    with pytest.raises(ValueError, match="single-device"):
        eng.exact_device()


def test_api_routes_mesh_to_packed(rng):
    """Near-uniform lengths pick the sequence-aligned engine on one
    device; under a mesh it refuses and the auto route takes the packed
    engine, in both packages, with equal counts."""
    X = random_ragged_seqs(rng, 16, 10, 16, alphabet=4)
    enc = encode_sequences(X)
    assert isinstance(T.FastSK(6, 2, config=T.KernelConfig(**CPU))._make_exact_engine(enc), PairsGkmEngine)
    fsk = T.FastSK(6, 2, config=T.KernelConfig(mesh=cpu_mesh(2, 4), **CPU))
    assert isinstance(fsk._make_exact_engine(enc), PackedPairsEngine)
    ref = J.FastSK(6, 2, config=J.KernelConfig(mesh=_jax_mesh(2, 4)))
    assert type(ref._make_exact_engine(enc)).__name__ == "PackedPairsEngine"
    fsk.compute_train(X)
    ref.compute_train(X)
    np.testing.assert_array_equal(fsk.kernel_counts, ref.kernel_counts)


@pytest.mark.parametrize("state", ["sharded", "replicated"])
def test_fastsk_mesh_matches_jax_and_single_device(state):
    """compute_kernel -> fit -> score("auc") under a CPU mesh
    (device_resident=True is ignored there, as in JAX): counts equal JAX's
    mesh run, AUC equals the port's single-device run."""
    rng = np.random.default_rng(21)
    y = rng.integers(0, 2, size=64)
    X = []
    for label in y:
        s = rng.integers(1, 21, size=int(rng.integers(12, 60)))
        if label:
            at = int(rng.integers(0, len(s) - 8 + 1))
            s[at : at + 8] = [3, 7, 1, 9, 4, 4, 12, 5]
        X.append(s.tolist())
    Xtr, Xte, ytr, yte = X[:48], X[48:], y[:48], y[48:]
    mesh = cpu_mesh(2, 2)
    t = T.FastSK(6, 2, config=T.KernelConfig(mesh=mesh, mesh_state=state, device_resident=True, **CPU))
    one = T.FastSK(6, 2, config=T.KernelConfig(**CPU))
    j = J.FastSK(6, 2, config=J.KernelConfig(mesh=_jax_mesh(2, 2), mesh_state=state))
    for f in (t, one, j):
        f.compute_kernel(Xtr, Xte, ytr, yte)
    assert t._counts_dev is None  # the mesh path keeps host counts
    np.testing.assert_array_equal(t.kernel_counts, j.kernel_counts)
    np.testing.assert_array_equal(t.kernel_counts, one.kernel_counts)
    for f in (t, one):
        f.fit(C=1.0)
    assert abs(t.score("auc") - one.score("auc")) <= 1e-9


# ------------------------------------------------------------- kernel H


def _plan(layout, tile, range_chunks, slab):
    return pairs_cuda.MmaPlan(layout, tile, range_chunks, 0, slab, 0, 0)


# small plans of each of kernel A's layouts, forced: the tile, the range
# of 128-row j chunks a block (paired rows in the resident and windows
# layouts) and the k-slab; 16 sequences of <= 20 letters, p_pad = 16, so
# a tile of 8 spans one chunk and 4 half of one
H_PLANS = {
    "resident": _plan("resident", 8, 1, 64),
    "windows": _plan("windows", 1, 1, 64),
    "depth": _plan("depth", 4, 1, 64),
    "slabs": _plan("slabs", 2, 1, 8),
}


def _probe_set(rng, alpha=4):
    X = random_ragged_seqs(rng, 16, 8, 20, alphabet=alpha)
    eng = PairsGkmEngine(encode_sequences(X), 5, 2, T.KernelConfig(**CPU))
    return X, eng, eng._build_x()


@pytest.mark.parametrize("layout", list(H_PLANS))
def test_probe_skeleton_and_matmul_plain_match_numpy(rng, layout):
    """skeleton: sum_{p,q} <x_ip, x_jq> by brute force in numpy; matmul:
    each tile pair's total at its corner entry and the mirror, the same
    under the plan's ranges and slabs as under one block a tile pair (in
    the resident and windows layouts the totals of the pair indices
    (g + 1) d0 + d1: window q of the lower tile weighs g + 1 where q is
    even)."""
    plan = H_PLANS[layout]
    X, eng, x = _probe_set(rng)
    xn = x.numpy().astype(np.int64).reshape(eng.n_pad, eng.p_pad, -1)
    d = np.einsum("ipf,jqf->ijpq", xn, xn)
    want = d.sum((2, 3))
    skel = pairs.pairs_probe_plain(x, k=3, p_pad=eng.p_pad, variant="skeleton", plan=plan)
    np.testing.assert_array_equal(skel.numpy(), want)
    paired = layout in ("resident", "windows")
    mm = pairs.pairs_probe_plain(x, k=3, p_pad=eng.p_pad, variant="matmul", plan=plan, g=5)
    s, nt = plan.tile, eng.n_pad // plan.tile
    wq = np.where(np.arange(eng.p_pad) % 2 == 0, 6, 1) if paired else np.ones(eng.p_pad, int)
    tiles = (d * wq).sum((2, 3)).reshape(nt, s, nt, s).sum((1, 3))  # [streamed, resident]
    corner = np.zeros_like(want)
    corner[::s, ::s] = np.where(np.tri(nt, dtype=bool), tiles, tiles.T)
    np.testing.assert_array_equal(mm.numpy(), corner)
    if paired:
        whole = _plan("resident", s, -(-s * eng.p_pad // 256), 64)
        np.testing.assert_array_equal(
            pairs.pairs_probe_plain(x, k=3, p_pad=eng.p_pad, variant="matmul", plan=whole,
                                    g=5).numpy(),
            corner,
        )


@pytest.mark.parametrize("g,k", [(8, 4), (16, 6), (10, 5), (5, 1), (12, 9)])
def test_probe_int32_chain_matches_jax(g, k):
    """The int32 chain equals JAX's ``ffact_pairing_i32 / k!``, and C(d, k)."""
    from fastsk_tpu.ops.pairs_pallas import ffact_pairing_i32

    d = np.arange(g + 1, dtype=np.int32)
    got = pairs.binom_ffact_i32(torch.from_numpy(d), k).numpy()
    want = np.asarray(ffact_pairing_i32(jnp.asarray(d), k)) // math.factorial(k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [math.comb(int(v), k) for v in d])


@pytest.mark.parametrize("layout", list(H_PLANS))
def test_probe_wrapper_variants_on_cpu(rng, monkeypatch, layout):
    """Every variant through the wrapper under each layout's plan: current
    and int32 equal the oracle's counts and JAX's engine; noop, loads and
    no_mma write zeros; matmul and skeleton their plain versions; no
    launch is counted on the CPU."""
    monkeypatch.setattr(pairs_cuda, "mma_plan", lambda *shape: H_PLANS[layout])
    X, eng, x = _probe_set(rng, alpha=6)
    kw = dict(g=5, k=3, p_pad=eng.p_pad)
    want = oracle.exact_counts(X, 5, 2)
    np.testing.assert_array_equal(want, JPairs(encode_sequences(X), 5, 2).exact())
    before = counters()["pairs_probe.launches"]
    for variant in pairs.PROBE_VARIANTS:
        got = pairs_cuda.pairs_probe(x, variant=variant, **kw)
        assert got.dtype == torch.int32 and got.shape == (eng.n_pad, eng.n_pad)
        if variant in ("current", "int32"):
            np.testing.assert_array_equal(got.numpy()[:16, :16], want)
        elif variant in ("noop", "loads", "no_mma"):
            assert not got.any()
        else:
            plain = pairs.pairs_probe_plain(
                x, k=3, p_pad=eng.p_pad, variant=variant, plan=H_PLANS[layout], g=5
            )
            np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert counters()["pairs_probe.launches"] == before
    with pytest.raises(ValueError, match="unknown probe variant"):
        pairs_cuda.pairs_probe(x, variant="fast", **kw)
    with pytest.raises(ValueError, match="exceed int32"):
        pairs_cuda.pairs_probe(x, g=20, k=10, p_pad=eng.p_pad, variant="int32")


def test_probe_cli_runs_on_cpu():
    import json

    out = subprocess.run(
        [sys.executable, "-m", "fastsk_tpu_torch.experiments.probe_pairs", "--device", "cpu",
         "--n", "12", "--length", "24", "--g", "6", "--m", "2", "--reps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["ok"] and res["timer"] == "host_clock" and res["layout"] == "resident"
    assert tuple(res["variants"]) == pairs.PROBE_VARIANTS
    assert set(res["split"]) == {"products_ms", "epilogue_ms", "loads_ms", "overlap_ms"}


def test_new_modules_leave_jax_out():
    code = (
        "import sys, fastsk_tpu_torch.parallel, "
        "fastsk_tpu_torch.experiments.probe_pairs; print('jax' in sys.modules)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True
    )
    assert out.stdout.strip() == "False"
