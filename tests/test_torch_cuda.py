"""Kernels A, B, C, D, E and G against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (from the ``cuda`` fixture, not at
import) where ``torch.cuda.is_available()`` is false. Run on a machine
with the card: ``python -m pytest tests/test_torch_cuda.py -q``.
Tolerances: counts are integers (equal); kernels B and C must take their
twins' exact f32 trajectories (equal iterations, alpha and grad).
"""

import math

import numpy as np
import pytest
import torch

from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine, PairsGkmEngine
from fastsk_tpu_torch.kernel.config import KernelConfig
from fastsk_tpu_torch.ops import pairs, pairs_cuda, pairs_packed, pairs_packed_cuda
from fastsk_tpu_torch.ops.encode import encode_sequences
from fastsk_tpu_torch.svm import smo_cuda
from fastsk_tpu_torch.svm.kernel_svm import nu_svc_start, nu_svr_start

import oracle

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "g,m,n,length,alpha",
    [(6, 2, 19, 30, 4), (8, 4, 33, 50, 5), (5, 4, 9, 12, 30), (10, 6, 17, 40, 4)],
)
def test_kernel_a_matches_plain_and_oracle(cuda, g, m, n, length, alpha):
    rng = np.random.default_rng(g * 100 + n)
    X = [rng.integers(1, alpha + 1, size=rng.integers(g, length + 1)).tolist() for _ in range(n)]
    eng = PairsGkmEngine(encode_sequences(X), g, m, KernelConfig(device=cuda))
    x = eng._build_x()
    before = pairs_cuda.pairs_counts.launches
    got = pairs_cuda.pairs_counts(x, g=g, k=g - m, p_pad=eng.p_pad)
    torch.cuda.synchronize()
    assert pairs_cuda.pairs_counts.launches == before + 1
    want = pairs.pairs_counts_plain(x, k=g - m, p_pad=eng.p_pad)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(got.cpu().numpy()[:n, :n], oracle.exact_counts(X, g, m))


# n=700 keeps the solver state in shared memory; n=10500 is past the
# 10240-row limit, so the same loop runs on it in global memory
@pytest.mark.parametrize("n", [700, 10500])
def test_kernel_b_matches_twin(cuda, n):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.where(X[:, 0] + 0.5 * rng.normal(size=n) > 0, 1.0, -1.0).astype(np.float32)
    K = X @ X.T
    for c_mask in (np.ones(n, np.float32), (np.arange(n) % 5 != 0).astype(np.float32)):
        Q = torch.from_numpy(K * np.outer(y, y)).to(cuda)
        args = (
            torch.from_numpy(y).to(cuda), torch.from_numpy(c_mask).to(cuda),
            -torch.ones(n, device=cuda), torch.zeros(n, device=cuda),
        )
        before = smo_cuda.smo_solve.launches
        a_k, g_k, it_k = smo_cuda.smo_solve(Q, *args, 1e-3, 10**6)
        assert smo_cuda.smo_solve.launches == before + 1
        qd = torch.diagonal(Q).contiguous()
        a_p, g_p, it_p = smo_cuda.smo_loop_plain(
            Q, args[0], args[1], qd, args[3], args[2].clone(), 1e-3, 10**6
        )
        assert it_k == it_p
        torch.testing.assert_close(a_k, a_p, rtol=0, atol=0)
        torch.testing.assert_close(g_k, g_p, rtol=0, atol=0)


def _nu_problem(kind, n, rng):
    """(Q, y, C, p, alpha0) of a Solver_NU problem with n rows: a nu-SVC
    (nu=0.5), the 2n dual of a nu-SVR (C=1, nu=0.5), or a nu-SVC whose
    negative class is held at a zero sum, so upN is empty for the whole
    solve and every iteration fetches row 0 for it."""
    if kind == "nu_svr":
        m = n // 2
        X = rng.normal(size=(m, 8)).astype(np.float32)
        t = (X[:, 0] + 0.3 * rng.normal(size=m)).astype(np.float32)
        K = X @ X.T
        K = np.block([[K, K], [K, K]])
        y = np.concatenate([np.ones(m), -np.ones(m)]).astype(np.float32)
        p = np.concatenate([-t, t]).astype(np.float32)
        a0 = nu_svr_start(m, 1.0, 0.5)
    else:
        X = rng.normal(size=(n, 8)).astype(np.float32)
        y = np.where(X[:, 0] + 0.5 * rng.normal(size=n) > 0, 1.0, -1.0).astype(np.float32)
        K = X @ X.T
        p = np.zeros(n, np.float32)
        a0 = nu_svc_start(y, 0.5)
        if kind == "upN_empty":
            a0[y < 0] = 0.0
            y[0] = 1.0  # row 0, the empty set's argmax, is a positive row
            a0[0] = 0.0
    return K * np.outer(y, y), y, np.ones(len(y), np.float32), p, a0


# n=700 keeps the solver state in shared memory; n=10500 runs it in global
# memory. The large shape is held to the twin on a capped prefix: the
# twin runs one host-synced step per iteration.
@pytest.mark.parametrize("kind", ["nu_svc", "nu_svr", "upN_empty"])
@pytest.mark.parametrize("n,max_iter", [(700, 100_000), (10500, 1500)])
def test_kernel_c_matches_twin(cuda, kind, n, max_iter):
    rng = np.random.default_rng(5)
    Q, y, C, p, a0 = (torch.from_numpy(v).to(cuda) for v in _nu_problem(kind, n, rng))
    before = smo_cuda.smo_nu_solve.launches
    a_k, g_k, it_k = smo_cuda.smo_nu_solve(Q, y, C, p, a0, 1e-3, max_iter)
    assert smo_cuda.smo_nu_solve.launches == before + 1
    grad0, qd = smo_cuda.initial_state(Q, p, a0)
    a_p, g_p, it_p = smo_cuda.smo_nu_loop_plain(Q, y, C, qd, a0, grad0, 1e-3, max_iter)
    assert it_k == it_p
    torch.testing.assert_close(a_k, a_p, rtol=0, atol=0)
    torch.testing.assert_close(g_k, g_p, rtol=0, atol=0)
    for cls in (1.0, -1.0):  # Solver_NU conserves each class's sum
        s0, s1 = float(a0[y == cls].sum()), float(a_k[y == cls].sum())
        assert abs(s1 - s0) <= 1e-3 * max(s0, 1.0)
    if kind == "upN_empty":
        assert float(a_k[y < 0].abs().max()) == 0.0


def _ragged(seed, n, lmin, lmax, alpha):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, alpha + 1, size=int(rng.integers(lmin, lmax + 1))).tolist() for _ in range(n)]


# (sequences, g, m, strip tile): 256-row strips split the longer sequences
# across strips and 128-row tiles; g=7 leaves a padding byte in the last
# word, g=12 uses three words, g=16 four, g=20 five; the last case
# exceeds int32 (its counts are known in closed form)
@pytest.mark.parametrize(
    "X,g,m,tile",
    [
        (_ragged(1, 9, 20, 400, 4), 6, 3, 256),
        (_ragged(2, 13, 10, 300, 24), 7, 3, 256),
        (_ragged(3, 40, 9, 60, 20), 8, 4, 2048),
        (_ragged(4, 6, 30, 200, 4), 12, 6, 256),
        (_ragged(5, 7, 30, 200, 4), 16, 14, 256),
        ([[3] * 130, [3] * 130, [3] * 40], 20, 10, 256),
    ],
)
def test_kernels_d_e_g_match_plain_and_oracle(cuda, monkeypatch, X, g, m, tile):
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    eng = PackedPairsEngine(encode_sequences(X), g, m, KernelConfig(device=cuda, pairs_backend="pallas_grouped"))
    rows = eng.rows()
    k = g - m
    want = pairs_packed.packed_counts_plain(
        rows.onehot, rows.seq_of, rows.first_seq, k=k, tile=tile, c_pad=eng.c_pad, n_out=eng.n
    )
    order = eng.order
    if g == 20:  # constant sequences: every window pair matches in all 20 places
        p = np.array([len(s) - g + 1 for s in X], dtype=np.int64)
        oracle_counts = np.outer(p, p) * math.comb(20, 10)
        assert oracle_counts.max() >= 2**31
    else:
        oracle_counts = oracle.exact_counts(X, g, m)
    np.testing.assert_array_equal(want.cpu().numpy(), oracle_counts[np.ix_(order, order)])

    before = pairs_packed_cuda.packed_band.launches
    band = pairs_packed_cuda.packed_band(rows, k=k, n_out=eng.n)
    torch.cuda.synchronize()
    assert pairs_packed_cuda.packed_band.launches == before + 1
    torch.testing.assert_close(band, want, rtol=0, atol=0)

    ns = eng.n_strips
    pa = torch.repeat_interleave(torch.arange(ns), torch.arange(ns, 0, -1)).to(cuda, torch.int32)
    pb = torch.cat([torch.arange(a, ns) for a in range(ns)]).to(cuda, torch.int32)
    before = pairs_packed_cuda.packed_pairlist.launches
    parts = pairs_packed_cuda.packed_pairlist(rows, pa, pb, k=k)
    torch.cuda.synchronize()
    assert pairs_packed_cuda.packed_pairlist.launches == before + 1
    parts_plain = pairs_packed.packed_pair_parts_plain(
        rows.onehot, rows.seq_of, rows.first_seq, pa.tolist(), pb.tolist(), k=k, tile=tile, c_pad=eng.c_pad
    )
    torch.testing.assert_close(parts, parts_plain, rtol=0, atol=0)

    before = pairs_packed_cuda.packed_grouped.launches
    grp = pairs_packed_cuda.packed_grouped(rows, 0, 0, k=k, group=eng.group)
    torch.cuda.synchronize()
    assert pairs_packed_cuda.packed_grouped.launches == before + 1
    grp_plain = pairs_packed.packed_pair_parts_plain(
        rows.onehot, rows.seq_of, rows.first_seq, [0] * eng.group, range(eng.group),
        k=k, tile=tile, c_pad=eng.c_pad,
    )
    torch.testing.assert_close(grp, grp_plain, rtol=0, atol=0)

    # every route through the engine, in the input order
    for route in ("band", "pairlist", "grouped"):
        eng.route = route
        np.testing.assert_array_equal(eng.exact(), oracle_counts)
