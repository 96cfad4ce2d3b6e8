"""Kernels A to H against their plain PyTorch versions, on the card
(kernel A with both of its bodies, D to G's one kernel at every code
width, E in both landings, kernel C at every cluster size), and the theta
engines' card path (bf16 products with f32 outputs) against the CPU's.

Marked ``cuda``; each test skips (from the ``cuda`` fixture, not at
import) where ``torch.cuda.is_available()`` is false. Run on a machine
with the card: ``python -m pytest tests/test_torch_cuda.py -q``.
Tolerances: counts are integers (equal); kernels B and C must take their
twins' exact f32 trajectories (equal iterations, alpha and grad), and a
batched launch of B each problem's lone one.
"""

import math

import numpy as np
import pytest
import torch

from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine, PairsGkmEngine
from fastsk_tpu_torch.kernel.config import KernelConfig
from fastsk_tpu_torch.kernel.engine import DenseGkmEngine
from fastsk_tpu_torch.kernel.sorted_engine import SortedGkmEngine
from fastsk_tpu_torch.ops import pairs, pairs_cuda, pairs_packed, pairs_packed_cuda
from fastsk_tpu_torch.ops.encode import encode_sequences
from fastsk_tpu_torch.parallel import make_mesh
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
    want = pairs.pairs_counts_plain(x, k=g - m, p_pad=eng.p_pad)
    oracle_counts = oracle.exact_counts(X, g, m)
    for body in ("dp4a", "mma"):
        before = pairs_cuda.pairs_counts.launches, dict(pairs_cuda.pairs_counts.bodies)
        got = pairs_cuda.pairs_counts(x, g=g, k=g - m, p_pad=eng.p_pad, body=body)
        torch.cuda.synchronize()
        assert pairs_cuda.pairs_counts.launches == before[0] + 1
        assert pairs_cuda.pairs_counts.bodies[body] == before[1][body] + 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        np.testing.assert_array_equal(got.cpu().numpy()[:n, :n], oracle_counts)


# one-hot depths that take each body by default: 40 B (pads to 64, mma),
# 320 B (mma, one block an SM), 420 B (448, mma, short sequences: a run
# per column sequence) and 512 B at p_pad = 200 (past the tensor-core
# tile: dp4a); a tile of several 128-row chunks (p_pad = 200, four
# sequences a side) and sequences that end inside a chunk
@pytest.mark.parametrize(
    "g,m,alpha,n,length,body",
    [
        (8, 4, 5, 21, 200, "mma"),
        (8, 4, 40, 9, 60, "mma"),
        (6, 3, 70, 9, 40, "mma"),
        (8, 4, 64, 5, 200, "dp4a"),
    ],
)
def test_kernel_a_default_body_by_depth(cuda, g, m, alpha, n, length, body):
    rng = np.random.default_rng(alpha * 10 + n)
    X = [rng.integers(1, alpha + 1, size=length).tolist() for _ in range(n)]
    X[0] = list(range(1, alpha + 1)) + X[0][alpha:]  # every code, so the alphabet is alpha
    eng = PairsGkmEngine(encode_sequences(X), g, m, KernelConfig(device=cuda))
    assert eng.alpha == alpha
    assert pairs_cuda.pairs_body(eng.n_pad, eng.p_pad, g * alpha) == body
    before = dict(pairs_cuda.pairs_counts.bodies)
    got = eng.exact()
    assert pairs_cuda.pairs_counts.bodies[body] == before[body] + 1
    np.testing.assert_array_equal(got, oracle.exact_counts(X, g, m))


@pytest.mark.parametrize(
    "n_pad,p_pad,depth,tile",
    [
        (7024, 200, 64, 4),   # KAT2B: 8 sequences would leave one block an SM
        (7232, 192, 64, 8),   # 7230 x 200 DNA, g=16
        (24, 96, 64, 8),
        (12, 8, 64, 4),
        (8, 200, 192, 1),
        (8, 200, 320, 1),     # one block an SM
        (8, 200, 448, 1),     # the deepest tile at p_pad = 200
        (8, 200, 512, 0),     # one sequence's tile does not fit: the dp4a body
        (8, 904, 320, 0),
    ],
)
def test_kernel_a_mma_tiling(cuda, n_pad, p_pad, depth, tile):
    s = pairs_cuda.mma_tile_sequences(n_pad, p_pad, depth)
    assert s == tile and (s == 0 or n_pad % s == 0)
    assert pairs_cuda.pairs_body(n_pad, p_pad, depth) == ("mma" if tile else "dp4a")


def _c_svc_problem(n, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.where(X[:, 0] + 0.5 * rng.normal(size=n) > 0, 1.0, -1.0).astype(np.float32)
    return X @ X.T * np.outer(y, y), y


def _twin(Q, y, C, p, a0, max_iter):
    grad0, qd = smo_cuda.initial_state(Q, p, a0)
    return smo_cuda.smo_loop_plain(Q, y, C, qd, a0, grad0, 1e-3, max_iter)


# n=700 and 10500 run to the eps stop; 12636 (the SVR duals' 2n at
# KAT2B) on a capped prefix, as the twin runs one host-synced step per
# iteration. At the default cluster every one keeps its slices in shared
# memory.
@pytest.mark.parametrize("n", [700, 10500, 12636])
def test_kernel_b_matches_twin(cuda, n):
    max_iter = 3000 if n == 12636 else 10**6
    Qn, y = _c_svc_problem(n)
    for c_mask in (np.ones(n, np.float32), (np.arange(n) % 5 != 0).astype(np.float32)):
        Q = torch.from_numpy(Qn).to(cuda)
        args = (
            torch.from_numpy(y).to(cuda), torch.from_numpy(c_mask).to(cuda),
            -torch.ones(n, device=cuda), torch.zeros(n, device=cuda),
        )
        before = smo_cuda.smo_solve.launches, smo_cuda.smo_solve.problems
        a_k, g_k, it_k = smo_cuda.smo_solve(Q, *args, 1e-3, max_iter)
        assert (smo_cuda.smo_solve.launches, smo_cuda.smo_solve.problems) == (before[0] + 1, before[1] + 1)
        assert smo_cuda.smo_smem_path(n, smo_cuda.smo_cluster_size())
        a_p, g_p, it_p = _twin(Q, *args[:2], args[2], args[3], max_iter)
        assert it_k == it_p
        torch.testing.assert_close(a_k, a_p, rtol=0, atol=0)
        torch.testing.assert_close(g_k, g_p, rtol=0, atol=0)


# every cluster size on one problem; one CTA cannot hold 10500 rows' slice
# (6 floats a row past 220 KB), so cluster=1 runs the global-memory mode
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
def test_kernel_b_cluster_sizes(cuda, cluster):
    n, max_iter = 10500, 4000
    Qn, y = _c_svc_problem(n, seed=4)
    Q = torch.from_numpy(Qn).to(cuda)
    args = (torch.from_numpy(y).to(cuda), torch.ones(n, device=cuda),
            -torch.ones(n, device=cuda), torch.zeros(n, device=cuda))
    assert smo_cuda.smo_smem_path(n, cluster) == (cluster > 1)
    a_k, g_k, it_k = smo_cuda.smo_solve(Q, *args, 1e-3, max_iter, cluster=cluster)
    a_p, g_p, it_p = _twin(Q, *args[:2], args[2], args[3], max_iter)
    assert it_k == it_p
    torch.testing.assert_close(a_k, a_p, rtol=0, atol=0)
    torch.testing.assert_close(g_k, g_p, rtol=0, atol=0)


def test_kernel_b_batched_folds(cuda):
    """Five Platt-fold masks in one launch: each fold bit-identical to its
    own launch and to the twin."""
    from fastsk_tpu_torch.svm.linear import stratified_kfold_indices

    n = 1500
    Qn, y = _c_svc_problem(n, seed=6)
    Q = torch.from_numpy(Qn).to(cuda)
    yt = torch.from_numpy(y).to(cuda)
    p = -torch.ones(n, device=cuda)
    C = torch.ones((5, n), device=cuda)
    for r, f in enumerate(stratified_kfold_indices(y, 5)):
        C[r, torch.as_tensor(f, device=cuda)] = 0.0
    a0 = torch.zeros((5, n), device=cuda)
    before = smo_cuda.smo_solve.launches, smo_cuda.smo_solve.problems
    a_b, g_b, it_b = smo_cuda.smo_solve(Q, yt, C, p, a0, 1e-3, 10**6)
    assert (smo_cuda.smo_solve.launches, smo_cuda.smo_solve.problems) == (before[0] + 1, before[1] + 5)
    assert a_b.shape == g_b.shape == (5, n) and len(it_b) == 5
    for r in range(5):
        a_s, g_s, it_s = smo_cuda.smo_solve(Q, yt, C[r].contiguous(), p, a0[r].contiguous(), 1e-3, 10**6)
        assert it_b[r] == it_s
        torch.testing.assert_close(a_b[r], a_s, rtol=0, atol=0)
        torch.testing.assert_close(g_b[r], g_s, rtol=0, atol=0)
        a_p, g_p, it_p = _twin(Q, yt, C[r].contiguous(), p, a0[r].contiguous(), 10**6)
        assert it_p == it_s
        torch.testing.assert_close(a_s, a_p, rtol=0, atol=0)
        torch.testing.assert_close(g_s, g_p, rtol=0, atol=0)


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


# n=700 runs to the eps stop; 10500 and 12636 (the SVR duals' 2n at
# KAT2B) are held to the twin on a capped prefix: the twin runs one
# host-synced step per iteration. At the default cluster every one keeps
# its slices in shared memory.
@pytest.mark.parametrize("kind", ["nu_svc", "nu_svr", "upN_empty"])
@pytest.mark.parametrize("n,max_iter", [(700, 100_000), (10500, 1500), (12636, 1500)])
def test_kernel_c_matches_twin(cuda, kind, n, max_iter):
    rng = np.random.default_rng(5)
    Q, y, C, p, a0 = (torch.from_numpy(v).to(cuda) for v in _nu_problem(kind, n, rng))
    before = smo_cuda.smo_nu_solve.launches
    a_k, g_k, it_k = smo_cuda.smo_nu_solve(Q, y, C, p, a0, 1e-3, max_iter)
    assert smo_cuda.smo_nu_solve.launches == before + 1
    assert smo_cuda.smo_smem_path(n, smo_cuda.smo_cluster_size(), "C")
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


# every cluster size on one problem; one CTA cannot hold 10500 rows' slice
# (7 floats a row past 220 KB), so cluster=1 runs the global-memory mode
@pytest.mark.parametrize("kind", ["nu_svc", "upN_empty"])
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
def test_kernel_c_cluster_sizes(cuda, cluster, kind):
    n, max_iter = 10500, 1500
    rng = np.random.default_rng(7)
    Q, y, C, p, a0 = (torch.from_numpy(v).to(cuda) for v in _nu_problem(kind, n, rng))
    assert smo_cuda.smo_smem_path(n, cluster, "C") == (cluster > 1)
    a_k, g_k, it_k = smo_cuda.smo_nu_solve(Q, y, C, p, a0, 1e-3, max_iter, cluster=cluster)
    grad0, qd = smo_cuda.initial_state(Q, p, a0)
    a_p, g_p, it_p = smo_cuda.smo_nu_loop_plain(Q, y, C, qd, a0, grad0, 1e-3, max_iter)
    assert it_k == it_p
    torch.testing.assert_close(a_k, a_p, rtol=0, atol=0)
    torch.testing.assert_close(g_k, g_p, rtol=0, atol=0)


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


def test_kernel_d_bytes_body_above_depth(cuda, monkeypatch):
    """Kernel D at one-hot rows of 1,200 bytes (g=12 over 100 codes: 7
    code planes), one launch, equal to the plain version and the
    oracle."""
    monkeypatch.setattr(PackedPairsEngine, "TILE", 256)
    X = _ragged(21, 12, 12, 300, 100)
    X[0] = list(range(1, 101)) + X[0]  # every code, so alpha = 100
    eng = PackedPairsEngine(encode_sequences(X), 12, 7, KernelConfig(device=cuda))
    assert eng.alpha == 100
    rows = eng.rows()
    want = pairs_packed.packed_counts_plain(
        rows.onehot, rows.seq_of, rows.first_seq, k=5, tile=256, c_pad=eng.c_pad, n_out=eng.n
    )
    before = pairs_packed_cuda.packed_band.launches
    got = pairs_packed_cuda.packed_band(rows, k=5, n_out=eng.n)
    torch.cuda.synchronize()
    assert pairs_packed_cuda.packed_band.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(eng.exact(), oracle.exact_counts(X, 12, 7))


# kernel E in both landings: strips of 64 rows
# (tiles of 64), 256 (two 128-row tiles) and 2048; the upper list of strip
# pairs, and a list with diagonal, reversed (b < a) and repeated slots
@pytest.mark.parametrize("kind", ["upper", "mixed"])
@pytest.mark.parametrize("tile", [64, 256, 2048])
def test_kernel_e_landings_match_plain(cuda, monkeypatch, tile, kind):
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = _ragged(50 + tile, 24 if tile == 2048 else 12, 20, 600, 24)
    eng = PackedPairsEngine(encode_sequences(X), 8, 4, KernelConfig(device=cuda))
    rows, ns, k = eng.rows(), eng.n_strips, 4
    assert ns >= 3
    if kind == "upper":
        pa, pb = torch.triu_indices(ns, ns, device=cuda).to(torch.int32)
    else:
        pa = torch.tensor([0, 2, ns - 1, 1, 1, 2, 0], dtype=torch.int32, device=cuda)
        pb = torch.tensor([0, 1, 0, 2, 2, 2, ns - 1], dtype=torch.int32, device=cuda)
    parts_plain = pairs_packed.packed_pair_parts_plain(
        rows.onehot, rows.seq_of, rows.first_seq, pa.tolist(), pb.tolist(), k=k, tile=tile,
        c_pad=eng.c_pad,
    )
    m = eng.n + eng.c_pad
    want = torch.zeros((m, m), dtype=torch.int64, device=cuda)
    fs = rows.first_seq.long()
    pairs_packed.land_parts(want, parts_plain, fs[pa.long()], fs[pb.long()], pb > pa)
    before = pairs_packed_cuda.packed_pairlist.launches
    parts = pairs_packed_cuda.packed_pairlist(rows, pa, pb, k=k)
    mat = pairs_packed_cuda.packed_pairlist(rows, pa, pb, k=k, out=torch.zeros_like(want))
    torch.cuda.synchronize()
    assert pairs_packed_cuda.packed_pairlist.launches == before + 2
    torch.testing.assert_close(parts, parts_plain, rtol=0, atol=0)
    torch.testing.assert_close(mat, want, rtol=0, atol=0)
    if kind == "upper":
        np.testing.assert_array_equal(
            mat[: eng.n, : eng.n].cpu().numpy(),
            oracle.exact_counts(X, 8, 4)[np.ix_(eng.order, eng.order)],
        )


def test_kernel_e_route_is_one_launch(cuda, monkeypatch):
    """E's route: one launch over the whole upper list, landing in the
    matrix, no part blocks landed by torch; counts equal to kernel D's."""
    monkeypatch.setattr(PackedPairsEngine, "TILE", 256)
    monkeypatch.setenv("FASTSK_PACKED_PAIRLIST", "1")
    X = _ragged(61, 30, 20, 500, 24)
    eng = PackedPairsEngine(encode_sequences(X), 8, 4, KernelConfig(device=cuda))
    assert eng.route == "pairlist" and eng.n_strips > 4
    landed = []
    land = pairs_packed.land_parts
    monkeypatch.setattr(pairs_packed, "land_parts", lambda *a: landed.append(1) or land(*a))
    before = pairs_packed_cuda.packed_pairlist.launches
    got = eng.exact()
    assert pairs_packed_cuda.packed_pairlist.launches == before + 1 and not landed
    eng.route = "band"
    np.testing.assert_array_equal(got, eng.exact())
    np.testing.assert_array_equal(got, oracle.exact_counts(X, 8, 4))


# kernels D, F and G at every word width of the codes (g = 4, 8, 12, 16,
# 20: one to five), at one-hot depths of 20 to 100 B (5 letters: 3
# planes) and 400 to 2,000 B (100 letters: 7 planes), at strips of 64 (G
# through E's pair list), 256 and 2048 rows
@pytest.mark.parametrize("alpha", [5, 100])
@pytest.mark.parametrize("g,tile", [(4, 64), (8, 256), (12, 2048), (16, 64), (20, 256)])
def test_bytes_body_every_width_matches_plain(cuda, monkeypatch, g, tile, alpha):
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = _ragged(70 + g + alpha, 30 if tile == 2048 else 10, g, 400, alpha)
    X[0] = list(range(1, alpha + 1)) + X[0]  # every code, so the alphabet is alpha
    m, k = g // 2, g - g // 2
    eng = PackedPairsEngine(encode_sequences(X), g, m, KernelConfig(device=cuda, pairs_backend="pallas_grouped"))
    assert eng.alpha == alpha
    rows, ns = eng.rows(), eng.n_strips
    assert ns >= 2
    want = pairs_packed.packed_counts_plain(
        rows.onehot, rows.seq_of, rows.first_seq, k=k, tile=tile, c_pad=eng.c_pad, n_out=eng.n
    )
    before = pairs_packed_cuda.packed_band.launches
    band = pairs_packed_cuda.packed_band(rows, k=k, n_out=eng.n)
    torch.cuda.synchronize()
    assert pairs_packed_cuda.packed_band.launches == before + 1
    torch.testing.assert_close(band, want, rtol=0, atol=0)

    # F: every strip's triangle (they add up to D), and the rectangle of the
    # later half against every strip but the first, at a row offset
    n_pad = eng.n + eng.c_pad
    tri = torch.zeros((n_pad, n_pad), dtype=torch.int64, device=cuda)
    for a in range(ns):
        pairs_packed_cuda.packed_block(tri, rows, (a, a + 1), k=k)
    torch.testing.assert_close(tri[: eng.n, : eng.n], want, rtol=0, atol=0)
    mid = ns // 2
    fs = rows.first_seq.cpu().numpy()
    row0 = int(fs[mid])
    blk = int(fs[ns - 1]) + eng.c_max - row0
    rect = dict(k=k, rows_j=rows, strips_j=(1, ns), row_off=row0)
    got = pairs_packed_cuda.packed_block(
        torch.zeros((blk, n_pad), dtype=torch.int64, device=cuda), rows, (mid, ns), **rect
    )
    plain = pairs_packed.packed_block_plain(
        torch.zeros((blk, n_pad), dtype=torch.int64, device=cuda), rows, (mid, ns), **rect
    )
    torch.testing.assert_close(got, plain, rtol=0, atol=0)

    # G: strip 0 against every strip, in part blocks
    grp = pairs_packed_cuda.packed_grouped(rows, 0, 0, k=k, group=1, n_groups=ns)
    grp_plain = pairs_packed.packed_pair_parts_plain(
        rows.onehot, rows.seq_of, rows.first_seq, [0] * ns, range(ns), k=k, tile=tile, c_pad=eng.c_pad
    )
    torch.cuda.synchronize()
    torch.testing.assert_close(grp, grp_plain, rtol=0, atol=0)


def _poly_a(seed):
    """Homopolymers of the lowest code and DNA with poly-A runs of 20-60;
    at each g = 17-20 one homopolymer's window count is not a multiple of
    8, so padding rows share its last group."""
    rng = np.random.default_rng(seed)
    X = [[1] * 130, [1] * 131, [4] * 40]
    for length in (90, 155, 203, 260, 333):
        s = rng.integers(1, 5, size=length)
        at = int(rng.integers(0, length - 60))
        s[at : at + int(rng.integers(20, 61))] = 1
        X.append(s.tolist())
    return X


def _window_pair_counts(X, g, k):
    """Exact counts by brute force over window pairs, codes compared
    directly."""
    wins = [np.array([s[p : p + g] for p in range(len(s) - g + 1)]) for s in X]
    comb = np.array([math.comb(d, k) for d in range(g + 1)], dtype=np.int64)
    return np.array([[comb[(a[:, None, :] == b[None, :, :]).sum(-1)].sum() for b in wins] for a in wins])


# g = 17 to 20 at k = 1 to 8 (m = g - 1 .. g - 8): padding rows must weigh
# nothing against valid rows that match them in nearly every place,
# through D, E (both landings), F (both walks) and G, at strips of 64
# rows (G through E's pair list) and 256 (G's own walk)
@pytest.mark.parametrize("tile", [64, 256])
@pytest.mark.parametrize("g,m", [(17, 16), (17, 9), (18, 13), (19, 11), (20, 12), (20, 19)])
def test_kernels_padding_rows_weigh_nothing(cuda, monkeypatch, g, m, tile):
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = _poly_a(g + m)
    eng = PackedPairsEngine(encode_sequences(X), g, m, KernelConfig(device=cuda))
    rows, ns, k = eng.rows(), eng.n_strips, g - m
    assert (eng.pack["p"] % 8).any() and ns >= 3
    want = torch.from_numpy(_window_pair_counts(X, g, k)[np.ix_(eng.order, eng.order)]).to(cuda)
    torch.testing.assert_close(pairs_packed_cuda.packed_band(rows, k=k, n_out=eng.n), want, rtol=0, atol=0)

    m_pad = eng.n + eng.c_pad
    pa, pb = torch.triu_indices(ns, ns, device=cuda).to(torch.int32)
    mat = pairs_packed_cuda.packed_pairlist(rows, pa, pb, k=k, out=torch.zeros((m_pad, m_pad), dtype=torch.int64, device=cuda))
    torch.testing.assert_close(mat[: eng.n, : eng.n], want, rtol=0, atol=0)
    parts = pairs_packed_cuda.packed_pairlist(rows, pa, pb, k=k)
    plain = pairs_packed.packed_pair_parts_plain(
        rows.onehot, rows.seq_of, rows.first_seq, pa.tolist(), pb.tolist(), k=k, tile=tile, c_pad=eng.c_pad
    )
    torch.testing.assert_close(parts, plain, rtol=0, atol=0)

    tri = torch.zeros((m_pad, m_pad), dtype=torch.int64, device=cuda)
    for a in range(ns):
        pairs_packed_cuda.packed_block(tri, rows, (a, a + 1), k=k)
    torch.testing.assert_close(tri[: eng.n, : eng.n], want, rtol=0, atol=0)
    mid = ns // 2
    fs = rows.first_seq.cpu().numpy()
    blk = int(fs[ns - 1]) + eng.c_max - int(fs[mid])
    rect = dict(k=k, rows_j=rows, strips_j=(0, ns), row_off=int(fs[mid]))
    zeros = lambda: torch.zeros((blk, m_pad), dtype=torch.int64, device=cuda)  # noqa: E731
    torch.testing.assert_close(
        pairs_packed_cuda.packed_block(zeros(), rows, (mid, ns), **rect),
        pairs_packed.packed_block_plain(zeros(), rows, (mid, ns), **rect), rtol=0, atol=0,
    )

    grp = pairs_packed_cuda.packed_grouped(rows, 0, 0, k=k, group=1, n_groups=ns)
    grp_plain = pairs_packed.packed_pair_parts_plain(
        rows.onehot, rows.seq_of, rows.first_seq, [0] * ns, range(ns), k=k, tile=tile, c_pad=eng.c_pad
    )
    torch.testing.assert_close(grp, grp_plain, rtol=0, atol=0)


# kernel F at every word width (g=6 one word, 7 with a padding byte, 12
# three, 16 four, 20 five), 256-row strips that split sequences, and the
# 2048-row default
@pytest.mark.parametrize(
    "X,g,m,tile",
    [
        (_ragged(11, 9, 20, 400, 4), 6, 3, 256),
        (_ragged(12, 13, 10, 300, 24), 7, 3, 256),
        (_ragged(13, 40, 9, 300, 20), 8, 4, 2048),
        (_ragged(14, 6, 30, 200, 4), 12, 6, 256),
        (_ragged(15, 7, 30, 200, 4), 16, 14, 256),
        ([[3] * 130, [3] * 130, [3] * 40], 20, 10, 256),
    ],
)
def test_kernel_f_matches_plain(cuda, monkeypatch, X, g, m, tile):
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    eng = PackedPairsEngine(encode_sequences(X), g, m, KernelConfig(device=cuda))
    rows = eng.rows()
    ns, k = eng.n_strips, g - m
    for a, b0, n_b in ((0, 0, ns), (ns // 2, ns // 2, ns - ns // 2), (ns - 1, 0, ns)):
        before = pairs_packed_cuda.packed_s1.launches
        got = pairs_packed_cuda.packed_s1(rows, a, rows, b0, n_b, k=k)
        torch.cuda.synchronize()
        assert pairs_packed_cuda.packed_s1.launches == before + 1
        want = pairs_packed.packed_s1_plain(
            rows.onehot[a * tile : (a + 1) * tile], rows.seq_of[a * tile : (a + 1) * tile],
            rows.first_seq[a], rows.onehot[b0 * tile : (b0 + n_b) * tile],
            k=k, tile=tile, c_pad=eng.c_pad,
        )
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# kernel F's block at strips narrower than a tile (64), of two tiles (256)
# and of the default 2048 rows; g=7; alphabets of 5 (3 code planes, one
# 16-byte load a row) and 48 (6 planes, two)
@pytest.mark.parametrize("alpha", [5, 48])
@pytest.mark.parametrize("tile,n,lmax", [(64, 9, 300), (256, 13, 400), (2048, 40, 400)])
def test_kernel_f_block_matches_plain(cuda, monkeypatch, tile, n, lmax, alpha):
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = _ragged(30 + tile + alpha, n, 10, lmax, alpha)
    X[0] = list(range(1, alpha + 1)) + X[0]  # every code, so the alphabet is alpha
    eng = PackedPairsEngine(encode_sequences(X), 7, 3, KernelConfig(device=cuda))
    assert eng.alpha == alpha and eng.n_strips >= 3
    rows, ns, k = eng.rows(), eng.n_strips, 4
    n_pad = eng.n + eng.c_pad
    fs = rows.first_seq.cpu().numpy()
    mid = ns // 2
    row0 = int(fs[mid])
    blk = int(fs[ns - 1]) + eng.c_max - row0
    want_tri = torch.zeros((n_pad, n_pad), dtype=torch.int64, device=cuda)
    for a in range(ns):
        pairs_packed.packed_block_plain(want_tri, rows, (a, a + 1), k=k)
    np.testing.assert_array_equal(want_tri[: eng.n, : eng.n].cpu().numpy(),
                                  oracle.exact_counts(X, 7, 3)[np.ix_(eng.order, eng.order)])
    rect = dict(k=k, rows_j=rows, strips_j=(1, ns), row_off=row0)
    want_rect = pairs_packed.packed_block_plain(
        torch.zeros((blk, n_pad), dtype=torch.int64, device=cuda), rows, (mid, ns), **rect
    )
    # the ring's diagonal step: strips d0.. (from the first 128-row tile
    # boundary at or past mid, as a shard starts) against themselves,
    # mirrored into their own row block
    d0 = mid + (mid * tile) % 128 // tile
    blk_d = int(fs[ns - 1]) + eng.c_max - int(fs[d0])
    diag = dict(k=k, strips_j=(d0, ns), row_off=int(fs[d0]))
    want_diag = pairs_packed.packed_block_plain(
        torch.zeros((blk_d, n_pad), dtype=torch.int64, device=cuda), rows, (d0, ns), **diag
    )
    before = pairs_packed_cuda.packed_block.launches
    tri = torch.zeros_like(want_tri)
    for a in range(ns):
        one = pairs_packed_cuda.packed_block(torch.zeros_like(tri), rows, (a, a + 1), k=k)
        if tile % 128 == 0:  # a strip holds whole tiles: each call is its plain version
            want = pairs_packed.packed_block_plain(torch.zeros_like(tri), rows, (a, a + 1), k=k)
            torch.testing.assert_close(one, want, rtol=0, atol=0)
        tri += one
    got = pairs_packed_cuda.packed_block(
        torch.zeros((blk, n_pad), dtype=torch.int64, device=cuda), rows, (mid, ns), **rect
    )
    got_diag = pairs_packed_cuda.packed_block(
        torch.zeros((blk_d, n_pad), dtype=torch.int64, device=cuda), rows, (d0, ns), **diag
    )
    torch.cuda.synchronize()
    assert pairs_packed_cuda.packed_block.launches == before + ns + 2
    torch.testing.assert_close(tri, want_tri, rtol=0, atol=0)
    torch.testing.assert_close(got, want_rect, rtol=0, atol=0)
    torch.testing.assert_close(got_diag, want_diag, rtol=0, atol=0)


# kernel G over several groups in one launch: 256-row strips in G's own
# walk of 128-row tiles, 64-row strips through kernel E's pair list
@pytest.mark.parametrize("tile", [256, 64])
def test_kernel_g_groups_match_plain(cuda, monkeypatch, tile):
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = _ragged(40 + tile, 20, 20, 400, 20)
    eng = PackedPairsEngine(encode_sequences(X), 7, 3, KernelConfig(device=cuda, pairs_backend="pallas_grouped"))
    rows, group, ns = eng.rows(), eng.group, eng.n_strips
    assert ns >= 2 * group
    for a in (0, group + 1, ns - 1):
        gidx = a // group
        n_groups = ns // group - gidx
        before = pairs_packed_cuda.packed_grouped.launches
        got = pairs_packed_cuda.packed_grouped(rows, a, gidx, k=4, group=group, n_groups=n_groups)
        torch.cuda.synchronize()
        assert pairs_packed_cuda.packed_grouped.launches == before + 1
        want = pairs_packed.packed_pair_parts_plain(
            rows.onehot, rows.seq_of, rows.first_seq, [a] * (n_groups * group),
            range(gidx * group, ns), k=4, tile=tile, c_pad=eng.c_pad,
        )
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(eng.exact(), oracle.exact_counts(X, 7, 3))


@pytest.mark.parametrize("state", ["sharded", "replicated"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_mesh_routes_match_kernel_d(cuda, monkeypatch, shape, state):
    """Both mesh routes, over the card named 1 or 4 times, equal kernel
    D's single-device counts through kernel F's block alone: one launch a
    (device, ring step) with live strips on both sides, or a round-robin
    strip; no stage-1 launch, and no plain or torch stage 2 or landing."""
    monkeypatch.setattr(PackedPairsEngine, "TILE", 256)
    X = _ragged(16, 60, 10, 400, 20)
    enc = encode_sequences(X)
    want = PackedPairsEngine(enc, 8, 4, KernelConfig(device=cuda)).exact()

    def refuse(*args, **kwargs):
        raise AssertionError("the card's mesh route ran the plain composite or torch stage 2")

    for name in ("parts_from_s1", "add_blocks", "packed_block_plain"):
        monkeypatch.setattr(pairs_packed, name, refuse)
    monkeypatch.setattr(pairs_packed_cuda, "packed_block_plain", refuse)
    mesh = make_mesh(*shape, devices=[cuda] * (shape[0] * shape[1]))
    eng = PackedPairsEngine(enc, 8, 4, KernelConfig(device=cuda, mesh=mesh, mesh_state=state))
    before = pairs_packed_cuda.packed_block.launches, pairs_packed_cuda.packed_s1.launches
    got = eng.exact()
    ns, n_dev = eng.n_strips, mesh.size
    spd = -(-ns // n_dev)
    live = sum(d * spd < ns for d in range(n_dev))
    launches = live**2 if state == "sharded" else ns
    assert pairs_packed_cuda.packed_block.launches == before[0] + launches
    assert pairs_packed_cuda.packed_s1.launches == before[1]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle.exact_counts(X, 8, 4))


# kernel H's two widths: 10 words (g=8 over 5 codes, as KAT2B) and 16
# (g=16 over DNA)
@pytest.mark.parametrize("g,m,alpha,n,length", [(8, 4, 5, 40, 60), (16, 10, 4, 24, 60)])
def test_kernel_h_variants_match_plain(cuda, g, m, alpha, n, length):
    rng = np.random.default_rng(g)
    X = rng.integers(1, alpha + 1, size=(n, length)).tolist()
    X[0][:alpha] = list(range(1, alpha + 1))  # every code, so hash_base = alpha
    eng = PairsGkmEngine(encode_sequences(X), g, m, KernelConfig(device=cuda))
    x = eng._build_x()
    assert pairs_cuda.padded_width(x.shape[1]) // 4 in pairs_cuda.PROBE_WIDTHS
    kw = dict(g=g, k=g - m, p_pad=eng.p_pad)
    tile = pairs_cuda.tile_sequences(eng.n_pad, eng.p_pad, pairs_cuda.padded_width(x.shape[1]))
    counts = pairs.pairs_counts_plain(x, k=g - m, p_pad=eng.p_pad)
    for variant in pairs.PROBE_VARIANTS:
        before = pairs_cuda.pairs_probe.launches
        got = pairs_cuda.pairs_probe(x, variant=variant, **kw)
        again = pairs_cuda.pairs_probe(x, variant=variant, **kw)
        torch.cuda.synchronize()
        assert pairs_cuda.pairs_probe.launches == before + 2
        torch.testing.assert_close(got, again, rtol=0, atol=0)
        want = (
            counts if variant in ("current", "int32")
            else pairs.pairs_probe_plain(x, k=g - m, p_pad=eng.p_pad, variant=variant, tile=tile)
        )
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("engine,alpha", [(DenseGkmEngine, 4), (SortedGkmEngine, 24)])
def test_theta_engines_on_the_card_match_the_cpu(cuda, engine, alpha):
    """The theta engines take bf16 products with f32 outputs only on the
    card (the CPU takes f32): exact counts equal the oracle's, in both
    accumulations; approx mode's iterations and counts equal the CPU run's
    and its sd trace is within rtol 1e-4 (f32 sums in another order)."""
    rng = np.random.default_rng(alpha)
    X = [rng.integers(1, alpha + 1, size=rng.integers(20, 121)).tolist() for _ in range(40)]
    enc = encode_sequences(X)
    card = engine(enc, 8, 4, KernelConfig(device=cuda))
    cpu = engine(enc, 8, 4, KernelConfig(device="cpu"))
    if engine is DenseGkmEngine:
        assert card.matmul_dtype == torch.bfloat16
    want = oracle.exact_counts(X, 8, 4)
    np.testing.assert_array_equal(card.exact(), want)
    np.testing.assert_array_equal(card.exact_device().to_host_int64(), want)
    got, ref = card.approx(conv_delta=0.1, seed=1), cpu.approx(conv_delta=0.1, seed=1)
    assert got.iters == ref.iters and got.converged == ref.converged
    np.testing.assert_array_equal(got.counts, ref.counts)
    np.testing.assert_allclose(got.stdevs, ref.stdevs, rtol=1e-4)
