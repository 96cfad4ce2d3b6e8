"""Kernels A and B against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (from the ``cuda`` fixture, not at
import) where ``torch.cuda.is_available()`` is false. Run on a machine
with the card: ``python -m pytest tests/test_torch_cuda.py -q``.
Tolerances: counts are integers (equal); kernel B must take the twin's
exact f32 trajectory (equal iterations, alpha and grad).
"""

import numpy as np
import pytest
import torch

from fastsk_tpu_torch.kernel.pairs_engine import PairsGkmEngine
from fastsk_tpu_torch.kernel.config import KernelConfig
from fastsk_tpu_torch.ops import pairs, pairs_cuda
from fastsk_tpu_torch.ops.encode import encode_sequences
from fastsk_tpu_torch.svm import smo_cuda

import oracle

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels A and B run only on the card")
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
