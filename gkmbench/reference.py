"""The plain reference of a gapped k-mer SVM job, in PyTorch and NumPy.

It imports nothing of the program and takes nothing the program made: it
works out the counts from the integer sequences the benchmark hands to
both sides, and reads the program's outputs (counts, the SVM's alphas and
bias, the AUC, approx mode's iterations and sd trace) only to judge them.

- ``allpairs_counts``: the exact kernel, K[i, j] = sum over window pairs
  (p of i, q of j) of C(matches, k), k = g - m. Window one-hots multiply
  in fp16 (0/1 operands, at most g <= 20 matches: exact), C(d, k) is a
  table lookup, and the window sums run in f32 without TF32 (exact below
  2^24, which ``allpairs_counts`` checks) and then in f64.
- ``ThetaCounter`` / ``approx_reference``: approx mode's seeded stream of
  position subsets, each subset's exact partial kernel (k-mer counts a
  sequence, one f64 product), and the stop rule on the train block.
- ``SvmJudge``: the C-SVC dual on the reference's own f64 kernel at one
  C (``at`` gives the same Grams at another), judged at the program's
  alphas: the KKT gap, the bias, the test probabilities
  and the test AUC of the program's decision values; and the program's
  Platt sigmoid against the reference's own, fitted on decision values
  of the reference's 5-fold cross-validation (``stratified_folds``,
  ``cv_decisions``, whose fold solves run in a pool of processes at the
  cells' sizes: ``svm_solve.py``); ``auc`` is FastSK's AUC.
- ``smo`` (``svm_solve.py``): a plain SMO (LIBSVM's second-order working
  set), which solves the reference's folds, and the control's whole
  problem (``gkmbench/control.py``).
"""

from __future__ import annotations

import copy
import itertools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gkmbench.svm_solve import _kkt, cv_decisions, cv_decisions_at, smo  # noqa: F401

# the stop rule's statistic is f32 in the configuration: a step whose f64
# ratio lies within this share of the threshold is not held against the
# program either way
STOP_BAND = 1e-4


def _windows(seqs: Sequence[Sequence[int]], g: int):
    """All g-mer windows ``[W, g]`` (letters coded 0..A-1 over the letters
    present), each window's sequence index, and A."""
    letters = sorted({c for s in seqs for c in s})
    code = np.zeros(max(letters) + 1, dtype=np.int64)
    code[letters] = np.arange(len(letters))
    wins, owner = [], []
    for i, s in enumerate(seqs):
        a = np.asarray(s, dtype=np.int64)
        if len(a) >= g:
            w = np.lib.stride_tricks.sliding_window_view(code[a], g)
            wins.append(w)
            owner.append(np.full(len(w), i, dtype=np.int64))
    return np.concatenate(wins), np.concatenate(owner), len(letters)


def _segments(owner: torch.Tensor, dtype) -> tuple:
    """(first sequence, 0/1 window-to-sequence matrix [w, s]) of a window
    block."""
    first = int(owner[0])
    ids = owner - first
    seg = torch.zeros((len(owner), int(ids[-1]) + 1), dtype=dtype, device=owner.device)
    seg[torch.arange(len(owner), device=owner.device), ids] = 1
    return first, seg


def allpairs_counts(seqs: Sequence[Sequence[int]], g: int, m: int, device,
                    block: int = 16384) -> torch.Tensor:
    """Exact gapped k-mer counts ``[n, n]`` int64 on ``device``."""
    k = g - m
    win, owner, A = _windows(seqs, g)
    n = len(seqs)
    p_max = int(np.bincount(owner, minlength=n).max())
    if p_max * math.comb(g, k) >= 1 << 24:
        raise ValueError("a sequence's window sum would pass 2^24 in f32")
    dev = torch.device(device)
    onehot_dtype = torch.float16 if dev.type == "cuda" else torch.float32
    W = len(win)
    cols = torch.as_tensor(win, device=dev) + torch.arange(g, device=dev) * A
    X = torch.zeros((W, g * A), dtype=onehot_dtype, device=dev)
    X.scatter_(1, cols, 1)
    own = torch.as_tensor(owner, device=dev)
    table = torch.tensor([float(math.comb(d, k)) for d in range(g + 1)], device=dev)
    K = torch.zeros((n, n), dtype=torch.float64, device=dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i0 in range(0, W, block):
            xi = X[i0 : i0 + block]
            fi, si = _segments(own[i0 : i0 + block], torch.float64)
            for j0 in range(i0, W, block):
                xj = X[j0 : j0 + block]
                fj, sj = _segments(own[j0 : j0 + block], torch.float32)
                d = (xi @ xj.T).to(torch.int32)
                w = torch.index_select(table, 0, d.view(-1)).view(d.shape)
                del d
                part = si.T @ (w @ sj).to(torch.float64)  # [seqs of i, seqs of j]
                del w
                K[fi : fi + part.shape[0], fj : fj + part.shape[1]] += part
                if j0 != i0:
                    K[fj : fj + part.shape[1], fi : fi + part.shape[0]] += part.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return K.to(torch.int64)


# ---------------------------------------------------------------- approx


def theta_stream(g: int, k: int, seed: int) -> np.ndarray:
    """Approx mode's stream: the C(g, k) kept-position subsets in
    lexicographic order, shuffled by ``numpy.random.default_rng(seed)``."""
    combos = np.array(list(itertools.combinations(range(g), k)), dtype=np.int64)
    return combos[np.random.default_rng(seed).permutation(len(combos))]


class ThetaCounter:
    """Exact partial kernels of single position subsets: each window's
    kept letters as one base-A key, the k-mer counts of each sequence, and
    their f64 Gram."""

    def __init__(self, seqs, g: int, device):
        win, owner, self.A = _windows(seqs, g)
        self.dev = torch.device(device)
        self.win = torch.as_tensor(win, device=self.dev)
        self.owner = torch.as_tensor(owner, device=self.dev)
        self.n = len(seqs)

    def __call__(self, theta) -> torch.Tensor:
        k = len(theta)
        key = torch.zeros(len(self.win), dtype=torch.int64, device=self.dev)
        for j, pos in enumerate(theta):
            key += self.win[:, int(pos)] * self.A**j
        buckets = self.A**k
        c = torch.zeros(self.n * buckets, dtype=torch.float64, device=self.dev)
        c.index_add_(0, self.owner * buckets + key,
                     torch.ones(len(key), dtype=torch.float64, device=self.dev))
        c = c.view(self.n, buckets)
        return c @ c.T


def approx_reference(seqs, n_train: int, g: int, m: int, seed: int, conv_delta: float,
                     iters: Optional[int], max_iters: int, device,
                     stat_dtype=torch.float64) -> dict:
    """The reference's approx run over the program's first ``iters``
    subsets: ``counts`` (their exact sum, int64), ``sd`` (the stop rule's
    sd at each step) and ``stop`` (the steps at which the program's
    decision, to go on before ``iters`` and to stop there, contradicts the
    rule by more than ``STOP_BAND``). With ``iters`` None the run goes on
    until its own rule stops it, and ``iters`` comes back too.
    ``stat_dtype`` is the precision of the rule's statistics (lower only in
    the control)."""
    stream = theta_stream(g, g - m, seed)
    total = len(stream)
    own = iters is None
    if own:
        iters = total if max_iters == -1 else min(max_iters, total)
    count = ThetaCounter(seqs, g, device)
    nt = n_train
    tri_count = nt * (nt + 1) / 2.0
    ksum = torch.zeros((count.n, count.n), dtype=torch.float64, device=count.dev)
    mean = torch.zeros((nt, nt), dtype=stat_dtype, device=count.dev)
    sds, ratios = [], []
    for t in range(1, min(iters, total) + 1):
        kt = count(stream[t - 1])
        ksum += kt
        ks = kt[:nt, :nt].to(stat_dtype)
        delta = ks - mean
        mean = mean + delta / t
        prod = delta * (ks - mean)
        tri = float((prod.sum() + torch.diagonal(prod).sum()).double()) / 2.0
        avg_var = 9999999.0 if t == 1 else tri / tri_count / (t - 1)
        sd = math.sqrt(avg_var / t)
        sds.append(sd)
        ratios.append(conv_delta / sd)
        if own and ratios[-1] > 1.96:
            iters = t
            break
    stop = sum(1 for r in ratios[:-1] if r > 1.96 * (1 + STOP_BAND))
    ends_early = iters < total and (max_iters == -1 or iters < max_iters)
    if ratios and ends_early and ratios[-1] < 1.96 * (1 - STOP_BAND):
        stop += 1
    if iters > total or iters < 1:
        stop += 1
    return {"counts": ksum.to(torch.int64), "sd": sds, "stop": stop, "iters": iters}


# ---------------------------------------------------------------- SVM


def normalize(counts: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Cosine normalization K / sqrt(diag diag^T)."""
    k = counts.to(dtype)
    d = torch.diagonal(k)
    return k / torch.sqrt(d[:, None] * d[None, :])


def auc(y, scores) -> float:
    """FastSK's AUC (the upstream's shared.cpp:414-426): the share of
    (positive, negative) pairs whose positive scores strictly higher; ties
    count as wrong. The larger label is positive."""
    y = np.asarray(y)
    s = np.asarray(scores, dtype=np.float64)
    pos = y == np.unique(y)[-1]
    neg = np.sort(s[~pos])
    wins = int(np.searchsorted(neg, s[pos], side="left").sum())
    return wins / (int(pos.sum()) * len(neg))


def sigmoid(f: np.ndarray, A: float, B: float) -> np.ndarray:
    """Platt's P(y = 1 | f) = 1 / (1 + exp(A f + B)), in the stable form."""
    z = np.asarray(f, dtype=np.float64) * A + B
    e = np.exp(-np.abs(z))
    return np.where(z >= 0, e / (1.0 + e), 1.0 / (1.0 + e))


def _platt_targets(y: np.ndarray) -> np.ndarray:
    """Platt's regularized targets: (n+ + 1) / (n+ + 2) for a positive row,
    1 / (n- + 2) for a negative one."""
    pos = np.asarray(y) > 0
    n1, n0 = float(pos.sum()), float((~pos).sum())
    return np.where(pos, (n1 + 1.0) / (n1 + 2.0), 1.0 / (n0 + 2.0))


def platt_nll(dec: np.ndarray, y: np.ndarray, A: float, B: float) -> float:
    """The negative log-likelihood that Platt's fit minimizes, of the
    sigmoid (A, B) on decision values ``dec`` with labels ``y`` (+1 / -1)."""
    f, t = np.asarray(dec, dtype=np.float64), _platt_targets(y)
    z = f * A + B
    return float(np.sum(np.logaddexp(0.0, z) - (1.0 - t) * z))


def sigmoid_train(dec: np.ndarray, y: np.ndarray, max_iter: int = 100):
    """Platt's (A, B) by Lin, Lin and Weng's Newton method with
    backtracking on regularized targets (LIBSVM's sigmoid_train)."""
    f = np.asarray(dec, dtype=np.float64)
    pos = np.asarray(y) > 0
    n1, n0 = float(pos.sum()), float((~pos).sum())
    t = _platt_targets(y)
    A, B = 0.0, float(np.log((n0 + 1.0) / (n1 + 1.0)))
    fval = platt_nll(f, y, A, B)
    for _ in range(max_iter):
        p = sigmoid(f, A, B)
        d2 = p * (1.0 - p)
        d1 = t - p
        h11, h22, h21 = float(np.sum(f * f * d2)) + 1e-12, float(np.sum(d2)) + 1e-12, float(np.sum(f * d2))
        g1, g2 = float(np.sum(f * d1)), float(np.sum(d1))
        if abs(g1) < 1e-5 and abs(g2) < 1e-5:
            break
        det = h11 * h22 - h21 * h21
        dA, dB = -(h22 * g1 - h21 * g2) / det, -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= 1e-10:
            na, nb = A + step * dA, B + step * dB
            nf = platt_nll(f, y, na, nb)
            if nf < fval + 1e-4 * step * gd:
                A, B, fval = na, nb, nf
                break
            step /= 2.0
        else:
            break
    return A, B


def stratified_folds(y, k: int = 5) -> List[np.ndarray]:
    """The held-out rows of each of ``k`` stratified folds, dealt as an
    unshuffled stratified k-fold deals them (scikit-learn's
    ``StratifiedKFold(k)`` with the classes in sorted order): fold i holds,
    of each class, as many rows as positions i, i + k, i + 2k, ... of the
    labels sorted by class do, and each class's rows go to folds 0..k-1 in
    contiguous blocks in their order."""
    y = np.asarray(y)
    classes = np.unique(y)
    cls = np.searchsorted(classes, y)
    by_class = np.sort(cls)
    fold_of = np.empty(len(y), dtype=np.int64)
    for c in range(len(classes)):
        sizes = [int(np.count_nonzero(by_class[i::k] == c)) for i in range(k)]
        fold_of[cls == c] = np.repeat(np.arange(k), sizes)
    return [np.flatnonzero(fold_of == i) for i in range(k)]


class SvmJudge:
    """The C-SVC problem of a job on the reference's kernel (f64): the
    train Gram of kernel rows (the ``linear`` kernel over rows that the
    program fits) and the test rows."""

    def __init__(self, counts: torch.Tensor, n_train: int, ytr, yte, C: float):
        K = normalize(counts)
        rows_tr = K[:n_train, :n_train]
        self.gram = (rows_tr @ rows_tr.T).cpu().numpy()
        self.test_gram = (K[n_train:, :n_train] @ rows_tr.T).cpu().numpy()
        classes = np.unique(ytr)
        self.y = np.where(np.asarray(ytr) == classes[-1], 1.0, -1.0)
        self.yte = np.asarray(yte)
        self.C = float(C)
        self._cv = None

    def at(self, C: float) -> "SvmJudge":
        """The same problem at another C: this judge's kernel and Grams,
        its own cross-validated sigmoid."""
        other = copy.copy(self)
        other.C, other._cv = float(C), None
        return other

    def judge(self, alpha_y: np.ndarray, rho: float) -> Dict[str, float]:
        """``svm_gap``: the KKT gap of the program's alphas on this
        problem, or their largest departure from the box or from y^T a = 0
        if larger; ``rho``: the program's bias against the one these alphas
        give."""
        alpha_y = np.asarray(alpha_y, dtype=np.float64)
        a = alpha_y * self.y
        box = max(0.0, float(-a.min()), float((a - self.C).max()))
        # an alpha within 1e-6 C of a bound is on it (C itself is f32 in
        # the program: 0.01 reads 0.0099999998)
        tol = 1e-6 * self.C
        a = np.where(a <= tol, 0.0, np.where(a >= self.C - tol, self.C, a))
        grad = self.y * (self.gram @ alpha_y) - 1.0
        gap, rho_ref = _kkt(grad, self.y, a, self.C)
        gap = max(gap, box, abs(float(alpha_y.sum())))
        return {"svm_gap": gap, "rho": abs(float(rho) - rho_ref)}

    def proba_gap(self, alpha_y: np.ndarray, rho: float, platt, proba: np.ndarray) -> float:
        """The largest gap between the program's test probabilities and
        the ones its alphas, bias and sigmoid give on this kernel."""
        dec = self.test_gram @ np.asarray(alpha_y, dtype=np.float64) - float(rho)
        return float(np.abs(np.asarray(proba, dtype=np.float64) - sigmoid(dec, *platt)).max())

    def test_auc(self, alpha_y: np.ndarray, rho: float) -> float:
        """FastSK's AUC of the test decision values that the program's
        alphas and bias give on this kernel (the AUC of any sigmoid of
        them with A < 0)."""
        return auc(self.yte, self.test_gram @ np.asarray(alpha_y, dtype=np.float64) - float(rho))

    def cv_sigmoid(self):
        """(decision values, A, B, its NLL): the reference's Platt fit on
        the decision values of its own 5-fold cross-validation, each fold
        solved by ``smo`` in f64. Worked out once (``cv_sigmoids`` works
        out several judges' at once)."""
        if self._cv is None:
            cv_sigmoids([self])
        return self._cv

    def platt_gap(self, platt) -> float:
        """How much worse the program's sigmoid (A, B) fits the reference's
        cross-validated decision values than the reference's own sigmoid:
        the excess of its NLL over the reference's, as a share of it."""
        dec, _, _, best = self.cv_sigmoid()
        return (platt_nll(dec, self.y, *platt) - best) / best


def cv_sigmoids(judges: Sequence[SvmJudge]) -> None:
    """Each judge's ``cv_sigmoid``, for judges of one problem (``at``) at
    their Cs, with every fold solve of them in one pool."""
    todo = [j for j in judges if j._cv is None]
    if not todo:
        return
    y = todo[0].y
    decs = cv_decisions_at(todo[0].gram, y, [j.C for j in todo], stratified_folds(y, 5))
    for j, dec in zip(todo, decs):
        A, B = sigmoid_train(dec, y)
        j._cv = (dec, A, B, platt_nll(dec, y, A, B))


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(b.device) - b).abs().max())


def sd_gap(program: List[float], reference: List[float]) -> float:
    """The largest relative gap between the program's sd trace and the
    reference's, over the reference's steps (a missing step counts 1)."""
    worst = 0.0
    for t, r in enumerate(reference):
        if t >= len(program) or not math.isfinite(program[t]):
            return max(worst, 1.0)
        worst = max(worst, abs(program[t] - r) / abs(r))
    return worst if len(program) == len(reference) else max(worst, 1.0)
