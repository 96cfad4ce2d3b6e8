"""The plain reference's SVM solves, in NumPy alone: ``smo``, a plain SMO
(LIBSVM's second-order working set and stop), and the decision values of
its cross-validation folds (``cv_decisions``, ``cv_decisions_at``).

The fold solves are independent and serial, and at the cells' sizes take
most of the reference's time: from ``POOL_ROWS`` rows on they run in a
pool of processes, each solve whole in one process, so that every number
is the serial one. The Gram goes to the pool once, through shared memory,
and the pool's processes import nothing but NumPy and this module.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import shared_memory
from typing import List, Optional, Sequence

import numpy as np

POOL_ROWS = 1024


def fold_decisions(gram: np.ndarray, y: np.ndarray, C: float, f: np.ndarray,
                   eps: float = 1e-3) -> np.ndarray:
    """The held-out rows ``f``'s decision values from the C-SVC that
    ``smo`` fits, in the dtype of ``gram``, on the other rows."""
    tr = np.setdiff1d(np.arange(len(y)), f)
    a, rho, _ = smo(np.ascontiguousarray(gram[np.ix_(tr, tr)]), y[tr], C, eps)
    return gram[np.ix_(f, tr)] @ (a * y[tr]).astype(gram.dtype) - rho


_POOL: tuple = ()  # (shared memory, gram, y, folds, eps) in a pool's process


def _pool_init(name, shape, dtype, y, folds, eps):
    global _POOL
    shm = shared_memory.SharedMemory(name=name)
    _POOL = (shm, np.ndarray(shape, dtype=dtype, buffer=shm.buf), y, folds, eps)


def _pool_fold(task):
    C, i = task
    _, gram, y, folds, eps = _POOL
    return fold_decisions(gram, y, C, folds[i], eps)


def _pooled(gram: np.ndarray, y: np.ndarray, folds, eps: float, tasks, workers: int) -> list:
    """``fold_decisions`` of each (C, fold) task, in a pool of processes
    that is shut down and joined, and the shared Gram freed, before this
    returns."""
    shm = shared_memory.SharedMemory(create=True, size=max(gram.nbytes, 1))
    try:
        np.ndarray(gram.shape, dtype=gram.dtype, buffer=shm.buf)[...] = gram
        # the largest C, as a rule the longest solve, first
        order = sorted(range(len(tasks)), key=lambda t: -tasks[t][0])
        init = (shm.name, gram.shape, gram.dtype.str, y, folds, eps)
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                 initializer=_pool_init, initargs=init) as ex:
            done = dict(zip(order, ex.map(_pool_fold, [tasks[t] for t in order])))
    finally:
        shm.close()
        shm.unlink()
    return [done[t] for t in range(len(tasks))]


def cv_decisions_at(gram: np.ndarray, y: np.ndarray, Cs: Sequence[float], folds,
                    eps: float = 1e-3, workers: Optional[int] = None) -> List[np.ndarray]:
    """``cv_decisions`` at each C of ``Cs``: from ``POOL_ROWS`` rows on (or
    where ``workers`` says) in a pool of processes, one a core but one."""
    tasks = [(C, i) for C in Cs for i in range(len(folds))]
    if workers is None:
        cores = len(os.sched_getaffinity(0))
        workers = min(len(tasks), max(1, cores - 1)) if len(y) >= POOL_ROWS else 1
    if workers > 1:
        parts = _pooled(gram, y, folds, eps, tasks, workers)
    else:
        parts = [fold_decisions(gram, y, C, folds[i], eps) for C, i in tasks]
    out = []
    for k in range(len(Cs)):
        dec = np.zeros(len(y), dtype=np.float64)
        for i, f in enumerate(folds):
            dec[f] = parts[k * len(folds) + i]
        out.append(dec)
    return out


def cv_decisions(gram: np.ndarray, y: np.ndarray, C: float, folds, eps: float = 1e-3) -> np.ndarray:
    """Each training row's decision value from the C-SVC that ``smo``
    fits, in the dtype of ``gram``, on the rows of the other folds (f64
    out)."""
    return cv_decisions_at(gram, y, [C], folds, eps)[0]


def _kkt(grad: np.ndarray, y: np.ndarray, a: np.ndarray, C: float):
    """(gap, rho) of a C-SVC dual point: the largest KKT violation m - M
    over LIBSVM's I_up and I_low, and the bias as LIBSVM's
    calculate_rho (the free alphas' mean of y grad, else the midpoint)."""
    up = np.where(y > 0, a < C, a > 0)
    low = np.where(y > 0, a > 0, a < C)
    myg = -y * grad
    gap = float(myg[up].max() - myg[low].min()) if up.any() and low.any() else 0.0
    yg = y * grad
    free = (a > 0) & (a < C)
    if free.any():
        rho = float(yg[free].mean())
    else:
        rho = float((yg[up].min() + yg[low].max()) / 2.0)
    return gap, rho


def smo(gram: np.ndarray, y: np.ndarray, C: float, eps: float = 1e-3,
        max_iter: Optional[int] = None):
    """A plain SMO for min 0.5 a^T Q a - sum a, 0 <= a <= C, y^T a = 0,
    Q = y y^T * gram, with LIBSVM's second-order working set and stop
    (m - M < eps), in the dtype of ``gram``: (alpha, rho, iterations)."""
    dt = gram.dtype
    n = len(y)
    y = y.astype(dt)
    a = np.zeros(n, dtype=dt)
    grad = -np.ones(n, dtype=dt)
    qd = np.diag(gram).astype(dt)
    up = y > 0  # a = 0: I_up holds y = +1, I_low y = -1
    low = ~up
    tau = 1e-12
    max_iter = max_iter or max(10_000_000, 100 * n)
    it = 0
    while it < max_iter:
        myg = -y * grad
        i = int(np.argmax(np.where(up, myg, -np.inf)))
        gmax = myg[i]
        low_myg = np.where(low, myg, np.inf)
        if gmax - low_myg.min() < eps:
            break
        b = gmax - low_myg
        quad = np.maximum(qd[i] + qd - 2.0 * gram[i], tau)
        obj = np.where(b > 0, -(b * b) / quad, np.inf)
        j = int(np.argmin(obj))
        if not np.isfinite(obj[j]):
            break
        it += 1
        qi = y[i] * y * gram[i]
        qj = y[j] * y * gram[j]
        ai, aj = float(a[i]), float(a[j])
        if y[i] != y[j]:
            quad_ij = max(float(qd[i] + qd[j] + 2.0 * qi[j]), tau)
            delta = (-grad[i] - grad[j]) / quad_ij
            diff = ai - aj
            ai += delta
            aj += delta
            if diff > 0:
                if aj < 0:
                    aj, ai = 0.0, diff
            elif ai < 0:
                ai, aj = 0.0, -diff
            if diff > 0:
                if ai > C:
                    ai, aj = C, C - diff
            elif aj > C:
                aj, ai = C, C + diff
        else:
            quad_ij = max(float(qd[i] + qd[j] - 2.0 * qi[j]), tau)
            delta = (grad[i] - grad[j]) / quad_ij
            s = ai + aj
            ai -= delta
            aj += delta
            if s > C:
                if ai > C:
                    ai, aj = C, s - C
            elif aj < 0:
                aj, ai = 0.0, s
            if s > C:
                if aj > C:
                    aj, ai = C, s - C
            elif ai < 0:
                ai, aj = 0.0, s
        dai, daj = ai - a[i], aj - a[j]
        a[i], a[j] = ai, aj
        grad += qi * dai + qj * daj
        for t in (i, j):
            up[t] = a[t] < C if y[t] > 0 else a[t] > 0
            low[t] = a[t] > 0 if y[t] > 0 else a[t] < C
    _, rho = _kkt(grad.astype(np.float64), y.astype(np.float64), a.astype(np.float64), C)
    return a, rho, it
