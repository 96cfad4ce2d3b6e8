"""Faults planted in the program's timed path, for the tests and for the
readings a limit is set from: each breaks one thing the comparison must
catch. ``plant(name, setattr)`` plants one with ``setattr(owner, attr,
value)`` (pytest's ``monkeypatch.setattr``, or ``planted`` below)."""

from __future__ import annotations

import contextlib


def solve_unchanged(setattr):
    """The SVM's main solve returns its start, alpha = 0, unchanged."""
    from fastsk_tpu_torch.svm import kernel_svm

    setattr(kernel_svm, "_solve_general",
            lambda Q, y, C, p, alpha0, eps, it: (alpha0, alpha0.sum() * 0, 0))


def solve_unchanged_at_C100(setattr):
    """The SVM's main solve returns its start unchanged when C is 100, and
    solves at every other C: a fault that only one fit of a sweep shows."""
    from fastsk_tpu_torch.svm import kernel_svm

    real = kernel_svm._solve_general

    def solve(Q, y, C, p, alpha0, eps, it):
        if float(C.max()) == 100.0:
            return alpha0, alpha0.sum() * 0, 0
        return real(Q, y, C, p, alpha0, eps, it)

    setattr(kernel_svm, "_solve_general", solve)


def rho_altered(setattr):
    """The fitted bias comes out 1% high."""
    from fastsk_tpu_torch.svm import kernel_svm

    real = kernel_svm._finalize_rho
    setattr(kernel_svm, "_finalize_rho", lambda *a: (lambda r: (r[0], r[1] * 1.01))(real(*a)))


def welford_unchanged(setattr):
    """Approx mode's step returns its state unchanged."""
    from fastsk_tpu_torch.ops import gkm

    setattr(gkm, "welford_step", lambda state, ks, **kw: (state, ks.sum() * 0.0))


def half_windows(setattr):
    """The engines count the first half of each sequence's windows only."""
    from fastsk_tpu_torch import api

    real = api.encode_sequences

    def half(seqs):
        return None if seqs is None else [s[: len(s) // 2 + 8] for s in seqs]

    setattr(api, "encode_sequences", lambda a, b=None, **kw: real(half(a), half(b), **kw))


def counts_altered(setattr):
    """One exact count is off by one where the engine lands it."""
    from fastsk_tpu_torch import api

    real = api.FastSK._compute

    def compute(self, enc):
        real(self, enc)
        self._counts_dev.counts[0, 1] += 1

    setattr(api.FastSK, "_compute", compute)


def auc_altered(setattr):
    """The score's AUC comes out 1% low."""
    from fastsk_tpu_torch import metrics

    real = metrics.auc_pairwise
    setattr(metrics, "auc_pairwise", lambda y, p: real(y, p) * 0.99)


def iterations_altered(setattr):
    """Approx mode reports one subset more than it consumed."""
    from fastsk_tpu_torch.kernel import engine

    real = engine.DenseGkmEngine.approx

    def approx(self, **kw):
        r = real(self, **kw)
        r.iters += 1
        return r

    setattr(engine.DenseGkmEngine, "approx", approx)


def platt_sign(setattr):
    """The Platt sigmoid's slope A comes out with the wrong sign."""
    from fastsk_tpu_torch.svm import kernel_svm

    real = kernel_svm.sigmoid_train
    setattr(kernel_svm, "sigmoid_train", lambda dec, y, **kw: (lambda a, b: (-a, b))(*real(dec, y, **kw)))


def platt_flat(setattr):
    """The Platt sigmoid's slope A comes out 0: every probability ties."""
    from fastsk_tpu_torch.svm import kernel_svm

    real = kernel_svm.sigmoid_train
    setattr(kernel_svm, "sigmoid_train", lambda dec, y, **kw: (0.0, real(dec, y, **kw)[1]))


def stream_seed_ignored(setattr):
    """Approx mode samples the stream of seed 0 whatever seed it is given."""
    from fastsk_tpu_torch.kernel import engine

    real = engine.DenseGkmEngine.approx
    setattr(engine.DenseGkmEngine, "approx", lambda self, **kw: real(self, **dict(kw, seed=0)))


FAULTS = {f.__name__: f for f in (solve_unchanged, solve_unchanged_at_C100, rho_altered,
                                  welford_unchanged, half_windows, counts_altered, auc_altered,
                                  iterations_altered, platt_sign, platt_flat, stream_seed_ignored)}


@contextlib.contextmanager
def planted(name: str):
    """``FAULTS[name]`` planted for the block, undone after it."""
    undo = []

    def set_(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    FAULTS[name](set_)
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)
