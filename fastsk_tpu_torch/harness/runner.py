"""Runner library: the workflow every published FastSK number came from.

Counterpart of ``fastsk_tpu/harness/runner.py``: read a dataset pair,
compute the gkm kernel, train a calibrated linear SVM on the kernel rows
(empirical kernel map) or LassoCV for regression, and report acc/AUC/r².
The timing helper runs the kernel in a subprocess with a kill-on-timeout,
because exact mode at extreme g/m can run long.

Everything runs on ``KernelConfig.device`` (the card by default; without
one, pass ``KernelConfig(device="cpu")``). Where the JAX entry point builds
a ``FastSK`` with no way to pass a config (``FastskRegressor``,
``time_fastsk``, ``FastskMulticlassRunner``), the port adds the ``config``
argument that ``FastskRunner.compute_kernel`` takes. The kernel rows come
straight from the host kernel matrix (``fsk.kernel[:ntr, :ntr]`` and
``[ntr:, :ntr]``), the values ``get_train_kernel`` would list.
"""

from __future__ import annotations

import multiprocessing
import os.path as osp
import time
from typing import Optional

import numpy as np
import torch

from ..api import FastSK
from ..io.fasta import FastaUtility
from ..kernel.config import KernelConfig, resolve_device
from ..metrics import roc_auc
from ..svm.linear import CalibratedLinearSVC
from ..utils.observe import Progress, timed


def _config(config: Optional[KernelConfig]) -> KernelConfig:
    """``config`` (a default one if None) after its device is checked."""
    config = config or KernelConfig()
    resolve_device(config.device)
    return config


def _rows(fsk: FastSK):
    """(train rows, test rows) of the normalized kernel against the
    training set: the host f64 matrix's blocks."""
    k, ntr = fsk.kernel, fsk.n_str_train
    return k[:ntr, :ntr], k[ntr:, :ntr]


def _find(prefix: str, data_locations) -> str:
    loc = next(
        (d for d in data_locations if osp.exists(osp.join(d, f"{prefix}.train.fasta"))),
        None,
    )
    if loc is None:
        raise FileNotFoundError(f"no {prefix}.train.fasta under {data_locations}")
    return loc


class FastskRunner:
    """fasta pair -> kernel -> calibrated LinearSVC on the EKM -> acc/auc.

    After ``train_and_test``, ``timings_`` holds its ``kernel_s``,
    ``fit_s`` and ``score_s`` (host clock, ending synchronized) and
    ``model_`` the fitted ``CalibratedLinearSVC``."""

    def __init__(self, prefix: str, data_locations=("/root/reference/data", "data")):
        self.prefix = prefix
        loc = _find(prefix, data_locations)
        self.train_file = osp.join(loc, f"{prefix}.train.fasta")
        self.test_file = osp.join(loc, f"{prefix}.test.fasta")
        reader = FastaUtility()
        self.train_seq, self.Ytrain = reader.read_data(self.train_file)
        self.test_seq, self.Ytest = reader.read_data(self.test_file)

    def compute_kernel(
        self,
        g: int,
        m: int,
        t: int = -1,
        approx: bool = False,
        I: int = -1,
        delta: float = 0.025,
        skip_variance: bool = False,
        config: Optional[KernelConfig] = None,
    ) -> FastSK:
        fsk = FastSK(
            g=g, m=m, t=t, approx=approx, delta=delta,
            max_iters=I, skip_variance=skip_variance, config=_config(config),
        )
        fsk.compute_kernel(self.train_seq, self.test_seq, self.Ytrain, self.Ytest)
        return fsk

    def train_and_test(
        self,
        g: int,
        m: int,
        t: int = -1,
        approx: bool = False,
        I: int = -1,
        delta: float = 0.025,
        skip_variance: bool = False,
        C: float = 1.0,
        config: Optional[KernelConfig] = None,
    ) -> dict:
        config = _config(config)
        progress = Progress(config.quiet)
        with timed(progress, "kernel", device=config.device) as kernel_t:
            fsk = self.compute_kernel(
                g, m, t=t, approx=approx, I=I, delta=delta,
                skip_variance=skip_variance, config=config,
            )
            Xtrain, Xtest = _rows(fsk)
        with timed(progress, "fit", device=config.device) as fit_t:
            clf = CalibratedLinearSVC(C=C, class_weight="balanced", device=config.device).fit(
                Xtrain, self.Ytrain
            )
        with timed(progress, "score", device=config.device) as score_t:
            acc = clf.score(Xtest, self.Ytest)
            probs = clf.predict_proba(Xtest)[:, 1]
            auc = roc_auc(self.Ytest, probs)
        self.timings_ = {
            "kernel_s": kernel_t["wall_s"], "fit_s": fit_t["wall_s"], "score_s": score_t["wall_s"],
        }
        self.model_ = clf
        return {"acc": acc, "auc": auc, "iters": fsk.iterations}


class FastskRegressor:
    """fasta pair with float labels -> kernel -> LassoCV -> r^2."""

    def __init__(self, prefix: str, data_locations=("/root/reference/data", "data")):
        loc = _find(prefix, data_locations)
        reader = FastaUtility()
        self.train_seq, ytr = reader.read_data(
            osp.join(loc, f"{prefix}.train.fasta"), regression=True
        )
        self.test_seq, yte = reader.read_data(
            osp.join(loc, f"{prefix}.test.fasta"), regression=True
        )
        self.Ytrain = np.asarray(ytr, dtype=np.float64)
        self.Ytest = np.asarray(yte, dtype=np.float64)

    def train_and_test(
        self,
        g: int,
        m: int,
        t: int = -1,
        approx: bool = True,
        I: int = 100,
        delta: float = 0.025,
        skip_variance: bool = False,
        config: Optional[KernelConfig] = None,
    ) -> float:
        """r² on the test split. After the call, ``model_`` holds the
        fitted ``LassoCV`` and ``timings_`` its ``kernel_s``, ``fit_s``."""
        from ..svm.lasso import LassoCV

        config = _config(config)
        progress = Progress(config.quiet)
        with timed(progress, "kernel", device=config.device) as kernel_t:
            fsk = FastSK(
                g=g, m=m, t=t, approx=approx, delta=delta,
                max_iters=I, skip_variance=skip_variance, config=config,
            )
            fsk.compute_kernel(self.train_seq, self.test_seq)
            Xtrain, Xtest = _rows(fsk)
        with timed(progress, "fit", device=config.device) as fit_t:
            model = LassoCV(cv=5, random_state=293, device=config.device).fit(Xtrain, self.Ytrain)
        self.timings_ = {"kernel_s": kernel_t["wall_s"], "fit_s": fit_t["wall_s"]}
        self.model_ = model
        return model.score(Xtest, self.Ytest)


def _timed_child(queue, prefix, kwargs, steady_runs):
    """Time ``FastskRunner(prefix).compute_kernel(**kwargs)``: the first
    run and the best of ``steady_runs`` more. Unlike the JAX package's, it
    enables no compilation cache: the port has no XLA step, and its kernels
    are built once into ``build/fastsk_tpu_torch/``."""
    runner = FastskRunner(prefix)
    t0 = time.time()
    runner.compute_kernel(**kwargs)
    first = time.time() - t0
    steady = first
    for _ in range(steady_runs):
        runner2 = FastskRunner(prefix)  # fresh inputs
        t0 = time.time()
        runner2.compute_kernel(**kwargs)
        steady = min(steady, time.time() - t0)
    queue.put((first, steady))


def time_fastsk(
    g: int,
    m: int,
    t: int = -1,
    prefix: str = "EP300",
    approx: bool = False,
    I: int = -1,
    skip_variance: bool = False,
    timeout: Optional[float] = None,
    detail: bool = False,
    steady_runs: int = 1,
    config: Optional[KernelConfig] = None,
):
    """Kernel wall-clock with a kill-on-timeout subprocess wrapper.

    With ``detail=True`` returns ``(first_s, steady_s, timed_out)`` where
    ``first_s`` includes the kernels' first build and launch and
    ``steady_s`` is the best of ``steady_runs`` re-runs. Without
    ``detail`` returns the steady seconds (or ``timeout`` if killed). With
    a ``timeout`` the runs go to a spawned process, killed at the timeout;
    a child that ends without a result raises."""
    kwargs = dict(
        g=g, m=m, t=t, approx=approx, I=I, skip_variance=skip_variance,
        config=_config(config),
    )
    if timeout is None:
        q: multiprocessing.Queue = multiprocessing.Queue()
        _timed_child(q, prefix, kwargs, steady_runs)
        first, steady = q.get()
        return (first, steady, False) if detail else steady
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(
        target=_timed_child, args=(q, prefix, kwargs, steady_runs)
    )
    proc.start()
    proc.join(timeout)
    if proc.is_alive():
        proc.terminate()
        proc.join()
        to = float(timeout)
        return (to, to, True) if detail else to
    try:
        # the child can CRASH without posting a result (engine rejection,
        # out of memory, device error): a bare q.get() would then block
        # forever and hang the whole sweep; surface the failure instead
        first, steady = q.get(timeout=5)
    except Exception:
        raise RuntimeError(
            f"timed child exited (code {proc.exitcode}) without a result "
            f"for g={g} m={m} prefix={prefix}"
        ) from None
    return (first, steady, False) if detail else steady


class FastskMulticlassRunner:
    """TSV multiclass workflow (MADAR Arabic / DSL): kernel -> one-vs-rest
    linear SVC on the EKM, or one-vs-one C-SVC on the kernel -> accuracy."""

    def __init__(self, train_file: str, test_file: str, reader=None):
        from ..io.readers import DslUtility

        if reader is None:
            if train_file.endswith(".fasta"):
                # webkb/sentiment ship as FASTA with integer labels beyond
                # {-1,0,1}; read them through the multiclass FASTA path.
                fasta = FastaUtility()
                self.train_seq, self.Ytrain = fasta.read_data(
                    train_file, multiclass=True
                )
                self.test_seq, self.Ytest = fasta.read_data(
                    test_file, multiclass=True
                )
                return
            reader = DslUtility()
        self.train_seq, self.Ytrain = reader.read_data(train_file)
        self.test_seq, self.Ytest = reader.read_data(test_file)

    def train_and_test(
        self,
        g: int,
        m: int,
        approx: bool = True,
        I: int = 50,
        C: float = 1.0,
        skip_variance: bool = True,
        svm: str = "linear_ovr",
        config: Optional[KernelConfig] = None,
    ) -> dict:
        """``svm``: "linear_ovr" = one-vs-rest linear SVC on the EKM (the
        reference's sklearn path); "kernel_ovo" = LIBSVM-style one-vs-one
        C-SVC directly on the precomputed kernel (svm/ovo.py), its Gram on
        the device."""
        config = _config(config)
        fsk = FastSK(
            g=g, m=m, approx=approx, max_iters=I, skip_variance=skip_variance,
            config=config,
        )
        fsk.compute_kernel(self.train_seq, self.test_seq)
        Xtrain, Xtest = _rows(fsk)
        if svm == "kernel_ovo":
            from ..svm.kernel_svm import KernelSVC

            def dev(a):
                return torch.as_tensor(a, dtype=torch.float32, device=config.device)

            clf = KernelSVC(C=C).fit(dev(Xtrain), np.asarray(self.Ytrain))
            preds = clf.predict(dev(Xtest))
            return {"acc": float(np.mean(preds == np.asarray(self.Ytest)))}
        from ..svm.linear import MulticlassLinearSVC

        clf = MulticlassLinearSVC(C=C, device=config.device).fit(Xtrain, self.Ytrain)
        return {"acc": clf.score(Xtest, self.Ytest)}
