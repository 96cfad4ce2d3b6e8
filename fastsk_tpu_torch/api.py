"""User-facing FastSK model class.

Counterpart of ``fastsk_tpu/api.py:FastSK``, with the same signature and
methods: ``compute_kernel / compute_train / kernel / kernel_counts /
get_train_kernel / get_test_kernel / get_stdevs / iterations /
save_kernel / fit / score / score_report / save_predictions``. The exact
kernel comes from the sequence-aligned or the packed (ragged) all-pairs
engine, or the theta engine as the last fallback, chosen as the JAX
package chooses; approx mode (``approx=True``, deterministic given
``seed``) and ``exact_engine="theta"`` run the dense theta engine when
``hash_base**k <= b_max_dense`` and the sorted one otherwise. The SVM is
any of the LIBSVM family (``svm_type`` c_svc, nu_svc, one_class,
epsilon_svr, nu_svr; multiclass labels train one-vs-one), all on
``KernelConfig.device``. Under ``KernelConfig.mesh`` the packed engine or
the theta engines compute the kernel over the mesh's devices (across
processes too, ``parallel/multihost.py``), and the fit runs on
``KernelConfig.device``; ``KernelConfig.checkpoint_path`` lets a dense
theta run resume after an interruption. Each stage of a job is a span of
``utils/observe.py`` (``encode``, ``engine.build``, ``normalize``,
``fit.gram``, ``score.gram``, ``score.predict`` here; the engines' and
the SVM's inside), named in a ``torch.profiler`` trace while one records.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .kernel.config import KernelConfig
from .kernel.engine import ApproxResult, DenseGkmEngine, cosine_normalize
from .kernel.sorted_engine import SortedGkmEngine
from .ops.encode import EncodedSeqs, encode_sequences, validate_g
from .ops.pairs import full_f32_matmul
from .utils.observe import span


class FastSK:
    def __init__(
        self,
        g: int,
        m: int,
        t: int = -1,
        approx: bool = False,
        delta: float = 0.025,
        max_iters: int = -1,
        skip_variance: bool = False,
        seed: int = 0,
        config: Optional[KernelConfig] = None,
    ):
        self.g = int(g)
        self.m = int(m)
        self.k = self.g - self.m
        self.t = t  # accepted for API parity with the reference
        self.approx = bool(approx)
        self.delta = float(delta)
        self.max_iters = int(max_iters)
        self.skip_variance = bool(skip_variance)
        self.seed = int(seed)
        self.config = config or KernelConfig()

        self._counts: Optional[np.ndarray] = None  # int64 [N, N]
        self._K: Optional[np.ndarray] = None  # float64 normalized [N, N]
        self._counts_dev = None  # DeviceCounts (device-resident mode)
        self._K_dev: Optional[torch.Tensor] = None  # f32 normalized, on device
        self._stdevs: List[float] = []  # approx mode's trace; empty in exact mode
        self._iters: int = 0  # approx mode's iterations; 0 in exact mode
        self.n_str_train = 0
        self.n_str_test = 0
        self.train_labels: Optional[np.ndarray] = None
        self.test_labels: Optional[np.ndarray] = None
        self._model = None

    # ------------------------------------------------------------ kernel

    def _make_engine(self, enc: EncodedSeqs):
        """The theta engine: dense while ``hash_base**k`` buckets fit
        ``b_max_dense``, sorted beyond."""
        if enc.hash_base**self.k <= self.config.b_max_dense:
            return DenseGkmEngine(enc, self.g, self.m, self.config)
        return SortedGkmEngine(enc, self.g, self.m, self.config)

    def _make_exact_engine(self, enc: EncodedSeqs):
        """The JAX package's choice: the sequence-aligned engine when
        lengths are near-uniform, the packed one on ragged data (padding
        waste > 1.5) or when the sequence-aligned engine refuses the
        shape; the theta engine when forced or as the last fallback."""
        from .kernel.pairs_engine import PackedPairsEngine, PairsGkmEngine

        choice = self.config.exact_engine
        if choice == "theta":
            return self._make_engine(enc)
        if choice == "packed":
            return PackedPairsEngine(enc, self.g, self.m, self.config)
        windows = enc.num_windows(self.g)
        waste = enc.n * ((int(windows.max()) + 7) // 8 * 8) / max(
            int(((windows + 7) // 8 * 8).sum()), 1
        )
        try:
            if choice == "auto" and waste > 1.5:
                return PackedPairsEngine(enc, self.g, self.m, self.config)
            return PairsGkmEngine(enc, self.g, self.m, self.config)
        except ValueError:
            if choice == "pairs":
                raise
            try:
                return PackedPairsEngine(enc, self.g, self.m, self.config)
            except ValueError:
                pass
            return self._make_engine(enc)

    def _compute(self, enc: EncodedSeqs) -> None:
        validate_g(enc, self.g, self.m)
        with span("engine.build"):
            engine = self._make_engine(enc) if self.approx else self._make_exact_engine(enc)
        self._counts_dev = None
        self._K_dev = None
        # The JAX package's rules (fastsk_tpu/api.py:150-180): under a mesh
        # only the dense engine stays device-resident (its row blocks are
        # collapsed onto config.device; every process of a multi-process
        # mesh assembles the whole matrix and fits the same replica); only
        # the single-device dense engine checkpoints a device-resident run,
        # so a checkpoint takes every other engine and mesh combination to
        # its host path rather than being ignored; approx device_out needs
        # one device and no checkpoint.
        cfg = self.config
        dense = isinstance(engine, DenseGkmEngine)
        use_dev = cfg.device_resident
        if cfg.mesh is not None and not dense:
            use_dev = False
        if cfg.checkpoint_path is not None and not (dense and cfg.mesh is None):
            use_dev = False
        if self.approx:
            dev_ok = use_dev and cfg.mesh is None and cfg.checkpoint_path is None
            res: ApproxResult = engine.approx(
                conv_delta=self.delta,
                max_iters=self.max_iters,
                skip_variance=self.skip_variance,
                seed=self.seed,
                device_out=dev_ok,
            )
            self._stdevs = res.stdevs
            self._iters = res.iters
            counts = res.counts
        else:
            counts = engine.exact_device() if use_dev else engine.exact()
            self._iters = 0
            self._stdevs = []
        with span("normalize"):
            if isinstance(counts, np.ndarray):
                # host path, or counts past int32 from the packed engine
                self._counts = counts
                self._K = cosine_normalize(counts)
            else:  # DeviceCounts
                self._counts_dev = counts
                self._K_dev = counts.normalized_f32()
                self._counts = None
                self._K = None
        self.n_str_train = enc.n_train
        self.n_str_test = enc.n_test
        # total g-mer count across all sequences — the reference's nfeat
        # (fastsk.cpp:117: features->n), used as the rbf gamma denominator
        self.nfeat = int(enc.num_windows(self.g).sum())

    def compute_kernel(
        self,
        Xtrain: Sequence[Sequence[int]],
        Xtest: Sequence[Sequence[int]],
        Ytrain: Optional[Sequence[int]] = None,
        Ytest: Optional[Sequence[int]] = None,
    ) -> None:
        """Compute the joint (train+test) normalized kernel matrix."""
        with span("encode"):
            enc = encode_sequences(Xtrain, Xtest)
        self._compute(enc)
        if Ytrain is not None:
            self.train_labels = np.asarray(Ytrain)
        if Ytest is not None:
            self.test_labels = np.asarray(Ytest)

    def compute_train(self, Xtrain: Sequence[Sequence[int]], Ytrain=None) -> None:
        """Compute the train-only kernel matrix."""
        with span("encode"):
            enc = encode_sequences(Xtrain, None)
        self._compute(enc)
        if Ytrain is not None:
            self.train_labels = np.asarray(Ytrain)

    def set_labels(self, Ytrain: Sequence[int], Ytest: Optional[Sequence[int]] = None):
        self.train_labels = np.asarray(Ytrain)
        if Ytest is not None:
            self.test_labels = np.asarray(Ytest)

    # ------------------------------------------------------------ access

    def _require_kernel(self) -> np.ndarray:
        if self._K is None:
            # device-resident run, host matrix explicitly requested:
            # exact integer pull + f64 normalization, identical to the
            # host-path result
            self._K = cosine_normalize(self.kernel_counts)
        return self._K

    @property
    def kernel(self) -> np.ndarray:
        """Full normalized (train+test) kernel matrix, float64 [N, N]."""
        return self._require_kernel()

    @property
    def kernel_counts(self) -> np.ndarray:
        """Unnormalized integer count kernel, int64 [N, N] (pulled from the
        device lazily in device-resident mode)."""
        if self._counts is None:
            if self._counts_dev is None:
                raise RuntimeError("call compute_kernel or compute_train first")
            self._counts = self._counts_dev.to_host_int64()
        return self._counts

    def get_train_kernel(self) -> List[List[float]]:
        """Train block of the normalized kernel (fastsk.cpp:190-200)."""
        k = self._require_kernel()
        ntr = self.n_str_train
        return k[:ntr, :ntr].tolist()

    def get_test_kernel(self) -> List[List[float]]:
        """Test-vs-train block of the normalized kernel (fastsk.cpp:202-217)."""
        k = self._require_kernel()
        ntr = self.n_str_train
        return k[ntr:, :ntr].tolist()

    def get_stdevs(self) -> List[float]:
        """Per-iteration convergence sd trace (approx mode; empty in exact
        mode)."""
        return list(self._stdevs)

    @property
    def iterations(self) -> int:
        """Number of Monte-Carlo iterations consumed (approx mode; 0 in
        exact mode)."""
        return self._iters

    def save_kernel(self, kernel_file: str) -> None:
        """Write the kernel: the reference text format (fastsk.cpp:223-237,
        one row of 1-indexed ``col:value`` pairs per sequence) by default,
        or binary ``.npy``/``.npz`` (with counts + split sizes) when the
        filename says so."""
        k = self._require_kernel()
        if kernel_file.endswith(".npy"):
            np.save(kernel_file, k)
            return
        if kernel_file.endswith(".npz"):
            np.savez_compressed(
                kernel_file,
                kernel=k,
                counts=self.kernel_counts,
                n_train=np.int64(self.n_str_train),
                n_test=np.int64(self.n_str_test),
            )
            return
        n = k.shape[0]
        with open(kernel_file, "w") as f:
            for i in range(n):
                f.write("".join(f"{j + 1}:{k[i, j]:e} " for j in range(n)))
                f.write("\n")

    # ------------------------------------------------------------ svm

    def fit(
        self,
        C: float = 1.0,
        nu: float = 0.5,
        eps: float = 0.001,
        kernel_type: str = "linear",
        svm_type: str = "c_svc",
    ) -> None:
        """Train an SVM on the computed kernel (defaults match
        bindings.cpp:36-41). ``kernel_type``:

        - "fastsk": SVM directly on the precomputed gkm kernel
        - "linear": SVM with a linear kernel over kernel rows (the
          reference's default — kernel rows as an empirical kernel map)
        - "rbf":    SVM with an RBF kernel over kernel rows,
          gamma = 1/nfeat (fastsk.cpp:273)

        ``svm_type`` selects the solver, like LIBSVM's -s: "c_svc"
        (default), "nu_svc", "one_class", "epsilon_svr", "nu_svr". ``nu``
        parameterizes the nu_* and one_class solvers; C-SVC ignores it.
        Multiclass labels train one-vs-one (svm.cpp:2163+).
        """
        from .svm.kernel_svm import (
            EpsilonSVR,
            KernelSVC,
            NuSVC,
            NuSVR,
            OneClassSVM,
        )

        if svm_type not in ("c_svc", "nu_svc", "one_class", "epsilon_svr", "nu_svr"):
            raise ValueError(
                "svm_type must be one of c_svc, nu_svc, one_class, "
                f"epsilon_svr, nu_svr; got {svm_type!r}"
            )
        if svm_type != "one_class" and self.train_labels is None:
            raise RuntimeError(
                "labels are required: pass Ytrain to compute_kernel or call set_labels"
            )
        if kernel_type not in ("fastsk", "linear", "rbf"):
            raise ValueError("kernel must be 'linear', 'fastsk', or 'rbf'")
        with span("fit.gram"):
            rows_train = self._rows()[0]
            gram = self._on_device(self._build_gram(rows_train, rows_train, kernel_type))
        self._fit_kernel_type = kernel_type
        self._fit_svm_type = svm_type
        if svm_type == "one_class":
            self._model = OneClassSVM(nu=nu, eps=eps).fit(gram)
            return
        model = {
            "c_svc": lambda: KernelSVC(C=C, eps=eps, probability=True),
            "nu_svc": lambda: NuSVC(nu=nu, eps=eps, probability=True),
            "epsilon_svr": lambda: EpsilonSVR(C=C, eps=eps),
            "nu_svr": lambda: NuSVR(C=C, nu=nu, eps=eps),
        }[svm_type]()
        self._model = model.fit(gram, np.asarray(self.train_labels))

    def _rows(self):
        """(train rows, test rows) of the normalized kernel against the
        training set: f32 on the device in device-resident mode, f64 numpy
        otherwise."""
        ntr = self.n_str_train
        k = self._K_dev if self._K_dev is not None else self._require_kernel()
        return k[:ntr, :ntr], k[ntr:, :ntr]

    def _on_device(self, gram):
        """A host Gram goes to the configured device for the SVM (as the
        JAX package's solvers move theirs to the default device)."""
        if isinstance(gram, torch.Tensor):
            return gram
        return torch.as_tensor(gram, dtype=torch.float32, device=self.config.device)

    def _build_gram(self, rows_a, rows_train, kernel_type: str):
        """Gram of ``rows_a`` against ``rows_train`` under ``kernel_type``.

        Rows are normalized-kernel rows: numpy f64 on the host path, torch
        f32 on the device-resident path — device Grams are built on the
        device (full f32 products, no TF32) so fit/score never pull the
        O(N^2) matrices.
        """
        if kernel_type == "fastsk":
            return rows_a
        on_dev = isinstance(rows_a, torch.Tensor)
        if on_dev:
            def dot(a, b):
                with full_f32_matmul():
                    return a @ b

            exp = torch.exp
        else:
            def dot(a, b):
                return a @ b

            exp = np.exp

        if kernel_type == "linear":
            return dot(rows_a, rows_train.T)
        # rbf, gamma = 1/nfeat (fastsk.cpp:273)
        gamma = 1.0 / max(self.nfeat, 1)
        sq_a = (rows_a**2).sum(1)
        sq_t = (rows_train**2).sum(1)
        return exp(
            -gamma * (sq_a[:, None] + sq_t[None, :] - 2 * dot(rows_a, rows_train.T))
        )

    def _test_gram(self):
        """Test-vs-train Gram under the fitted kernel_type (on the device
        when the kernel is device-resident)."""
        with span("score.gram"):
            rows_train, rows_test = self._rows()
            return self._build_gram(rows_test, rows_train, self._fit_kernel_type)

    def _check_scorable(self) -> None:
        if self._model is None:
            raise RuntimeError("call fit() first")
        if self.test_labels is None:
            raise RuntimeError("test labels are required")

    def _is_binary_classifier(self) -> bool:
        """A two-class c_svc / nu_svc model (fit gives it Platt
        probabilities); one-class and SVR models carry no classes."""
        return len(getattr(self._model, "classes_", [])) == 2

    def score(self, metric: str = "auc") -> float:
        """Predict on the test block and report accuracy, AUROC (binary
        classifiers) or r2 (the SVR types) (fastsk.cpp:418-530, minus the
        unconditional auc_file.txt side effect)."""
        from .metrics import accuracy_score, auc_pairwise, r2_score

        if metric not in ("accuracy", "auc", "r2"):
            raise ValueError("metric argument must be 'accuracy', 'auc', or 'r2'")
        self._check_scorable()
        gram_test = self._test_gram()
        y_test = np.asarray(self.test_labels)
        with span("score.predict"):
            if self._fit_svm_type in ("epsilon_svr", "nu_svr"):
                if metric != "r2":
                    raise ValueError("regression models score with metric='r2'")
                return r2_score(y_test.astype(np.float64), self._model.predict(gram_test))
            if metric == "r2":
                raise ValueError("metric='r2' is for the SVR types")
            if metric == "auc":
                if not self._is_binary_classifier():
                    raise ValueError(
                        "metric='auc' requires a binary classifier; use 'accuracy'"
                    )
                probs = self._model.predict_proba(gram_test)[:, 1]
                return auc_pairwise(y_test, probs)
            return accuracy_score(y_test, self._model.predict(gram_test)) * 100.0

    def save_predictions(self, path: str) -> None:
        """Write per-test-point ``label value`` lines — the reference's
        auc_file.txt side effect (fastsk.cpp:447-476, 502), opt-in here.
        ``value`` is the positive-class probability for binary
        classifiers, the predicted value for the SVR types, and the
        predicted class otherwise."""
        self._check_scorable()
        gram_test = self._test_gram()
        if self._is_binary_classifier():
            vals = self._model.predict_proba(gram_test)[:, 1]
        else:
            vals = self._model.predict(gram_test)
        with open(path, "w") as f:
            for label, v in zip(np.asarray(self.test_labels), vals):
                f.write(f"{label} {v}\n")

    def score_report(self) -> dict:
        """Full scoring report: acc, and for binary classifiers AUROC and
        TPR/TNR/FNR/FPR — everything the reference's score() prints
        (fastsk.cpp:508-529), as a dict."""
        from .metrics import accuracy_score, auc_pairwise, confusion_rates

        self._check_scorable()
        gram_test = self._test_gram()
        y = np.asarray(self.test_labels)
        preds = self._model.predict(gram_test)
        out = {"accuracy": accuracy_score(y, preds)}
        if self._is_binary_classifier():
            probs = self._model.predict_proba(gram_test)[:, 1]
            out["auc"] = auc_pairwise(y, probs)
            out.update(confusion_rates(y, preds))
        return out
