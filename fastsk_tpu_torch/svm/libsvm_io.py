"""LIBSVM text model format: save/load for precomputed-kernel SVMs.

Copied from ``fastsk_tpu/svm/libsvm_io.py`` (numpy only). It writes the
port's fitted models through the attribute names they share with the JAX
package's (``alpha_y_``, ``rho_``, ``classes_``, ``platt_``, ``coef_``,
``_ovo.models_``, ``_ovo.pair_idx_``), so a file written by either
package loads in the other.

The interop surface the reference ecosystem reads: svm_save_model /
svm_load_model (libsvm-code/svm.cpp:2672-2758, 2903-3010), with the header
key-value lines (svm_type, kernel_type, nr_class, total_sv, rho, label,
probA, probB, nr_sv) followed by one ``SV`` line per support vector:
``nr_class-1`` coefficients then the node list. Precomputed-kernel SVs are
stored as ``0:i`` — the 1-based index of the SV in the training set
(svm.cpp:2745-2746) — so a loaded model predicts from K[new, train] rows.

Multiclass coefficient layout follows svm_train's build exactly
(svm.cpp:2300-2352): SVs are grouped by class (grouping order), and the
pair (i, j) classifier's coefficients live in sv_coef[j-1] over class i's
block and sv_coef[i] over class j's block.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .ovo import OneVsOneSVC, multiclass_probability, sigmoid_predict

SVM_TYPES = ("c_svc", "nu_svc", "one_class", "epsilon_svr", "nu_svr")


def _fmt(x: float) -> str:
    return f"{x:.17g}"


def _grouping_label_order(model) -> List:
    """LIBSVM label order for a fitted classifier: grouping order for OvO,
    positive-class-first for our binary solvers (whose decision is
    positive for classes_[1])."""
    ovo = getattr(model, "_ovo", None)
    if ovo is not None:
        return list(ovo.classes_)
    return [model.classes_[1], model.classes_[0]]


def save_libsvm_model(path: str, model, svm_type: str) -> None:
    """Write a fitted solver in LIBSVM text format (kernel_type
    precomputed). Supported: KernelSVC / NuSVC (binary or OvO multiclass),
    EpsilonSVR, NuSVR, OneClassSVM."""
    if svm_type not in SVM_TYPES:
        raise ValueError(f"svm_type must be one of {SVM_TYPES}")
    lines = [f"svm_type {svm_type}", "kernel_type precomputed"]

    if svm_type in ("one_class", "epsilon_svr", "nu_svr"):
        coef = np.asarray(model.coef_, dtype=np.float64)
        sv = np.flatnonzero(np.abs(coef) > 0)
        lines.append("nr_class 2")
        lines.append(f"total_sv {len(sv)}")
        lines.append(f"rho {_fmt(model.rho_)}")
        lines.append("SV")
        for i in sv:
            lines.append(f"{_fmt(coef[i])} 0:{i + 1} ")
        _write(path, lines)
        return

    ovo = getattr(model, "_ovo", None)
    if ovo is None:
        # binary classifier: one pair, coefficients are alpha * y
        coef = np.asarray(model.alpha_y_, dtype=np.float64)
        labels = _grouping_label_order(model)
        sv = np.flatnonzero(np.abs(coef) > 0)
        # class block order: positive class first (labels[0])
        pos_first = np.concatenate(
            [sv[coef[sv] > 0], sv[coef[sv] < 0]]
        )
        n_pos = int((coef[sv] > 0).sum())
        lines.append("nr_class 2")
        lines.append(f"total_sv {len(sv)}")
        lines.append(f"rho {_fmt(model.rho_)}")
        lines.append("label " + " ".join(str(int(c)) for c in labels))
        platt = getattr(model, "platt_", None)
        if platt is not None:
            lines.append(f"probA {_fmt(platt[0])}")
            lines.append(f"probB {_fmt(platt[1])}")
        lines.append(f"nr_sv {n_pos} {len(sv) - n_pos}")
        lines.append("SV")
        for i in pos_first:
            lines.append(f"{_fmt(coef[i])} 0:{i + 1} ")
        _write(path, lines)
        return

    # OvO multiclass (svm.cpp:2300-2352 layout)
    nc = len(ovo.classes_)
    n_pairs = nc * (nc - 1) // 2
    idx_by_class = ovo.idx_by_class_
    # per-pair alpha (signed) mapped to global training indices
    pair_alpha = []
    nonzero: set = set()
    for p, (i, j) in enumerate(ovo.pairs_):
        m = ovo.models_[p]
        a = np.asarray(m.alpha_y_, dtype=np.float64)
        gidx = ovo.pair_idx_[p]
        pair_alpha.append((gidx, a))
        nonzero.update(int(g) for g, av in zip(gidx, a) if abs(av) > 0)
    sv_by_class = [
        [int(g) for g in idx_by_class[c] if int(g) in nonzero]
        for c in range(nc)
    ]
    sv_global = [g for block in sv_by_class for g in block]
    pos_of = {g: q for q, g in enumerate(sv_global)}
    total_sv = len(sv_global)
    coef = np.zeros((nc - 1, total_sv))
    for p, (i, j) in enumerate(ovo.pairs_):
        gidx, a = pair_alpha[p]
        ci = len(idx_by_class[i])
        for local, g in enumerate(gidx):
            g = int(g)
            if g not in pos_of:
                continue
            row = j - 1 if local < ci else i
            coef[row, pos_of[g]] = a[local]
    lines.append(f"nr_class {nc}")
    lines.append(f"total_sv {total_sv}")
    lines.append(
        "rho " + " ".join(_fmt(m.rho_) for m in ovo.models_)
    )
    lines.append("label " + " ".join(str(int(c)) for c in ovo.classes_))
    if ovo.probability:
        lines.append("probA " + " ".join(_fmt(a) for a, _ in ovo.platt_))
        lines.append("probB " + " ".join(_fmt(b) for _, b in ovo.platt_))
    lines.append("nr_sv " + " ".join(str(len(b)) for b in sv_by_class))
    lines.append("SV")
    for q, g in enumerate(sv_global):
        cs = " ".join(_fmt(coef[r, q]) for r in range(nc - 1))
        lines.append(f"{cs} 0:{g + 1} ")
    _write(path, lines)


def _write(path: str, lines: List[str]) -> None:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


class LibsvmModel:
    """A model loaded from LIBSVM text format, predicting from
    K[new, train] rows of the same training set (precomputed kernel).

    Mirrors svm_predict_values (svm.cpp:2521-2604): regression/one-class
    use a single coefficient vector; classification evaluates all
    C(nc, 2) pair decisions from the blocked coefficient layout and votes.
    """

    def __init__(self):
        self.svm_type = "c_svc"
        self.nr_class = 2
        self.rho: np.ndarray = np.zeros(1)
        self.label: List[int] = []
        self.probA = None
        self.probB = None
        self.nr_sv: List[int] = []
        self.sv_indices: np.ndarray = np.zeros(0, dtype=np.int64)  # 0-based
        self.sv_coef: np.ndarray = np.zeros((1, 0))

    # -- prediction --------------------------------------------------

    def _pair_decisions(self, gram_rows: np.ndarray) -> np.ndarray:
        kv = np.asarray(gram_rows, np.float64)[:, self.sv_indices]
        nc = self.nr_class
        starts = np.concatenate([[0], np.cumsum(self.nr_sv)])
        dec = []
        p = 0
        for i in range(nc):
            for j in range(i + 1, nc):
                si, ei = starts[i], starts[i + 1]
                sj, ej = starts[j], starts[j + 1]
                s = (
                    kv[:, si:ei] @ self.sv_coef[j - 1, si:ei]
                    + kv[:, sj:ej] @ self.sv_coef[i, sj:ej]
                    - self.rho[p]
                )
                dec.append(s)
                p += 1
        return np.stack(dec, axis=1)

    def decision_function(self, gram_rows: np.ndarray) -> np.ndarray:
        if self.svm_type in ("one_class", "epsilon_svr", "nu_svr"):
            kv = np.asarray(gram_rows, np.float64)[:, self.sv_indices]
            return kv @ self.sv_coef[0] - self.rho[0]
        return self._pair_decisions(gram_rows)

    def predict(self, gram_rows: np.ndarray) -> np.ndarray:
        if self.svm_type in ("epsilon_svr", "nu_svr"):
            return self.decision_function(gram_rows)
        if self.svm_type == "one_class":
            return np.where(self.decision_function(gram_rows) > 0, 1, -1)
        dec = self._pair_decisions(gram_rows)
        nc = self.nr_class
        votes = np.zeros((dec.shape[0], nc), dtype=np.int64)
        p = 0
        for i in range(nc):
            for j in range(i + 1, nc):
                win = dec[:, p] > 0
                votes[win, i] += 1
                votes[~win, j] += 1
                p += 1
        return np.asarray(self.label)[np.argmax(votes, axis=1)]

    def predict_proba(self, gram_rows: np.ndarray) -> np.ndarray:
        """Columns in ``self.label`` order (LIBSVM convention)."""
        if self.probA is None or self.probB is None:
            raise RuntimeError("model has no probability parameters")
        dec = self._pair_decisions(gram_rows)
        nc = self.nr_class
        out = np.zeros((dec.shape[0], nc))
        if nc == 2:
            p1 = sigmoid_predict(dec[:, 0], self.probA[0], self.probB[0])
            out[:, 0] = p1
            out[:, 1] = 1.0 - p1
            return out
        lo, hi = OneVsOneSVC.MIN_PROB, 1.0 - OneVsOneSVC.MIN_PROB
        for row in range(dec.shape[0]):
            r = np.zeros((nc, nc))
            p = 0
            for i in range(nc):
                for j in range(i + 1, nc):
                    pr = float(
                        np.clip(
                            sigmoid_predict(
                                dec[row, p], self.probA[p], self.probB[p]
                            ),
                            lo,
                            hi,
                        )
                    )
                    r[i, j] = pr
                    r[j, i] = 1.0 - pr
                    p += 1
            out[row] = multiclass_probability(r)
        return out


def load_libsvm_model(path: str) -> LibsvmModel:
    model = LibsvmModel()
    with open(path) as f:
        raw = f.read().splitlines()
    it = iter(raw)
    sv_lines: List[str] = []
    for line in it:
        parts = line.split()
        if not parts:
            continue
        key = parts[0]
        if key == "SV":
            sv_lines = list(it)
            break
        vals = parts[1:]
        if key == "svm_type":
            if vals[0] not in SVM_TYPES:
                raise ValueError(f"unknown svm_type {vals[0]!r}")
            model.svm_type = vals[0]
        elif key == "kernel_type":
            if vals[0] not in ("precomputed", "fastsk"):
                raise ValueError(
                    f"only precomputed-kernel models are supported; got {vals[0]!r}"
                )
        elif key == "nr_class":
            model.nr_class = int(vals[0])
        elif key == "total_sv":
            model.total_sv = int(vals[0])
        elif key == "rho":
            model.rho = np.array([float(v) for v in vals])
        elif key == "label":
            model.label = [int(v) for v in vals]
        elif key == "probA":
            model.probA = np.array([float(v) for v in vals])
        elif key == "probB":
            model.probB = np.array([float(v) for v in vals])
        elif key == "nr_sv":
            model.nr_sv = [int(v) for v in vals]
        else:
            raise ValueError(f"unknown model header field {key!r}")
    n_coef = max(model.nr_class - 1, 1)
    sv_lines = [ln for ln in sv_lines if ln.strip()]
    total = len(sv_lines)
    model.sv_coef = np.zeros((n_coef, total))
    model.sv_indices = np.zeros(total, dtype=np.int64)
    for q, line in enumerate(sv_lines):
        parts = line.split()
        for r in range(n_coef):
            model.sv_coef[r, q] = float(parts[r])
        node = parts[n_coef]
        idx, val = node.split(":")
        if idx != "0":
            raise ValueError(
                "expected precomputed-kernel SV node '0:<index>'; got "
                f"{node!r}"
            )
        model.sv_indices[q] = int(float(val)) - 1  # to 0-based
    if not model.nr_sv:
        model.nr_sv = [total]
    return model
