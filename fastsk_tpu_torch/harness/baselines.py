"""Subprocess runners for the third-party baseline tools.

Copied from ``fastsk_tpu/harness/baselines.py`` (it imports no JAX); its
calibrated linear SVM is the port's, on ``device`` (default the card).

The reference's oracle-comparison strategy (SURVEY.md §4) drives gkmSVM-2.0,
LSGKM, GaKCo, and a JVM blended-spectrum kernel as subprocesses and compares
AUCs (test/utils.py:448-856, results/run_lsgkm.py). The binaries are not
distributable with this repo, so these runners reproduce the full command
construction, file conversion, output parsing, and scoring — everything
except the executables — and are validated in CI against stub executables
(tests/test_torch_harness.py). Point ``exec_location`` at a real
install to run the actual oracle comparison.

Deliberate differences from the reference runners: explicit timeouts on
every subprocess (the reference only wraps some calls), pathlib-safe temp
handling, missing-binary errors that say what to install, and our own
metrics (pairwise AUC identical to sklearn's roc_auc_score).
"""

from __future__ import annotations

import os
import os.path as osp
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np


class BaselineNotInstalled(FileNotFoundError):
    pass


def _run(command: Sequence[str], timeout: Optional[float]) -> str:
    exe = command[0]
    if not (osp.exists(exe) or any(
        osp.exists(osp.join(p, exe)) for p in os.environ.get("PATH", "").split(":")
    )):
        raise BaselineNotInstalled(
            f"baseline executable not found: {exe!r} — install the tool and "
            "pass its location (see docstrings)"
        )
    out = subprocess.run(
        list(command), check=True, capture_output=True, text=True,
        timeout=timeout,
    )
    return out.stdout


def split_pos_neg(
    fasta: str, pos_out: str, neg_out: str, start_id: int = 1
) -> Tuple[int, int]:
    """Split a labeled fasta into the .pos/.neg pair the gkm tools expect
    (labels 1 -> pos, 0/-1 -> neg). Each sequence gets a UNIQUE integer
    name — the gkm parsers key sequences by name, so duplicate headers
    silently collapse the dataset (the reference's converter numbers them
    the same way, results/other_scripts/gkmify.py:45-46). Sequences are
    lowercased for parity with the reference converter."""
    n_pos = n_neg = 0
    uid = start_id
    with open(fasta) as f, open(pos_out, "w") as fp, open(neg_out, "w") as fn:
        label_line = True
        label = None
        for line in f:
            if label_line:
                label = line.rstrip().split(">")[-1]
                label_line = False
            else:
                target = fp if label == "1" else fn
                if label == "1":
                    n_pos += 1
                else:
                    n_neg += 1
                target.write(f">{uid}\n{line.rstrip().lower()}\n")
                uid += 1
                label_line = True
    return n_pos, n_neg


def _read_pred_scores(path: str) -> List[float]:
    """gkm/lsgkm prediction files: one '<name> <score>' line per sequence."""
    preds = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                preds.append(float(parts[-1]))
    return preds


def _acc_auc(pos_preds, neg_preds) -> Tuple[float, float]:
    from ..metrics import roc_auc

    pos = np.asarray(pos_preds, float)
    neg = np.asarray(neg_preds, float)
    acc = (float((pos > 0).sum()) + float((neg <= 0).sum())) / max(
        len(pos) + len(neg), 1
    )
    y = np.concatenate([np.ones(len(pos)), -np.ones(len(neg))])
    auc = roc_auc(y, np.concatenate([pos, neg]))
    return acc, auc


class GkmRunner:
    """gkmSVM-2.0 pipeline: gkmsvm_kernel -> gkmsvm_train -> gkmsvm_classify
    (test/utils.py:448-619). ``max_m`` follows the reference's reading of
    the -d parameter: the eq.-3 truncation bound, 3 in approx mode, g in
    exact mode."""

    def __init__(self, exec_location: str, data_location: str, dataset: str,
                 g: int, k: int, approx: bool = False,
                 alphabet: Optional[str] = None, outdir: str = "./temp",
                 timeout: Optional[float] = 3600):
        self.exec_location = exec_location
        self.dir = data_location
        self.dataset = dataset
        self.outdir = outdir
        self.g, self.k, self.alphabet = g, k, alphabet
        self.max_m = 3 if approx else g
        self.timeout = timeout

        os.makedirs(outdir, exist_ok=True)
        d, ds = self.dir, self.dataset
        self.train_pos_file = osp.join(d, ds + ".train.pos.fasta")
        self.train_neg_file = osp.join(d, ds + ".train.neg.fasta")
        self.test_pos_file = osp.join(d, ds + ".test.pos.fasta")
        self.test_neg_file = osp.join(d, ds + ".test.neg.fasta")
        self.kernel_file = osp.join(outdir, ds + "_kernel.out")
        self.svm_file_prefix = osp.join(outdir, "svmtrain")
        self.svmalpha = self.svm_file_prefix + "_svalpha.out"
        self.svseq = self.svm_file_prefix + "_svseq.fa"
        self.pos_pred_file = osp.join(outdir, ds + ".preds.pos.out")
        self.neg_pred_file = osp.join(outdir, ds + ".preds.neg.out")

    def ensure_split_data(self, train_fasta: str, test_fasta: str) -> None:
        """Generate the .pos/.neg files from our labeled fasta pair."""
        split_pos_neg(train_fasta, self.train_pos_file, self.train_neg_file)
        split_pos_neg(test_fasta, self.test_pos_file, self.test_neg_file)

    def _flags(self) -> List[str]:
        flags = ["-l", str(self.g), "-k", str(self.k),
                 "-d", str(self.max_m), "-R"]
        if self.alphabet is not None:
            flags += ["-A", self.alphabet]
        return flags

    def compute_train_kernel(self, t: int = 1) -> None:
        cmd = [osp.join(self.exec_location, "gkmsvm_kernel"),
               "-a", "2", "-l", str(self.g), "-k", str(self.k),
               "-d", str(self.max_m), "-T", str(t), "-R"]
        if self.alphabet is not None:
            cmd += ["-A", self.alphabet]
        cmd += [self.train_pos_file, self.train_neg_file, self.kernel_file]
        _run(cmd, self.timeout)

    def train_svm(self) -> None:
        cmd = [osp.join(self.exec_location, "gkmsvm_train"),
               self.kernel_file, self.train_pos_file, self.train_neg_file,
               self.svm_file_prefix]
        _run(cmd, self.timeout)

    def classify(self) -> None:
        exe = osp.join(self.exec_location, "gkmsvm_classify")
        for test_file, pred_file in (
            (self.test_pos_file, self.pos_pred_file),
            (self.test_neg_file, self.neg_pred_file),
        ):
            cmd = [exe] + self._flags() + [
                test_file, self.svseq, self.svmalpha, pred_file
            ]
            _run(cmd, self.timeout)

    def evaluate(self) -> Tuple[float, float]:
        return _acc_auc(
            _read_pred_scores(self.pos_pred_file),
            _read_pred_scores(self.neg_pred_file),
        )

    def train_and_test(self, t: int = 1) -> Tuple[float, float]:
        self.compute_train_kernel(t)
        self.train_svm()
        self.classify()
        return self.evaluate()


class LsgkmRunner:
    """LSGKM pipeline: gkmtrain -> gkmpredict on pos/neg test files
    (results/run_lsgkm.py:100-116)."""

    def __init__(self, exec_location: str, data_location: str, dataset: str,
                 g: int, m: int, outdir: str = "./temp",
                 timeout: Optional[float] = 3600):
        self.exec_location = exec_location
        self.g, self.m, self.k = g, m, g - m
        self.timeout = timeout
        os.makedirs(outdir, exist_ok=True)
        d, ds = data_location, dataset
        self.train_pos_file = osp.join(d, ds + ".train.pos.fasta")
        self.train_neg_file = osp.join(d, ds + ".train.neg.fasta")
        self.test_pos_file = osp.join(d, ds + ".test.pos.fasta")
        self.test_neg_file = osp.join(d, ds + ".test.neg.fasta")
        self.svm_file_prefix = osp.join(outdir, ds + "_lsgkm")
        self.model_file = self.svm_file_prefix + ".model.txt"
        self.pos_pred_file = osp.join(outdir, ds + ".lsgkm.preds.pos.out")
        self.neg_pred_file = osp.join(outdir, ds + ".lsgkm.preds.neg.out")

    def train(self, t: int = 1) -> None:
        cmd = [osp.join(self.exec_location, "gkmtrain"),
               "-t", "2", "-l", str(self.g), "-k", str(self.k),
               "-d", str(self.m), "-T", str(t), "-R",
               self.train_pos_file, self.train_neg_file,
               self.svm_file_prefix]
        _run(cmd, self.timeout)

    def predict(self, t: int = 1) -> None:
        exe = osp.join(self.exec_location, "gkmpredict")
        for test_file, pred_file in (
            (self.test_pos_file, self.pos_pred_file),
            (self.test_neg_file, self.neg_pred_file),
        ):
            _run([exe, "-v", "0", "-T", str(t), test_file,
                  self.model_file, pred_file], self.timeout)

    def train_and_test(self, t: int = 1) -> Tuple[float, float]:
        self.train(t)
        self.predict(t)
        return _acc_auc(
            _read_pred_scores(self.pos_pred_file),
            _read_pred_scores(self.neg_pred_file),
        )


class GaKCoRunner:
    """GaKCo pipeline: one binary computing a combined train+test kernel,
    scored with the published calibrated-linear-SVM pipeline
    (test/utils.py:621-728)."""

    def __init__(self, exec_location: str, data_location: str, type_: str,
                 prefix: str, outdir: str = "./temp",
                 timeout: Optional[float] = 3600):
        if type_ not in ("dna", "protein"):
            raise ValueError("type_ must be 'dna' or 'protein'")
        self.exec_location = exec_location
        self.timeout = timeout
        os.makedirs(outdir, exist_ok=True)
        self.train_file = osp.join(data_location, prefix + ".train.fasta")
        self.test_file = osp.join(data_location, prefix + ".test.fasta")
        self.train_test_file = osp.join(outdir, prefix + "_train_test.fasta")
        dict_name = (
            "protein.dictionary.txt" if type_ == "protein"
            else "dna.dictionary.txt"
        )
        self.dict_file = osp.join(data_location, dict_name)
        self.labels_file = osp.join(outdir, "labels.txt")
        self.kernel_file = osp.join(outdir, "kernel.txt")
        self.num_train = self.num_test = 0

    def combine_train_and_test(self) -> None:
        lines = []
        for path, attr in ((self.train_file, "num_train"),
                           (self.test_file, "num_test")):
            count = 0
            with open(path) as f:
                for line in f:
                    if line.startswith(">") or (
                        ">" in line.split()[0][:8] if line.split() else False
                    ):
                        count += 1
                    lines.append(line)
            setattr(self, attr, count)
        with open(self.train_test_file, "w") as f:
            f.writelines(lines)

    def compute_kernel(self, g: int, m: int) -> None:
        self.g, self.m, self.k = g, m, g - m
        cmd = [self.exec_location, "-g", str(g), "-k", str(self.k),
               self.train_test_file, self.dict_file, self.labels_file,
               self.kernel_file]
        _run(cmd, self.timeout)

    def read_kernel(self) -> Tuple[np.ndarray, np.ndarray]:
        """GaKCo writes 'i:value' pairs per row; EKM columns are the
        train block."""
        rows = []
        with open(self.kernel_file) as f:
            for line in f:
                rows.append(
                    [float(item.split(":")[1])
                     for item in line.split()][: self.num_train]
                )
        x = np.asarray(rows)
        return x[: self.num_train], x[self.num_train :]

    def read_labels(self):
        from ..io.fasta import FastaUtility

        reader = FastaUtility()
        _, ytr = reader.read_data(self.train_file)
        _, yte = reader.read_data(self.test_file)
        return ytr, yte

    def train_and_test(self, g: int, m: int, C: float = 1.0, device="cuda"):
        from ..metrics import roc_auc
        from ..svm.linear import CalibratedLinearSVC

        self.combine_train_and_test()
        self.compute_kernel(g, m)
        xtr, xte = self.read_kernel()
        ytr, yte = self.read_labels()
        clf = CalibratedLinearSVC(C=C, device=device).fit(xtr, np.asarray(ytr))
        acc = clf.score(xte, np.asarray(yte))
        auc = roc_auc(np.asarray(yte), clf.predict_proba(xte)[:, 1])
        return acc, auc


class BlendedSpectrumRunner:
    """JVM blended spectrum kernel (ComputeStringKernel), scored with the
    published pipeline (test/utils.py:730-856)."""

    def __init__(self, exec_dir: str, data_location: str, prefix: str,
                 outdir: str = "./temp", timeout: Optional[float] = 3600):
        self.exec_dir = exec_dir
        self.timeout = timeout
        os.makedirs(outdir, exist_ok=True)
        self.train_fasta = osp.join(data_location, prefix + ".train.fasta")
        self.test_fasta = osp.join(data_location, prefix + ".test.fasta")
        self.seq_file = osp.join(outdir, prefix + "_spectrum.train_test.txt")
        self.kernel_file = osp.join(outdir, "kernel.txt")
        self.num_train = self.num_test = 0
        self.Ytrain: list = []
        self.Ytest: list = []

    def write_sequences(self) -> None:
        """Plain lowercased sequence lines, train then test."""
        seqs = []
        for path, ylist, attr in (
            (self.train_fasta, self.Ytrain, "num_train"),
            (self.test_fasta, self.Ytest, "num_test"),
        ):
            with open(path) as f:
                label_line = True
                count = 0
                for line in f:
                    line = line.rstrip()
                    if label_line:
                        ylist.append(line.split(">")[-1])
                        count += 1
                        label_line = False
                    else:
                        seqs.append(line.lower())
                        label_line = True
            setattr(self, attr, count)
        with open(self.seq_file, "w") as f:
            f.write("\n".join(seqs) + "\n")

    def compute_kernel(self, k1: int = 3, k2: int = 5) -> None:
        cmd = ["java", "-cp", self.exec_dir, "ComputeStringKernel",
               "spectrum", str(k1), str(k2), self.seq_file,
               self.kernel_file]
        _run(cmd, self.timeout)

    def read_kernel(self) -> Tuple[np.ndarray, np.ndarray]:
        rows = []
        with open(self.kernel_file) as f:
            for line in f:
                rows.append([float(v) for v in line.split()][: self.num_train])
        x = np.asarray(rows)
        return x[: self.num_train], x[self.num_train :]

    def train_and_test(self, k1: int = 3, k2: int = 5, C: float = 1.0, device="cuda"):
        from ..metrics import roc_auc
        from ..svm.linear import CalibratedLinearSVC

        self.write_sequences()
        self.compute_kernel(k1, k2)
        xtr, xte = self.read_kernel()
        ytr = np.asarray(self.Ytrain)
        yte = np.asarray(self.Ytest)
        clf = CalibratedLinearSVC(C=C, class_weight="balanced", device=device).fit(xtr, ytr)
        acc = clf.score(xte, yte)
        auc = roc_auc(yte.astype(float), clf.predict_proba(xte)[:, 1])
        return acc, auc
