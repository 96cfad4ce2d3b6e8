"""``fastsk-torch-predict``: apply a saved SVM model to a saved kernel.

Copied from ``fastsk_tpu/predict_cli.py`` with its imports retargeted to
this package; it runs numpy on the host. Run it as ``fastsk-torch-predict``
or ``python -m fastsk_tpu_torch.predict_cli``.

The working replacement for the reference's svm-predict tool
(libsvm-code/svm-predict.c — present in the reference tree but never
built, setup.py:31-41). Consumes:

- a model file — LIBSVM text format (svm/libsvm_io.py) or our npz
  (svm/kernel_svm.py), and
- a kernel file — the ``.npz`` written by ``FastSK.save_kernel`` (which
  records n_train/n_test) or a plain ``.npy`` matrix with ``--n-train``.

Writes one prediction per line (label, or decision value for the SVR
types; ``-b`` adds probability estimates like svm-predict's -b), and
prints accuracy when a labeled test fasta is supplied.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_kernel(path: str, n_train: int | None):
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            k = z["kernel"]
            ntr = int(z["n_train"]) if "n_train" in z else n_train
    elif path.endswith(".npy"):
        k = np.load(path)
        ntr = n_train
    else:
        # reference text format: rows of 1-indexed col:value pairs
        rows = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    rows.append(
                        [float(p.split(":")[1]) for p in line.split()]
                    )
        k = np.asarray(rows)
        ntr = n_train
    if ntr is None:
        raise SystemExit("--n-train is required for .npy/.txt kernels")
    return k, ntr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fastsk-torch-predict",
        description="apply a saved SVM model to a saved precomputed kernel",
    )
    ap.add_argument("model_file", help=".model (LIBSVM text) or .npz")
    ap.add_argument("kernel_file", help=".npz from save_kernel, .npy, or text")
    ap.add_argument("output_file", nargs="?", help="predictions (default stdout)")
    ap.add_argument("--n-train", type=int, help="train rows for .npy/.txt kernels")
    ap.add_argument("-b", "--probability", action="store_true",
                    help="output probability estimates (classification)")
    ap.add_argument("--test-file", help="labeled test fasta for accuracy")
    args = ap.parse_args(argv)

    if args.model_file.endswith(".npz"):
        from .svm.kernel_svm import load_svm_model

        model = load_svm_model(args.model_file)
        labels = None
    else:
        from .svm.libsvm_io import load_libsvm_model

        model = load_libsvm_model(args.model_file)
        labels = model.label

    k, ntr = load_kernel(args.kernel_file, args.n_train)
    gram_rows = k[ntr:, :ntr]
    preds = model.predict(gram_rows)

    out = open(args.output_file, "w") if args.output_file else sys.stdout
    try:
        if args.probability:
            probs = model.predict_proba(gram_rows)
            header = labels if labels is not None else list(
                getattr(model, "classes_", range(probs.shape[1]))
            )
            out.write("labels " + " ".join(str(c) for c in header) + "\n")
            for p, row in zip(preds, probs):
                out.write(f"{p} " + " ".join(f"{v:.6g}" for v in row) + "\n")
        else:
            for p in preds:
                out.write(f"{p}\n")
    finally:
        if args.output_file:
            out.close()

    if args.test_file:
        from .io.fasta import FastaUtility

        _, y = FastaUtility().read_data(args.test_file)
        y = np.asarray(y)
        acc = float(np.mean(preds.astype(type(y[0])) == y))
        print(f"Accuracy = {acc * 100:.4f}% ({int(acc * len(y))}/{len(y)})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
