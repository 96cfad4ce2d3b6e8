"""Command-line interface of the port: ``fastsk-torch``.

Counterpart of ``fastsk_tpu/cli.py`` (the ``fastsk`` CLI), with the same
flags plus ``--device``:

    fastsk-torch -g 10 -m 6 -C 1 train.fasta test.fasta [dictionary.txt]
    python -m fastsk_tpu_torch.cli -g 10 -m 4 --json train.fasta test.fasta

It runs the exact kernel, or approx mode (``-a``; ``-I``, ``--delta``,
``--skip-variance`` and ``--seed`` as in the JAX CLI), and any SVM type of
the LIBSVM family on ``--device``: the card by default, the CPU only with
``--device cpu`` (without a card and without that flag it exits with an
error). ``--checkpoint`` and ``--checkpoint-every``, which only the
unported checkpoint slice reads (ROADMAP.md slice 5), raise
``NotImplementedError`` when set instead of being ignored. ``-t`` is
accepted and ignored, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fastsk-torch",
        description="gapped k-mer string kernel + SVM in PyTorch, with CUDA "
                    "kernels for the H100",
    )
    ap.add_argument("-g", type=int, required=True, help="g-mer length (0 < g <= 20)")
    ap.add_argument("-m", type=int, required=True, help="max mismatches (0 <= m < g)")
    ap.add_argument("-t", type=int, default=-1,
                    help="accepted for reference parity; parallelism is the device's")
    ap.add_argument("-C", type=float, default=1.0, help="SVM C parameter")
    ap.add_argument("--nu", type=float, default=0.5,
                    help="nu parameter for nu_svc / nu_svr / one_class")
    ap.add_argument("-r", "--kernel-type", default="linear",
                    choices=["linear", "fastsk", "rbf"], help="SVM kernel over the gkm kernel")
    ap.add_argument("-s", "--svm-type", default="c_svc",
                    choices=["c_svc", "nu_svc", "one_class", "epsilon_svr", "nu_svr"],
                    help="SVM solver type (LIBSVM -s)")
    ap.add_argument("-I", "--max-iters", type=int, default=-1,
                    help="max Monte-Carlo iterations in approx mode")
    ap.add_argument("-a", "--approx", action="store_true",
                    help="Monte-Carlo approximation with convergence stopping")
    ap.add_argument("--delta", type=float, default=0.025, help="approx convergence delta")
    ap.add_argument("--skip-variance", action="store_true",
                    help="approx without variance tracking (exactly max-iters samples)")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--seed", type=int, default=0, help="approx sampling seed (deterministic)")
    ap.add_argument("--metric", default="both", choices=["auc", "accuracy", "both"])
    ap.add_argument("--save-kernel", metavar="PATH",
                    help="write the normalized kernel in the reference text format "
                         "(.npy / .npz by extension)")
    ap.add_argument("--save-model", metavar="PATH",
                    help="write the fitted SVM (npz, or LIBSVM text with "
                         "--model-format libsvm)")
    ap.add_argument("--model-format", default="npz", choices=["npz", "libsvm"],
                    help="model persistence format")
    ap.add_argument("--save-predictions", metavar="PATH",
                    help="write per-test-point 'label value' lines (the "
                         "reference's auc_file.txt, opt-in)")
    ap.add_argument("--checkpoint", metavar="PATH",
                    help="checkpoint kernel computation (not ported yet: "
                         "raises, ROADMAP.md slice 5)")
    ap.add_argument("--checkpoint-every", type=int, default=512,
                    help="thetas between checkpoints (not ported yet: raises "
                         "if set, ROADMAP.md slice 5)")
    ap.add_argument("--device-resident", action="store_true",
                    help="keep the kernel on the device end to end (fit/score "
                         "without the O(N^2) device->host pull)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the kernel and the SVM (default: "
                         "cuda; the CPU runs only with --device cpu)")
    ap.add_argument("--no-svm", action="store_true", help="kernel computation only")
    ap.add_argument("--json", action="store_true", help="emit one JSON line of results")
    ap.add_argument("train_file")
    ap.add_argument("test_file", nargs="?")
    ap.add_argument("dictionary_file", nargs="?")
    return ap


# flags of the JAX CLI that only the unported slices read: setting one
# raises rather than being ignored
UNPORTED = {
    "checkpoint": ("--checkpoint", "slice 5 (checkpoint/resume)"),
    "checkpoint_every": ("--checkpoint-every", "slice 5 (checkpoint/resume)"),
}


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for dest, (flag, slice_) in UNPORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP.md {slice_}")

    import torch

    from .api import FastSK
    from .io.fasta import FastaUtility, Vocabulary
    from .kernel.config import KernelConfig

    device = args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device found; pass --device cpu to run on the CPU")
    vocab = (
        Vocabulary.from_dictionary_file(args.dictionary_file)
        if args.dictionary_file
        else None
    )
    reader = FastaUtility(vocab=vocab)
    Xtrain, Ytrain = reader.read_data(args.train_file)
    Xtest, Ytest = (reader.read_data(args.test_file) if args.test_file else ([], []))

    if args.save_predictions and (args.no_svm or not args.test_file):
        print("--save-predictions requires a test file and a fitted SVM "
              "(drop --no-svm)", file=sys.stderr)
        return 2
    config = KernelConfig(device=device, device_resident=args.device_resident)
    fsk = FastSK(
        g=args.g,
        m=args.m,
        t=args.t,
        approx=args.approx,
        delta=args.delta,
        max_iters=args.max_iters,
        skip_variance=args.skip_variance,
        seed=args.seed,
        config=config,
    )

    t0 = time.time()
    if Xtest:
        fsk.compute_kernel(Xtrain, Xtest, Ytrain, Ytest)
    else:
        fsk.compute_train(Xtrain, Ytrain)
    kernel_time = time.time() - t0
    if not args.quiet:
        print(f"kernel computed in {kernel_time:.2f} s "
              f"(n={fsk.n_str_train}+{fsk.n_str_test}, iters={fsk.iterations}, "
              f"device={device})",
              file=sys.stderr)

    if args.save_kernel:
        fsk.save_kernel(args.save_kernel)

    results = {"kernel_time_s": round(kernel_time, 3)}
    if not args.no_svm and Xtest and Ytest is not None:
        t0 = time.time()
        fsk.fit(C=args.C, nu=args.nu, kernel_type=args.kernel_type,
                svm_type=args.svm_type)
        results["svm_time_s"] = round(time.time() - t0, 3)
        if args.svm_type in ("epsilon_svr", "nu_svr"):
            results["r2"] = round(fsk.score("r2"), 6)
        else:
            import numpy as np

            binary = len(np.unique(np.asarray(Ytrain))) == 2
            if args.metric in ("auc", "both") and binary and args.svm_type != "one_class":
                results["auc"] = round(fsk.score("auc"), 6)
            if args.metric in ("accuracy", "both"):
                results["accuracy"] = round(fsk.score("accuracy"), 4)
        if args.save_model:
            from .svm.kernel_svm import save_svm_model

            save_svm_model(args.save_model, fsk._model,
                           fmt=args.model_format, svm_type=args.svm_type)
        if args.save_predictions:
            fsk.save_predictions(args.save_predictions)

    if args.json:
        print(json.dumps(results))
    elif not args.quiet:
        for k, v in results.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
