"""The deep-learning baselines' AUC across seeds, on one pos/neg split.

Trains the CharCNN or the SeqLSTM at the recipe of ``chip_smoke.py``'s
phase 26 (Adam, lr 1e-3, batch 64; the CNN 8 epochs, the LSTM 30) once a
seed, ``--repeat`` times over, and prints one JSON line a run, then a
summary: the first repeat's AUCs, their mean and the seeds under
``--floor``, and the seeds whose repeats differ. ``train_model`` runs
deterministic kernels, so none should; ``--nondeterministic`` trains
without them, to show the run-to-run spread they remove on the card.

    python -m fastsk_tpu_torch.experiments.dl_seeds --model lstm --seeds 20
    python -m fastsk_tpu_torch.experiments.dl_seeds --seeds 1 --repeat 6 --nondeterministic

``--prefix`` names ``<prefix>.{train,test}.{pos,neg}.fasta`` (KAT2B's by
default).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from ..models.train import train_model

HERE = os.path.dirname(os.path.abspath(__file__))
KAT2B = os.path.join(HERE, "..", "..", "experiments", "results_baselines", "tmp", "KAT2B")
EPOCHS = {"cnn": 8, "lstm": 30}
FLOORS = {"cnn": 0.85, "lstm": 0.80}  # phase 26's


def labeled_fasta(prefix: str, split: str, tmpdir: str) -> str:
    """The split's pos/neg files as one FASTA with >1 / >0 labels."""
    path = os.path.join(tmpdir, f"{split}.fasta")
    with open(path, "w") as out:
        for part, label in (("pos", 1), ("neg", 0)):
            with open(f"{prefix}.{split}.{part}.fasta") as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith(">"):
                        out.write(f">{label}\n{line}\n")
    return path


def run(model: str, seeds: int, repeat: int = 1, epochs: int | None = None,
        floor: float | None = None, prefix: str = KAT2B, device: str = "cuda",
        nondeterministic: bool = False) -> dict:
    epochs = epochs or EPOCHS[model]
    floor = FLOORS[model] if floor is None else floor
    with tempfile.TemporaryDirectory() as tmpdir:
        tr, te = (labeled_fasta(prefix, s, tmpdir) for s in ("train", "test"))
        train = train_model.__wrapped__ if nondeterministic else train_model
        runs = []
        for r in range(repeat):
            for seed in range(seeds):
                res = train(model, tr, te, epochs=epochs, batch_size=64, lr=1e-3, seed=seed,
                            device=device)
                runs.append(dict(seed=seed, repeat=r, auc=res.auc, acc=res.acc,
                                 train_s=res.train_time_s))
                print(json.dumps(runs[-1]), flush=True)
    auc = np.array([[row["auc"] for row in runs if row["repeat"] == r] for r in range(repeat)])
    return dict(model=model, epochs=epochs, seeds=seeds, repeat=repeat, floor=floor,
                deterministic=not nondeterministic,
                auc=auc[0].tolist(), mean_auc=float(auc[0].mean()),
                under_floor=[s for s in range(seeds) if auc[0, s] < floor],
                differing=[s for s in range(seeds) if len(set(auc[:, s])) > 1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(EPOCHS), default="lstm")
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--repeat", type=int, default=1, help="runs a seed")
    ap.add_argument("--epochs", type=int, default=None, help="default: phase 26's")
    ap.add_argument("--floor", type=float, default=None, help="default: phase 26's")
    ap.add_argument("--prefix", default=KAT2B)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nondeterministic", action="store_true",
                    help="train without the deterministic kernels")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.model, args.seeds, args.repeat, args.epochs, args.floor,
                         args.prefix, args.device, args.nondeterministic)))


if __name__ == "__main__":
    main()
