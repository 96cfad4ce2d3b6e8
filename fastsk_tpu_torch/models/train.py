"""Training and evaluation loops for the deep-learning baselines.

Counterpart of ``fastsk_tpu/models/train.py``: read a FASTA pair, one-hot
(CNN) or token (LSTM) encode it with static padded shapes, train with
cross entropy, report accuracy and AUC; multi-seed repeats and train-size
fractions. Everything runs on ``device`` (the card by default).

Randomness: the weights are drawn from an explicit ``torch.Generator``
seeded with ``seed`` (the CNN's dropout from a second one on the device);
the subset for ``train_fraction`` and the batch order keep numpy's
``default_rng(seed)``, as in the JAX package. Training runs under
``torch.use_deterministic_algorithms`` (restored on return), so one seed
gives one result on the card too: ``nn.Embedding``'s CUDA backward
otherwise sums a token's rows in a varying order, and Adam carries those
last-bit differences into a different model (KAT2B's LSTM at seed 0
ended anywhere from AUC 0.62 to 0.87 on an H100).

The three optimizers do what optax's do: ``adam`` is ``torch.optim.Adam``
(eps 1e-8), ``sgd`` is torch's SGD with dampening 0 (``momentum=None``:
plain SGD), and ``adagrad`` is written here, since optax's accumulator
starts at 0.1 with its eps of 1e-7 inside the square root, where
``torch.optim.Adagrad`` starts at 0 and adds eps outside.

At batch size 1 the LSTM runs one optimizer step a sampled sequence, as the
JAX package's scan does (its history also gives each epoch's two halves of
steps, so that one epoch shows whether the loss falls). Its class-weighted loss is normalized by the
weight, as the batched path and the reference's
``F.cross_entropy(weight=...)`` do; the JAX package's B=1 path does not
normalize it (``fastsk_tpu/models/train.py:201``), so there the weight
scales its steps and here it cancels.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.fasta import FastaUtility
from ..kernel.config import resolve_device
from ..metrics import accuracy_score, roc_auc
from .charcnn import CharCNN
from .init import flax_init_
from .lstm import SeqLSTM


def encode_dataset(X, Y, max_len: int, vocab_size: int):
    """Pad/truncate to [N, max_len] int32 plus lengths and labels."""
    n = len(X)
    toks = np.zeros((n, max_len), dtype=np.int32)
    lengths = np.zeros(n, dtype=np.int32)
    for i, seq in enumerate(X):
        s = np.asarray(seq[:max_len], dtype=np.int32)
        toks[i, : len(s)] = s
        lengths[i] = len(s)
    y = np.asarray(Y)
    classes = np.unique(y)
    y01 = np.searchsorted(classes, y).astype(np.int32)
    return toks, lengths, y01, classes


@dataclass
class TrainResult:
    acc: float
    auc: float
    train_time_s: float
    history: List[dict] = field(default_factory=list)


def _batches(rng, n, batch_size):
    order = rng.permutation(n)
    for i in range(0, n, batch_size):
        yield order[i : i + batch_size]


class Adagrad(torch.optim.Optimizer):
    """optax.adagrad: ``s += g**2; p -= lr * g / sqrt(s + eps)``, with
    ``s`` starting at ``initial_accumulator_value``."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial=initial_accumulator_value, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial"])
                s = state["sum"]
                s.add_(p.grad * p.grad)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0)
                p.sub_(group["lr"] * (scale * p.grad))


def make_optimizer(name: str, params, lr: float, momentum: Optional[float] = 0.9):
    """The optimizer ``train_model`` names, as optax defines it."""
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum or 0.0, dampening=0.0)
    if name == "adagrad":
        return Adagrad(params, lr)
    raise ValueError(f"unknown optimizer {name!r}")


@contextlib.contextmanager
def _deterministic():
    """Deterministic kernels where PyTorch has them (a warning where it has
    none), without the mode's NaN fill of every new tensor (a kernel a
    tensor, which nothing here reads unwritten); the caller's settings come
    back on exit."""
    det = torch.utils.deterministic
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(), det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


@_deterministic()
def train_model(
    model_kind: str,  # "cnn" | "lstm"
    train_file: str,
    test_file: str,
    epochs: int = 10,
    batch_size: int = 64,
    lr: float = 1e-3,
    optimizer: str = "adam",
    max_len: Optional[int] = None,
    seed: int = 0,
    train_fraction: float = 1.0,
    embedding_size: Optional[int] = None,
    hidden_size: Optional[int] = None,
    momentum: Optional[float] = 0.9,
    class_weight: Optional[str] = None,
    bidir: bool = False,
    device="cuda",
) -> TrainResult:
    dev = resolve_device(device)
    reader = FastaUtility()
    Xtr, Ytr = reader.read_data(train_file)
    Xte, Yte = reader.read_data(test_file)
    vocab_size = len(reader.vocab) + 1
    if max_len is None:
        max_len = max(len(s) for s in Xtr + Xte)

    if train_fraction < 1.0:
        rng0 = np.random.default_rng(seed)
        keep = rng0.permutation(len(Xtr))[: max(2, int(len(Xtr) * train_fraction))]
        Xtr = [Xtr[i] for i in keep]
        Ytr = [Ytr[i] for i in keep]

    toks_tr, len_tr, y_tr, classes = encode_dataset(Xtr, Ytr, max_len, vocab_size)
    toks_te, len_te, y_te, _ = encode_dataset(Xte, Yte, max_len, vocab_size)
    n_classes = max(2, len(classes))

    gen = torch.Generator().manual_seed(seed)
    if model_kind == "cnn":
        model = CharCNN(n_classes=n_classes)

        def inputs(toks, lengths):
            onehot = F.one_hot((toks.long() - 1).clamp_min(0), vocab_size - 1).float()
            return (onehot * (toks > 0)[..., None],)

        model.init_params(*inputs(torch.from_numpy(toks_tr[:2]), None), gen)
        model.generator = torch.Generator(device=dev).manual_seed(seed)
    elif model_kind == "lstm":
        # size defaults follow the JAX package (64 / 128); the reference's
        # run_rnn.py defaults (-em 32, --hidden 64) go through the arguments
        model = SeqLSTM(
            vocab_size=vocab_size,
            n_classes=n_classes,
            embedding_size=embedding_size or 64,
            hidden_size=hidden_size or 128,
            bidir=bidir,
        )
        flax_init_(model, gen)

        def inputs(toks, lengths):
            return (toks.long(), lengths)
    else:
        raise ValueError(f"unknown model kind {model_kind!r}")
    model.to(dev)

    # the reference's hyper-tune grid spans sgd and adam; run_rnn.py's
    # default LSTM optimizer is PLAIN sgd (no momentum)
    opt = make_optimizer(optimizer, model.parameters(), lr, momentum)

    # class-weighted cross entropy ("balanced" = sklearn's n/(k*n_c) rule)
    if class_weight == "balanced":
        counts = np.bincount(y_tr, minlength=n_classes).astype(np.float64)
        cw = torch.as_tensor(len(y_tr) / (n_classes * np.maximum(counts, 1)),
                             dtype=torch.float32, device=dev)
    elif class_weight is None:
        cw = None
    else:
        raise ValueError(f"unknown class_weight {class_weight!r}")

    toks_d = torch.from_numpy(toks_tr).to(dev)
    y_d = torch.from_numpy(y_tr).long().to(dev)
    len_cpu = torch.from_numpy(len_tr)

    def step(idx: np.ndarray) -> torch.Tensor:
        model.train()
        idx_d = torch.from_numpy(idx).to(dev)
        logits = model(*inputs(toks_d[idx_d], len_cpu[torch.from_numpy(idx)]))
        # mean cross entropy; class-weighted, it is normalized by the weights
        loss = F.cross_entropy(logits, y_d[idx_d], weight=cw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    rng = np.random.default_rng(seed)
    history = []
    t0 = time.time()
    n_tr = len(y_tr)
    if batch_size == 1 and model_kind == "lstm":
        # the reference's LSTM regime: one uniformly sampled sequence per
        # optimizer step (epochs * n_tr steps), plain SGD in run_rnn.py
        idxs = rng.integers(0, n_tr, size=epochs * n_tr)
        losses = torch.stack([step(idxs[s : s + 1]) for s in range(len(idxs))]).cpu().numpy()
        # each epoch's mean loss, and the means of its two halves of steps
        history = []
        for e in range(epochs):
            ep = losses[e * n_tr:(e + 1) * n_tr]
            history.append({"epoch": e, "loss": float(ep.mean()),
                            "loss_first_half": float(ep[: len(ep) // 2].mean()),
                            "loss_second_half": float(ep[len(ep) // 2 :].mean())})
        train_time = _synced(dev, t0)
        return _evaluate(model, inputs, toks_te, len_te, y_te, n_classes, 64, train_time,
                         history, dev)
    for epoch in range(epochs):
        losses = []
        for idx in _batches(rng, n_tr, batch_size):
            if len(idx) < batch_size:
                idx = np.concatenate([idx, idx[: batch_size - len(idx)]])
            losses.append(step(idx))
        history.append({"epoch": epoch, "loss": float(torch.stack(losses).mean())})
    train_time = _synced(dev, t0)
    return _evaluate(model, inputs, toks_te, len_te, y_te, n_classes, batch_size, train_time,
                     history, dev)


def _synced(dev: torch.device, t0: float) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.time() - t0


@torch.no_grad()
def _evaluate(model, inputs, toks_te, len_te, y_te, n_classes, batch_size, train_time,
              history, dev) -> TrainResult:
    model.eval()
    probs = []
    for i in range(0, len(y_te), batch_size):
        sl = slice(i, min(i + batch_size, len(y_te)))
        idx = np.arange(sl.start, sl.stop)
        if len(idx) < batch_size:
            idx = np.concatenate([idx, np.zeros(batch_size - len(idx), dtype=int)])
        logits = model(*inputs(torch.from_numpy(toks_te[idx]).to(dev),
                               torch.from_numpy(len_te[idx])))
        probs.append(torch.softmax(logits, dim=-1)[: sl.stop - sl.start])
    probs = torch.cat(probs).cpu().numpy()
    preds = probs.argmax(axis=1)
    acc = accuracy_score(y_te, preds)
    auc = roc_auc(y_te, probs[:, 1]) if n_classes == 2 else float("nan")
    return TrainResult(acc=acc, auc=auc, train_time_s=train_time, history=history)


def run_repeats(
    model_kind: str,
    train_file: str,
    test_file: str,
    seeds: int = 5,
    train_fractions: Tuple[float, ...] = (1.0,),
    **kwargs,
) -> List[dict]:
    """Multi-seed, multi-train-fraction sweep (``device`` and the other
    arguments go to ``train_model``)."""
    rows = []
    for frac in train_fractions:
        for seed in range(seeds):
            res = train_model(
                model_kind, train_file, test_file,
                seed=seed, train_fraction=frac, **kwargs,
            )
            rows.append(
                {"model": model_kind, "fraction": frac, "seed": seed,
                 "acc": res.acc, "auc": res.auc, "time_s": res.train_time_s}
            )
    return rows
