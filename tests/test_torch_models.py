"""The port's CharCNN / SeqLSTM baselines against the flax models on the CPU.

``fastsk_tpu_torch/models/`` against ``fastsk_tpu/models/``: logits in
eval mode from the flax weights carried over by ``from_flax_params``
(CharCNN; SeqLSTM with masking, stacked, and one-layer ``bidir``); the
initial weights' spread against flax's; one training step per optimizer
(adam, sgd with and without momentum, adagrad) with the dropouts at 0 on
the same batch, against optax; ``train_model`` (under deterministic
kernels, the caller's setting restored) and ``run_repeats`` on
``tests/test_models.py``'s small pair, and ``experiments/dl_seeds.py``'s
command line; and the two reference bugs the port
does not copy (``bidir`` with two layers raises; the batch-size-1 LSTM's
class weight is normalized, so it cancels).

Tolerances: logits within 1e-4; an optimizer step's loss and updated
weights within 1e-5; the initial weights' standard deviations within 10%
of flax's (the same distributions, not the same draws).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fastsk_tpu.models import CharCNN as JCharCNN
from fastsk_tpu.models import SeqLSTM as JSeqLSTM
from fastsk_tpu_torch.models import CharCNN, SeqLSTM
from fastsk_tpu_torch.models import train as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _onehot(rng, b, length, a=4):
    return np.eye(a, dtype=np.float32)[rng.integers(0, a, size=(b, length))]


def _carried_cnn(params, sample, **kw):
    model = CharCNN(**kw)
    model.init_params(torch.from_numpy(sample), torch.Generator().manual_seed(0))
    model.load_state_dict(model.from_flax_params(_np_tree(params)))
    return model.eval()


@pytest.mark.parametrize("length,alphabet", [(60, 4), (200, 4), (80, 21)])
def test_charcnn_logits_match_flax(rng, length, alphabet):
    x = _onehot(rng, 3, length, alphabet)
    jm = JCharCNN()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = _carried_cnn(params, x)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _tokens(rng, lengths, width=12, vocab=6):
    toks = rng.integers(1, vocab - 1, size=(len(lengths), width)).astype(np.int32)
    for i, n in enumerate(lengths):
        toks[i, n:] = 0
    return toks, np.asarray(lengths, dtype=np.int32)


def _carried_lstm(params, **kw):
    model = SeqLSTM(**kw)
    model.load_state_dict(model.from_flax_params(_np_tree(params)))
    return model.eval()


@pytest.mark.parametrize("n_layers,bidir", [(1, False), (2, False), (1, True)])
def test_lstm_logits_match_flax(rng, n_layers, bidir):
    kw = dict(vocab_size=6, hidden_size=16, embedding_size=8, n_layers=n_layers, bidir=bidir)
    toks, lengths = _tokens(rng, [12, 5, 8, 1, 11])
    jm = JSeqLSTM(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(toks), jnp.asarray(lengths))
    want = np.asarray(jm.apply(params, jnp.asarray(toks), jnp.asarray(lengths)))
    model = _carried_lstm(params, **kw)
    got = model(torch.from_numpy(toks).long(), torch.from_numpy(lengths)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # masking: tokens past a row's length change nothing
    toks2 = toks.copy()
    toks2[1, 5:] = 3
    got2 = model(torch.from_numpy(toks2).long(), torch.from_numpy(lengths)).detach().numpy()
    np.testing.assert_allclose(got2[1], got[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("bidir", [False, True])
def test_lstm_full_rows_match_flax(rng, bidir):
    """A batch whose rows all fill the width skips the packing."""
    kw = dict(vocab_size=6, hidden_size=16, embedding_size=8, bidir=bidir)
    toks, lengths = _tokens(rng, [12, 12, 12])
    jm = JSeqLSTM(**kw)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(toks), jnp.asarray(lengths))
    want = np.asarray(jm.apply(params, jnp.asarray(toks), jnp.asarray(lengths)))
    got = _carried_lstm(params, **kw)(torch.from_numpy(toks).long(), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)


def test_lstm_empty_row_keeps_a_zero_state(rng):
    """A row of length 0 (an empty sequence) takes the zero carry, so its
    logits are the head's bias. flax 0.12's RNN picks carry index
    ``length - 1`` there, which wraps to the last step (an expected
    difference, ROADMAP.md)."""
    kw = dict(vocab_size=6, hidden_size=16, embedding_size=8)
    toks, lengths = _tokens(rng, [7, 0, 12])
    model = SeqLSTM(**kw)
    with torch.no_grad():
        model.dense.bias.copy_(torch.tensor([0.25, -0.5]))
    got = model(torch.from_numpy(toks).long(), torch.from_numpy(lengths)).detach().numpy()
    np.testing.assert_array_equal(got[1], np.float32([0.25, -0.5]))
    assert np.abs(got[[0, 2]] - got[1]).max() > 1e-3


def test_bidir_with_two_layers_raises():
    with pytest.raises(ValueError, match="bidir"):
        SeqLSTM(vocab_size=6, n_layers=2, bidir=True)


@pytest.mark.parametrize("kind", ["cnn", "lstm"])
def test_initial_weights_spread_like_flax(kind):
    """Each parameter's standard deviation within 10% of flax's at real
    widths (biases zero in both)."""
    if kind == "cnn":
        x = np.zeros((2, 200, 4), np.float32)
        jp = _np_tree(JCharCNN().init(jax.random.PRNGKey(1), jnp.asarray(x)))
        model = CharCNN()
        model.init_params(torch.from_numpy(x), torch.Generator().manual_seed(1))
    else:
        toks = np.ones((2, 10), np.int32)
        jm = JSeqLSTM(vocab_size=300, embedding_size=64, hidden_size=128)
        jp = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(toks), jnp.asarray([10, 10])))
        model = SeqLSTM(vocab_size=300, embedding_size=64, hidden_size=128)
        tt.flax_init_(model, torch.Generator().manual_seed(1))
    want = model.from_flax_params(jp)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        if float(w.std()) == 0.0:
            assert float(got[name].abs().max()) == 0.0, name
        else:
            assert abs(float(got[name].std()) / float(w.std()) - 1) < 0.1, name


OPTIMIZERS = {
    "adam": (lambda: optax.adam(1e-3), dict(name="adam", lr=1e-3)),
    "sgd_momentum": (lambda: optax.sgd(0.05, momentum=0.9), dict(name="sgd", lr=0.05, momentum=0.9)),
    "sgd": (lambda: optax.sgd(0.05, momentum=None), dict(name="sgd", lr=0.05, momentum=None)),
    "adagrad": (lambda: optax.adagrad(0.05), dict(name="adagrad", lr=0.05)),
}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_optimizer_steps_match_optax(rng, opt):
    """Two steps on the same batch (the second reads the optimizer's
    state): each loss, then the weights, within 1e-5."""
    x = _onehot(rng, 8, 60)
    y = rng.integers(0, 2, size=8)
    jm = JCharCNN(channels=16, dropout_input=0.0, dropout_fc=0.0)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    model = _carried_cnn(params, x, channels=16, dropout_input=0.0, dropout_fc=0.0).train()
    make_tx, kw = OPTIMIZERS[opt]
    tx = make_tx()
    state = tx.init(params)

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    optimizer = tt.make_optimizer(kw.pop("name"), model.parameters(), **kw)
    for _ in range(2):
        want_loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        loss = torch.nn.functional.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y))
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        assert abs(loss.item() - float(want_loss)) < 1e-5
    want = model.from_flax_params(_np_tree(params))
    for name, w in model.state_dict().items():
        np.testing.assert_allclose(w.numpy(), want[name].numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_adagrad_starts_its_sum_at_one_tenth():
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0, 0.0]))
    opt = tt.Adagrad([p], lr=0.5)
    p.grad = torch.tensor([0.3, -0.1, 0.0])
    opt.step()
    want = np.float32([1.0, -2.0, 0.0]) - 0.5 * np.float32([0.3, -0.1, 0.0]) / np.sqrt(
        np.float32([0.09, 0.01, 0.0]) + 0.1 + 1e-7)
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6)


# ------------------------------------------------------------ training


@pytest.fixture
def fasta_pair(tmp_path, rng):
    from test_cli_persistence import _write_fasta
    from test_integration import make_synthetic_motif_data

    Xtr, Ytr = make_synthetic_motif_data(rng, 40, 60)
    Xte, Yte = make_synthetic_motif_data(rng, 15, 60)
    tr, te = tmp_path / "tr.fasta", tmp_path / "te.fasta"
    _write_fasta(tr, Xtr, Ytr)
    _write_fasta(te, Xte, Yte)
    return str(tr), str(te)


def test_charcnn_learns_motifs(fasta_pair):
    res = tt.train_model("cnn", *fasta_pair, epochs=12, batch_size=16, seed=0, device="cpu")
    assert res.auc > 0.8
    assert res.history[-1]["loss"] < res.history[0]["loss"]
    assert len(res.history) == 12 and res.train_time_s > 0


def test_lstm_learns(fasta_pair):
    res = tt.train_model("lstm", *fasta_pair, epochs=15, batch_size=16, seed=0, device="cpu")
    assert res.history[-1]["loss"] < res.history[0]["loss"]


def test_training_is_seeded(fasta_pair):
    a = tt.train_model("cnn", *fasta_pair, epochs=2, batch_size=16, seed=3, device="cpu")
    b = tt.train_model("cnn", *fasta_pair, epochs=2, batch_size=16, seed=3, device="cpu")
    assert a.history == b.history and a.auc == b.auc


def test_training_runs_deterministic_kernels(fasta_pair, monkeypatch):
    seen = []
    cross_entropy = tt.F.cross_entropy

    def spy(*args, **kwargs):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return cross_entropy(*args, **kwargs)

    monkeypatch.setattr(tt.F, "cross_entropy", spy)
    assert not torch.are_deterministic_algorithms_enabled()
    tt.train_model("lstm", *fasta_pair, epochs=1, batch_size=16, seed=0, device="cpu")
    assert seen and all(seen)
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("flags", [[], ["--nondeterministic"]])
def test_dl_seeds_cli_runs_on_cpu(tmp_path, rng, flags):
    from test_cli_persistence import _write_fasta
    from test_integration import make_synthetic_motif_data

    for split, n in (("train", 20), ("test", 8)):
        X, Y = make_synthetic_motif_data(rng, n, 40)
        for part, label in (("pos", 1), ("neg", 0)):
            _write_fasta(tmp_path / f"k.{split}.{part}.fasta",
                         [x for x, y in zip(X, Y) if y == label], [label] * n)
    out = subprocess.run(
        [sys.executable, "-m", "fastsk_tpu_torch.experiments.dl_seeds", "--device", "cpu",
         "--model", "lstm", "--seeds", "2", "--repeat", "2", "--epochs", "1",
         "--prefix", str(tmp_path / "k"), *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    res = lines[-1]
    assert len(lines) == 5 and [r["seed"] for r in lines[:4]] == [0, 1, 0, 1]
    assert res["floor"] == 0.80 and len(res["auc"]) == 2 and res["deterministic"] == (not flags)
    assert res["differing"] == []  # the CPU's kernels repeat either way
    assert res["mean_auc"] == pytest.approx(np.mean(res["auc"]))
    assert res["under_floor"] == [s for s in (0, 1) if res["auc"][s] < 0.80]


def test_run_repeats_fractions(fasta_pair):
    rows = tt.run_repeats("cnn", *fasta_pair, seeds=2, train_fractions=(0.5, 1.0), epochs=2,
                          batch_size=16, device="cpu")
    assert len(rows) == 4
    assert {r["fraction"] for r in rows} == {0.5, 1.0}
    assert {r["seed"] for r in rows} == {0, 1}


def test_batch_size_one_normalizes_the_class_weight(fasta_pair):
    """At B=1 the balanced weight divides out of the loss (the batched
    path's and the reference's normalization), so the run equals the
    unweighted one step for step; its plain-SGD loss falls."""
    kw = dict(epochs=2, batch_size=1, optimizer="sgd", momentum=None, lr=0.05,
              train_fraction=0.5, hidden_size=16, embedding_size=8, device="cpu")
    weighted = tt.train_model("lstm", *fasta_pair, class_weight="balanced", **kw)
    plain = tt.train_model("lstm", *fasta_pair, **kw)
    assert weighted.history == plain.history and weighted.auc == plain.auc
    assert plain.history[-1]["loss"] < plain.history[0]["loss"]
    first = plain.history[0]
    assert first["loss_second_half"] < first["loss_first_half"]


def test_encode_dataset_matches_jax():
    from fastsk_tpu.models import train as jt

    X = [[1, 2, 3], [], [4, 4, 4, 4, 4, 4]]
    Y = [1, 0, 1]
    for got, want in zip(tt.encode_dataset(X, Y, 5, 6), jt.encode_dataset(X, Y, 5, 6)):
        np.testing.assert_array_equal(got, want)
