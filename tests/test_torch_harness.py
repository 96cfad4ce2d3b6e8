"""The port's readers, runners and baseline runners against the JAX package.

``fastsk_tpu_torch/io/readers.py`` and ``harness/`` against
``fastsk_tpu``'s on the same files: the TSV readers, ``FastskRunner``,
``FastskRegressor`` and both ``FastskMulticlassRunner`` routes on the
synthetic FASTA and TSV pairs of ``tests/test_harness.py``;
``time_fastsk`` in-process, killed at a timeout and with a crashing child;
the baseline subprocess runners against stub executables, as
``tests/test_baseline_runners.py`` drives the JAX package's; ``python -m
fastsk_tpu_torch --help``; and every new entry point refusing to run on
the CPU unasked when there is no card.

Tolerances: kernels equal (both packages' exact integer counts,
normalized in f64); probabilities within 1e-4 (the linear SVMs' f32
solves, tests/test_torch_linear.py); accuracies and AUCs equal; r² within
1e-4 with LassoCV's ``alpha_`` equal (tests/test_torch_lasso.py).
"""

import os
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

import fastsk_tpu.harness.baselines as jb
import fastsk_tpu_torch.harness.baselines as tb
from fastsk_tpu.harness import runner as jr
from fastsk_tpu.io import readers as jread
from fastsk_tpu.svm.linear import CalibratedLinearSVC as JCal
from fastsk_tpu_torch.harness import runner as tr
from fastsk_tpu_torch.io import readers as tread
from fastsk_tpu_torch.kernel.config import KernelConfig

CPU = KernelConfig(device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- readers


@pytest.mark.parametrize("kind", ["arabic", "dsl"])
def test_readers_match_jax(tmp_path, kind):
    p = tmp_path / "data.tsv"
    p.write_text(
        "abcdefghijk\tMSA\n"
        "zzzzzzzzzzzz\tCAI\n"
        "shortie\tMSA\n"  # < 10 chars: dropped
        "abcdefghijk\tXXX\n"  # not a kept dialect: dropped by ArabicUtility
        "qrstuvwxyzab\tCAI\n"
    )
    cls = "ArabicUtility" if kind == "arabic" else "DslUtility"
    jx = getattr(jread, cls)()
    tx = getattr(tread, cls)()
    assert tx.read_data(str(p)) == jx.read_data(str(p))
    assert str(tx.vocab) == str(jx.vocab) and len(tx.classes) == len(jx.classes)


def test_arabic_reader_refuses_a_long_label(tmp_path):
    p = tmp_path / "bad.tsv"
    p.write_text("abcdefghijk\tMSAX\n")
    with pytest.raises(ValueError):
        tread.ArabicUtility().read_data(str(p))


# ---------------------------------------------------------------- runners


@pytest.fixture
def syn_pair(tmp_path, rng):
    from test_cli_persistence import _write_fasta
    from test_integration import make_synthetic_motif_data

    Xtr, Ytr = make_synthetic_motif_data(rng, 30, 30)
    Xte, Yte = make_synthetic_motif_data(rng, 12, 30)
    _write_fasta(tmp_path / "syn.train.fasta", Xtr, Ytr)
    _write_fasta(tmp_path / "syn.test.fasta", Xte, Yte)
    return str(tmp_path)


def test_fastsk_runner_matches_jax(syn_pair):
    trun = tr.FastskRunner("syn", data_locations=(syn_pair,))
    jrun = jr.FastskRunner("syn", data_locations=(syn_pair,))
    got = trun.train_and_test(g=6, m=2, C=1.0, config=CPU)
    want = jrun.train_and_test(g=6, m=2, C=1.0)
    assert got == want and got["auc"] > 0.9
    # equal kernels, and the port's fitted model's probabilities against a
    # JAX fit on the same rows
    fsk = trun.compute_kernel(6, 2, config=CPU)
    jfsk = jrun.compute_kernel(6, 2)
    np.testing.assert_array_equal(fsk.kernel, np.asarray(jfsk.kernel))
    ntr = fsk.n_str_train
    xte = fsk.kernel[ntr:, :ntr]
    jcal = JCal(C=1.0, class_weight="balanced").fit(
        np.array(jfsk.get_train_kernel()), jrun.Ytrain)
    np.testing.assert_allclose(
        trun.model_.predict_proba(xte), jcal.predict_proba(np.array(jfsk.get_test_kernel())),
        rtol=0, atol=1e-4)
    assert set(trun.timings_) == {"kernel_s", "fit_s", "score_s"}


def test_fastsk_regressor_matches_jax(tmp_path, rng):
    """tests/test_harness.py::test_fastsk_regressor's set: labels are the
    row sums of the exact kernel."""
    import test_integration as ti
    from fastsk_tpu import FastSK as JFastSK

    X, _ = ti.make_synthetic_motif_data(rng, 40, 26)
    fsk = JFastSK(g=6, m=2)
    fsk.compute_train(X)
    yfull = np.asarray(fsk.kernel).sum(axis=1)
    for name, rows in (("train", slice(0, 60)), ("test", slice(60, None))):
        with open(tmp_path / f"reg.{name}.fasta", "w") as f:
            for seq, label in zip(X[rows], yfull[rows]):
                f.write(f">{label}\n" + "".join("acgt"[v - 1] for v in seq) + "\n")
    treg = tr.FastskRegressor("reg", data_locations=(str(tmp_path),))
    jreg = jr.FastskRegressor("reg", data_locations=(str(tmp_path),))
    got = treg.train_and_test(g=6, m=2, approx=False, config=CPU)
    want = jreg.train_and_test(g=6, m=2, approx=False)
    assert got > 0.8
    assert abs(got - want) < 1e-4
    from fastsk_tpu.svm.lasso import LassoCV as JLassoCV

    jfsk = JFastSK(g=6, m=2)
    jfsk.compute_kernel(jreg.train_seq, jreg.test_seq)
    jcv = JLassoCV(cv=5, random_state=293).fit(np.array(jfsk.get_train_kernel()), jreg.Ytrain)
    assert treg.model_.alpha_ == jcv.alpha_


def _tsv(path, rng, n, motifs):
    labels = sorted(motifs)
    lines = []
    for _ in range(n):
        lab = labels[rng.integers(0, len(labels))]
        s = rng.integers(0, 26, size=30)
        pos = rng.integers(0, 24)
        s[pos : pos + 6] = motifs[lab]
        lines.append("".join(chr(97 + v) for v in s) + "\t" + lab)
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("svm", ["linear_ovr", "kernel_ovo"])
def test_multiclass_runner_matches_jax(tmp_path, rng, svm):
    motifs = {"AAA": [1, 1, 2, 2, 1, 1], "BBB": [3, 3, 4, 4, 3, 3],
              "CCC": [5, 6, 5, 6, 5, 6]}
    tr_file = _tsv(tmp_path / "tr.tsv", rng, 60, motifs)
    te_file = _tsv(tmp_path / "te.tsv", rng, 24, motifs)
    got = tr.FastskMulticlassRunner(tr_file, te_file).train_and_test(
        g=6, m=2, approx=False, svm=svm, config=CPU)
    want = jr.FastskMulticlassRunner(tr_file, te_file).train_and_test(
        g=6, m=2, approx=False, svm=svm)
    assert got == want and got["acc"] > 0.7


def test_multiclass_runner_arabic_reader(tmp_path, rng):
    motifs = {"MSA": [1, 1, 2, 2, 1, 1], "CAI": [3, 3, 4, 4, 3, 3],
              "BEI": [5, 6, 5, 6, 5, 6]}
    tr_file = _tsv(tmp_path / "tr.tsv", rng, 60, motifs)
    te_file = _tsv(tmp_path / "te.tsv", rng, 24, motifs)
    runner = tr.FastskMulticlassRunner(tr_file, te_file, reader=tread.ArabicUtility())
    assert sorted(set(runner.Ytrain)) == [1, 2, 3]
    res = runner.train_and_test(g=6, m=2, approx=False, svm="kernel_ovo", config=CPU)
    assert res["acc"] > 0.7


# ---------------------------------------------------------- time_fastsk


@pytest.fixture
def data_cwd(syn_pair, tmp_path, monkeypatch):
    """A working directory whose data/ holds the syn pair (the runners'
    default data location)."""
    os.makedirs(tmp_path / "data", exist_ok=True)
    for split in ("train", "test"):
        os.replace(os.path.join(syn_pair, f"syn.{split}.fasta"),
                   tmp_path / "data" / f"syn.{split}.fasta")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_time_fastsk_in_process(data_cwd):
    first, steady, timed_out = tr.time_fastsk(
        6, 2, prefix="syn", detail=True, steady_runs=2, config=CPU)
    assert not timed_out and 0 < steady <= first
    assert tr.time_fastsk(6, 2, prefix="syn", config=CPU) > 0


def test_time_fastsk_kills_a_child_at_its_timeout(data_cwd):
    got = tr.time_fastsk(6, 2, prefix="syn", timeout=0.05, detail=True, config=CPU)
    assert got == (0.05, 0.05, True)


def test_time_fastsk_child_crash_raises(data_cwd):
    with pytest.raises(RuntimeError, match="without a result"):
        tr.time_fastsk(6, 2, prefix="absent", timeout=120, config=CPU)


# ---------------------------------------------------------- baselines


def _write_exec(path, body):
    with open(path, "w") as f:
        f.write("#!/bin/bash\n" + body)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


@pytest.fixture
def data_dir(tmp_path, rng):
    d = tmp_path / "data"
    d.mkdir()
    seqs = ["".join("acgt"[c] for c in rng.integers(0, 4, size=30)) for _ in range(24)]
    labels = [1, 0] * 6 + [1] * 6 + [0] * 6
    for name, rows in (("train", slice(0, 16)), ("test", slice(16, None))):
        with open(d / f"toy.{name}.fasta", "w") as f:
            for y, s in zip(labels[rows], seqs[rows]):
                f.write(f">{y}\n{s}\n")
    with open(d / "dna.dictionary.txt", "w") as f:
        f.write("a\nc\ng\nt\n")
    return str(d)


def test_split_pos_neg_matches_jax(data_dir, tmp_path):
    src = os.path.join(data_dir, "toy.train.fasta")
    outs = {}
    for name, mod in (("t", tb), ("j", jb)):
        p, n = str(tmp_path / f"{name}.p"), str(tmp_path / f"{name}.n")
        counts = mod.split_pos_neg(src, p, n)
        outs[name] = (counts, open(p).read(), open(n).read())
    assert outs["t"] == outs["j"] and outs["t"][0] == (10, 6)


def test_gkm_runner_pipeline(data_dir, tmp_path):
    exec_dir = tmp_path / "bin"
    exec_dir.mkdir()
    log = str(tmp_path / "cmds.log")
    _write_exec(exec_dir / "gkmsvm_kernel", f'echo kernel "$@" >> {log}\ntouch "${{@: -1}}"\n')
    _write_exec(exec_dir / "gkmsvm_train",
                f'echo train "$@" >> {log}\ntouch "$4_svalpha.out" "$4_svseq.fa"\n')
    _write_exec(
        exec_dir / "gkmsvm_classify",
        f'echo classify "$@" >> {log}\n'
        'out="${@: -1}"; in="${@: -4:1}"\n'
        'case "$in" in *pos*) s=0.9;; *) s=-0.4;; esac\n'
        'for x in $(grep ">" "$in"); do echo "seq $s" >> "$out"; done\n',
    )
    runner = tb.GkmRunner(str(exec_dir), data_dir, "toy", g=6, k=4, approx=True,
                          outdir=str(tmp_path / "out"))
    runner.ensure_split_data(os.path.join(data_dir, "toy.train.fasta"),
                             os.path.join(data_dir, "toy.test.fasta"))
    assert runner.train_and_test(t=2) == (1.0, 1.0)
    cmds = open(log).read()
    assert "-l 6" in cmds and "-k 4" in cmds and "-d 3" in cmds
    assert "-T 2" in cmds and "-R" in cmds


def test_lsgkm_runner_pipeline(data_dir, tmp_path):
    exec_dir = tmp_path / "bin"
    exec_dir.mkdir()
    log = str(tmp_path / "cmds.log")
    _write_exec(exec_dir / "gkmtrain", f'echo train "$@" >> {log}\ntouch "${{@: -1}}.model.txt"\n')
    _write_exec(
        exec_dir / "gkmpredict",
        f'echo predict "$@" >> {log}\n'
        'out="${@: -1}"; in="${@: -3:1}"\n'
        'case "$in" in *pos*) s=1.5;; *) s=-2.0;; esac\n'
        'for x in $(grep ">" "$in"); do echo "seq $s" >> "$out"; done\n',
    )
    runner = tb.LsgkmRunner(str(exec_dir), data_dir, "toy", g=10, m=3,
                            outdir=str(tmp_path / "out"))
    for split in ("train", "test"):
        tb.split_pos_neg(os.path.join(data_dir, f"toy.{split}.fasta"),
                         getattr(runner, f"{split}_pos_file"),
                         getattr(runner, f"{split}_neg_file"))
    assert runner.train_and_test(t=4) == (1.0, 1.0)
    cmds = open(log).read()
    assert "-t 2" in cmds and "-l 10" in cmds and "-k 7" in cmds
    assert "-d 3" in cmds and "-T 4" in cmds


def test_gakco_runner_matches_jax(data_dir, tmp_path):
    """The stub writes an identity-ish kernel; both packages' calibrated
    linear SVMs score it alike."""
    gakco = tmp_path / "GaKCo"
    _write_exec(
        gakco,
        'data="$5"; out="$8"\n'
        'n=$(grep -c ">" "$data")\n'
        'for i in $(seq 1 $n); do\n'
        '  row=""\n'
        '  for j in $(seq 1 $n); do\n'
        '    if [ $i -eq $j ]; then v=1.0; else v=0.1; fi\n'
        '    row="$row$j:$v "\n'
        '  done\n'
        '  echo "$row" >> "$out"\ndone\n',
    )
    got = tb.GaKCoRunner(str(gakco), data_dir, "dna", "toy", outdir=str(tmp_path / "t")
                         ).train_and_test(g=6, m=2, device="cpu")
    want = jb.GaKCoRunner(str(gakco), data_dir, "dna", "toy", outdir=str(tmp_path / "j")
                          ).train_and_test(g=6, m=2)
    assert got == want


def test_blended_spectrum_matches_jax(data_dir, tmp_path):
    """The JVM's kernel file faked; parsing and scoring as in JAX."""
    java = tmp_path / "java"
    _write_exec(
        java,
        'out="${@: -1}"\n'
        'for i in $(seq 1 24); do row=""; for j in $(seq 1 24); do\n'
        '  if [ $i -eq $j ]; then v=1.0; elif [ $(( (i + j) % 2 )) -eq 0 ]; then v=0.5;'
        ' else v=0.1; fi\n'
        '  row="$row$v "; done; echo "$row" >> "$out"; done\n',
    )
    old = os.environ["PATH"]
    os.environ["PATH"] = f"{tmp_path}:{old}"
    try:
        got = tb.BlendedSpectrumRunner(str(tmp_path), data_dir, "toy",
                                       outdir=str(tmp_path / "t")).train_and_test(device="cpu")
        want = jb.BlendedSpectrumRunner(str(tmp_path), data_dir, "toy",
                                        outdir=str(tmp_path / "j")).train_and_test()
    finally:
        os.environ["PATH"] = old
    assert got == want


def test_missing_binary_raises(data_dir, tmp_path):
    runner = tb.GkmRunner(str(tmp_path / "nowhere"), data_dir, "toy", g=6, k=4,
                          outdir=str(tmp_path / "out"))
    runner.ensure_split_data(os.path.join(data_dir, "toy.train.fasta"),
                             os.path.join(data_dir, "toy.test.fasta"))
    with pytest.raises(tb.BaselineNotInstalled):
        runner.compute_train_kernel()


# ------------------------------------------------------------ entry points


def test_python_m_package_help():
    proc = subprocess.run([sys.executable, "-m", "fastsk_tpu_torch", "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout


def _entry_points(tmp_path):
    """Every new entry point, called with its default device."""
    from fastsk_tpu_torch.models import train as tt
    from fastsk_tpu_torch.svm import lasso, linear

    X = np.random.default_rng(0).normal(size=(12, 3))
    y = np.arange(12) % 2
    fa = tmp_path / "a.fasta"
    fa.write_text("".join(f">{i % 2}\nacgtacgtac\n" for i in range(8)))
    (tmp_path / "t.tsv").write_text("".join(f"abcdefghijkl\t{'ab'[i % 2]}\n" for i in range(6)))
    tsv = str(tmp_path / "t.tsv")
    for split in ("train", "test"):
        (tmp_path / f"p.{split}.fasta").write_text(fa.read_text())
    loc = (str(tmp_path),)
    return {
        "LinearSVC": lambda: linear.LinearSVC().fit(X, y),
        "CalibratedLinearSVC": lambda: linear.CalibratedLinearSVC().fit(X, y),
        "MulticlassLinearSVC": lambda: linear.MulticlassLinearSVC().fit(X, y),
        "train_eval_linear": lambda: linear.train_eval_linear(X, X, y, y),
        "Lasso": lambda: lasso.Lasso().fit(X, y),
        "LassoCV": lambda: lasso.LassoCV().fit(X, y),
        "FastskRunner.compute_kernel":
            lambda: tr.FastskRunner("p", data_locations=loc).compute_kernel(3, 1),
        "FastskRunner.train_and_test":
            lambda: tr.FastskRunner("p", data_locations=loc).train_and_test(3, 1),
        "FastskRegressor": lambda: tr.FastskRegressor("p", data_locations=loc).train_and_test(3, 1),
        "FastskMulticlassRunner":
            lambda: tr.FastskMulticlassRunner(tsv, tsv).train_and_test(3, 1),
        "time_fastsk": lambda: tr.time_fastsk(3, 1, prefix="p"),
        "train_model": lambda: tt.train_model("cnn", str(fa), str(fa), epochs=1),
        "run_repeats": lambda: tt.run_repeats("lstm", str(fa), str(fa), seeds=1, epochs=1),
    }


ENTRY_POINTS = [
    "LinearSVC", "CalibratedLinearSVC", "MulticlassLinearSVC", "train_eval_linear", "Lasso",
    "LassoCV", "FastskRunner.compute_kernel", "FastskRunner.train_and_test",
    "FastskRegressor", "FastskMulticlassRunner", "time_fastsk", "train_model", "run_repeats",
]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_need_a_card_or_device_cpu(tmp_path, monkeypatch, name):
    """With no card, the default device raises and names device='cpu'; no
    entry point falls back to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points(tmp_path)[name]()
