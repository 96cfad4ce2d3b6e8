"""Whole runs of tiny cells on the CPU: the result line, the faults the
comparison must catch, the import check, and the refusal of a machine
without a card."""

import json
import os
import subprocess
import sys

import pytest

from gkmbench import control, faults, harness, run
from gkmbench.tests.tiny import tiny_cell
from gkmbench.trace import reduce_trace

CELLS = ["kat2b.train", "p219.train", "kat2b.approx", "kat2b.grid"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct_and_keeps_the_line(cell, trace):
    c = tiny_cell(cell)
    r = run.run(c, 2**31 + 17, 0.2, bool(trace), device="cpu")
    assert r["correct"], r["checks"]
    assert list(r) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert set(r["checks"]) == set(c.limits)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == {"job_s", "setup_s"}
    json.dumps(r, allow_nan=False)


FAULTS = [
    ("kat2b.train", "solve_unchanged"), ("p219.train", "solve_unchanged"),
    ("kat2b.train", "rho_altered"), ("p219.train", "rho_altered"),
    ("kat2b.approx", "welford_unchanged"),
    ("kat2b.train", "half_windows"), ("p219.train", "half_windows"), ("kat2b.approx", "half_windows"),
    ("kat2b.train", "counts_altered"), ("p219.train", "counts_altered"),
    ("kat2b.train", "auc_altered"), ("p219.train", "auc_altered"), ("kat2b.approx", "auc_altered"),
    ("kat2b.approx", "iterations_altered"),
    ("kat2b.train", "platt_sign"), ("p219.train", "platt_sign"), ("kat2b.approx", "platt_sign"),
    ("kat2b.train", "platt_flat"), ("p219.train", "platt_flat"), ("kat2b.approx", "platt_flat"),
    ("kat2b.grid", "solve_unchanged"), ("kat2b.grid", "solve_unchanged_at_C100"),
    ("kat2b.grid", "rho_altered"), ("kat2b.grid", "half_windows"), ("kat2b.grid", "counts_altered"),
    ("kat2b.grid", "auc_altered"), ("kat2b.grid", "platt_sign"), ("kat2b.grid", "platt_flat"),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    c = tiny_cell(cell)
    faults.FAULTS[fault](monkeypatch.setattr)
    r = run.run(c, 23, 0.2, False, device="cpu")
    assert not r["correct"], r["checks"]


def test_a_fault_at_one_C_fails_that_Cs_numbers_only(monkeypatch):
    faults.FAULTS["solve_unchanged_at_C100"](monkeypatch.setattr)
    r = run.run(tiny_cell("kat2b.grid"), 29, 0.2, False, device="cpu")
    over = {n for n, c in r["checks"].items() if c["value"] is None or c["value"] > c["limit"]}
    assert not r["correct"] and over and all(n.endswith("_C100") for n in over), r["checks"]
    assert run.run(tiny_cell("kat2b.train"), 29, 0.2, False, device="cpu")["correct"]


SINGLE_FIT = {
    "kat2b.train": {"counts", "svm_gap", "rho", "proba", "platt", "auc"},
    "p219.train": {"counts", "svm_gap", "rho", "proba", "platt", "auc"},
    "kat2b.approx": {"counts", "svm_gap", "rho", "proba", "platt", "auc", "stop", "sd_trace"},
}


@pytest.mark.parametrize("cell", sorted(SINGLE_FIT))
def test_a_single_fit_cell_keeps_its_plain_names(cell, tmp_path):
    c = tiny_cell(cell)
    data = harness.load_module("loaders", c.config["loader"]).load(c.config, 31, harness.HERE)
    fsk, job = harness.run_job(harness.import_program(), c, data, 31, "cpu", harness.no_span)
    assert [f.C for f in job.fits] == [c.config["C"]]
    last = harness.last_job_outputs(fsk, str(tmp_path))
    numbers = harness.compare(c, data, 31, last, harness.Window(0.0, [job, job], 0, []), "cpu")
    assert set(numbers) == SINGLE_FIT[cell] == harness.check_names(c)


def test_a_sweep_judges_each_fit_at_its_own_C(tmp_path):
    c = tiny_cell("kat2b.grid")
    data = harness.load_module("loaders", c.config["loader"]).load(c.config, 37, harness.HERE)
    fsk, job = harness.run_job(harness.import_program(), c, data, 37, "cpu", harness.no_span)
    assert [f.C for f in job.fits] == [0.001, 0.01, 0.1, 1, 10, 100]
    assert all(f.auc is not None and f.platt is not None for f in job.fits)
    last = harness.last_job_outputs(fsk, str(tmp_path))
    good = harness.compare(c, data, 37, last, harness.Window(0.0, [job], 0, []), "cpu")
    assert set(good) == harness.check_names(c) and harness.passed(harness.checks(good, c.limits))
    # the C = 100 fit's alphas judged at C = 0.001 break the box there
    swap = {0.001: 100.0, 100.0: 0.001}
    fits = sorted((harness.FitOut(swap.get(f.C, f.C), f.alpha_y, f.rho, f.platt, f.auc)
                   for f in job.fits), key=lambda f: f.C)
    swapped = harness.JobOut(fits=fits, digest=job.digest)
    bad = harness.compare(c, data, 37, last, harness.Window(0.0, [swapped], 0, []), "cpu")
    assert bad["svm_gap_C0.001"] > c.limits["svm_gap_C0.001"]


STREAM_SEEDS = [1, 2, 2**31 + 5]


@pytest.mark.parametrize("seed", STREAM_SEEDS)
def test_approx_is_correct_on_other_streams(seed):
    c = control.with_stream_seed(tiny_cell("kat2b.approx"))
    r = run.run(c, seed, 0.2, False, device="cpu")
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("seed", STREAM_SEEDS)
def test_approx_stream_seed_ignored_is_not_correct(seed, monkeypatch):
    c = control.with_stream_seed(tiny_cell("kat2b.approx"))
    faults.FAULTS["stream_seed_ignored"](monkeypatch.setattr)
    r = run.run(c, seed, 0.2, False, device="cpu")
    assert not r["correct"], r["checks"]


LOAD_PATH = """
import json, sys
sys.path.insert(0, {root!r})
from gkmbench import harness, control, reference, trace, run_view
from gkmbench.tests.tiny import tiny_cell
for name in {cells!r}:
    c = tiny_cell(name)
    data = harness.load_module("loaders", c.config["loader"]).load(c.config, 3, harness.HERE)
    api = harness.import_program()
    harness.run_job(api, c, data, 3, "cpu", harness.no_span)
    reference.allpairs_counts(data.Xtr + data.Xte, c.config["g"], c.config["m"], "cpu")
    control.control_outputs(c, data, 3, "cpu")
print(json.dumps(harness.forbidden_modules()))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
from gkmbench import reference, yardstick, trace, data_types
from gkmbench.loaders import fasta_split, ragged_fixed
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0].startswith("fastsk"))))
"""


def _python(code):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code.format(root=harness.ROOT, cells=CELLS)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_load_path_imports_neither_jax_nor_the_jax_package():
    assert _python(LOAD_PATH) == []


def test_reference_imports_nothing_of_the_program():
    assert _python(REFERENCE_ONLY) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastsk_tpu_torch_extra", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "jaxlib", raising=False)
    monkeypatch.delitem(sys.modules, "flax", raising=False)
    monkeypatch.delitem(sys.modules, "fastsk_tpu", raising=False)
    for m in [m for m in sys.modules if m.startswith(("fastsk_tpu.", "jax.", "jaxlib.", "flax."))]:
        monkeypatch.delitem(sys.modules, m)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_measurement_refuses_a_machine_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "gkmbench/run.py", "--workload", "kat2b.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=harness.ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_trace_reduction(tmp_path):
    ev = [
        {"cat": "user_annotation", "name": "gkmbench:window", "ts": 0, "dur": 100, "tid": 1},
        {"cat": "user_annotation", "name": "gkmbench:0:compute_kernel", "ts": 0, "dur": 40, "tid": 1},
        {"cat": "user_annotation", "name": "gkmbench:0:fit", "ts": 40, "dur": 50, "tid": 1},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 1, "dur": 20, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1, "tid": 1},
        {"cat": "cpu_op", "name": "aten::sort", "ts": 60, "dur": 20, "tid": 1},
        {"cat": "kernel", "name": "gemm", "ts": 10, "dur": 20, "tid": 7},
        {"cat": "kernel", "name": "gemm", "ts": 25, "dur": 10, "tid": 8},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 45, "dur": 5, "tid": 7},
        {"cat": "kernel", "name": "smo", "ts": 95, "dur": 20, "tid": 7},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = reduce_trace(str(path))
    us = 1e-6
    assert t.window_s == pytest.approx(100 * us)
    assert t.busy_s == pytest.approx((25 + 5 + 5) * us)
    assert t.per_job("compute_kernel", t.busy_in) == pytest.approx([25 * us])
    assert t.per_job("fit", lambda a, b: b - a) == pytest.approx([50 * us])
    assert dict(t.device_ops)["gemm"] == pytest.approx(30 * us)  # by name, not merged
    idle = dict(t.idle_gaps)
    # gaps [0, 10] under aten::mm, [35, 45] with no host op (its middle in
    # fit), [50, 95] under aten::sort
    assert idle == pytest.approx({"compute_kernel: aten::mm": 10 * us, "fit: python": 10 * us,
                                  "fit: aten::sort": 45 * us})
