"""The cell ``p219.approx`` (approx jobs on protein 2.19's shape, the
sorted theta engine) cut down for the CPU: whole runs, the faults the
comparison must catch, the control at the cell's size on the card, and
the readers of the sorted engine's counters."""

import copy
from collections import Counter

import pytest
import torch

from gkmbench import control, faults, harness, program_counters, run
from gkmbench.harness import JobOut, Window
from gkmbench.run_view import RunView
from gkmbench.tests.test_gkmbench_program_counters import BASE, SPANS, _view

CELL = "p219.approx"
READERS = ["sorted.pass_ms", "sorted.slabs"]


def tiny_approx_cell() -> harness.Cell:
    """``p219.approx`` on 30 sequences of 16-60 letters. g 8 and m 4 stay:
    24 letters at k = 4 are what make ``FastSK`` take the sorted engine
    (``gkmbench/tests/tiny.py`` has no cut for p219_g8m4_approx; its cut of
    p219_g8m4 to g 5, m 2 is what the dense engine takes)."""
    cell = copy.deepcopy(harness.load_cell(CELL))
    cell.config["data"].update({"n": 30, "lmin": 16, "lmax": 60})
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_is_correct_through_the_sorted_engine(trace):
    from fastsk_tpu_torch.utils import observe

    observe.reset_counters()  # as in a fresh process
    c = tiny_approx_cell()
    r = run.run(c, 2**31 + 17, 0.2, bool(trace), device="cpu")
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(c.limits) == harness.check_names(c)
    assert observe.counters()["sorted.passes"] > 0  # the sorted engine ran, not the dense one
    m = {k: v["value"] for k, v in r["metrics"].items()}
    if not trace:
        assert set(m) == {"job_s", "setup_s"}
        return
    assert set(m) <= {x["name"] for x in c.per_layer}
    assert m["sorted.slabs"] > 0 and m["svm.iters"] > 0 and m["encode.host_s"] > 0
    # no device on the CPU: the device-trace readers find nothing
    assert "sorted.pass_ms" not in m and "svm.device_s" not in m


def test_the_cell_lists_exactly_its_metrics():
    c = harness.load_cell(CELL)
    assert {m["name"] for m in c.end_to_end} == {"job_s", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "api.kernel_s", "api.fit_s", "engine.host_s", "svm.device_s", "device.idle_pct",
        "encode.host_s", "engine.stage_s", "svm.iters", "sorted.pass_ms", "sorted.slabs"}


FAULTS = ["solve_unchanged", "rho_altered", "welford_unchanged", "half_windows",
          "counts_altered", "auc_altered", "platt_sign", "platt_flat"]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = run.run(tiny_approx_cell(), 23, 0.2, False, device="cpu")
    assert not r["correct"], r["checks"]


def test_sorted_iterations_altered_is_not_correct(monkeypatch):
    """faults.py's ``iterations_altered`` plants in the dense engine; the
    same fault in the sorted engine fails the stop rule."""
    from fastsk_tpu_torch.kernel.sorted_engine import SortedGkmEngine

    real = SortedGkmEngine.approx

    def approx(self, **kw):
        r = real(self, **kw)
        r.iters += 1
        return r

    monkeypatch.setattr(SortedGkmEngine, "approx", approx)
    r = run.run(tiny_approx_cell(), 23, 0.2, False, device="cpu")
    assert not r["correct"] and r["checks"]["stop"]["value"] >= 1, r["checks"]


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_approx_is_correct_on_other_streams(seed):
    r = run.run(control.with_stream_seed(tiny_approx_cell()), seed, 0.2, False, device="cpu")
    assert r["correct"], r["checks"]


@pytest.mark.cuda
def test_control_is_not_correct_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")
    c = harness.load_cell(CELL)
    seed = 2**31 + 101
    data = harness.load_module("loaders", c.config["loader"]).load(c.config, seed, harness.HERE)
    last, job = control.control_outputs(c, data, seed, "cuda")
    numbers = harness.compare(c, data, seed, last, Window(0.0, [job], 0, []), "cuda")
    assert not harness.passed(harness.checks(numbers, c.limits)), numbers


def _run(trace, jobs=3):
    cell = tiny_approx_cell()
    data = harness.load_module("loaders", cell.config["loader"]).load(cell.config, 5, harness.HERE)
    window = Window(seconds=1e-4, jobs=[JobOut(iterations=4) for _ in range(jobs)],
                    failed=0, errors=[])
    return RunView(cell=cell, data=data, setup_s=1.0, window=window, trace=trace)


def test_readers_of_the_sorted_engine_s_counters(tmp_path, monkeypatch):
    trace = _view(tmp_path, BASE + SPANS, "spans.json")
    c = Counter({"sorted.passes": 40, "sorted.slabs": 5600})
    monkeypatch.setattr(program_counters, "read", lambda: c)
    rv = _run(trace)
    got = {m: harness.load_module("metrics", m).read(rv) for m in READERS}
    assert got == pytest.approx({
        # compute_kernel's 25 us of device time a job over 10 passes a
        # job (40 over the window's 3 jobs and the warm one)
        "sorted.pass_ms": 1e3 * 25e-6 / 10,
        "sorted.slabs": 140.0,
    })
    assert all(harness.load_module("metrics", m).read(_run(None)) is None for m in READERS)
    # a port that counts no pass (the packed or dense engines, or a port
    # without the counters) gives nothing
    for counted in (Counter({"smo.iterations": 10}), None):
        monkeypatch.setattr(program_counters, "read", lambda: counted)
        assert all(harness.load_module("metrics", m).read(rv) is None for m in READERS)
