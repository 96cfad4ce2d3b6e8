"""The readers of the port's own spans and counters
(``gkmbench/program_counters.py``): on a hand-built run, on a tiny traced
run on the CPU, and the trace's reduction with the port's spans in it."""

import json
from collections import Counter

import pytest

from gkmbench import harness, program_counters, run
from gkmbench.harness import JobOut, Window
from gkmbench.run_view import RunView
from gkmbench.tests.tiny import tiny_cell
from gkmbench.trace import reduce_trace

CELLS = ["kat2b.train", "p219.train", "kat2b.approx", "kat2b.grid"]
NEW = ["encode.host_s", "engine.stage_s", "svm.iter_us", "svm.iters"]
OLD = ["api.kernel_s", "api.fit_s", "engine.host_s", "count_roofline", "theta.ms",
       "svm.device_s", "device.idle_pct", "job_mfu"]
B = "smo_cluster_kernel(float const*, float const*)"

BASE = [
    {"cat": "user_annotation", "name": "gkmbench:window", "ts": 0, "dur": 100, "tid": 1},
    {"cat": "user_annotation", "name": "gkmbench:0:compute_kernel", "ts": 0, "dur": 40, "tid": 1},
    {"cat": "user_annotation", "name": "gkmbench:0:fit", "ts": 40, "dur": 50, "tid": 1},
    {"cat": "cpu_op", "name": "aten::mm", "ts": 1, "dur": 20, "tid": 1},
    {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1, "tid": 1,
     "args": {"correlation": 7}},
    {"cat": "cpu_op", "name": "aten::sort", "ts": 60, "dur": 20, "tid": 1},
    {"cat": "kernel", "name": "gemm", "ts": 10, "dur": 20, "tid": 7, "args": {"correlation": 7}},
    {"cat": "kernel", "name": "gemm", "ts": 25, "dur": 10, "tid": 8},
    {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 45, "dur": 5, "tid": 7},
    {"cat": "kernel", "name": B, "ts": 95, "dur": 20, "tid": 7, "args": {"correlation": 9}},
]
# the port's spans around the same host work, and kernel B's launch
SPANS = [
    {"cat": "user_annotation", "name": "fastsk:count", "ts": 0.5, "dur": 21, "tid": 1},
    {"cat": "user_annotation", "name": "fastsk:fit.gram", "ts": 40, "dur": 4, "tid": 1},
    {"cat": "user_annotation", "name": "fastsk:smo.solve", "ts": 55, "dur": 39, "tid": 1},
    {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 56, "dur": 1, "tid": 1,
     "args": {"correlation": 9}},
]


def _view(tmp_path, events, name):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return reduce_trace(str(path))


def _run(trace, jobs=3):
    cell = tiny_cell("kat2b.train")
    data = harness.load_module("loaders", cell.config["loader"]).load(cell.config, 5, harness.HERE)
    window = Window(seconds=1e-4, jobs=[JobOut(iterations=0) for _ in range(jobs)],
                    failed=0, errors=[])
    return RunView(cell=cell, data=data, setup_s=1.0, window=window, trace=trace)


def test_the_port_s_spans_leave_the_reduction_as_it_was(tmp_path):
    base = _view(tmp_path, BASE, "base.json")
    more = _view(tmp_path, BASE + SPANS, "spans.json")
    assert (more.window, more.spans, more.busy, more.device_ops) == (
        base.window, base.spans, base.busy, base.device_ops)
    assert sorted(s for _, s in more.idle_gaps) == sorted(s for _, s in base.idle_gaps)
    # only a gap's label moves: [35, 45], its middle in the fit span's first
    # host event, is now named by the port's stage
    assert dict(more.idle_gaps)["fit: fastsk:fit.gram"] == pytest.approx(10e-6)
    assert "fit: python" in dict(base.idle_gaps) and "fit: python" not in dict(more.idle_gaps)
    before, after = _run(base), _run(more)
    for name in OLD:
        reader = harness.load_module("metrics", name).read
        assert reader(after) == reader(before), name


def test_readers_of_the_port_s_counters(tmp_path, monkeypatch):
    trace = _view(tmp_path, BASE + SPANS, "spans.json")
    c = Counter({"encode.span_s": 0.3, "encode.spans": 3, "engine.build.span_s": 0.06,
                 "engine.build.spans": 3, "engine.stage.span_s": 0.03, "engine.stage.spans": 3,
                 "smo.iterations": 4000})
    monkeypatch.setattr(program_counters, "read", lambda: c)
    rv = _run(trace)
    got = {m: harness.load_module("metrics", m).read(rv) for m in NEW}
    assert got == pytest.approx({
        "encode.host_s": 0.1, "engine.stage_s": 0.03,
        "svm.iters": 1000.0,  # 4,000 over the window's 3 jobs and the warm one
        "svm.iter_us": 5 / 3000,  # B's 5 us inside the window over 3,000 iterations
    })
    assert all(harness.load_module("metrics", m).read(_run(None)) is None for m in NEW)
    monkeypatch.setattr(program_counters, "read", lambda: None)  # a port without the registry
    assert all(harness.load_module("metrics", m).read(rv) is None for m in NEW)


def test_the_registry_is_the_port_s():
    from fastsk_tpu_torch.utils import observe

    observe.count("gkmbench.test")
    assert program_counters.read() == observe.counters()


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_traced_run_reports_the_port_s_stages(cell):
    from fastsk_tpu_torch.utils import observe

    observe.reset_counters()  # as in a fresh process
    r = run.run(tiny_cell(cell), 2**31 + 29, 0.2, True, device="cpu")
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["encode.host_s"] > 0 and m["engine.stage_s"] > 0 and m["svm.iters"] > 0
    assert "svm.iter_us" not in m  # no kernel B on the CPU
    assert m["encode.host_s"] + m["engine.stage_s"] < m["api.kernel_s"]
