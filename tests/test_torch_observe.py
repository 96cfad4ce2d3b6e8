"""The port's observability and roofline accounting, on the CPU.

``fastsk_tpu_torch/utils/observe.py`` (``Progress``, ``timed``,
``profiler_trace``, the ``profile_dir`` knob on seeded
``compute_kernel`` runs; ``span`` and the counter registry: a shared no-op
without a profiler, each stage of a traced exact and approx job nested
where it belongs, kernel B's iterations counted) and ``utils/roofline.py`` (device classes on
card names, ``mfu``, the bound helpers ``chip_smoke.py`` takes from it,
and kernel A's and kernel D's work against brute-force counts of the
port's tiles on seeded sequences; the JAX test of the same kind reads the
absent reference data dir, this one does not). Also the package-level
checks: the port imports no JAX, and every public name of the JAX files
this slice ports exists in the port unless ROADMAP.md lists it as not
ported.

Counts are exact: work and tile counts equal, kernels with and without a
trace equal.
"""

import ast
import glob
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from fastsk_tpu_torch import FastSK, KernelConfig
from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine, PairsGkmEngine
from fastsk_tpu_torch.ops import pairs_cuda
from fastsk_tpu_torch.ops.encode import encode_sequences
from fastsk_tpu_torch.ops.pairs_cuda import mma_depth, padded_width, tile_sequences
from fastsk_tpu_torch.ops.pairs_packed_cuda import ROW_TILE, code_planes
from fastsk_tpu_torch.utils import roofline
from fastsk_tpu_torch.svm import kernel_svm
from fastsk_tpu_torch.utils import observe
from fastsk_tpu_torch.utils.observe import Progress, profiler_trace, timed

from conftest import random_ragged_seqs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- observe


def test_progress_quiet_gating():
    buf = io.StringIO()
    Progress(quiet=True, stream=buf).log("hidden")
    assert buf.getvalue() == ""
    buf2 = io.StringIO()
    Progress(quiet=False, stream=buf2).log("shown")
    out = buf2.getvalue()
    assert "shown" in out and out.startswith("[fastsk +")


@pytest.mark.parametrize("device", [None, "cpu"])
def test_timed_reports_wall_and_rate(device):
    buf = io.StringIO()
    p = Progress(quiet=False, stream=buf)
    with timed(p, "span", work_items=100, unit="pairs", device=device) as info:
        pass
    assert info["wall_s"] >= 0 and info["rate"] > 0
    assert "pairs/s" in buf.getvalue()
    with timed(p, "plain") as info2:
        pass
    assert "rate" not in info2 and "plain:" in buf.getvalue()


def _traces(path):
    return sorted(glob.glob(os.path.join(path, "*.json")))


def test_profiler_trace_noop_and_file(tmp_path):
    with profiler_trace(None):
        x = 1
    assert x == 1
    with profiler_trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = _traces(tmp_path / "tr")
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("engine", ["pairs", "packed", "theta"])
def test_profile_dir_traces_a_seeded_compute_kernel(tmp_path, rng, capsys, engine):
    """Each exact engine writes a trace under profile_dir, logs through
    Progress when not quiet, and computes the same counts as without."""
    X = random_ragged_seqs(rng, 9, 12, 20, 4)
    plain = FastSK(6, 2, config=KernelConfig(device="cpu", exact_engine=engine))
    plain.compute_kernel(X[:6], X[6:])
    cfg = KernelConfig(device="cpu", exact_engine=engine, profile_dir=str(tmp_path), quiet=False)
    fsk = FastSK(6, 2, config=cfg)
    fsk.compute_kernel(X[:6], X[6:])
    np.testing.assert_array_equal(fsk.kernel_counts, plain.kernel_counts)
    assert len(_traces(tmp_path)) == 1
    err = capsys.readouterr().err
    assert "[fastsk +" in err and "pairs/s" in err


# -------------------------------------------------------- spans, counters


def _traced(fn, path):
    """``fn()`` under a CPU ``torch.profiler``; the trace's annotations on
    the calling thread as (name, start, end), by start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    events = json.load(open(path))["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e]
    tid = next(e["tid"] for e in spans if e["name"].startswith("job:"))
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in spans if e["tid"] == tid), key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """Each span's name with the name of the innermost span around it."""
    out = []
    for i, (name, a, b) in enumerate(spans):
        around = [s for j, s in enumerate(spans) if j != i and s[1] <= a and b <= s[2]]
        inner = min(around, key=lambda s: s[2] - s[1])[0] if around else None
        out.append((name, inner))
    return out


def _job(fsk, X, y, ntr):
    def run():
        with torch.profiler.record_function("job:compute_kernel"):
            fsk.compute_kernel(X[:ntr], X[ntr:], y[:ntr], y[ntr:])
        with torch.profiler.record_function("job:fit"):
            fsk.fit(C=1.0)
        with torch.profiler.record_function("job:score"):
            fsk.score("auc")
    return run


def test_span_without_a_profiler_is_one_shared_noop(rng):
    assert observe.span("encode") is observe.span("count") is observe._OFF
    X = random_ragged_seqs(rng, 16, 12, 20, 4)
    y = np.array([0, 1] * 8)
    before = observe.counters()
    plain = FastSK(5, 2, config=KernelConfig(device="cpu", device_resident=True))
    _job(plain, X, y, 12)()
    assert not [k for k in observe.counters() - before if k.endswith((".span_s", ".spans"))]
    fsk = FastSK(5, 2, config=KernelConfig(device="cpu", device_resident=True))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        _job(fsk, X, y, 12)()
    np.testing.assert_array_equal(fsk.kernel_counts, plain.kernel_counts)
    np.testing.assert_array_equal(fsk.kernel, plain.kernel)
    moved = observe.counters() - before
    assert moved["encode.spans"] == 1 and moved["encode.span_s"] > 0


# the innermost span around each span of a traced exact job (the engines'
# ``timed`` label around their staging and count kernel)
EXACT_PARENTS = {
    "pairs": {
        ("fastsk:encode", "job:compute_kernel"), ("fastsk:engine.build", "job:compute_kernel"),
        ("fastsk:pairs exact kernel", "job:compute_kernel"),
        ("fastsk:engine.stage", "fastsk:pairs exact kernel"),
        ("fastsk:count", "fastsk:pairs exact kernel"),
        ("fastsk:normalize", "job:compute_kernel"),
    },
    "packed": {
        ("fastsk:encode", "job:compute_kernel"), ("fastsk:engine.build", "job:compute_kernel"),
        ("fastsk:packed pairs kernel", "job:compute_kernel"),
        ("fastsk:engine.stage", "fastsk:packed pairs kernel"),
        ("fastsk:count", "fastsk:packed pairs kernel"),
        ("fastsk:engine.unsort", "fastsk:packed pairs kernel"),
        ("fastsk:engine.unsort", "job:compute_kernel"),
        ("fastsk:normalize", "job:compute_kernel"),
    },
}
FIT_SCORE_PARENTS = {
    ("fastsk:fit.gram", "job:fit"), ("fastsk:fit.solve", "job:fit"),
    ("fastsk:fit.platt", "job:fit"), ("fastsk:smo.solve", "fastsk:fit.solve"),
    ("fastsk:smo.solve", "fastsk:fit.platt"),
    ("fastsk:score.gram", "job:score"), ("fastsk:score.predict", "job:score"),
}


@pytest.mark.parametrize("engine", ["pairs", "packed"])
def test_a_traced_exact_job_names_each_stage_where_it_runs(tmp_path, rng, engine):
    X = random_ragged_seqs(rng, 20, 14, 20 if engine == "pairs" else 60, 4)
    y = np.array([0, 1] * 10)
    cfg = KernelConfig(device="cpu", device_resident=True, exact_engine=engine)
    spans = _traced(_job(FastSK(5, 2, config=cfg), X, y, 15), tmp_path / "t.json")
    got = {p for p in _parents(spans) if p[0].startswith("fastsk:")}
    assert got == EXACT_PARENTS[engine] | FIT_SCORE_PARENTS


def test_a_traced_approx_job_names_its_batches_and_pulls(tmp_path, rng):
    X = random_ragged_seqs(rng, 16, 14, 20, 4)
    y = np.array([0, 1] * 8)
    fsk = FastSK(6, 3, approx=True, max_iters=6, seed=3,
                 config=KernelConfig(device="cpu", device_resident=True, theta_batch=2))
    spans = _traced(_job(fsk, X, y, 12), tmp_path / "t.json")
    parents = _parents(spans)
    compute = {p for p in parents if p[1] == "job:compute_kernel"}
    assert compute == {("fastsk:encode", "job:compute_kernel"),
                       ("fastsk:engine.build", "job:compute_kernel"),
                       ("fastsk:theta.batch", "job:compute_kernel"),
                       ("fastsk:theta.pull", "job:compute_kernel"),
                       ("fastsk:normalize", "job:compute_kernel")}
    batches = [p for p in parents if p[0] == "fastsk:theta.batch"]
    assert len(batches) == len([p for p in parents if p[0] == "fastsk:theta.pull"]) == 3
    assert {p for p in parents if p[0].startswith("fastsk:") and p not in compute} == FIT_SCORE_PARENTS


def test_smo_iterations_are_the_main_solve_and_the_longest_fold(rng, monkeypatch):
    n = 60
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.where(X[:, 0] + 0.5 * rng.normal(size=n) > 0, 1, 0)
    gram = torch.as_tensor(X @ X.T)
    folds, real = [], kernel_svm.smo_solve

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        if args[2].dim() == 2:
            folds.append(out[2])
        return out

    monkeypatch.setattr(kernel_svm, "smo_solve", spy)
    before = observe.counters()
    model = kernel_svm.KernelSVC(C=1.0, probability=True).fit(gram, y)
    moved = observe.counters() - before
    assert len(folds) == 1 and len(folds[0]) == 5
    assert moved["smo.iterations"] == model.iters_ + max(folds[0]) > model.iters_ > 0


# ------------------------------------------------------------ roofline


def test_classify_device_and_mfu():
    assert roofline.classify_device("NVIDIA H100 80GB HBM3") == "h100"
    assert roofline.classify_device("NVIDIA H100 PCIe") == "h100"
    assert roofline.classify_device("NVIDIA A100-SXM4-80GB") is None
    assert roofline.classify_device(torch.device("cpu")) is None
    assert roofline.classify_device("cpu") is None
    h100 = "NVIDIA H100 80GB HBM3"
    assert roofline.device_peak_flops(h100, "int8") == 1979e12
    assert roofline.device_hbm_bw(h100) == 3.35e12
    assert abs(roofline.mfu(989e12, 1.0, h100, "bf16") - 1.0) < 1e-12
    assert roofline.mfu(1e12, 1.0, "cpu") is None
    line = roofline.format_mfu_line("x", 989e12, 2.0, h100, "bf16")
    assert "50.0%" in line and "h100" in line
    assert "unknown device peak" in roofline.format_mfu_line("x", 1e9, 1.0, "cpu", "bf16")


def test_bounds_are_the_smoke_record_s():
    """chip_smoke.py takes its peaks and bounds from the package, and they
    keep the values the kernel record used before the move."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.count_bound is roofline.count_bound and smoke.smo_bound is roofline.smo_bound
    assert smoke.bound is roofline.bound
    b = roofline.count_bound(1000, 40, 1e3)
    assert b["bound_ms"] == 2.0 * 40 * 1000 * 1001 / 2 / 1979e12 * 1e3
    assert b["bound_by"] == "operations"
    s = roofline.smo_bound(100, 10)
    assert s == {"bound_ms": (4.0 * 100 * 100 + 2000.0) / 3.35e12 * 1e3, "bound_by": "bytes"}


def _mma_tile_rule(n_pad, p_pad, depth):
    """The resident layout's tile side: rows padded to 32 bytes, sequences
    to 16 windows, the tile's paired j rows (two windows a row) in 128-row
    chunks beside a ring of three, the pair table at g = 20 and two sets of
    bins in one block's 227 KB, at most 2,048 windows a tile of several
    sequences; else one sequence beside a ring of two; 0 where one
    sequence's windows do not fit (``pairs_cuda.mma_plan`` then streams
    them). These tests' own copy of the rule, held to the table that
    tests/test_torch_cuda.py holds the card to."""
    if n_pad < 1 or p_pad < 8 or depth < 32:
        return 0
    d32, pw = -(-depth // 32) * 32, -(-p_pad // 16) * 16

    def smem(s, stages=3):
        return ((-(-s * pw // 256) + stages) * 128 * d32 + 21 * 21 * 128 + 8 * s * s
                + (2 * stages + 2) * 8)

    for s in (8, 4, 2, 1):
        if n_pad % s == 0 and smem(s) <= 227 * 1024 and (s == 1 or s * pw <= 2048):
            return s
    return 1 if smem(1, 2) <= 227 * 1024 else 0


@pytest.mark.parametrize("n_pad,p_pad,depth,tile", [
    (7024, 200, 64, 8), (7232, 192, 64, 8), (24, 96, 64, 8), (12, 8, 64, 4), (8, 200, 192, 4),
    (8, 200, 256, 2), (8, 200, 320, 1), (8, 200, 384, 1), (8, 200, 512, 0), (8, 904, 320, 0),
])
def test_tile_rule_is_the_library_s(n_pad, p_pad, depth, tile):
    """The same table as tests/test_torch_cuda.py::test_kernel_a_mma_tiling;
    ``mma_plan`` keeps the resident layout exactly where the rule fits."""
    assert _mma_tile_rule(n_pad, p_pad, depth) == tile
    plan = pairs_cuda.mma_plan(n_pad, p_pad, depth, 20)
    assert (plan.layout == "resident") == (tile > 0)
    if tile:
        assert plan.tile == tile and plan.ranges == 1


def _brute_kernel_a(eng, body):
    """Kernel A's int8 MACs, block by block, chunk by chunk, as
    csrc/pairs.cu walks them in ``mma_plan``'s layout (or the dp4a body's
    tiles)."""
    f = eng.g * eng.alpha
    macs = 0
    if body == "mma":
        plan = pairs_cuda.mma_plan(eng.n_pad, eng.p_pad, f, eng.g)
        paired = plan.layout in ("resident", "windows")
        # rows padded to 32 bytes and sequences to 16 windows, j rows paired
        # (resident, windows), or rows padded to 64 bytes (depth, slabs)
        depth = plan.slab if paired else mma_depth(f)
        rows = plan.tile * (pairs_cuda.ws_windows(eng.p_pad) if paired else eng.p_pad)
        nc = -(-rows // 128)
        ncj = -(-rows // 256) if paired else nc
        nt = eng.n_pad // plan.tile
        for bi in range(nt):
            for bj in range(bi, nt):
                for r in range(plan.ranges):
                    j_chunks = min(ncj, (r + 1) * plan.range_chunks) - r * plan.range_chunks
                    for ci in range(nc):
                        for wg in range(2):  # every warpgroup of every i chunk
                            macs += j_chunks * 64 * 128 * depth
        return macs, plan.layout
    width = padded_width(f)
    s = tile_sequences(eng.n_pad, eng.p_pad, width)
    nt = eng.n_pad // s
    for bi in range(nt):
        for bj in range(nt):
            if bj >= bi:  # the lower block triangle returns at once
                macs += (s * eng.p_pad) ** 2 * width
    return macs, None


@pytest.mark.parametrize("n,length,g,m,body", [
    (13, 30, 6, 2, "mma"), (40, 200, 8, 4, "mma"), (9, 57, 10, 6, "mma"), (3, 4010, 8, 4, "dp4a"),
    (3, 4010, 8, 4, "mma"),
])
def test_pairs_engine_flops_counts_kernel_a_s_tiles(n, length, g, m, body):
    rng = np.random.default_rng(n)
    X = rng.integers(1, 5, size=(n, length)).tolist()
    eng = PairsGkmEngine(encode_sequences(X), g, m, KernelConfig(device="cpu"))
    rl = roofline.pairs_engine_flops(eng, body=body)
    macs, layout = _brute_kernel_a(eng, body)
    assert rl["body"] == body and rl["layout"] == layout
    assert layout == {"mma": "resident", "dp4a": None}[body]
    assert rl["flops"] == 2.0 * macs
    windows = n * (length - g + 1)
    useful = sum(2 * g * eng.alpha for a in range(windows) for b in range(a, windows))
    # the resident and windows layouts multiply paired j rows: a product
    # column serves two windows, so they execute at least half the work
    assert rl["useful_flops"] == useful <= rl["flops"] * (2 if body == "mma" else 1)
    assert roofline.count_bound(windows, g * eng.alpha, 1.0)["bound_ms"] == useful / 1979e12 * 1e3
    assert rl["ai"] > 0 and rl["bytes_hbm"] > 0 and rl["dtype"] == "int8"


@pytest.mark.parametrize("n,length,alpha,g,m,layout", [
    (5, 300, 60, 10, 4, "depth"), (12, 120, 100, 8, 4, "depth"), (4, 2507, 21, 8, 4, "windows"),
    (5, 150, 130, 14, 7, "slabs"),
])
def test_pairs_engine_flops_counts_kernel_a_s_stream_layouts(n, length, alpha, g, m, layout):
    """The windows, depth and slabs layouts' blocks (ranges of j chunks;
    the depth and slabs layouts' every warpgroup) against the block walk."""
    X = np.random.default_rng(alpha).integers(1, alpha + 1, size=(n, length))
    X[0, :alpha] = np.arange(1, alpha + 1)
    eng = PairsGkmEngine(encode_sequences(X.tolist()), g, m, KernelConfig(device="cpu"))
    rl = roofline.pairs_engine_flops(eng)
    macs, brute_layout = _brute_kernel_a(eng, "mma")
    assert rl["layout"] == brute_layout == layout
    paired = layout in ("resident", "windows")  # a product column serves two windows
    assert rl["flops"] * (2 if paired else 1) >= rl["useful_flops"] and rl["flops"] == 2.0 * macs


@pytest.mark.parametrize("n,alpha", [(30, 4), (60, 24)])
def test_packed_engine_flops_counts_kernel_d_s_pairs(n, alpha):
    rng = np.random.default_rng(alpha)
    X = random_ragged_seqs(rng, n, 16, 300, alpha)
    eng = PackedPairsEngine(encode_sequences(X), 8, 4, KernelConfig(device="cpu"))
    rl = roofline.packed_engine_flops(eng)
    planes = eng.rows().planes
    n_tiles = planes.shape[0] // ROW_TILE
    tile_pairs = sum(1 for a in range(n_tiles) for b in range(n_tiles) if b >= a)
    assert rl["tile_pairs"] == tile_pairs
    assert rl["window_pairs"] == tile_pairs * ROW_TILE**2
    nb = code_planes(eng.alpha)
    assert rl["code_planes"] == nb and rl["bit_ops"] == rl["window_pairs"] * (nb + 1)
    assert rl["flops"] == 2.0 * 8 * eng.alpha * rl["window_pairs"]
    assert rl["bytes_hbm"] == planes.numel() * 4 + planes.shape[0] * 4 + eng.n**2 * 8


# ------------------------------------------------------------- package

_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|fastsk_tpu)\b", re.M)


def test_the_port_imports_no_jax():
    files = glob.glob(os.path.join(REPO, "fastsk_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    offenders = [f for f in files if _JAX_IMPORT.search(open(f).read())]
    assert len(files) > 40 and offenders == []


# this slice's JAX files, and what ROADMAP.md lists as not ported from them
PORTED = {
    "svm/linear.py": set(), "svm/lasso.py": set(), "__main__.py": set(),
    "utils/observe.py": {"enable_compilation_cache"},
    "utils/roofline.py": {
        "TPU_PEAKS", "TPU_HBM_BW", "TPU_VPU_OPS", "TPU_VPU_OPS_MEASURED", "vpu_rate",
        "ffact_vpu_ops", "pairs_kernel_composite", "packed_band_composite",
        "format_composite_line",
    },
    "io/readers.py": set(), "harness/__init__.py": set(), "harness/runner.py": set(),
    "harness/baselines.py": set(), "models/__init__.py": set(), "models/charcnn.py": set(),
    "models/lstm.py": set(), "models/train.py": set(),
}


def _public(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", sorted(PORTED))
def test_every_public_name_is_ported(rel):
    jax_file = os.path.join(REPO, "fastsk_tpu", rel)
    port_file = os.path.join(REPO, "fastsk_tpu_torch", rel)
    assert os.path.exists(port_file)
    missing = _public(jax_file) - _public(port_file) - PORTED[rel]
    # the JAX files' own imports of jax, flax, optax and functools are not API
    missing -= {"jax", "jnp", "nn", "optax", "functools", "annotations"}
    assert missing == set(), missing
