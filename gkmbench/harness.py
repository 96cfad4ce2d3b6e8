"""One run of one cell: set-up, the measured window of whole jobs, the
trace's reduction and the comparison with the plain reference.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``BENCHMARK.json`` names a cell's configuration file and
traffic mix; the configuration names its loader (``loaders/<name>.py``);
the mix is ``traffic/<name>.json``; each metric is read by
``metrics/<name>.py``; each cell's limits are ``limits/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "fastsk_tpu")


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: dict
    config: dict  # the configuration's file
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench or read_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}.get(name)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = read_json(os.path.join(root, conf["file"]))
    traffic = read_json(os.path.join(HERE, "traffic", f"{work['traffic']}.json"))
    limits = read_json(os.path.join(HERE, "limits", f"{name}.json"))

    # a metric without a workloads list is every cell's (a per-layer one:
    # every cell that reports the end-to-end metric it moves)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in names else [])]
    return Cell(work, config, traffic, limits, e2e, layer)


def load_module(kind: str, name: str):
    """``gkmbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gkmbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(value, config: dict, seed: int):
    """A traffic parameter: ``"$seed"`` is the run's seed, ``"$key"`` the
    configuration's ``key``; lists and objects resolve inside."""
    if isinstance(value, str) and value.startswith("$"):
        return seed if value == "$seed" else config[value[1:]]
    if isinstance(value, dict):
        return {k: resolve(v, config, seed) for k, v in value.items()}
    if isinstance(value, list):
        return [resolve(v, config, seed) for v in value]
    return value


@dataclass
class FitOut:
    """One ``fit`` of a job and the ``score`` that follows it (host
    values)."""
    C: float
    alpha_y: np.ndarray
    rho: float
    platt: tuple  # the fitted sigmoid's (A, B)
    auc: Optional[float] = None


@dataclass
class JobOut:
    """What one job leaves for the comparison (host values only)."""
    fits: List[FitOut] = field(default_factory=list)  # in the order of the calls
    iterations: int = 0
    stdevs: List[float] = field(default_factory=list)
    digest: Optional[int] = None  # the int64 sum of the job's exact counts
    seconds: float = 0.0  # the job's wall, host clock, synchronized


def fit_Cs(cell: Cell, seed: int) -> List[float]:
    """The C of each ``fit`` call of the cell's mix, in order."""
    return [float(resolve(c["args"]["C"], cell.config, seed))
            for c in cell.traffic["calls"] if c["call"] == "fit"]


def counts_digest(fsk):
    """The int64 sum of a job's exact counts, taken where they lie: on the
    device in a device-resident run, as a tensor that ``int()`` reads once
    the window has closed (a host read inside the window would stall it);
    else, or past int32 (a carry plane), from the host counts."""
    import torch

    dev = getattr(fsk, "_counts_dev", None)
    if dev is None or dev.hi is not None:
        return int(np.asarray(fsk.kernel_counts, dtype=np.int64).sum())
    return dev.counts.sum(dtype=torch.int64)


def run_job(api, cell: Cell, data, seed: int, device: str, span: Callable):
    """One job as a user's script runs it: a ``FastSK`` from the
    configuration and the mix, then the mix's calls in order, each inside
    ``span(call)``; each ``fit`` is read with its C once it returns, and
    the AUC of a ``score`` goes to the fit before it. Returns the
    ``FastSK`` and its ``JobOut``."""
    cfg, traffic = cell.config, cell.traffic
    kcfg = api.KernelConfig(device=device, **cfg.get("kernel_config", {}))
    fsk = api.FastSK(cfg["g"], cfg["m"], config=kcfg,
                     **resolve(traffic.get("construct", {}), cfg, seed))
    out = JobOut()
    for c in traffic["calls"]:
        name, args = c["call"], resolve(c.get("args", {}), cfg, seed)
        with span(name):
            if name == "compute_kernel":
                r = fsk.compute_kernel(data.Xtr, data.Xte, data.ytr, data.yte)
            else:
                r = getattr(fsk, name)(**args)
        if name == "fit":
            model = fsk._model
            out.fits.append(FitOut(float(args["C"]), np.asarray(model.alpha_y_, dtype=np.float64),
                                   float(model.rho_), tuple(float(v) for v in model.platt_)))
        elif name == "score" and out.fits:
            out.fits[-1].auc = float(r)
    out.iterations = int(fsk.iterations)
    out.stdevs = [float(s) for s in fsk.get_stdevs()]
    out.digest = counts_digest(fsk)
    return fsk, out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``fastsk_tpu_torch`` is not ``fastsk_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def import_program():
    """The port, from this checkout only."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    api = importlib.import_module("fastsk_tpu_torch")
    where = os.path.dirname(os.path.dirname(os.path.abspath(api.__file__)))
    if where != ROOT:
        raise RuntimeError(f"fastsk_tpu_torch loaded from {where}, not from this checkout {ROOT}")
    return api


@dataclass
class Window:
    """The measured window on the host clock."""
    seconds: float  # first job's start to the last job's end
    jobs: List[JobOut]
    failed: int
    errors: List[str]


def measure(api, cell: Cell, data, seed: int, seconds: float, device: str,
            span_factory, sync: Callable[[], None]):
    """Whole jobs, closed loop, one in flight, until ``seconds`` have
    passed; the last job's ``FastSK`` is kept for the comparison."""
    jobs, errors, failed = [], [], 0
    fsk = None
    sync()
    t0 = time.perf_counter()
    while True:
        fsk = None  # the previous job's state is freed before the next job
        start = time.perf_counter()
        try:
            fsk, out = run_job(api, cell, data, seed, device, span_factory(len(jobs)))
        except Exception as e:  # a failed job is counted, and fails the run
            failed += 1
            errors.append(f"{type(e).__name__}: {e}")
            out = JobOut()
        sync()
        out.seconds = time.perf_counter() - start
        jobs.append(out)
        if time.perf_counter() - t0 >= seconds:
            break
    return Window(time.perf_counter() - t0, jobs, failed, errors), fsk


def last_job_outputs(fsk, workdir: str) -> dict:
    """What the window's last job produced, taken through the program's
    public API once the window has closed: its exact counts
    (``kernel_counts``) and its test probabilities (``save_predictions``,
    the values ``score`` ranked)."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"predictions.{os.getpid()}.txt")  # one file a process
    fsk.save_predictions(path)
    with open(path) as f:
        proba = np.array([float(line.split()[1]) for line in f if line.strip()])
    os.remove(path)
    return {"counts": fsk.kernel_counts, "proba": proba}


def check_name(name: str, C: float, multi: bool) -> str:
    """A compared number's name: plain in a cell whose mix fits once, else
    with the C of the fits it judges (``svm_gap_C0.001``)."""
    return f"{name}_C{C:g}" if multi else name


def check_names(cell: Cell, seed: int = 0) -> set:
    """The names of the numbers that ``compare`` gives in ``cell``."""
    Cs = fit_Cs(cell, seed)
    multi = len(Cs) > 1
    approx = bool(cell.traffic.get("construct", {}).get("approx", False))
    return ({"counts"} | ({"stop", "sd_trace"} if approx else set())
            | {check_name(k, C, multi) for C in Cs for k in ("svm_gap", "rho", "auc", "platt")}
            | {check_name("proba", Cs[-1], multi)})


def compare(cell: Cell, data, seed: int, last: dict, window: Window, device: str,
            log: Callable[[str], None] = lambda s: None) -> Dict[str, float]:
    """The numbers compared, each the worst over the jobs it covers: the
    last job's counts and every job's count digest, the last fit's
    probabilities (``last``, from ``last_job_outputs``), every fit's
    alphas, bias, Platt sigmoid and AUC, judged at its own C, approx
    mode's stop and sd trace. The reference's kernel and Grams are built
    once; each C of the mix has its own judge."""
    import torch

    from gkmbench import reference as ref

    cfg = cell.config
    g, m = cfg["g"], cfg["m"]
    seqs = list(data.Xtr) + list(data.Xte)
    nt = len(data.Xtr)
    prog_counts = torch.as_tensor(np.asarray(last["counts"], dtype=np.int64))
    final = window.jobs[-1]
    t0 = time.perf_counter()
    out: Dict[str, float] = {}
    approx = bool(cell.traffic.get("construct", {}).get("approx", False))
    if approx:
        kw = resolve(cell.traffic["construct"], cfg, seed)
        r = ref.approx_reference(seqs, nt, g, m, kw["seed"], kw.get("delta", 0.025),
                                 final.iterations, kw.get("max_iters", -1), device)
        counts = r["counts"]
        out["stop"] = float(r["stop"])
        out["sd_trace"] = max(ref.sd_gap(j.stdevs, r["sd"]) if j.iterations == final.iterations
                              else 1.0 for j in window.jobs)
    else:
        counts = ref.allpairs_counts(seqs, g, m, device)
    digest = int(counts.sum())
    out["counts"] = max([ref.max_abs_diff(prog_counts, counts)]
                        + [math.inf if j.digest is None else float(abs(int(j.digest) - digest))
                           for j in window.jobs])
    log(f"reference counts {time.perf_counter() - t0:.3f} s")
    Cs = fit_Cs(cell, seed)
    multi = len(Cs) > 1
    if any([f.C for f in j.fits] != Cs or any(f.auc is None for f in j.fits)
           for j in window.jobs):
        return dict(out, **{n: math.inf for n in check_names(cell, seed) if n not in out})
    base = ref.SvmJudge(counts, nt, data.ytr, data.yte, Cs[0])
    judges = {C: base if C == Cs[0] else base.at(C) for C in Cs}
    ref.cv_sigmoids(list(judges.values()))
    log(f"reference folds at {len(judges)} C {time.perf_counter() - t0:.3f} s")
    worst: Dict[str, float] = {}
    judged = set()  # a fit that reads the same as one judged already reads the same verdict
    for j in window.jobs:
        for f in j.fits:
            key = (f.C, f.alpha_y.tobytes(), f.rho, f.platt, f.auc)
            if key in judged:
                continue
            judged.add(key)
            judge = judges[f.C]
            verdict = dict(judge.judge(f.alpha_y, f.rho),
                           auc=abs(f.auc - judge.test_auc(f.alpha_y, f.rho)),
                           platt=judge.platt_gap(f.platt))
            for k, v in verdict.items():
                name = check_name(k, f.C, multi)
                worst[name] = max(worst.get(name, 0.0), v)
    out.update(worst)
    fit = final.fits[-1]  # the model the job leaves, which save_predictions reads
    out[check_name("proba", fit.C, multi)] = judges[fit.C].proba_gap(
        fit.alpha_y, fit.rho, fit.platt, last["proba"])
    log(f"reference total {time.perf_counter() - t0:.3f} s")
    return out


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit (a number the cell has no limit for,
    or a limit with no number, fails)."""
    out = {}
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name)
        out[name] = {"value": value if value is not None and math.isfinite(value) else None,
                     "limit": limits.get(name)}
    return out


def passed(checked: Dict[str, dict]) -> bool:
    """Every number present and within its limit (a missing or infinite
    number is null and fails)."""
    return all(c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
               for c in checked.values())


@contextlib.contextmanager
def no_span(name):
    yield


def read_metrics(cell: Cell, metrics: List[dict], run) -> Dict[str, dict]:
    """Each metric by its reader; a reader that finds nothing gives None
    and the metric is left out."""
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
