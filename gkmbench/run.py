"""Run one cell of the benchmark of fastsk_tpu_torch once, on the card.

    python3 gkmbench/run.py --workload kat2b.train --seed 7 --seconds 30 --trace 0

Set-up (the CUDA context, the port's kernels, built once into the
checkout's ``build/fastsk_tpu_torch/``, the cell's data from the seed and
one warm job) is ``setup_s``. The window then runs whole jobs, closed loop,
one in flight, for ``--seconds``; ``job_s`` is the window over its jobs.
With ``--trace 1`` the window runs under ``torch.profiler`` and the run
reports the cell's per-layer metrics instead. Once the window has closed
the plain reference (``reference.py``) judges what the jobs produced;
every number compared is printed beside its limit, last on standard error
and last in the result line. The result is the last line of standard
output. Without a CUDA card (or fewer than the cell asks for) the run
exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "build", "gkmbench")
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(CACHE, sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gkmbench import harness  # noqa: E402


def log(msg: str) -> None:
    print(f"gkmbench: {msg}", file=sys.stderr, flush=True)


def power_limit_w():
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float = T_START) -> dict:
    """One run of ``cell``: the result line's object (``correct`` false
    where a number passes its limit or a job failed)."""
    import torch

    from gkmbench.run_view import RunView

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    api = harness.import_program()
    loader = harness.load_module("loaders", cell.config["loader"])
    data = loader.load(cell.config, seed, HERE)
    harness.run_job(api, cell, data, seed, device, harness.no_span)  # warm job
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    view = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        def factory(job):
            @contextlib.contextmanager
            def span(call):
                with record_function(f"gkmbench:{job}:{call}"):
                    yield
                    sync()
            return span

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function("gkmbench:window"):
                window, fsk = harness.measure(api, cell, data, seed, seconds, device, factory, sync)
        os.makedirs(CACHE, exist_ok=True)
        path = os.path.join(CACHE, f"trace.{os.getpid()}.json")  # one file a process
        prof.export_chrome_trace(path)
        del prof
        from gkmbench.trace import reduce_trace

        view = reduce_trace(path)
        os.remove(path)
    else:
        window, fsk = harness.measure(api, cell, data, seed, seconds, device,
                                      lambda job: harness.no_span, sync)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    log(f"window {window.seconds:.3f} s, {len(window.jobs)} jobs, {window.failed} failed; "
        f"job seconds {' '.join(f'{j.seconds:.4f}' for j in window.jobs)}")
    for e in window.errors[:5]:
        log(f"job failed: {e}")

    # the last job's outputs leave the program, then its state is freed
    last = (harness.last_job_outputs(fsk, CACHE)
            if window.failed == 0 and fsk is not None else None)
    fsk = None
    if cuda:
        torch.cuda.empty_cache()
    numbers = {}
    if last is not None:
        numbers = harness.compare(cell, data, seed, last, window, device, log)
    checked = harness.checks(numbers, cell.limits)
    rv = RunView(cell=cell, data=data, setup_s=setup_s, window=window, trace=view)
    metrics = harness.read_metrics(cell, cell.per_layer if trace else cell.end_to_end, rv)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.workload["chips"] if cuda else 1,
           "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    if view is not None:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
    result = {"correct": window.failed == 0 and bool(numbers) and harness.passed(checked),
              "attempted": len(window.jobs), "failed": window.failed,
              "metrics": metrics, "device": dev}
    if view is not None:
        result["breakdown"] = {"device_ops": [[n, s] for n, s in view.device_ops],
                               "idle_gaps": [[n, s] for n, s in view.idle_gaps]}
    result["checks"] = checked
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        log(f"loaded modules that the benchmark forbids: {', '.join(bad)}: no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
