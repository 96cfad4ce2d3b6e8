"""Observability: progress logging, timing, spans, counters and profiler
traces.

Counterpart of ``fastsk_tpu/utils/observe.py``:

- ``Progress``: structured stderr logging gated by ``KernelConfig.quiet``,
  with elapsed-time stamps;
- ``timed``: context manager measuring a span and reporting a rate
  (e.g. sequence-pairs/s); given a CUDA ``device`` it synchronizes before
  each clock read, so the span ends synchronized; it opens the ``span``
  of its label, so a log line and a trace name the same stage;
- ``span``: names a stage of the program in a ``torch.profiler`` trace
  (``fastsk:<name>``, on the clock of the device's kernels and copies)
  while a profiler records, and adds the stage's host wall to the
  counter ``<name>.span_s`` and its entries to ``<name>.spans``; with no
  profiler it is one flag read and a shared no-op. A span never
  synchronizes and never reads a device value;
- ``count``, ``counters``, ``reset_counters``: the one registry of the
  program's counters (kernel launches, kernel B's iterations, bytes sent
  between processes), always on: a dict add each;
- ``profiler_trace``: a ``torch.profiler`` trace of the CPU and, where
  there is one, the card, exported as a Chrome trace (JSON) into
  ``log_dir``.

The JAX package's ``enable_compilation_cache`` (XLA's persistent compile
cache) has no counterpart: the port compiles its kernels once into
``build/fastsk_tpu_torch/`` (``_build.py``) and has no XLA step.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import Counter
from typing import Iterator, Optional, Union

import torch
import torch.autograd.profiler as _profiler

_COUNTS: Counter = Counter()


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] += n


def counters() -> Counter:
    """A copy of every counter (a name never counted reads 0)."""
    return Counter(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


@contextlib.contextmanager
def _recorded(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"fastsk:{name}"):
        try:
            yield
        finally:
            count(f"{name}.span_s", time.perf_counter() - t0)
            count(f"{name}.spans")


_OFF = contextlib.nullcontext()


def span(name: str):
    """The stage ``name`` as a context manager: ``fastsk:<name>`` in the
    trace of a recording ``torch.profiler``, else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name)


class Progress:
    def __init__(self, quiet: bool = True, stream=None):
        self.quiet = quiet
        self.stream = stream or sys.stderr
        self._t0 = time.perf_counter()

    def log(self, msg: str) -> None:
        if self.quiet:
            return
        dt = time.perf_counter() - self._t0
        print(f"[fastsk +{dt:8.2f}s] {msg}", file=self.stream, flush=True)


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(
    progress: Progress, label: str, work_items: Optional[float] = None,
    unit: str = "items", device: Union[str, torch.device, None] = None,
) -> Iterator[dict]:
    """Measure a span; on exit logs wall time and, when ``work_items`` is
    given, the achieved rate. Yields a dict the caller may inspect. With a
    CUDA ``device`` the clock is read after a synchronize at both ends."""
    out = {"label": label}
    _sync(device)
    t0 = time.perf_counter()
    try:
        with span(label):
            yield out
    finally:
        _sync(device)
        wall = time.perf_counter() - t0
        out["wall_s"] = wall
        if work_items:
            out["rate"] = work_items / max(wall, 1e-12)
            progress.log(
                f"{label}: {wall:.2f} s ({out['rate']:.3e} {unit}/s)"
            )
        else:
            progress.log(f"{label}: {wall:.2f} s")


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Write a ``torch.profiler`` trace of the span into ``log_dir`` as
    ``trace_<pid>_<ns>.json`` (Chrome trace format; no-op if None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )
