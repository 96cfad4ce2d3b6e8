"""What the port's own counter registry (``counters()`` of
``fastsk_tpu_torch/utils/observe.py``) holds once a run's window has
closed. Kernel B's iterations (``smo.iterations``) are counted all run
long, the warm job's too; each span's host wall (``<span>.span_s``) and
entries (``<span>.spans``) are counted only while a profiler records, so
in a traced run they are the window's. A port without the registry gives
None, and so does its metrics' reader."""

from __future__ import annotations

import sys
from collections import Counter
from typing import Optional

B_KERNEL = "smo_cluster_kernel"  # kernel B's name in the device trace


def read() -> Optional[Counter]:
    observe = sys.modules.get("fastsk_tpu_torch.utils.observe")
    counters = getattr(observe, "counters", None)
    return None if counters is None else counters()


def span_wall_a_entry(c: Counter, names, per: str) -> Optional[float]:
    """The host wall of the spans ``names`` over the entries of the span
    ``per`` (one a job), or None where ``per`` was never entered."""
    if c is None or c[f"{per}.spans"] == 0:
        return None
    return sum(c[f"{n}.span_s"] for n in names) / c[f"{per}.spans"]


def iterations_a_job(run) -> Optional[float]:
    """``smo.iterations`` over the process's jobs, the warm job and the
    window's: every job of a run is the same work, so the same count."""
    c = read()
    if c is None or c["smo.iterations"] == 0 or run.jobs == 0:
        return None
    return c["smo.iterations"] / (run.jobs + 1)
