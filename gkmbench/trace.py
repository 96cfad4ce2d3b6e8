"""The reduction of a traced window: ``torch.profiler``'s Chrome trace to
the benchmark's spans, the device's busy intervals and the breakdown.

The benchmark marks the window (``gkmbench:window``) and each call of each
job (``gkmbench:<job>:<call>``) with ``record_function``; a call's span
ends in ``torch.cuda.synchronize()``. Device time is the union of kernel,
copy and set intervals, so overlapping streams count once.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

from gkmbench.yardstick import covered, gaps, union

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


@dataclass
class TraceView:
    window: Tuple[float, float]  # seconds, on the trace's clock
    spans: List[Tuple[int, str, float, float]]  # (job, call, start, end)
    busy: List[Tuple[float, float]]  # merged device intervals inside the window
    device_ops: List[Tuple[str, float]]  # device time by kernel name, largest first
    idle_gaps: List[Tuple[str, float]]  # idle time by what the host was doing, largest first

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def busy_in(self, t0: float, t1: float) -> float:
        return covered(self.busy, t0, t1)

    def per_job(self, call: str, fn) -> List[float]:
        """``fn(start, end)`` summed over each job's spans of ``call``."""
        out: Dict[int, float] = defaultdict(float)
        for job, name, a, b in self.spans:
            if name == call:
                out[job] += fn(a, b)
        return [out[j] for j in sorted(out)]


def _host_labels(host, gap_list, spans):
    """For each gap, the benchmark call around its middle and the innermost
    host event running there (a sweep over properly nested events)."""
    host = sorted(host)
    labels, stack, at = [], [], 0
    for a, b in gap_list:
        mid = (a + b) / 2
        while at < len(host) and host[at][0] <= mid:
            s, e, name = host[at]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            at += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        call = next((c for _, c, s, e in spans if s <= mid < e), "between jobs")
        labels.append(f"{call}: {stack[-1][2] if stack else 'python'}")
    return labels


def reduce_trace(path: str, top: int = 10) -> TraceView:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, window, tid = [], None, None
    device, by_name = [], defaultdict(float)
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if "dur" not in e:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        if cat == "user_annotation" and name.startswith("gkmbench:"):
            if name == "gkmbench:window":
                window, tid = (a, b), e.get("tid")
            else:
                _, job, call = name.split(":", 2)
                spans.append((int(job), call, a, b))
        elif cat in DEVICE_CATS:
            device.append((a, b, name))
    if window is None:
        raise ValueError("the trace holds no gkmbench:window span")
    t0, t1 = window
    busy = union((max(a, t0), min(b, t1)) for a, b, _ in device if b > t0 and a < t1)
    for a, b, name in device:
        if b > t0 and a < t1:
            by_name[name[:120]] += min(b, t1) - max(a, t0)
    host = []
    for e in events:
        if e.get("cat") in HOST_CATS and "dur" in e and e.get("tid") == tid:
            name = e.get("name", "")
            if not name.startswith("gkmbench:"):
                a = float(e["ts"]) * 1e-6
                host.append((a, a + float(e["dur"]) * 1e-6, name[:80]))
    gap_list = gaps(busy, t0, t1)
    idle = defaultdict(float)
    for (a, b), label in zip(gap_list, _host_labels(host, gap_list, spans)):
        idle[label] += b - a
    spans.sort(key=lambda s: s[2])
    return TraceView(
        window=window, spans=spans, busy=busy,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:top],
    )
