"""torch.profiler over a few queries, reduced to the device's busy time,
its idle share, kernels a query and a breakdown.

Each traced query is wrapped in a ``record_function`` span named
``QUERY_SPAN``; the traced window runs from the first span's start to the
last one's end, on the trace's own clock.  Device operations are the
trace's kernels, copies and memsets; busy time is the union of their
intervals inside the window (so overlapping streams count once), and the
idle gaps are what the union leaves out, each named by the innermost host
operation or Python function (the profiler records the stack) running at
its midpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np

QUERY_SPAN = "lanczos_bench.query"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10


def union(intervals):
    """Merged, sorted (start, end) intervals of their union."""
    merged = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            if t1 > merged[-1][1]:
                merged[-1][1] = t1
        else:
            merged.append([t0, t1])
    return [tuple(m) for m in merged]


def union_length(intervals) -> float:
    return sum(t1 - t0 for t0, t1 in union(intervals))


def gaps(intervals, lo: float, hi: float):
    """The parts of [lo, hi] that no interval covers, in order."""
    out, cur = [], lo
    for t0, t1 in union(intervals):
        if t1 <= lo or t0 >= hi:
            continue
        if t0 > cur:
            out.append((cur, t0))
        cur = max(cur, t1)
    if cur < hi:
        out.append((cur, hi))
    return out


def _clip(t0, t1, lo, hi):
    return max(t0, lo), min(t1, hi)


@dataclasses.dataclass
class TraceSummary:
    queries: int
    window_s: float
    busy_s: float
    kernels: int
    device_ops: list   # [[name, seconds]], most time first
    idle_gaps: list    # [[host activity, seconds]], most time first

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def summarize(events: list) -> TraceSummary:
    """Reduce a Chrome trace's events (µs clock) to a TraceSummary."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name") == QUERY_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError("the trace holds no query span")
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    dev, by_name, kernels = [], {}, 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t0, t1 = _clip(e["ts"], e["ts"] + e.get("dur", 0), lo, hi)
        if t1 <= t0:
            continue
        dev.append((t0, t1))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t1 - t0)
        kernels += e.get("cat") == "kernel"
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("name") != QUERY_SPAN]
    h_ts = np.array([e["ts"] for e in host], dtype=np.float64)
    h_dur = np.array([e.get("dur", 0) for e in host], dtype=np.float64)
    idle = {}
    for g0, g1 in gaps(dev, lo, hi):
        mid = 0.5 * (g0 + g1)
        inner = np.flatnonzero((h_ts <= mid) & (h_ts + h_dur >= mid))
        name = (host[inner[np.argmin(h_dur[inner])]]["name"] if inner.size
                else "host outside any traced op")
        idle[name] = idle.get(name, 0.0) + (g1 - g0)

    def top(d):
        return [[k, v * 1e-6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return TraceSummary(
        queries=len(spans), window_s=(hi - lo) * 1e-6,
        busy_s=union_length(dev) * 1e-6, kernels=kernels,
        device_ops=top(by_name), idle_gaps=top(idle))


def trace_queries(query, count: int) -> TraceSummary:
    """Run ``query`` ``count`` times under torch.profiler (CPU and CUDA
    activity, with the Python stack), each in a QUERY_SPAN; the trace is
    written to a temporary directory under TMPDIR, read back, deleted and
    summarized."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, with_stack=True) as prof:
        for _ in range(count):
            with record_function(QUERY_SPAN):
                query()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summarize(events)
