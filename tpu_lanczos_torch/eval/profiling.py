"""Timing and profiling helpers.

The port of ``tpu_lanczos/eval/profiling.py``: the analog of the
reference CUDA code's cudaEvent timer pairs (``cuda_start_timer`` /
``cuda_end_timer``, parallel-final/lib/helpers.cu:14-29) and its
gettimeofday stage table (main.cu:134-166).  Device work is bracketed by
fences (a synchronize of each CUDA device the tensors live on; nothing on
the CPU, where torch ops are synchronous), stages accumulate into a
printable table, and ``trace`` writes a ``torch.profiler`` Chrome
trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

TRACE_FILE = "trace.json"


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of every tensor in ``obj`` (a tensor, or a
    sequence, dict or dataclass holding tensors)."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            out.add(obj.device)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _cuda_devices(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _cuda_devices(o, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), out)
    return out


def wait(*objs) -> None:
    """Wait for the device work queued so far on the devices of ``objs``'
    tensors (the ``jax.block_until_ready`` of the reference)."""
    for dev in _cuda_devices(objs, set()):
        torch.cuda.synchronize(dev)


class _StageHandle:
    """Collects what a stage produced, for the exit fence."""

    def __init__(self):
        self._outs: list = []

    def fence(self, *objs):
        """Register tensors whose device work belongs to this stage; the
        stage's exit waits for them."""
        self._outs.extend(objs)


class StageTimer:
    """Accumulates wall time per named stage with device fencing."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, *fence):
        """Times the block.  ``fence`` tensors (pre-existing inputs) are
        waited for at ENTRY, so device work queued before is not billed
        to this stage.  Tensors the stage itself produces must be
        registered on the yielded handle (``st.fence(out)``): a CUDA op
        returns before the device runs it, and the stage's own device
        work is only counted if its outputs are fenced at exit:

            with t.stage("lanczos", x) as st:
                state = lanczos(dg, x, k)
                st.fence(state)
        """
        wait(*fence)
        h = _StageHandle()
        t0 = time.perf_counter()
        yield h
        wait(*h._outs)
        self.stages[name] = (self.stages.get(name, 0.0)
                             + time.perf_counter() - t0)

    def table(self) -> str:
        width = max((len(k) for k in self.stages), default=5)
        total = sum(self.stages.values())
        lines = [f"{k:{width}}  {v:9.4f}s  {100*v/total:5.1f}%"
                 for k, v in self.stages.items()]
        lines.append(f"{'total':{width}}  {total:9.4f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a
    GPU is present); on exit the Chrome trace is written to
    ``logdir/trace.json`` (chrome://tracing or Perfetto).  Yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def timed(fn, *args, reps: int = 3, **kw):
    """Median wall time of ``fn`` with its result waited for, after one
    warm call.  Returns (result of the warm call, median seconds)."""
    out = fn(*args, **kw)
    wait(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        wait(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))

