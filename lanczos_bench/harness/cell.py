"""One run of one cell: the graph, the program's set-up, the closed-loop
window, the trace and per-layer readers (``--trace 1``), the check
against the reference, and the result line.

The order keeps each number to what it measures:
1. the graph from the seed (the benchmark's own work, not set-up);
2. set-up, timed from the first import of the program to the end of the
   warm-up queries: the kernel library (built by nvcc on a checkout's
   first run; that build and load are also timed on their own, as
   ``build_s``), the pack with its copy to the card, every shape the
   window uses;
3. the window: one client, queries back to back until ``seconds`` have
   passed, each from call to return;
4. with ``trace``: a few more queries under the profiler, then the
   per-layer readers (some time device work of their own);
5. the card's memory peak, then the program's state freed;
6. the reference, and the sampled answers held to the cell's limits.
"""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time

import numpy as np

from lanczos_bench.harness import control, correct, graphs, trace as tracing

PROGRAM = "tpu_lanczos_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_lanczos")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Sample:
    """The answers kept for the check: all of them, or a reservoir of
    ``size`` drawn from the seed."""

    def __init__(self, size, seed: int):
        self.size, self.seen, self.kept = size, 0, []
        self.rng = np.random.default_rng(seed)

    def offer(self, result) -> None:
        self.seen += 1
        if self.size is None or len(self.kept) < self.size:
            self.kept.append(result)
        else:
            slot = int(self.rng.integers(0, self.seen))
            if slot < self.size:
                self.kept[slot] = result


class Run:
    """What a run measured, handed to every metric's ``read(run)``."""

    def __init__(self, cell, device: str):
        self.cell, self.device = cell, device
        self.traffic = cell.traffic
        self.n = self.nnz = 0
        self.graph = self.dg = self.query = None
        self.gen_s = self.build_s = self.pack_s = self.setup_s = None
        self.nvcc_ran = False
        self.latencies: list = []
        self.window_s = None
        self.trace = None
        self.device_name = None
        self._values: dict = {}
        self._readers = {m.name: m.reader
                         for m in cell.end_to_end + cell.per_layer}

    @property
    def program(self):
        return importlib.import_module(PROGRAM)

    @property
    def on_cuda(self) -> bool:
        return self.device.startswith("cuda")

    def metric(self, name: str):
        """The value of the cell's metric ``name`` (read once)."""
        if name not in self._values:
            self._values[name] = self._readers[name].read(self)
        return self._values[name]

    def sync(self) -> None:
        if self.on_cuda:
            import torch
            torch.cuda.synchronize()

    def device_ms(self, fn, min_group_s: float = 0.2, groups: int = 3):
        """Milliseconds a call of ``fn`` keeps the card busy, by CUDA
        events around groups of back-to-back calls (the median of the
        groups' means), after a warm call; None off the card."""
        if not self.on_cuda:
            return None
        import torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        one_ms = max(start.elapsed_time(end), 1e-3)
        reps = max(3, math.ceil(min_group_s * 1e3 / one_ms))
        means = []
        for _ in range(groups):
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            means.append(start.elapsed_time(end) / reps)
        return float(np.median(means))


def _query(run: Run):
    t = run.traffic
    entry = getattr(run.program, t["entry"])
    kwargs = dict(t["kwargs"])
    graph, dg = run.graph, run.dg
    return lambda: entry(graph, dg=dg, **kwargs)


def load_kernels(run: Run) -> None:
    """The program's kernel library, loaded before the first query needs
    it and built by nvcc where the checkout has no up-to-date build: its
    own part of set-up, timed as ``build_s``."""
    if not run.on_cuda:
        return
    build = importlib.import_module(f"{PROGRAM}.kernels._build")
    run.nvcc_ran = not build._up_to_date()
    tb = time.perf_counter()
    build.library()
    run.build_s = time.perf_counter() - tb


def set_up(run: Run, indptr, indices) -> None:
    t0 = time.perf_counter()
    tl = run.program
    load_kernels(run)
    run.graph = tl.CSRGraph(indptr=indptr, indices=indices,
                            n=indptr.shape[0] - 1)
    tp = time.perf_counter()
    run.dg = getattr(tl, run.traffic["pack"])(run.graph, device=run.device)
    run.sync()
    run.pack_s = time.perf_counter() - tp
    run.query = _query(run)
    for _ in range(int(run.traffic["warmup_queries"])):
        run.query()
    run.sync()
    run.setup_s = time.perf_counter() - t0


def window(run: Run, seconds: float, sample: Sample) -> int:
    """Queries back to back until ``seconds`` have passed; returns the
    number that raised."""
    failed = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        t0 = time.perf_counter()
        try:
            result = run.query()
        except (RuntimeError, ValueError) as exc:
            failed += 1
            result = None
            log(f"query {len(run.latencies)} failed: {exc!r}")
        t1 = time.perf_counter()
        run.latencies.append(t1 - t0)
        if result is not None:
            sample.offer(result)
        if t1 >= deadline:
            break
    run.window_s = t1 - t_start
    return failed


def check(run: Run, indptr, indices, kept: list) -> tuple[bool, dict]:
    t = run.traffic
    t0 = time.perf_counter()
    ref = control.reference(t, indptr, indices)
    readings = [correct.numbers(t["answer"], r, ref) for r in kept]
    log(f"span reference {time.perf_counter() - t0:.3f} s "
        f"({len(kept)} answers compared)")
    if not readings:
        return False, correct.verdict({}, run.cell.limits)[1]
    return correct.verdict(correct.worst(readings), run.cell.limits)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch

    run = Run(cell, device)
    if run.on_cuda:
        torch.cuda.reset_peak_memory_stats()
        run.device_name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    indptr, indices = graphs.generate(cell.config, seed)
    run.gen_s = time.perf_counter() - t0
    run.n, run.nnz = indptr.shape[0] - 1, indices.shape[0]
    log(f"span graph {run.gen_s:.3f} s: n={run.n} nnz={run.nnz} "
        f"seed={seed}")

    set_up(run, indptr, indices)
    if run.build_s is not None:
        log(f"span build {run.build_s:.3f} s "
            f"({'nvcc ran' if run.nvcc_ran else 'library loaded'})")
    log(f"span setup {run.setup_s:.3f} s (pack {run.pack_s:.3f} s)")
    sample = Sample(cell.traffic.get("check_sample"), seed)
    failed = window(run, seconds, sample)
    log(f"span window {run.window_s:.3f} s: {len(run.latencies)} queries, "
        f"{failed} failed")

    if trace:
        run.trace = tracing.trace_queries(
            run.query, int(cell.traffic["trace_queries"]))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = run.metric(m.name)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    device_info = {"platform": "gpu" if run.on_cuda else device,
                   "kind": run.device_name or device,
                   "count": cell.chips,
                   "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                         if run.on_cuda else 0)}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s

    kept = sample.kept
    breakdown = None if run.trace is None else {
        "device_ops": run.trace.device_ops,
        "idle_gaps": run.trace.idle_gaps}
    run.graph = run.dg = run.query = sample = None
    gc.collect()
    if run.on_cuda:
        torch.cuda.empty_cache()
    ok, checks = check(run, indptr, indices, kept)
    out = {"correct": bool(ok and failed == 0),
           "attempted": len(run.latencies), "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if run.build_s is not None:
        out["build"] = {"seconds": run.build_s, "nvcc_ran": run.nvcc_ran}
    out["checks"] = checks
    return out
