"""Small cells for the benchmark's tests: the real traffic and limits of
a cell on a graph and a k that a CPU test run can hold."""

from __future__ import annotations

import copy

from lanczos_bench.harness import spec

SMALL_GRAPHS = {
    "barabasi_albert": {"generator": "barabasi_albert", "n": 600, "m": 10},
}


def small_cell(workload: str, k: int | None = None, warmup: int = 0):
    """``workload``'s cell with its graph cut to SMALL_GRAPHS, ``k``
    steps where given, and ``warmup`` warm-up queries."""
    cell = spec.load_cell(workload)
    cell.config = dict(SMALL_GRAPHS[cell.config["generator"]])
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["warmup_queries"] = warmup
    if k is not None:
        cell.traffic["kwargs"]["k"] = k
    return cell
