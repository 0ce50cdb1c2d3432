"""chain_tiles: the serial chain of a served float32 query's SpMVs, in
tiles: the ``query`` span's delta of the program's ``chain_tiles``
counter (``kernels/spmv_cpg.py``: each SpMV adds its pack's chain, every
level's heaviest dest chunk's real tiles, whose sums a block takes one
tile after another; a property of the pack's partition), median over
``QUERIES`` queries recorded inside the program's ``obs.recording()``,
no profiler on.  A query of k steps on a pack of
levels L reads k times the sum over L of each level's heaviest chunk's
tiles.  None where the program has no such counter (no ``obs``, or no
``chain_tiles`` among its counters)."""

import importlib

import numpy as np

from lanczos_bench.harness.cell import PROGRAM

UNIT, BETTER, SOURCE = "tiles", "lower", "program_counter"
LAYER, MOVES = "pack", "query_ms"
NAME = "chain_tiles"
QUERIES = 5


def read(run):
    if run.traffic["precision"] != "float32":
        return None
    try:
        obs = importlib.import_module(f"{PROGRAM}.obs")
    except ModuleNotFoundError:
        return None
    if not any(NAME in names
               for _, names in getattr(obs, "LAUNCH_COUNTERS", ())):
        return None
    with obs.recording() as rec:
        for _ in range(QUERIES):
            run.query()
        roots = rec.take()
    values = [r.counts.get(NAME, 0) for r in roots if r.name == "query"]
    return float(np.median(values)) if values else None
