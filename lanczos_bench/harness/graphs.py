"""The cell's graph, made by the generator its configuration names
(``lanczos_bench/graphs/<generator>.py``) from the run's seed."""

from __future__ import annotations

import importlib

from lanczos_bench.harness.spec import check_name


def generate(config: dict, seed: int):
    """(indptr int64, indices int32) of the configuration's graph."""
    name = check_name(config["generator"], "generator")
    module = importlib.import_module(f"lanczos_bench.graphs.{name}")
    return module.generate(config, seed)
