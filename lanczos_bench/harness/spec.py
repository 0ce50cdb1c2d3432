"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) resolves to:
- its configuration, the JSON file that ``configs[].file`` names;
- its traffic mix, ``lanczos_bench/traffic/<traffic>.json``;
- its correctness limits, ``lanczos_bench/cells/<workload>.json``;
- its metrics, each ``lanczos_bench/metrics/<metric>.py``: the end-to-end
  and per-layer entries whose ``workloads`` list holds the cell, or that
  have none.
So a later configuration, mix, metric or cell is a new file and a new
entry, with no edit to this code.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_DIR = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# what every metric module declares, checked against its BENCHMARK.json entry
DECLARED = {"UNIT": "unit", "BETTER": "better", "SOURCE": "source"}
DECLARED_PER_LAYER = {"LAYER": "layer", "MOVES": "moves"}


class SpecError(ValueError):
    """BENCHMARK.json or a file it names is malformed or missing."""


@dataclasses.dataclass
class Metric:
    name: str
    entry: dict      # the BENCHMARK.json entry
    reader: object   # the module with ``read(run)``

    @property
    def unit(self) -> str:
        return self.entry["unit"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict          # number compared -> its limit
    end_to_end: list      # [Metric]
    per_layer: list       # [Metric]


def check_name(name, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{what} {name!r} is not a valid name")
    return name


def check_unit(unit, what: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise SpecError(f"{what}: unit {unit!r} is not valid")
    return unit


def load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as exc:
        raise SpecError(f"missing file {path}") from exc


def load_benchmark(root: str = ROOT_DIR) -> dict:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            check_name(entry["name"], key)
    for entry in bench["end_to_end"] + bench["per_layer"]:
        check_unit(entry["unit"], entry["name"])
    return bench


def metric_module(name: str, root: str = ROOT_DIR):
    path = os.path.join(root, "lanczos_bench", "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise SpecError(f"no reader {path} for metric {name}")
    spec = importlib.util.spec_from_file_location(
        f"lanczos_bench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _metric(entry: dict, per_layer: bool, root: str) -> Metric:
    module = metric_module(entry["name"], root)
    declared = dict(DECLARED, **(DECLARED_PER_LAYER if per_layer else {}))
    for attr, key in declared.items():
        if getattr(module, attr, None) != entry[key]:
            raise SpecError(
                f"metric {entry['name']}: {attr} "
                f"{getattr(module, attr, None)!r} in its reader, "
                f"{entry[key]!r} in BENCHMARK.json")
    return Metric(entry["name"], entry, module)


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(workload: str, root: str = ROOT_DIR,
              bench: dict | None = None) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    try:
        w = next(w for w in bench["workloads"] if w["name"] == workload)
    except StopIteration:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json") \
            from None
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(
        root, "lanczos_bench", "traffic", f"{check_name(w['traffic'], 'traffic')}.json"))
    limits = load_json(os.path.join(
        root, "lanczos_bench", "cells", f"{workload}.json"))["limits"]
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[_metric(e, False, root) for e in bench["end_to_end"]
                    if _applies(e, workload)],
        per_layer=[_metric(e, True, root) for e in bench["per_layer"]
                   if _applies(e, workload)])
