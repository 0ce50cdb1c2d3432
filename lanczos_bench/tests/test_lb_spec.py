"""BENCHMARK.json and every file it names load, keep the contract's
names, units and keys, and a new configuration, traffic mix, metric and
cell added as files are found without an edit."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from lanczos_bench.harness import spec

ROOT = spec.ROOT_DIR
BENCH = spec.load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lanczos_bench"]
    assert BENCH["command"][1] == "lanczos_bench/run.py"
    assert all(_text(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == CONFIG_KEYS
    assert entry["file"].startswith("lanczos_bench/configs/")
    cfg = spec.load_json(os.path.join(ROOT, entry["file"]))
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert _text(entry["why"]) and _text(entry["source"])
    for key in entry["reduced"]:
        spec.check_name(key, "reduced key")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_entry_and_files(workload):
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert set(entry) == WORKLOAD_KEYS and entry["chips"] in (1, 4)
    assert _text(entry["why"])
    cell = spec.load_cell(workload)
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m.entry["moves"] in names
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    for key in ("pack", "entry", "kwargs", "answer", "precision", "control",
                "warmup_queries", "trace_queries"):
        assert key in cell.traffic, key


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_entry_and_reader(entry):
    per_layer = entry in BENCH["per_layer"]
    allowed = (LAYER_KEYS if per_layer else E2E_KEYS) | {"workloads"}
    assert LAYER_KEYS - {"layer", "moves"} <= set(entry) <= allowed
    assert entry["better"] in ("lower", "higher")
    assert entry["source"] in spec.SOURCES
    spec.check_unit(entry["unit"], entry["name"])
    if per_layer:
        assert _text(entry["layer"])
    else:
        assert 0.01 <= entry["bound"] <= 0.25
        assert entry["source"] in ("host_clock", "device_trace")
    for w in entry.get("workloads", []):
        assert w in WORKLOADS
    assert callable(spec.metric_module(entry["name"]).read)


def test_names_are_unique_and_valid():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(set(names)) == len(names)
    metrics = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for bad in ("a b", "a,b", "a/b", "", "x" * 65, "µs"):
        with pytest.raises(spec.SpecError):
            spec.check_name(bad, "test")
    for bad in ("tokens per second", "x" * 17, "µs"):
        with pytest.raises(spec.SpecError):
            spec.check_unit(bad, "test")


def test_a_declaration_that_disagrees_is_refused(tmp_path):
    root = _copy(tmp_path)
    path = os.path.join(root, "lanczos_bench", "metrics", "pack_s.py")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace('"setup_s"', '"query_ms"'))
    with pytest.raises(spec.SpecError, match="MOVES"):
        spec.load_cell(WORKLOADS[0], root=root)


def _copy(tmp_path):
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "lanczos_bench"),
                    os.path.join(root, "lanczos_bench"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


NEW_METRIC = '''"""probe_queries: the window's query count (a test metric)."""

UNIT, BETTER, SOURCE = "queries", "higher", "host_clock"
LAYER, MOVES = "query driver", "query_ms"


def read(run):
    return float(len(run.latencies))
'''

RUN_NEW_CELL = '''
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(1, {repo!r})
from lanczos_bench.harness import spec
from lanczos_bench.harness.cell import run_cell
cell = spec.load_cell("mesh30.topk5.k12")
print(json.dumps(run_cell(cell, 7, 0.0, True, device="cpu")))
'''


def test_new_files_are_found_without_an_edit(tmp_path):
    """A later PR's config, traffic mix, metric and cell, added as files
    and entries, run through the harness as it stands."""
    root = _copy(tmp_path)
    bench_dir = os.path.join(root, "lanczos_bench")
    with open(os.path.join(bench_dir, "configs", "stencil_30.json"), "w") as f:
        json.dump({"name": "stencil_30", "source": "a test mesh",
                   "generator": "stencil_2d", "side": 30, "reduced": []}, f)
    traffic = spec.load_json(os.path.join(bench_dir, "traffic",
                                          "topk20_f32.json"))
    traffic["kwargs"].update(k=12, topk=5)
    traffic["warmup_queries"], traffic["trace_queries"] = 1, 1
    with open(os.path.join(bench_dir, "traffic", "topk5_k12.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench_dir, "cells", "mesh30.topk5.k12.json"),
              "w") as f:
        json.dump({"limits": {"topk_err": 1e-4}}, f)
    with open(os.path.join(bench_dir, "metrics", "probe_queries.py"),
              "w") as f:
        f.write(NEW_METRIC)
    bench_path = os.path.join(root, "BENCHMARK.json")
    bench = spec.load_json(bench_path)
    bench["configs"].append({
        "name": "stencil_30", "source": "a test mesh", "reduced": [],
        "file": "lanczos_bench/configs/stencil_30.json", "why": "test"})
    bench["workloads"].append({
        "name": "mesh30.topk5.k12", "config": "stencil_30",
        "traffic": "topk5_k12", "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "probe_queries", "unit": "queries", "better": "higher",
        "source": "host_clock", "layer": "query driver",
        "moves": "query_ms", "workloads": ["mesh30.topk5.k12"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)

    cell = spec.load_cell("mesh30.topk5.k12", root=root)
    assert cell.config["side"] == 30 and cell.traffic["kwargs"]["topk"] == 5
    assert "probe_queries" in [m.name for m in cell.per_layer]
    code = RUN_NEW_CELL.format(root=root, repo=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["probe_queries"]["value"] >= 1
    assert set(out["checks"]) == {"topk_err"}
