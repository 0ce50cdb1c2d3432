"""The Graph500 configuration: its frozen generator gives the port's
graph array for array, its cell loads with its metrics, and the
``chain_tiles`` reader reads the program's counter on a real query and
gives None on a program without it."""

import importlib

import numpy as np
import pytest

from lanczos_bench.graphs import graph500
from lanczos_bench.harness import graphs, spec
from lanczos_bench.harness.cell import Run, _query
from tpu_lanczos_torch.graphs import generators

CELL = "g500s21.topk20.f32"


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 + 11, 2**40 + 3])
@pytest.mark.parametrize("scale, edgefactor", [(8, 16), (10, 16), (12, 16),
                                               (9, 4)])
def test_graph500_equals_the_ports(scale, edgefactor, seed):
    indptr, indices = graph500.graph500(scale, edgefactor, seed)
    g = generators.graph500(scale, edgefactor, seed)
    assert indptr.dtype == g.indptr.dtype and indices.dtype == g.indices.dtype
    assert np.array_equal(indptr, g.indptr)
    assert np.array_equal(indices, g.indices)


def test_generate_reads_the_config():
    cell = spec.load_cell(CELL)
    assert cell.config["generator"] == "graph500"
    assert (cell.config["scale"], cell.config["edgefactor"]) == (21, 16)
    small = dict(cell.config, scale=9)
    a = graphs.generate(small, 1)
    b = graphs.generate(small, 2)
    assert a[0].shape == (2**9 + 1,)
    assert not np.array_equal(a[1], b[1])
    with pytest.raises(ValueError):
        graph500.graph500(0, 16, 1)


def test_the_cell_loads_with_its_metrics():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    assert set(cell.limits) == {"topk_err", "norm_err"}
    assert {m.name for m in cell.end_to_end} == {
        "query_ms", "query_p95_ms", "setup_s"}
    assert {m.name for m in cell.per_layer} == {
        "pack_s", "lanczos_ms", "driver_ms", "spmv_roofline_pct",
        "device_idle_pct", "kernels_per_query", "query_lanczos_ms",
        "eigh_ms", "host_stage_ms", "chain_tiles"}
    assert cell.traffic == spec.load_cell("ba1M.topk20.f32").traffic
    bench = spec.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "graph500_s21")
    assert entry["reduced"] == ["scale"]


def _small_run(scale=9, k=6):
    import tpu_lanczos_torch as tl

    cell = spec.load_cell(CELL)
    cell.config = dict(cell.config, scale=scale)
    cell.traffic = dict(cell.traffic,
                        kwargs=dict(cell.traffic["kwargs"], k=k))
    run = Run(cell, "cpu")
    indptr, indices = graphs.generate(cell.config, 3)
    run.graph = tl.CSRGraph(indptr=indptr, indices=indices,
                            n=indptr.shape[0] - 1)
    run.dg = tl.best_device_pack(run.graph, device="cpu")
    run.query = _query(run)
    return run


def test_chain_tiles_reads_the_programs_counter(monkeypatch):
    run = _small_run()
    reader = spec.metric_module("chain_tiles")
    monkeypatch.setattr(reader, "QUERIES", 2)
    chain = sum(int(lv["counts"].max()) for lv in run.dg.levels)
    assert reader.read(run) == 6 * chain


def test_chain_tiles_is_none_without_the_counter(monkeypatch):
    obs = importlib.import_module("tpu_lanczos_torch.obs")
    without = tuple((module, tuple(n for n in names if n != "chain_tiles"))
                    for module, names in obs.LAUNCH_COUNTERS)
    monkeypatch.setattr(obs, "LAUNCH_COUNTERS", without)
    run = _small_run()
    calls = []
    run.query = lambda: calls.append(1)
    reader = spec.metric_module("chain_tiles")
    assert reader.read(run) is None
    assert not calls


def test_chain_tiles_is_none_without_obs(monkeypatch):
    reader = spec.metric_module("chain_tiles")
    run = _small_run()
    real = importlib.import_module

    def no_obs(name, *args):
        if name.endswith(".obs"):
            raise ModuleNotFoundError(name)
        return real(name, *args)

    monkeypatch.setattr(reader.importlib, "import_module", no_obs)
    assert reader.read(run) is None
    run.traffic = {"precision": "df64"}
    assert reader.read(run) is None
