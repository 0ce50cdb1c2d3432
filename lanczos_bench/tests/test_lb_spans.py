"""The span helper (harness/spans.py) and the five readers of the
program's spans, on fake span records, on a program without spans, and
once on the real program's query on the CPU."""

import importlib

import pytest

from lanczos_bench.harness import spans, spec
from lanczos_bench.harness.cell import Run, _query
from lanczos_bench.tests.helpers import small_cell

F32_READERS = ("query_lanczos_ms", "eigh_ms", "host_stage_ms")
DF64_READERS = ("query_df_passes_ms", "host_stage_ms.df64")


def rec(name, kind, wall_ms, device_ms=None, children=()):
    return {"name": name, "kind": kind, "wall_ms": wall_ms,
            "device_ms": device_ms, "children": list(children)}


def f32_query(scale=1.0):
    """The fused float32 query's stages, every time times ``scale``."""
    s = scale
    return rec("query", "sync", 32 * s, 31 * s, [
        rec("start", "device", 0.1 * s, 0.05 * s),
        rec("lanczos", "device", 21 * s, 22 * s),
        rec("eigh", "device", 0.6 * s, 0.5 * s),
        rec("multiply_out", "device", 0.1 * s, 0.09 * s),
        rec("topk", "device", 0.2 * s, 0.1 * s),
        rec("fetch", "sync", 0.3 * s, 0.01 * s),
        rec("map_nodes", "host", 9 * s)])


def df64_query(scale=1.0):
    s = scale
    return rec("query", "sync", 78 * s, 77 * s, [
        rec("start", "device", 0.1 * s, 0.05 * s),
        rec("pass1", "device", 33 * s, 34 * s),
        rec("fetch_tridiag", "sync", 0.2 * s, 0.01 * s),
        rec("eigh", "host", 0.7 * s),
        rec("pass2", "device", 32 * s, 33 * s),
        rec("fetch", "sync", 1.4 * s, 1.3 * s),
        rec("to_f64", "host", 6 * s),
        rec("permute_out", "host", 5 * s)])


class FakeRun:
    def __init__(self, precision, queries):
        self.traffic = {"precision": precision}
        setattr(self, spans.ATTR, queries)


def read(name, run):
    return spec.metric_module(name).read(run)


def test_total_takes_the_outermost_match():
    tree = rec("query", "sync", 10, None, [
        rec("a", "host", 4, None, [rec("b", "host", 3)]),
        rec("c", "device", 2, 1.5, [rec("d", "host", 1)])])
    host = spans.of_kind("host")
    assert spans.total(tree, "wall_ms", host) == 5  # a, and d under c
    assert spans.total(tree, "device_ms", spans.named("c")) == 1.5
    assert spans.total(tree, "device_ms", spans.named("a")) is None


def test_median_is_none_without_a_value():
    q = [f32_query()]
    assert spans.median([], "wall_ms", spans.named("lanczos")) is None
    assert spans.median(None, "wall_ms", spans.named("lanczos")) is None
    assert spans.median(q, "device_ms", spans.named("pass1")) is None
    assert spans.median(q, "device_ms", spans.named("map_nodes")) is None


@pytest.mark.parametrize("name, want", [
    ("query_lanczos_ms", 22.0), ("eigh_ms", 0.5), ("host_stage_ms", 9.0)])
def test_f32_readers(name, want):
    run = FakeRun("float32", [f32_query(s) for s in (1.0, 0.9, 1.2)])
    assert read(name, run) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("query_df_passes_ms", 67.0), ("host_stage_ms.df64", 11.7)])
def test_df64_readers(name, want):
    run = FakeRun("df64", [df64_query(s) for s in (1.1, 1.0, 0.8)])
    assert read(name, run) == pytest.approx(want)


@pytest.mark.parametrize("name", F32_READERS + DF64_READERS)
def test_readers_are_silent_elsewhere(name):
    precision = "df64" if name in F32_READERS else "float32"
    queries = [df64_query() if precision == "df64" else f32_query()]
    assert read(name, FakeRun(precision, queries)) is None
    assert read(name, FakeRun("float32" if precision == "df64" else "df64",
                              None)) is None


@pytest.mark.parametrize("name", F32_READERS + DF64_READERS)
def test_card_times_off_the_card_are_none(name):
    """Off CUDA the program's device_ms is None: the card-time readers
    give nothing, the host walls still read."""
    precision = "df64" if name in DF64_READERS else "float32"
    q = df64_query() if precision == "df64" else f32_query()
    for s in q["children"]:
        s["device_ms"] = None
    value = read(name, FakeRun(precision, [q]))
    assert (value is None) == name.startswith(("query_", "eigh_"))


class QueryRun:
    """A run whose query counts its calls."""

    def __init__(self, precision, query):
        self.traffic = {"precision": precision}
        self.calls = 0
        self._inner = query

    def query(self):
        self.calls += 1
        return self._inner()


def test_a_program_without_spans_gives_none(monkeypatch):
    real = importlib.import_module

    def no_obs(name, *args):
        if name.endswith(".obs"):
            raise ModuleNotFoundError(name)
        return real(name, *args)

    monkeypatch.setattr(spans.importlib, "import_module", no_obs)
    run = QueryRun("float32", lambda: None)
    for name in F32_READERS:
        assert read(name, run) is None
    assert run.calls == 0


@pytest.mark.parametrize("workload, names", [
    ("ba1M.topk20.f32", ["start", "lanczos", "eigh", "multiply_out", "topk",
                         "fetch", "map_nodes"]),
    ("ba1M.expm.df64", ["start", "pass1", "fetch_tridiag", "eigh", "pass2",
                        "fetch", "to_f64", "permute_out"])])
def test_recorded_from_the_program(workload, names, monkeypatch):
    """The cell's own query on a small graph on the CPU: QUERIES of them
    (cut to a few here) recorded once a run, each the program's stages
    as records."""
    import numpy as np
    import tpu_lanczos_torch as tl

    from lanczos_bench.harness import graphs

    monkeypatch.setattr(spans, "QUERIES", {"float32": 3, "df64": 2})
    cell = small_cell(workload, k=6)
    run = Run(cell, "cpu")
    indptr, indices = graphs.generate(cell.config, 11)
    run.graph = tl.CSRGraph(indptr=indptr, indices=indices,
                            n=indptr.shape[0] - 1)
    run.dg = tl.best_device_pack(run.graph, device="cpu")
    inner = QueryRun(cell.traffic["precision"], _query(run))
    first = spans.recorded(inner)
    assert spans.recorded(inner) is first
    assert inner.calls == spans.QUERIES[cell.traffic["precision"]]
    assert len(first) == inner.calls
    for q in first:
        assert q["name"] == "query"
        assert [c["name"] for c in q["children"]] == names
        assert all(c["device_ms"] is None for c in q["children"])
        assert np.isfinite(q["wall_ms"])
    host = [m for m in cell.per_layer if m.name.startswith("host_stage_ms")]
    assert len(host) == 1
    assert host[0].reader.read(inner) > 0
