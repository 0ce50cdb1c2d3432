"""The port's spans and counters (tpu_lanczos_torch/obs.py) on its served
queries: the span trees of ``expm_action_summary`` (device and host eig,
``low_mem``), ``expm_action`` and ``expm_action_df`` (names, kinds,
parents, one query id a call, children inside their parent), answers
bit-identical with recording on and off, no span made with recording off
and no profiler, the spans in a CPU ``torch.profiler`` trace, and
``d2h_bytes`` equal to the bytes fetched.

The test marked ``cuda`` skips without a card; on a machine with one:

    python -m pytest --noconftest tests/test_torch_obs.py -q

This file imports only the port (``--noconftest`` skips
tests/conftest.py, which imports jax).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tpu_lanczos_torch import (best_device_pack, expm_action,
                               expm_action_df, expm_action_summary,
                               generators, obs)

torch.set_num_threads(1)

K = 8
TOPK = 5

# name -> (entry, kwargs, the query's stages in order)
CASES = {
    "summary_device": (expm_action_summary,
                       dict(k=K, topk=TOPK, eig_impl="device"),
                       ["start", "lanczos", "eigh", "multiply_out", "topk",
                        "fetch", "map_nodes"]),
    "summary_host": (expm_action_summary,
                     dict(k=K, topk=TOPK, eig_impl="host"),
                     ["start", "lanczos", "fetch_tridiag", "eigh",
                      "multiply_out", "topk", "fetch", "map_nodes"]),
    "summary_low_mem": (expm_action_summary,
                        dict(k=K, topk=TOPK, low_mem=True),
                        ["start", "pass1", "fetch_tridiag", "eigh", "pass2",
                         "topk", "fetch", "map_nodes"]),
    "expm_action": (expm_action, dict(k=K),
                    ["start", "lanczos", "fetch_tridiag", "eigh",
                     "multiply_out", "fetch_tridiag", "fetch",
                     "permute_out"]),
    "expm_action_device_log": (expm_action,
                               dict(k=K, eig_impl="device", log_scale=True),
                               ["start", "lanczos", "eigh", "multiply_out",
                                "fetch", "fetch_tridiag", "fetch",
                                "permute_out"]),
    "expm_action_low_mem": (expm_action, dict(k=K, low_mem=True),
                            ["start", "pass1", "fetch_tridiag", "eigh",
                             "pass2", "fetch", "permute_out"]),
    "expm_action_df": (expm_action_df, dict(k=K, log_scale=True),
                       ["start", "pass1", "fetch_tridiag", "eigh", "pass2",
                        "fetch", "to_f64", "permute_out"]),
}
KINDS = {"start": obs.DEVICE, "lanczos": obs.DEVICE, "pass1": obs.DEVICE,
         "pass2": obs.DEVICE, "multiply_out": obs.DEVICE,
         "topk": obs.DEVICE, "fetch": obs.SYNC, "fetch_tridiag": obs.SYNC,
         "map_nodes": obs.HOST, "permute_out": obs.HOST, "to_f64": obs.HOST}


@pytest.fixture(scope="module")
def ba():
    g = generators.barabasi_albert(300, 6, seed=4)
    return g, best_device_pack(g, device="cpu")


def _call(ba, case):
    g, dg = ba
    entry, kw, _ = CASES[case]
    return entry(g, dg=dg, **kw)


def _recorded(ba, case):
    with obs.recording() as rec:
        out = _call(ba, case)
    roots = rec.take()
    assert rec.take() == []  # cleared when read
    return out, roots


@pytest.mark.parametrize("case", CASES)
def test_span_tree(ba, case):
    _, roots = _recorded(ba, case)
    assert len(roots) == 1
    (q,) = roots
    entry, kw, stages = CASES[case]
    assert (q.name, q.kind, q.entry, q.parent) == ("query", obs.SYNC,
                                                   entry.__name__, None)
    assert [c.name for c in q.children] == stages
    eigh_kind = (obs.DEVICE if kw.get("eig_impl") == "device"
                 else obs.HOST)
    for c in q.children:
        assert c.kind == (eigh_kind if c.name == "eigh" else KINDS[c.name])
        assert c.parent is q and c.children == []
    spans = list(q.walk())
    assert {s.query_id for s in spans} == {q.query_id}
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        assert s.device_ms is None  # no card time off CUDA
        for c in s.children:
            assert s.t0_ns <= c.t0_ns <= c.t1_ns <= s.t1_ns
    assert 0 <= q.self_ms <= q.wall_ms
    assert q.self_ms == pytest.approx(
        q.wall_ms - sum(c.wall_ms for c in q.children))


def test_query_ids_differ_between_calls(ba):
    with obs.recording() as rec:
        _call(ba, "summary_device")
        _call(ba, "expm_action_df")
    a, b = rec.take()
    assert a.query_id != b.query_id
    assert (a.entry, b.entry) == ("expm_action_summary", "expm_action_df")


def _fields(out):
    return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}


@pytest.mark.parametrize("case", CASES)
def test_answers_bit_identical_with_recording(ba, case):
    off = _fields(_call(ba, case))
    on = _fields(_recorded(ba, case)[0])
    assert off.keys() == on.keys()
    for name, value in off.items():
        if isinstance(value, np.ndarray):
            assert value.dtype == on[name].dtype
            assert np.array_equal(value, on[name]), name
        else:
            assert value == on[name], name


def test_recording_off_makes_no_span(ba, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was made with recording off")

    monkeypatch.setattr(obs, "_Open", refuse)
    monkeypatch.setattr(obs, "Span", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert obs._active is None and not torch.autograd._profiler_enabled()
    for case in ("summary_device", "summary_low_mem", "expm_action",
                 "expm_action_df"):
        _call(ba, case)
    assert obs.span("lanczos", obs.DEVICE) is obs.query("x", "cpu")


def test_recording_is_scoped():
    assert obs._active is None
    with obs.recording() as outer:
        with obs.recording() as inner:
            assert obs._active is inner
        assert obs._active is outer
    assert obs._active is None


def test_spans_in_a_profiler_trace(ba, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(ba, "summary_device")
        _call(ba, "expm_action_df")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("name", "").startswith(obs.PREFIX)]
    assert events and all(e["cat"] == "user_annotation" for e in events)
    queries = [e for e in events
               if e["name"] == "tpu_lanczos_torch.query[sync]"]
    assert len(queries) == 2
    names = set()
    for e in events:
        if e in queries:
            continue
        names.add(e["name"])
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        assert any(q["ts"] <= t0 and t1 <= q["ts"] + q["dur"]
                   for q in queries), e["name"]
    want = {f"tpu_lanczos_torch.{n}[{KINDS.get(n, obs.HOST)}]"
            for case in ("summary_device", "expm_action_df")
            for n in CASES[case][2] if n != "eigh"}
    assert want <= names
    assert {"tpu_lanczos_torch.eigh[device]",
            "tpu_lanczos_torch.eigh[host]"} <= names


def test_d2h_bytes_are_the_bytes_fetched(ba):
    _, dg = ba
    f32, i64 = 4, 8
    # every SpMV walks each level once; chain_tiles adds the heaviest
    # chunk's tiles of each (the CPU runs the levels' plain versions)
    chain = sum(int(lv["counts"].max()) for lv in dg.levels)
    _, (q,) = _recorded(ba, "summary_device")
    # values, norm, shift, alpha, beta, x_norm in one copy; the indices
    assert q.counts == {"d2h_bytes": (TOPK + 2 + K + K - 1 + 1) * f32
                        + TOPK * i64, "syncs": 2, "chain_tiles": K * chain}
    _, (q,) = _recorded(ba, "summary_host")
    # alpha, beta, x_norm; values, indices, norm
    assert q.counts == {"d2h_bytes": (2 * K) * f32 + (TOPK + 1) * f32
                        + TOPK * i64, "syncs": 4, "chain_tiles": K * chain}
    _, (q,) = _recorded(ba, "expm_action")
    # T twice (the coefficients, the result), the answer
    assert q.counts == {"d2h_bytes": 2 * (2 * K) * f32 + dg.n_pad * f32,
                        "syncs": 3, "chain_tiles": K * chain}
    _, (q,) = _recorded(ba, "expm_action_df")
    # pass 1's df alpha, beta and x_norm; both halves of the answer; two
    # passes of df SpMVs, 2K - 1 of them
    assert q.counts == {"d2h_bytes": (4 * K + 2) * f32 + 2 * dg.n_pad * f32,
                        "syncs": 3, "chain_tiles": (2 * K - 1) * chain}


def test_pack_spans():
    g = generators.barabasi_albert(300, 6, seed=4)
    with obs.recording() as rec:
        dg = best_device_pack(g, device="cpu")
    (p,) = rec.take()
    assert (p.name, p.kind, p.entry) == ("pack", obs.HOST, None)
    names = [c.name for c in p.children]
    assert names[0] == "build_levels"
    assert names[1:] == ["to_device"] * (len(dg.levels) + 1)
    assert [c.kind for c in p.children] == (
        [obs.HOST] + [obs.DEVICE] * (len(dg.levels) + 1))


def test_table(ba):
    _, roots = _recorded(ba, "expm_action_df")
    text = obs.table(roots)
    lines = text.splitlines()
    assert lines[0].split() == ["stage", "kind", "calls", "host", "ms",
                                "self", "ms", "card", "ms"]
    assert lines[1].split()[:3] == ["query", "sync", "1"]
    assert lines[2].split()[:3] == ["start", "device", "1"]
    assert lines[-1].startswith("counters: d2h_bytes=")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: card time and launch counts")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["summary_device", "expm_action_df"])
def test_card_times_and_launch_counts(card, case):
    g = generators.barabasi_albert(20000, 8, seed=4)
    dg = best_device_pack(g, device=card)
    entry, kw, _ = CASES[case]
    kw = dict(kw, k=30)
    entry(g, dg=dg, **kw)  # builds and loads the kernel library
    torch.cuda.synchronize()
    with obs.recording() as rec:
        out = entry(g, dg=dg, **kw)
    (q,) = rec.take()
    k, levels = kw["k"], len(dg.levels)
    if case == "summary_device":
        assert q.counts["launches"] == k * levels
        assert q.counts["launches_step"] == k
        assert np.all(np.isfinite(out.top_values))
    else:
        assert q.counts["launches_df"] == (2 * k - 1) * levels
        assert q.counts["launches_step_df"] == 2 * k - 1
        assert np.all(np.isfinite(out.ans))
    for s in q.walk():
        if s.kind == obs.HOST:
            assert s.device_ms is None
        else:
            assert s.device_ms is not None and s.device_ms >= 0.0
    assert sum(c.device_ms for c in q.children if c.kind != obs.HOST) \
        <= q.device_ms * 1.01 + 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("case, counts", [
    ("summary_device", {"lanczos": lambda k, L: k * (L + 1)}),
    ("expm_action_df", {"pass1": lambda k, L: k * (L + 1),
                        "pass2": lambda k, L: (k - 1) * (L + 1)})])
def test_card_trace_spans_hold_their_launches(card, tmp_path, case, counts):
    """In a card trace every stage is a user_annotation inside the query,
    and the kernels a device stage launched were launched inside it."""
    from torch.profiler import ProfilerActivity, profile

    g = generators.barabasi_albert(20000, 8, seed=4)
    dg = best_device_pack(g, device=card)
    entry, kw, stages = CASES[case]
    kw = dict(kw, k=30)
    entry(g, dg=dg, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        entry(g, dg=dg, **kw)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith(obs.PREFIX)}
    (query,) = [e for n, e in spans.items()
                if n.startswith(obs.PREFIX + "query[")]
    eigh_kind = obs.DEVICE if kw.get("eig_impl") == "device" else obs.HOST
    for stage in stages:
        kind = eigh_kind if stage == "eigh" else KINDS[stage]
        e = spans[f"{obs.PREFIX}{stage}[{kind}]"]
        assert query["ts"] <= e["ts"] <= e["ts"] + e["dur"] \
            <= query["ts"] + query["dur"]
    launch_at = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kernels = [launch_at[e["args"]["correlation"]] for e in events
               if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launch_at]

    def launched_in(name):
        e = spans[f"{obs.PREFIX}{name}[{obs.DEVICE}]"]
        return sum(e["ts"] <= t <= e["ts"] + e["dur"] for t in kernels)

    for name, want in counts.items():
        assert launched_in(name) >= want(kw["k"], len(dg.levels)), name
    host = [n for n in spans if n.endswith(f"[{obs.HOST}]")]
    assert host
    for name in host:
        e = spans[name]
        assert not any(e["ts"] <= t <= e["ts"] + e["dur"] for t in kernels)
