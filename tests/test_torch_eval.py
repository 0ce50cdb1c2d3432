"""The port's eval harness (tpu_lanczos_torch/eval/) against the JAX
package's (tpu_lanczos/eval/) on the CPU, on the same numpy-seeded
inputs: the suite's configs, graph builds and cache keys, the sweeps,
the profiling helpers, the stage breakdown, fused serving, pack_truth,
stochastic_bench's output file, and every module run as ``python -m``
without jax.  The df64 modules are in tests/test_torch_eval_df.py."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_cases  # noqa: F401  (one torch thread a worker)
from tpu_lanczos.core.pipeline import (
    expm_action as ref_expm_action, expm_action_summary as ref_summary)
from tpu_lanczos.eval import bench_suite as ref_suite
from tpu_lanczos.eval import sweeps as ref_sweeps
from tpu_lanczos.graphs import generators as ref_gen
from tpu_lanczos.kernels.cpg import pack_cpg as ref_pack_cpg
from tpu_lanczos_torch.eval import (
    bench_suite, fused_serving, pack_truth, profiling, stage_breakdown,
    stochastic_bench, sweeps)
from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.kernels.cpg import pack_cpg
from tpu_lanczos_torch.utils import ROOT_DIR

EVAL_MODULES = ("profiling", "bench_suite", "stage_breakdown",
                "fused_serving", "accuracy_gpu", "sweeps", "df_sweep",
                "df_accuracy_suite", "europe_df64", "stochastic_bench",
                "pack_truth", "route_sweep")

# a tiny config of each of the suite's six generator kinds
TINY = {
    "barabasi": dict(name="t_ba", kind="barabasi", n=300, m=3,
                     pack=dict(sub=256, theta=40)),
    "uniform": dict(name="t_un", kind="uniform", n=300, e=900,
                    pack=dict(sub=128, order="degree")),
    "stencil": dict(name="t_st", kind="stencil", side=12),
    "stencil3d": dict(name="t_s3", kind="stencil3d", nx=5, ny=4, nz=3),
    "rmat": dict(name="t_rm", kind="rmat", n=256, e=1000,
                 pack=dict(sub=128, theta=30)),
    "clique": dict(name="t_cl", kind="clique", n=300, papers=200,
                   pack=dict(sub=128)),
}


def _same_csr(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


def _port_graph(g):
    return CSRGraph(indptr=g.indptr, indices=g.indices, n=g.n)


def _tree_digest(path):
    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(path)):
        dirs.sort()
        for f in sorted(files):
            p = os.path.join(root, f)
            h.update(p.encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def test_configs_equal_reference():
    assert len(bench_suite.CONFIGS) == len(ref_suite.CONFIGS)
    for mine, ref in zip(bench_suite.CONFIGS, ref_suite.CONFIGS):
        assert mine == ref
    assert bench_suite.ORACLE_N_MAX == ref_suite.ORACLE_N_MAX


@pytest.mark.parametrize("kind", list(TINY))
def test_build_equals_reference(kind, tmp_path):
    cfg = TINY[kind]
    mine = bench_suite.build(cfg, str(tmp_path / "port"))
    ref = ref_suite.build(cfg, str(tmp_path / "ref"))
    _same_csr(mine, ref)
    # each package wrote one graph cache file, under the same name
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "ref")
    # and the cached read gives the same graph again
    _same_csr(bench_suite.build(cfg, str(tmp_path / "port")), ref)


def test_truncated_graph_cache_is_rebuilt(tmp_path):
    cfg = TINY["stencil"]
    g = bench_suite.build(cfg, str(tmp_path))
    path = bench_suite.graph_cache_path(cfg, str(tmp_path))
    with open(path, "rb") as f:
        head = f.read(100)
    with open(path, "wb") as f:
        f.write(head)
    _same_csr(bench_suite.build(cfg, str(tmp_path)), g)
    with np.load(path) as z:  # overwritten with a whole file
        assert int(z["n"]) == g.n


def test_cache_paths_match_reference(tmp_path):
    d = str(tmp_path)
    for cfg in bench_suite.CONFIGS:
        for k in (50, 100):
            assert (bench_suite.oracle_cache_path(cfg, k, d)
                    == ref_suite.oracle_cache_path(cfg, k, d))
        assert (bench_suite.pack_cache_path(cfg, d)
                == ref_suite.pack_cache_path(cfg, d))
    # bench.py's flagship-graph cache name, native generator
    g = bench_suite.load_graph(500, 3, 0, d)
    assert os.listdir(d) == ["ba_500_3_0_native.npz"]
    _same_csr(g, ref_gen.barabasi_albert(500, 3, seed=0, use_native=True))
    _same_csr(bench_suite.load_graph(500, 3, 0, d), g)


def test_pack_cache_round_trip(tmp_path):
    cfg = TINY["barabasi"]
    g = bench_suite.build(cfg, str(tmp_path))
    dg, pack_s = bench_suite.load_or_pack(cfg, g, str(tmp_path), "cpu")
    again, pack_s2 = bench_suite.load_or_pack(cfg, g, str(tmp_path), "cpu")
    assert pack_s2 == pack_s > 0  # the original pack's seconds, stored
    assert again.t_reals == dg.t_reals and again.sub == 256
    for a, b in zip(dg.levels, again.levels):
        for key in ("l1", "l2", "s_ids", "starts", "counts"):
            assert torch.equal(a[key], b[key])
    ref = ref_pack_cpg(ref_suite.build(cfg, str(tmp_path / "ref")),
                       **cfg["pack"])
    assert dg.total_tiles == ref.total_tiles


def test_run_one_row(tmp_path, capsys, monkeypatch):
    cfg = TINY["barabasi"]
    row = bench_suite.run_one(cfg, k=20, reps=1, cache_dir=str(tmp_path),
                              device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(row))
    # the reference's keys, with ns_per_tile in place of the v5e cycles
    ref_keys = {"name", "n", "nnz", "fmt", "k", "build_s", "pack_s",
                "compile_s", "lanczos_s", "lanczos_s_single", "protocol",
                "gnnz_per_s", "roofline_pct", "tiles", "rel_err", "err_ref",
                "err_s", "analog", "ref_s", "vs_ref"}
    assert ref_keys <= set(row) and "ns_per_tile" in row
    assert "cyc_per_tile" not in row
    assert row["fmt"] == "CPGGraph" and row["device"] == "cpu"
    assert row["protocol"]["timing"] == "host_wall"
    dg = pack_cpg(bench_suite.build(cfg, str(tmp_path)), device="cpu",
                  **cfg["pack"])
    L, nb = len(dg.levels), dg.n_bcast
    assert row["levels_checked"] == {"plain": L + (L + nb), "comp": L - nb,
                                     "df": L}
    assert row["tiles"] == dg.total_tiles
    assert row["err_ref"] == "oracle_f64" and row["rel_err"] < 1e-5
    # the df64 self-check branch past ORACLE_N_MAX
    monkeypatch.setattr(bench_suite, "ORACLE_N_MAX", 0)
    row = bench_suite.run_one(cfg, k=20, reps=1, cache_dir=str(tmp_path),
                              device="cpu")
    assert row["err_ref"] == "df64_selfcheck" and row["rel_err"] < 1e-5


def test_k_sweep_matches_reference():
    kw = dict(n=400, edges=1200, ks=(5, 15, 30))
    mine = sweeps.k_sweep(**kw, dtype="float64", device="cpu")
    ref = ref_sweeps.k_sweep(**kw, dtype="float64")
    assert [r["k"] for r in mine] == [5, 15, 30]
    for a, b in zip(mine, ref):
        assert a["k"] == b["k"]
        assert abs(a["rel_err"] - b["rel_err"]) <= 1e-12
    assert mine[-1]["rel_err"] < 1e-9 < mine[0]["rel_err"]


def test_pack_sweep_matches_reference():
    kw = dict(n=5000, m=6, thetas=(40,), subs=(128, 256))
    mine = sweeps.pack_sweep(**kw, device="cpu")
    ref = ref_sweeps.pack_sweep(**kw)
    assert len(mine) == len(ref) == 2
    for a, b in zip(mine, ref):
        assert (a["theta"], a["sub"], a["tiles"]) == (
            b["theta"], b["sub"], b["tiles"])
        assert a["fill_pct"] == pytest.approx(b["fill_pct"], abs=0.006)
        assert "lanczos_s" not in a  # timed on a GPU only


def test_stage_timer():
    t = profiling.StageTimer()
    x = torch.ones((256, 256))
    with t.stage("mm", x) as st:
        y = x @ x
        st.fence(y)
    with t.stage("sum", y) as st:
        z = y.sum()
        st.fence({"z": z, "parts": [y]})
    assert set(t.stages) == {"mm", "sum"}
    assert "total" in t.table()
    assert all(v > 0 for v in t.stages.values())


def test_timed():
    x = torch.ones((128, 128))
    out, dt = profiling.timed(lambda a: a + 1, x, reps=2)
    assert dt >= 0
    np.testing.assert_allclose(out.numpy(), 2.0)


def test_trace_writes_chrome_trace(tmp_path):
    x = torch.ones((64, 64))
    with profiling.trace(str(tmp_path)) as prof:
        (x @ x).sum()
    assert prof is not None
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.fixture(scope="module")
def ba300():
    g = ref_gen.barabasi_albert(300, 3, seed=5, use_native=False)
    return g, _port_graph(g)


def test_breakdown_matches_reference(ba300):
    g_ref, g = ba300
    k, reps = 20, 1
    row, ans, shift = stage_breakdown.breakdown(
        g, None, k, reps, "cpu", name="t", dtype="float64")
    ref = ref_expm_action(g_ref, None, k, dtype="float64", log_scale=True)
    a = ans * np.exp(shift - ref.log_scale)
    rel = np.linalg.norm(a - ref.ans) / np.linalg.norm(ref.ans)
    assert rel < 1e-10
    assert set(row["stages_s"]) == set(stage_breakdown.STAGES)
    assert row["staged_vs_expm_rel"] < 1e-14
    assert row["lanczos_runs"] == 1 + 2 * reps + 3 * 3
    assert row["ref_cuda_whole_s"] is None and row["whole_s"] > 0
    assert row["pipelined_s"] > 0 and row["dtype"] == "float64"


def test_fused_serving_topk_matches_reference(ba300):
    g_ref, g = ba300
    dg = pack_cpg(g, device="cpu")
    row = fused_serving.run(g, dg, k=20, topk=10, reps=1)
    ref = ref_summary(g_ref, k=20, topk=10, eig_impl="host")
    assert set(row["top_nodes"]) == set(ref.top_nodes.tolist())
    assert row["topk_node_overlap"] == "10/10"
    assert row["topk_value_rel_diff"] < 1e-3
    assert "includes_compile" not in row


def test_pack_truth_tiles_match_reference(tmp_path):
    cfg = TINY["rmat"]
    summary = pack_truth.run(cfg, warm_reps=1, cache_dir=str(tmp_path))
    ref = ref_pack_cpg(ref_suite.build(cfg, str(tmp_path / "ref")),
                       **cfg["pack"])
    assert summary["tiles"] == ref.total_tiles
    assert summary["cold_wall_s"] > 0 and summary["warm_wall_s"] > 0


def test_stochastic_bench_writes_only_out(tmp_path, capsys):
    results = os.path.join(ROOT_DIR, "bench_results")
    before = _tree_digest(results)
    out = tmp_path / "rows.jsonl"
    cache = tmp_path / "cache"
    # m=1 (a tree) keeps the plain CPU SpMV's ~3,600 calls short
    rc = stochastic_bench.main(["300", "1", "--out", str(out), "--device",
                                "cpu", "--cache", str(cache)])
    assert rc == 0
    assert _tree_digest(results) == before
    assert os.listdir(cache) == ["ba_300_1_0_native.npz"]
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert rows == printed and len(rows) == 5
    assert [r["study"] for r in rows] == [
        "estrada_bn0k_a", "estrada_bn0k_b", "estrada_bn0k_plain",
        "estrada_bn0k_seed_agreement", "subgraph_bn0k"]
    agree = rows[3]
    assert agree["budget_3sigma"] == pytest.approx(3 * np.hypot(
        rows[0]["rel_stderr"], rows[1]["rel_stderr"]))
    assert agree["ok"] == (agree["rel_diff"] <= agree["budget_3sigma"])


RUN_AS_MAIN = r"""
import json, runpy, sys
report = {}
for name in sys.argv[1:]:
    sys.argv = [name, "--help"]
    try:
        runpy.run_module("tpu_lanczos_torch.eval." + name,
                         run_name="__main__")
        code = 0
    except SystemExit as e:
        code = e.code or 0
    report[name] = dict(code=code, jax="jax" in sys.modules,
                        ref="tpu_lanczos" in sys.modules)
print("REPORT" + json.dumps(report))
"""


@pytest.fixture(scope="module")
def main_report():
    proc = subprocess.run(
        [sys.executable, "-c", RUN_AS_MAIN, *EVAL_MODULES], cwd=ROOT_DIR,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("REPORT"))
    return json.loads(line[len("REPORT"):])


@pytest.mark.parametrize("name", EVAL_MODULES)
def test_module_runs_as_main_without_jax(name, main_report):
    assert main_report[name] == dict(code=0, jax=False, ref=False)
