"""The port's df64 eval modules against the JAX package's on the CPU:
accuracy_gpu (the reference's accuracy_tpu), df_sweep, both branches of
df_accuracy_suite.run_one, and europe_df64's checkpoint resume.  The JAX
side runs its Pallas kernels in interpret mode, the port's wrappers their
plain versions; the df64 answers agree to 1e-12 and the f32 ones to
1e-5 (relative)."""

import numpy as np
import pytest

import _torch_cases  # noqa: F401  (one torch thread a worker)
from tpu_lanczos.core.lanczos_df import (
    expm_action_df as ref_expm_action_df,
    expm_action_ks_df as ref_expm_action_ks_df)
from tpu_lanczos.core.pipeline import (
    expm_action as ref_expm_action, expm_action_ks as ref_expm_action_ks)
from tpu_lanczos.eval import bench_suite as ref_suite
from tpu_lanczos.eval import df_accuracy_suite as ref_df_suite
from tpu_lanczos.eval import oracle as ref_oracle
from tpu_lanczos.graphs import generators as ref_gen
from tpu_lanczos.kernels.cpg import pack_cpg as ref_pack_cpg
from tpu_lanczos_torch.core.lanczos_df import expm_action_df
from tpu_lanczos_torch.eval import (
    accuracy_gpu, bench_suite, df_accuracy_suite, df_sweep, europe_df64)
from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.kernels.cpg import pack_cpg

K = 20
STENCIL = dict(name="t_st", kind="stencil", side=12)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def ba():
    g_ref = ref_gen.barabasi_albert(256, 3, seed=4, use_native=False)
    g = CSRGraph(indptr=g_ref.indptr, indices=g_ref.indices, n=g_ref.n)
    return g_ref, g, pack_cpg(g, sub=128, device="cpu")


def test_accuracy_gpu_matches_reference(ba):
    g_ref, g, dg = ba
    ref, shift = ref_oracle.expm_action_shifted(g_ref, np.ones(g.n), K)
    # given the oracle answer (as chip_smoke passes it), run() skips its own
    rows = accuracy_gpu.run(g, dg, K, ref=ref, shift=shift)
    assert [r["pipeline"] for r in rows] == ["f32_two_pass",
                                             "df64_two_pass"]
    assert rows[0]["oracle_s"] is None and rows[0]["backend"] == "cpu"
    # the reference's accuracy_tpu pipelines on the same graph (its f32
    # one through the XLA format: a shorter interpret-mode compile, and
    # the f32 bar is 1e-5)
    cg_ref = ref_pack_cpg(g_ref, sub=128)
    r32 = ref_expm_action(g_ref, None, K, low_mem=True, log_scale=True)
    err32 = ref_oracle.rel_error(
        np.asarray(r32.ans, np.float64) * np.exp(r32.log_scale - shift), ref)
    rdf = ref_expm_action_df(g_ref, None, K, dg=cg_ref, log_scale=True)
    errdf = ref_oracle.rel_error(rdf.ans * np.exp(rdf.log_scale - shift),
                                 ref)
    assert abs(rows[0]["rel_err"] - err32) <= 1e-5
    assert abs(rows[1]["rel_err"] - errdf) <= 1e-12
    assert rows[0]["rel_err"] < 1e-5 and rows[1]["rel_err"] < 1e-12
    # and the df64 answer itself
    mine = expm_action_df(g, None, K, dg=dg, log_scale=True)
    assert _rel(mine.ans * np.exp(mine.log_scale - rdf.log_scale),
                rdf.ans) < 1e-12


def test_df_sweep_matches_reference():
    kw = dict(n=300, e=500, seed=1234)
    ks = [5, 10, 20, 30]
    rows = df_sweep.run(**kw, ks=ks, device="cpu")
    assert [r["k"] for r in rows] == ks
    g = ref_gen.uniform_random(kw["n"], kw["e"], seed=kw["seed"])
    truth = ref_oracle.expm_action_dense(g, np.ones(g.n))
    cg = ref_pack_cpg(g)
    res_df, diffs_df = ref_expm_action_ks_df(g, ks, dg=cg)
    res_f32, _ = ref_expm_action_ks(g, ks, dg=cg)
    for row in rows:
        k = row["k"]
        assert abs(row["rel_err_df64"] - _rel(res_df[k].ans, truth)) <= 1e-12
        assert abs(row["rel_err_f32"] - _rel(
            np.asarray(res_f32[k].ans, np.float64), truth)) <= 1e-5
        assert abs(row["diff_vs_kmax_df64"] - diffs_df[k]) <= 1e-12
    assert rows[-1]["rel_err_df64"] < 1e-12 < rows[0]["rel_err_df64"]


def test_df_accuracy_suite_oracle_branch(tmp_path):
    mine = df_accuracy_suite.run_one(STENCIL, K, str(tmp_path / "port"),
                                     device="cpu")
    ref = ref_df_suite.run_one(STENCIL, K, str(tmp_path / "ref"))
    assert mine["err_ref"] == ref["err_ref"] == "oracle_f64_shifted"
    assert abs(mine["df64_rel_err"] - ref["df64_rel_err"]) <= 1e-12
    assert mine["df64_rel_err"] < 1e-12
    # the oracle answer is cached under the reference's key
    assert (tmp_path / "port" / "oracle_t_st_kindstencil_side12_k20_s.npz"
            ).exists()


def test_df_accuracy_suite_self_branch(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_suite, "ORACLE_N_MAX", 0)
    mine = df_accuracy_suite.run_one(STENCIL, K, str(tmp_path), device="cpu")
    assert mine["err_ref"] == f"df64_self_k{K + 10}"
    g = ref_suite.build(STENCIL, str(tmp_path / "ref"))
    _, diffs = ref_expm_action_ks_df(g, [K, K + 10], dg=ref_pack_cpg(g),
                                     log_scale=True)
    assert abs(mine["df64_rel_err"] - diffs[K]) <= 1e-12


def test_europe_df64_resume_bit_identical(tmp_path, capsys):
    rows = europe_df64.run(side=20, k=K, cache_dir=str(tmp_path),
                           ckpt_chunk=8, device="cpu")
    assert [r["study"] for r in rows] == [
        "europe_df64_whole", "europe_df64_self_consistency",
        "europe_df64_checkpoint"]
    assert rows[0]["n"] == 400 and np.isfinite(rows[0]["ans_norm"])
    assert rows[1]["rel_diff"] < 1e-12
    ck = rows[2]
    assert ck["resume_from_j"] == 16 and ck["resume_bit_identical"] is True
    assert len(capsys.readouterr().out.strip().splitlines()) == 3
    # the snapshots are removed; the graph and pack caches stay
    assert not [p for p in tmp_path.iterdir() if "europe_df64_ck" in p.name]
