"""The rest of the single-device pipeline of the port against the JAX
package and the float64 oracle, on the CPU: the device eigensolve and the
fused summary, the one-decomposition k-sweep, f(A)·x, reorthogonalized
Lanczos, pipelined serving, spectral bounds and run_config.

Bars and why:
- ``eigh_device`` eigenvalues within 1e-12 of ``eigh_host`` (f64): two
  LAPACK solvers of one small matrix;
- the fused summary (``eig_impl="device"``, f32): the same top-k nodes as
  the port's host-eig path and the reference's fused path, values within
  1e-4 relative (an f32 eigensolve; the reference documents ~3e-5);
- ``expm_action_ks``: each answer within 1e-12 of the port's own
  ``expm_action(k=k)`` (the same decomposition prefix) and within 1e-10 of
  the reference's (f64; different dot order), ``diffs[k_max] == 0``;
- ``fa_action`` within 1e-10 of ``oracle.fa_action`` and of the
  reference (f64), and the reference's own overflow cases
  (tests/test_core.py:241-322) at their bars;
- reorthogonalized f64 alpha/beta within 1e-10 of the reference over all
  30 steps on the graph where the plain recurrence departs at j ~ 23;
- pipelined answers bit-identical to sequential ``expm_action``;
- ``spectral_bounds`` brackets lambda_max (tests/test_core.py:403);
- ``run_config`` equal to ``expm_action`` with the same knobs, and with
  ``shards=2`` within 1e-10 of the reference's ``run_config`` (f64; the
  sharded sums run in other orders);
- ``fmt="best"`` packs CPG up to ``CPG_MAX_N`` nodes and the ``auto``
  ELL/COO/HYB format past it, as the reference; the answer matches the
  oracle either way (1e-10, f64).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from tpu_lanczos.config import Config as RefConfig
from tpu_lanczos.core import pipeline as ref_pipeline
from tpu_lanczos.core.lanczos import lanczos as ref_lanczos
from tpu_lanczos.graphs import generators
from tpu_lanczos.kernels import formats as ref_formats
from tpu_lanczos_torch import (Config, expm_action, expm_action_ks,
                               expm_action_pipelined, expm_action_summary,
                               fa_action, run_config, spectral_bounds)
from tpu_lanczos_torch.core import pipeline, tridiag
from tpu_lanczos_torch.core.lanczos import lanczos, lanczos_init, lanczos_range
from tpu_lanczos_torch.eval import oracle
from tpu_lanczos_torch.kernels import cpg, formats

from _torch_cases import PACK_CASES, to_port_graph


def _ba3000():
    return generators.barabasi_albert(3000, 6, seed=11, use_native=False)


def test_eigh_device_matches_eigh_host():
    rng = np.random.default_rng(0)
    alpha, beta = rng.standard_normal(30), rng.random(29) + 0.1
    evals, evecs = tridiag.eigh_device(torch.from_numpy(alpha),
                                       torch.from_numpy(beta))
    want, _ = tridiag.eigh_host(alpha, beta)
    np.testing.assert_allclose(evals.numpy(), want, rtol=1e-12, atol=1e-12)
    t = tridiag.dense_tridiagonal(torch.from_numpy(alpha),
                                  torch.from_numpy(beta)).numpy()
    np.testing.assert_allclose(t @ evecs.numpy(), evecs.numpy() * want,
                               atol=1e-12)


def test_fused_summary_matches_host_path_and_reference():
    g_ref = _ba3000()
    g = to_port_graph(g_ref)
    s_d = expm_action_summary(g, k=30, topk=10, fmt="auto",
                              eig_impl="device", device="cpu")
    s_h = expm_action_summary(g, k=30, topk=10, fmt="auto", device="cpu")
    s_r = ref_pipeline.expm_action_summary(g_ref, k=30, topk=10,
                                           dtype="float32", fmt="auto",
                                           eig_impl="device")
    assert set(s_d.top_nodes) == set(s_h.top_nodes) == set(s_r.top_nodes)
    for other in (s_h, s_r):
        scale = np.exp(s_d.log_scale - other.log_scale)
        np.testing.assert_allclose(s_d.top_values * scale, other.top_values,
                                   rtol=1e-4)
        np.testing.assert_allclose(s_d.ans_norm * scale, other.ans_norm,
                                   rtol=1e-4)
    assert s_d.alpha.shape == (30,) and s_d.beta.shape == (29,)
    np.testing.assert_allclose(s_d.alpha, s_h.alpha, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="low_mem"):
        expm_action_summary(g, k=10, topk=5, eig_impl="device",
                            low_mem=True, device="cpu")


def test_expm_action_device_eig_matches_host_f64():
    g = to_port_graph(_ba3000())
    host = expm_action(g, k=30, dtype="float64", fmt="auto", device="cpu")
    dev = expm_action(g, k=30, dtype="float64", fmt="auto",
                      eig_impl="device", device="cpu")
    assert oracle.rel_error(dev.ans, host.ans) < 1e-12


def test_expm_action_ks_matches_single_runs_and_reference():
    g_ref = generators.uniform_random(1200, 4800, seed=9)
    g = to_port_graph(g_ref)
    ks = [5, 10, 20, 40]
    results, diffs = expm_action_ks(g, ks, dtype="float64", device="cpu")
    ref_results, _ = ref_pipeline.expm_action_ks(g_ref, ks, dtype="float64")
    for k in ks:
        single = expm_action(g, k=k, dtype="float64", fmt="auto",
                             device="cpu")
        assert oracle.rel_error(results[k].ans, single.ans) < 1e-12, k
        assert oracle.rel_error(results[k].ans, ref_results[k].ans) < 1e-10
        assert results[k].alpha.shape == (k,)
    assert diffs[40] == 0.0
    assert diffs[5] > diffs[20] >= 0.0


def test_expm_action_ks_log_scale_overflow_regime():
    g = to_port_graph(generators.barabasi_albert(3000, 12, seed=3,
                                                 use_native=False))
    results, diffs = expm_action_ks(g, [10, 30], dtype="float32",
                                    log_scale=True, device="cpu")
    for k in (10, 30):
        assert np.all(np.isfinite(results[k].ans))
        assert results[k].log_scale is not None
    assert diffs[30] == 0.0 and np.isfinite(diffs[10])


def test_fa_action_general_functions_match_oracle_and_reference():
    g_ref = generators.uniform_random(600, 2400, seed=11)
    g = to_port_graph(g_ref)
    lam_max = scipy.linalg.eigh(g_ref.to_scipy().toarray(),
                                eigvals_only=True)[-1]
    sigma = lam_max + 1.0
    for f in (lambda ev: np.exp(-0.5 * ev), np.cos,
              lambda ev: 1.0 / (sigma - ev)):
        res = fa_action(g, f, k=40, dtype="float64", device="cpu")
        assert res.log_scale is None
        want = oracle.fa_action(g, np.ones(g.n), 40, f)
        ref = ref_pipeline.fa_action(g_ref, f, k=40, dtype="float64")
        assert oracle.rel_error(res.ans, want) < 1e-10
        assert oracle.rel_error(res.ans, np.asarray(ref.ans)) < 1e-10


def test_fa_action_f64_coefficient_overflow_rescales():
    """f finite in f64 but f * x_norm * V[0, :] overflowing f64: the
    answer comes back finite and shifted, as the reference's does."""
    g_ref = generators.barabasi_albert(200, 3, seed=1)
    g = to_port_graph(g_ref)
    ev = np.linalg.eigvalsh(g.to_scipy().toarray())
    lo, hi = ev[0], ev[-1]

    def f(e):
        return np.exp(708.0 * (e - lo) / (hi - lo))  # f(hi) ~ 1.1e307

    r = fa_action(g, f, k=40, dtype="float64", device="cpu")
    assert np.all(np.isfinite(r.ans))
    assert r.log_scale is not None and r.log_scale > 700
    w, V = np.linalg.eigh(g.to_scipy().toarray())
    fe_scaled = np.exp(708.0 * (w - lo) / (hi - lo) - r.log_scale)
    ref_scaled = V @ (fe_scaled * (V.T @ np.ones(g.n)))
    assert oracle.rel_error(r.ans, ref_scaled) < 1e-8
    r_ref = ref_pipeline.fa_action(g_ref, f, k=40, dtype="float64")
    np.testing.assert_allclose(r.log_scale, r_ref.log_scale, rtol=1e-12)


def test_fa_action_f32_shift_and_pole():
    g = to_port_graph(generators.uniform_random(600, 2400, seed=11))
    evals, evecs = scipy.linalg.eigh(g.to_scipy().toarray())
    coeff = evecs.T @ np.ones(g.n)

    def f(ev):
        return np.exp(20.0 * ev)  # overflows f32, finite in f64

    want = evecs @ (f(evals) * coeff)
    res = fa_action(g, f, k=80, dtype="float32", device="cpu")
    assert res.log_scale is not None and np.all(np.isfinite(res.ans))
    got = res.ans.astype(np.float64) * np.exp(res.log_scale)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    with pytest.raises(FloatingPointError):
        with np.errstate(divide="ignore"):
            fa_action(g, lambda ev: 1.0 / (ev - ev[0]), k=80,
                      dtype="float64", device="cpu")


def test_reorthogonalized_lanczos_matches_reference():
    build, _ = PACK_CASES["ba2000"]
    g_ref = build()
    ref_dg = ref_formats.pack(g_ref, "auto")
    port_dg = formats.pack(to_port_graph(g_ref), "auto", device="cpu")
    x = np.ones(g_ref.n)
    st_ref = ref_lanczos(ref_dg, jnp.asarray(ref_dg.permute_in(
        x, np.float64)), 30, reorthogonalize=True)
    st = lanczos(port_dg, torch.from_numpy(port_dg.permute_in(
        x, np.float64)), 30, reorthogonalize=True)
    np.testing.assert_allclose(st.alpha.numpy(), np.asarray(st_ref.alpha),
                               rtol=1e-10)
    np.testing.assert_allclose(st.beta.numpy(), np.asarray(st_ref.beta),
                               rtol=1e-10)
    # and the basis stays orthonormal to f64 precision
    q = st.q_basis.numpy()
    np.testing.assert_allclose(q @ q.T, np.eye(30), atol=1e-12)


def test_lanczos_range_in_chunks_equals_lanczos():
    build, _ = PACK_CASES["ba2000"]
    dg = cpg.pack_cpg(to_port_graph(build()), device="cpu")
    x = dg.realmask.double()
    st = lanczos(dg, x, 20, reorthogonalize=True)
    carry, x_norm = lanczos_init(dg, x, 20)
    for j0, j1 in ((0, 7), (7, 15), (15, 20)):
        carry = lanczos_range(dg, carry, j0, j1, reorthogonalize=True)
    assert torch.equal(carry[3], st.alpha)
    assert torch.equal(carry[4][:19], st.beta)
    assert torch.equal(carry[2], st.q_basis)
    assert torch.equal(x_norm, st.x_norm)


def test_pipelined_bit_identical_to_sequential():
    g = to_port_graph(generators.barabasi_albert(400, 5, seed=3))
    rng = np.random.default_rng(0)
    xs = [None, rng.standard_normal(g.n), rng.random(g.n)]
    for log_scale in (False, True):
        piped = expm_action_pipelined(g, xs, k=25, log_scale=log_scale,
                                      device="cpu")
        assert len(piped) == 3
        for x, got in zip(xs, piped):
            want = expm_action(g, x, k=25, fmt="auto", log_scale=log_scale,
                               device="cpu")
            np.testing.assert_array_equal(got.ans, want.ans)
            np.testing.assert_array_equal(got.alpha, want.alpha)
            assert got.log_scale == want.log_scale


def test_spectral_bounds_brackets_lambda_max():
    import scipy.sparse.linalg as spl

    g = to_port_graph(generators.barabasi_albert(2000, 6, seed=11))
    ritz, upper = spectral_bounds(g, k=40, device="cpu")
    lam = float(spl.eigsh(g.to_scipy().astype(np.float64), k=1, which="LA",
                          return_eigenvectors=False)[0])
    assert abs(ritz - lam) / lam < 1e-3
    assert lam <= upper + 1e-6
    katz = fa_action(g, lambda ev: 1.0 / (upper + 1.0 - ev), k=30,
                     device="cpu")
    assert np.all(np.isfinite(katz.ans))


@pytest.mark.parametrize("fmt,layout", [("cpg", "slab"), ("coo", "auto")])
def test_run_config_equals_expm_action(fmt, layout):
    cfg = Config(krylov_dim=20, dtype="float64", fmt=fmt, cpg_sub=256,
                 cpg_layout=layout, n=3000, barabasi_deg=4, seed=2,
                 log_scale_output=True)
    res = run_config(cfg, device="cpu")
    g = generators.barabasi_albert(3000, 4, seed=2)
    dg = None
    if fmt == "cpg":
        dg = cpg.pack_cpg(to_port_graph(g), sub=256, layout=layout,
                          device="cpu")
        assert dg.layout == "slab"
    want = expm_action(to_port_graph(g), k=20, dtype="float64", fmt=fmt,
                       dg=dg, log_scale=True, device="cpu")
    np.testing.assert_array_equal(res.ans, want.ans)
    assert res.log_scale == want.log_scale
    # Config.shards: the row-sharded path on 2 CPU shards, against the
    # reference's run_config on 2 of its virtual CPU devices; the slab
    # layout is refused there with the reference's text
    cfg = dataclasses.replace(cfg, shards=2)
    if layout == "slab":
        with pytest.raises(ValueError) as got:
            run_config(cfg, device="cpu")
        with pytest.raises(ValueError) as ref_err:
            ref_pipeline.run_config(RefConfig(**dataclasses.asdict(cfg)))
        assert str(got.value) == str(ref_err.value)
        cfg = dataclasses.replace(cfg, cpg_layout="classic")
    ans, shift, _, sg = run_config(cfg, device="cpu")
    ref_ans, ref_shift, _, _ = ref_pipeline.run_config(
        RefConfig(**dataclasses.asdict(cfg)))
    assert sg.n_shards == 2 and shift is not None
    assert oracle.rel_error(ans * np.exp(shift - ref_shift), ref_ans) < 1e-10


def test_best_pack_past_the_cpg_cap(monkeypatch):
    g = to_port_graph(generators.uniform_random(500, 1500, seed=3))
    want = oracle.expm_action(g, np.ones(g.n), 20)
    assert isinstance(pipeline.best_device_pack(g, device="cpu"),
                      cpg.CPGGraph)
    monkeypatch.setattr(pipeline, "CPG_MAX_N", g.n - 1)
    dg = pipeline.best_device_pack(g, device="cpu")
    assert isinstance(dg, formats.DeviceGraph)
    assert dg.fmt in ("ell", "coo", "hyb")
    res = expm_action(g, k=20, dtype="float64", fmt="best", device="cpu")
    assert oracle.rel_error(res.ans, want) < 1e-10
