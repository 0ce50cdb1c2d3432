"""Lanczos and the e^A.x pipeline of the port against the JAX package
and the float64 oracle, on the same pack (the reference's, carried over
with ``from_numpy``), on the CPU through the plain SpMV.

Bars and why:
- f64 alpha/beta within rtol 1e-10 of the reference over the first
  K_ORTHO steps: torch's dot and XLA's dot reduce in different orders.
  Past those steps the recurrence (no reorthogonalization) has lost
  orthogonality and amplifies the last-bit differences about tenfold a
  step, to O(1) by j ~ 23 on this graph in BOTH packages; there the bar
  is the top Ritz value (lambda_max, which sets e^A.x), within 1e-12;
- f64 e^A.x within 1e-12 of the oracle (the reference's bar,
  tests/test_cpg.py:58-62);
- f32 e^A.x within 1e-4 of the f64 oracle, and the same top-20 nodes as
  the reference's summary;
- log-scale shift on K120 within 1e-5 relative of the exact
  lambda_max = 119, and within 2e-5 of the reference's, whose own f32
  shift is 1.5e-5 off 119 (x = 1 spans an invariant subspace there, so
  every later Lanczos direction is f32 rounding noise).
"""

import numpy as np
import pytest
import torch

from tpu_lanczos.core import pipeline as ref_pipeline
from tpu_lanczos.core.lanczos import lanczos as ref_lanczos
from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos.graphs.csr import CSRGraph
from tpu_lanczos_torch import expm_action, expm_action_summary
from tpu_lanczos_torch.core.lanczos import lanczos
from tpu_lanczos_torch.core.tridiag import eigh_host
from tpu_lanczos_torch.eval import oracle

from _torch_cases import PACK_CASES, port_pack, to_port_graph

K = 30
K_ORTHO = 15  # steps before orthogonality loss on BA n=2000, m=8


@pytest.fixture(scope="module")
def ba():
    build, _ = PACK_CASES["ba2000"]
    g = build()
    ref = ref_cpg.pack_cpg(g)
    want = oracle.expm_action(to_port_graph(g), np.ones(g.n), K)
    return g, ref, port_pack(ref), want


@pytest.mark.parametrize("start", ["ones", "random"])
def test_lanczos_f64_alpha_beta_match_reference(ba, start):
    import jax.numpy as jnp

    g, ref, port, _ = ba
    xr = (np.ones(g.n) if start == "ones"
          else np.random.default_rng(3).standard_normal(g.n))
    st_ref = ref_lanczos(ref, jnp.asarray(ref.permute_in(xr, np.float64)), K,
                         spmv_impl="interpret")
    st = lanczos(port, torch.from_numpy(port.permute_in(xr, np.float64)), K)
    assert st.k == K and st.beta.shape == (K - 1,)
    assert st.q_basis.shape == (K, port.n_pad)
    alpha_ref, beta_ref = np.asarray(st_ref.alpha), np.asarray(st_ref.beta)
    np.testing.assert_allclose(st.alpha.numpy()[:K_ORTHO],
                               alpha_ref[:K_ORTHO], rtol=1e-10)
    np.testing.assert_allclose(st.beta.numpy()[:K_ORTHO],
                               beta_ref[:K_ORTHO], rtol=1e-10)
    np.testing.assert_allclose(float(st.x_norm), float(st_ref.x_norm),
                               rtol=1e-14)
    ritz = eigh_host(st.alpha.numpy(), st.beta.numpy())[0]
    ritz_ref = eigh_host(alpha_ref, beta_ref)[0]
    np.testing.assert_allclose(ritz[-1], ritz_ref[-1], rtol=1e-12)


def test_expm_action_f64_matches_oracle(ba):
    g, _, port, want = ba
    res = expm_action(to_port_graph(g), k=K, dtype="float64", dg=port)
    assert res.k == K and res.log_scale is None
    assert res.ans.dtype == np.float64 and res.ans.shape == (g.n,)
    assert oracle.rel_error(res.ans, want) < 1e-12
    # an explicit all-ones x gives the same answer as the x=None start
    res1 = expm_action(to_port_graph(g), np.ones(g.n), k=K,
                       dtype="float64", dg=port)
    np.testing.assert_array_equal(res1.ans, res.ans)


def test_expm_action_f32_matches_oracle_and_reference_topk(ba):
    g, ref, port, want = ba
    res = expm_action(to_port_graph(g), k=K, dtype="float32", dg=port,
                      device="cpu")
    assert res.ans.dtype == np.float32
    assert oracle.rel_error(res.ans.astype(np.float64), want) < 1e-4
    summ = expm_action_summary(to_port_graph(g), k=K, topk=20, dg=port)
    summ_ref = ref_pipeline.expm_action_summary(
        g, k=K, topk=20, dtype="float32", fmt="cpg", spmv_impl="interpret",
        dg=ref)
    assert set(summ.top_nodes) == set(summ_ref.top_nodes)
    assert set(summ.top_nodes) == set(np.argsort(want)[-20:])
    np.testing.assert_allclose(summ.top_values, summ_ref.top_values,
                               rtol=1e-4)
    np.testing.assert_allclose(summ.log_scale, summ_ref.log_scale,
                               rtol=1e-5)
    assert np.all(np.diff(summ.top_values) <= 0)  # descending


def test_log_scale_avoids_f32_overflow_like_reference():
    """K120 has lambda_max = 119: e^119 overflows f32.  The shifted answer
    stays finite, and its shift is lambda_max to f32 accuracy and close to
    the reference's (both run CPG packs; bars in the module docstring)."""
    iu, ju = np.triu_indices(120, k=1)
    edges = np.stack([iu, ju], axis=1)
    g_ref = CSRGraph.from_edges(120, edges)
    g = to_port_graph(g_ref)
    res = expm_action(g, k=K, dtype="float32", log_scale=True, device="cpu")
    assert np.all(np.isfinite(res.ans))
    assert res.log_scale is not None and res.log_scale > 100
    want = ref_pipeline.expm_action(g_ref, k=K, dtype="float32",
                                    log_scale=True, fmt="cpg",
                                    spmv_impl="interpret")
    np.testing.assert_allclose(res.log_scale, 119.0, rtol=1e-5)
    np.testing.assert_allclose(res.log_scale, want.log_scale, rtol=2e-5)
    # the unguarded path really does overflow on this graph
    raw = expm_action(g, k=K, dtype="float32", device="cpu")
    assert not np.all(np.isfinite(raw.ans))


def test_k_clamps_to_n_minus_1():
    # a path with one chord: no two nodes tie in e^A.1
    path = np.stack([np.arange(9), np.arange(1, 10)], axis=1)
    g = to_port_graph(CSRGraph.from_edges(
        10, np.concatenate([path, [[0, 2]]])))
    res = expm_action(g, k=50, dtype="float64", device="cpu")
    assert res.k == 9 and res.alpha.shape == (9,) and res.beta.shape == (8,)
    want = oracle.expm_action(g, np.ones(10), 50)
    assert oracle.rel_error(res.ans, want) < 1e-12
    summ = expm_action_summary(g, k=50, topk=3, dtype="float64",
                               device="cpu")
    assert summ.k == 9
    assert set(summ.top_nodes) == set(np.argsort(want)[-3:])


@pytest.mark.parametrize("kw,item", [
    (dict(fmt="auto"), "queue 1 item 5"),
    (dict(fmt="ell"), "queue 1 item 5"),
    (dict(eig_impl="device"), "queue 1 items 7 and 8"),
    (dict(fmt="coo"), "queue 1 item 5"),
    (dict(reorthogonalize=True), "queue 1 item 6"),
])
def test_unported_arguments_raise(kw, item):
    """Each argument that raised NotImplementedError until its ROADMAP
    item (``item``) was ported now runs and gives the default path's
    answer (f32: within 1e-5) and top nodes."""
    g = to_port_graph(CSRGraph.from_edges(
        4, np.array([[0, 1], [1, 2], [2, 3], [0, 2]])))
    base = expm_action(g, k=3, device="cpu")
    res = expm_action(g, k=3, device="cpu", **kw)
    np.testing.assert_allclose(res.ans, base.ans, rtol=1e-5, err_msg=item)
    if "reorthogonalize" not in kw:
        summ = expm_action_summary(g, k=3, topk=2, device="cpu", **kw)
        want = expm_action_summary(g, k=3, topk=2, device="cpu")
        assert set(summ.top_nodes) == set(want.top_nodes), item
