"""The port's two-pass Q-free mode (``lanczos_alphabeta``,
``lanczos_recombine``, ``low_mem=True``) against its stored-Q Lanczos,
the float64 oracle and the JAX package, on the CPU through the plain
SpMV, on the reference's pack carried over with ``port_pack``.

Bars and why:
- ``lanczos_alphabeta``'s alpha, beta and x_norm equal ``lanczos``'s bit
  for bit in float32 and float64: both run the one step ``lanczos_step``;
- ``lanczos_recombine`` within 1e-12 (float64) or 1e-5 (float32)
  relative of ``coeff @ Q``: the same q_j, summed one by one in place of
  a GEMV, so only the order of the sum differs;
- ``expm_action(low_mem=True, dtype="float64")`` below 1e-12 against the
  oracle (the stored-Q path's bar);
- ``expm_action_summary(low_mem=True)`` gives the same top-20 nodes as
  the stored-Q summary and as the reference's low_mem summary, with
  values within 1e-5 relative of the stored-Q summary's (float32);
- ``low_mem`` with ``reorthogonalize``, and a low_mem summary with
  ``eig_impl="device"``, raise ValueError as the reference does.
"""

import numpy as np
import pytest
import torch

from tpu_lanczos.core import pipeline as ref_pipeline
from tpu_lanczos.graphs.csr import CSRGraph
from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos_torch import expm_action, expm_action_summary
from tpu_lanczos_torch.core import expmv
from tpu_lanczos_torch.core.lanczos import (
    lanczos, lanczos_alphabeta, lanczos_recombine)
from tpu_lanczos_torch.eval import oracle

from _torch_cases import PACK_CASES, port_pack, to_port_graph

K = 30


@pytest.fixture(scope="module")
def ba():
    build, _ = PACK_CASES["ba2000"]
    g = build()
    ref = ref_cpg.pack_cpg(g)
    want = oracle.expm_action(to_port_graph(g), np.ones(g.n), K)
    return g, ref, port_pack(ref), want


def _x(port, dtype):
    x = np.random.default_rng(7).standard_normal(port.n)
    return torch.from_numpy(port.permute_in(x, dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_alphabeta_equals_stored_q_lanczos(ba, dtype):
    _, _, port, _ = ba
    x = _x(port, dtype)
    st = lanczos(port, x, K)
    alpha, beta, x_norm = lanczos_alphabeta(port, x, K)
    assert alpha.shape == beta.shape == (K,)
    assert torch.equal(alpha, st.alpha)
    assert torch.equal(beta[: K - 1], st.beta)
    assert torch.equal(x_norm, st.x_norm)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
def test_recombine_matches_coeff_at_q(ba, dtype, tol):
    _, _, port, _ = ba
    x = _x(port, dtype)
    st = lanczos(port, x, K)
    tmp, _ = expmv.host_coefficients(
        *expmv.fetch_tridiag(st.alpha, st.beta, st.x_norm))
    coeff = torch.from_numpy(tmp.astype(dtype))
    got = lanczos_recombine(port, x, coeff, K)
    want = coeff @ st.q_basis
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want)) < tol


def test_expm_action_low_mem_f64_matches_oracle(ba):
    g, _, port, want = ba
    pg = to_port_graph(g)
    res = expm_action(pg, k=K, dtype="float64", dg=port, low_mem=True)
    assert res.k == K and res.log_scale is None
    assert res.ans.dtype == np.float64 and res.ans.shape == (g.n,)
    assert res.beta.shape == (K - 1,)
    assert oracle.rel_error(res.ans, want) < 1e-12
    stored = expm_action(pg, k=K, dtype="float64", dg=port)
    np.testing.assert_array_equal(res.alpha, stored.alpha)
    np.testing.assert_array_equal(res.beta, stored.beta)
    scaled = expm_action(pg, k=K, dtype="float64", dg=port, low_mem=True,
                         log_scale=True)
    assert oracle.rel_error(scaled.full_ans(), want) < 1e-12


def test_summary_low_mem_matches_stored_q_and_reference(ba):
    g, ref, port, want = ba
    pg = to_port_graph(g)
    low = expm_action_summary(pg, k=K, topk=20, dg=port, low_mem=True)
    stored = expm_action_summary(pg, k=K, topk=20, dg=port)
    low_ref = ref_pipeline.expm_action_summary(
        g, k=K, topk=20, dtype="float32", fmt="cpg", spmv_impl="interpret",
        dg=ref, low_mem=True)
    assert set(low.top_nodes) == set(stored.top_nodes)
    assert set(low.top_nodes) == set(low_ref.top_nodes)
    assert set(low.top_nodes) == set(np.argsort(want)[-20:])
    np.testing.assert_allclose(low.top_values, stored.top_values, rtol=1e-5)
    np.testing.assert_array_equal(low.alpha, stored.alpha)
    assert low.log_scale == stored.log_scale
    np.testing.assert_allclose(low.ans_norm, stored.ans_norm, rtol=1e-5)


@pytest.mark.parametrize("entry,kw", [
    ("expm_action", dict(reorthogonalize=True)),
    ("expm_action_summary", dict(eig_impl="device")),
])
def test_low_mem_rejects_like_reference(entry, kw):
    g_ref = CSRGraph.from_edges(4, np.array([[0, 1], [1, 2], [2, 3]]))
    port_fn = {"expm_action": expm_action,
               "expm_action_summary": expm_action_summary}[entry]
    with pytest.raises(ValueError, match="low_mem"):
        port_fn(to_port_graph(g_ref), k=2, device="cpu", low_mem=True, **kw)
    with pytest.raises(ValueError, match="low_mem"):
        getattr(ref_pipeline, entry)(g_ref, k=2, low_mem=True, **kw)
