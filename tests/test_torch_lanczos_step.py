"""The Lanczos step outside the SpMV (``kernels/lanczos_step.py``, rows 5
and 5c) on the CPU, where the wrappers run their plain versions, against
the JAX package, on seeded numpy inputs.

Bars and why:
- ``lanczos_step_ref`` in float64 against the reference's loop body
  (``tpu_lanczos/core/lanczos.py:84-96`` through ``lanczos_range`` for
  one iteration, jax x64, the same ELL graph), with and without
  reorthogonalization: alpha, beta and q_{j+1} within 1e-14 relative
  (XLA's dot and torch's sum in other orders);
- ``lanczos_step_df_ref`` against ``tpu_lanczos.core.df64``'s df_dot,
  df_sub/df_add/df_scale, df_norm and df_div composed as the reference's
  ``_body_core`` does after its SpMV, on the same (hi, lo) inputs: alpha,
  beta and q_{j+1} within 1e-13 (the tree's error terms summed in
  another order, df64.py:112-115);
- breakdown (v' = 0) gives beta = 0 and q_{j+1} = 0 exactly in both rows;
- the dispatch: a CPU tensor runs the plain version (no launch counted),
  a ``meta`` tensor raises;
- through the new step, ``lanczos_alphabeta`` == ``lanczos`` and a df64
  checkpoint resume == the one-shot pass, bit for bit, every step one
  call of the step function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.core import df64 as ref_df
from tpu_lanczos.core.lanczos import lanczos_range as ref_lanczos_range
from tpu_lanczos.graphs import generators
from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos.kernels import formats as ref_formats
from tpu_lanczos_torch.core import checkpoint, lanczos_df
from tpu_lanczos_torch.core.lanczos import (
    lanczos, lanczos_alphabeta, lanczos_recombine)
from tpu_lanczos_torch.kernels import formats as port_formats
from tpu_lanczos_torch.kernels import lanczos_step as ls
from tpu_lanczos_torch.kernels.spmv import spmv

from _torch_cases import port_pack, to_port_graph

J, K = 3, 8


@pytest.fixture(scope="module")
def ell():
    g = generators.barabasi_albert(600, 5, seed=4, use_native=False)
    return (ref_formats.pack(g, fmt="ell"),
            port_formats.pack(to_port_graph(g), fmt="ell", device="cpu"))


def _carry(n, seed):
    """q_j (normalized), q_{j-1}, a (K, n) basis with row j = q_j and
    rows past j zero, and the coefficient buffers at step J."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(n)
    q /= np.linalg.norm(q)
    qp = rng.standard_normal(n) / np.sqrt(n)
    basis = np.linalg.qr(rng.standard_normal((n, K)))[0].T.copy()
    basis[J] = q
    basis[J + 1:] = 0.0
    alpha = np.zeros(K)
    beta = np.zeros(K)
    beta[: J] = rng.uniform(0.5, 2.0, J)
    alpha[: J] = rng.uniform(-1.0, 1.0, J)
    return q, qp, basis, alpha, beta


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("reorth", [False, True])
def test_step_ref_matches_reference_body(ell, reorth):
    ref_dg, port_dg = ell
    n = port_dg.n_pad
    q, qp, basis, alpha, beta = _carry(n, 11)
    carry = tuple(jnp.asarray(a) for a in (q, qp, basis, alpha, beta))
    q_next_r, _, _, alpha_r, beta_r = ref_lanczos_range(
        ref_dg, carry, J, J + 1, reorthogonalize=reorth)
    t = [torch.from_numpy(a.copy()) for a in (q, qp, basis, alpha, beta)]
    qt, qpt, basis_t, alpha_t, beta_t = t
    q_next = ls.lanczos_step_ref(spmv(port_dg, qt), qt, qpt, alpha_t, beta_t,
                                 J, q_basis=basis_t if reorth else None)
    assert _rel(alpha_t[J], alpha_r[J]) < 1e-14
    assert _rel(beta_t[J], beta_r[J]) < 1e-14
    assert _rel(q_next.numpy(), q_next_r) < 1e-14
    # the buffers' other slots untouched
    assert torch.equal(alpha_t[:J], torch.from_numpy(alpha[:J]))
    assert torch.equal(beta_t[:J], torch.from_numpy(beta[:J]))


def _df_pair(x):
    hi = x.astype(np.float32)
    return hi, (x - hi.astype(np.float64)).astype(np.float32)


def _ref_df_step(v, q, qp, b_prev):
    """The reference's _body_core after its SpMV, in its own df ops."""
    a = ref_df.df_dot(v, q)
    v = ref_df.df_sub(v, ref_df.df_add(ref_df.df_scale(a, q),
                                       ref_df.df_scale(b_prev, qp)))
    b = ref_df.df_norm(v)
    ok = b[0] > 0
    safe_b = (jnp.where(ok, b[0], 1.0), jnp.where(ok, b[1], 0.0))
    inv_b = ref_df.df_div(ref_df.df_from(jnp.float32(1.0)), safe_b)
    q_next = ref_df.df_scale(inv_b, v)
    return a, b, (jnp.where(ok, q_next[0], 0.0),
                  jnp.where(ok, q_next[1], 0.0))


@pytest.mark.parametrize("n", [128, 3000])
def test_step_df_ref_matches_reference_df_ops(n):
    rng = np.random.default_rng(n)
    q = rng.standard_normal(n)
    q /= np.linalg.norm(q)
    vecs = [_df_pair(x) for x in (rng.standard_normal(n), q,
                                  rng.standard_normal(n) / np.sqrt(n))]
    bp = _df_pair(np.array(0.8125 + 1e-9))
    ref_in = [tuple(jnp.asarray(a) for a in p) for p in vecs]
    a_r, b_r, qn_r = _ref_df_step(*ref_in, tuple(jnp.asarray(x)
                                                 for x in bp))
    v, qt, qpt = [tuple(torch.from_numpy(a) for a in p) for p in vecs]
    ab = [torch.zeros(K, dtype=torch.float32) for _ in range(4)]
    ab[2][J - 1], ab[3][J - 1] = float(bp[0]), float(bp[1])
    qn = ls.lanczos_step_df_ref(v, qt, qpt, ab[:2], ab[2:], J)

    def f64(pair):
        return np.asarray(pair[0], np.float64) + np.asarray(pair[1],
                                                            np.float64)

    assert _rel(f64((ab[0][J], ab[1][J])), f64(a_r)) < 1e-13
    assert _rel(f64((ab[2][J], ab[3][J])), f64(b_r)) < 1e-13
    assert _rel(f64((qn[0].numpy(), qn[1].numpy())), f64(qn_r)) < 1e-13


def test_breakdown_gives_zero():
    q = torch.full((256,), 1 / 16.0, dtype=torch.float64)
    alpha, beta = torch.zeros(4, dtype=torch.float64), torch.zeros(
        4, dtype=torch.float64)
    qn = ls.lanczos_step(2.0 * q, q, torch.zeros_like(q), alpha, beta, 0)
    assert alpha[0].item() == 2.0 and beta[0].item() == 0.0
    assert not bool(qn.any())
    qf = q.float()
    z = torch.zeros_like(qf)
    ab = [torch.zeros(4) for _ in range(4)]
    qh, ql = ls.lanczos_step_df((2.0 * qf, z.clone()), (qf, z), (z, z),
                                ab[:2], ab[2:], 0)
    assert ab[0][0].item() == 2.0 and ab[2][0].item() == 0.0
    assert not bool(qh.any() or ql.any())


def test_dispatch_cpu_runs_plain_version_meta_raises():
    q = torch.linspace(0.1, 1.0, 256, dtype=torch.float64)
    q /= q.norm()
    v = 3.0 * q + 0.01
    ab = (torch.zeros(4, dtype=torch.float64),
          torch.zeros(4, dtype=torch.float64))
    counts = (ls.launches_step, ls.launches_step_df)
    got = ls.lanczos_step(v.clone(), q, torch.zeros_like(q), *ab, 0)
    want = ls.lanczos_step_ref(v.clone(), q, torch.zeros_like(q),
                               torch.zeros(4, dtype=torch.float64),
                               torch.zeros(4, dtype=torch.float64), 0)
    assert torch.equal(got, want)
    qf, z = q.float(), torch.zeros(256)
    abf = [torch.zeros(4) for _ in range(4)]
    ls.lanczos_step_df((v.float(), z.clone()), (qf, z), (z, z), abf[:2],
                       abf[2:], 0)
    assert (ls.launches_step, ls.launches_step_df) == counts
    assert ls.workspace("cpu") is None
    assert ls.df_norm((qf, z)) == lanczos_df.df.df_norm((qf, z))
    m = torch.zeros(256, device="meta")
    mk = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ls.lanczos_step(m, m, m, mk, mk, 0)
    with pytest.raises(ValueError, match="meta"):
        ls.lanczos_step_df((m, m), (m, m), (m, m), (mk, mk), (mk, mk), 0)


def _count_steps(monkeypatch, name):
    calls = []
    real = getattr(ls, name)

    def counted(*args, **kw):
        calls.append(args[5])
        return real(*args, **kw)

    monkeypatch.setattr(ls, name, counted)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_alphabeta_equals_lanczos_through_the_step(monkeypatch, dtype):
    g = generators.barabasi_albert(2000, 8, seed=2, use_native=False)
    port = port_pack(ref_cpg.pack_cpg(g))
    x = torch.from_numpy(port.permute_in(
        np.random.default_rng(5).standard_normal(g.n), np.float64)).to(dtype)
    k = 20
    calls = _count_steps(monkeypatch, "lanczos_step_ref")
    st = lanczos(port, x, k)
    alpha, beta, x_norm = lanczos_alphabeta(port, x, k)
    assert calls == list(range(k)) * 2
    assert torch.equal(alpha, st.alpha) and torch.equal(beta[:k - 1],
                                                        st.beta)
    assert torch.equal(x_norm, st.x_norm)
    # the stored rows are the q_j the recombine pass regenerates
    ans = lanczos_recombine(
        port, x, torch.eye(k, dtype=dtype)[k - 1], k)
    assert torch.equal(ans, st.q_basis[k - 1])


class _Preempted(Exception):
    pass


def test_df_checkpoint_resume_through_the_step(monkeypatch, tmp_path):
    g = generators.barabasi_albert(2000, 8, seed=2, use_native=False)
    port = port_pack(ref_cpg.pack_cpg(g))
    hi = port.realmask.to(torch.float32)
    lo = torch.zeros_like(hi)
    k, chunk = 12, 5
    calls = _count_steps(monkeypatch, "lanczos_step_df_ref")
    want = lanczos_df.lanczos_alphabeta_df(port, hi, lo, k)
    assert calls == list(range(k))
    real = lanczos_df.lanczos_alphabeta_df_range
    seen = []

    def cut(cg, carry, j0, j1):
        if seen:
            raise _Preempted
        seen.append(j0)
        return real(cg, carry, j0, j1)

    path = str(tmp_path / "df.npz")
    monkeypatch.setattr(lanczos_df, "lanczos_alphabeta_df_range", cut)
    with pytest.raises(_Preempted):
        checkpoint.lanczos_alphabeta_df_checkpointed(
            port, hi, lo, k, checkpoint_path=path, chunk=chunk)
    monkeypatch.setattr(lanczos_df, "lanczos_alphabeta_df_range", real)
    calls.clear()
    got = checkpoint.lanczos_alphabeta_df_checkpointed(
        port, hi, lo, k, checkpoint_path=path, chunk=chunk)
    assert calls == list(range(chunk, k))
    for g_pair, w_pair in zip(got, want):
        for g_t, w_t in zip(g_pair, w_pair):
            assert torch.equal(g_t, w_t)
