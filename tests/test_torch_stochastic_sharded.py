"""The port's sharded stochastic estimators (tpu_lanczos_torch/core/
stochastic.py ``*_sharded``, over dist/mesh.py's probe bodies) against
the JAX package's and the dense oracle, on the CPU, on
tests/test_stochastic.py's ba200 graph and 4 CPU shards.

Bars and why:
- the trace-probe body and the diagonal-probe body, on one host-made +-1
  vector split by shard and the same sharded CPG pack (the reference's,
  its Pallas kernel in interpret mode), within 1e-10 (float64) over 15
  steps: the SpMV is bit-identical, the dots sum in other orders;
- the probes: shard s of probe i depends only on (seed, stream, attempt,
  i, s), on either kind of mesh, so a run's first probes are a shorter
  run's on every shard; +-1 on real cells, 0 on padding; the same signs
  in float32 and float64; each shard's stream differs from the others'
  and from the single-device probe's;
- seeded float64 estimates: torch's generator is not JAX's, so they meet
  the reference's dense-oracle bands of tests/test_stochastic.py:198-330
  at that file's seeds, the Estrada index and subgraph centrality on both
  pack types (fmt "auto" and "cpg"), the DOS and the heat trace on the
  ELL/COO pack (fmt "auto"; on the CPU the CPG pack's plain level walk
  makes them slow, and the CPG path is held by the two above).  One band
  is seed luck and is held statistically instead: plain (undeflated)
  Hutchinson for the Estrada index within 0.5 of the truth.  Over seeds
  0-9 the port's error is 0.03-0.65 at relative stderrs 0.18-0.32 (seed
  0: 0.65, 1.45 of its stderrs), so seed 0 is held to 3 of its own
  stderrs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.core import expmv as ref_expmv
from tpu_lanczos.dist import cpg_sharded as ref_cs
from tpu_lanczos.dist import make_mesh as ref_make_mesh
from tpu_lanczos.dist.mesh import ROWS
from tpu_lanczos.graphs import generators
from tpu_lanczos_torch.core import stochastic as st
from tpu_lanczos_torch.dist import mesh as dmesh
from tpu_lanczos_torch.dist import cpg_sharded as cs
from tpu_lanczos_torch.dist.partition import pack_sharded
from tpu_lanczos_torch.eval import oracle

from _torch_cases import to_port_graph

K_BODY = 15


@pytest.fixture(scope="module")
def ba200():
    g = generators.barabasi_albert(200, 3, seed=1)
    evals, evecs = np.linalg.eigh(g.to_scipy().toarray())
    return dict(g=g, pg=to_port_graph(g), evals=evals,
                tr_true=float(np.exp(evals).sum()),
                diag_true=(evecs ** 2) @ np.exp(evals))


@pytest.fixture(scope="module")
def mesh4():
    return dmesh.make_mesh(4, device="cpu")


@pytest.fixture(scope="module")
def cpg4(ba200, mesh4):
    ref_mesh = ref_make_mesh(4)
    ref = ref_cs.pack_cpg_sharded(ba200["g"], 4, mesh=ref_mesh)
    port = cs.pack_cpg_sharded(ba200["pg"], 4, mesh=mesh4)
    return ref, ref_mesh, port


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _body_inputs(sg, seed=3, m=4):
    rng = np.random.default_rng(seed)
    z = sg.permute_in(rng.choice([-1.0, 1.0], sg.n), np.float64)
    mask = np.concatenate([r.numpy() for r in sg.realmask])
    u = rng.standard_normal((m, sg.n_pad)) * mask
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = np.sort(rng.uniform(0.1, 1.0, m))[::-1].copy()
    return z, u, w


def _host_probe(monkeypatch, mesh, sg, z):
    """Make probe 0 of every stream the host vector z, split by shard."""
    parts = mesh.split(z, sg.n_loc)
    monkeypatch.setattr(dmesh, "shard_probes", lambda *a: parts)
    return parts


def _ref_vec(ref_mesh, x):
    return jax.device_put(jnp.asarray(x), jax.sharding.NamedSharding(
        ref_mesh, jax.sharding.PartitionSpec(ROWS)))


def _u_split(mesh, sg, u):
    return [torch.from_numpy(np.ascontiguousarray(
        u[:, s * sg.n_loc:(s + 1) * sg.n_loc])) for s in mesh.shards]


def test_trace_probe_body_matches_reference(monkeypatch, cpg4, mesh4):
    ref, ref_mesh, sg = cpg4
    z, u, _ = _body_inputs(sg)
    parts = _host_probe(monkeypatch, mesh4, sg, z)
    mask = [torch.ones_like(p) for p in parts]
    A, B, XN, C = cs.trace_probes_cpg_sharded(
        sg, mask, 0, st._TRACE_STREAM, K_BODY, 1, mesh4,
        _u_split(mesh4, sg, u))
    ra, rb, rxn = ref_cs.lanczos_alphabeta_cpg_sharded(
        ref, _ref_vec(ref_mesh, z), K_BODY, ref_mesh, interpret=True)
    assert _rel(A[0].numpy(), ra) <= 1e-10
    assert _rel(B[0].numpy()[: K_BODY - 1], np.asarray(rb)[: K_BODY - 1]) \
        <= 1e-10
    assert float(XN[0]) == pytest.approx(float(rxn), rel=1e-12)
    assert _rel(C[0].numpy(), u @ z) <= 1e-12


def test_diag_probe_body_matches_reference(monkeypatch, cpg4, mesh4):
    ref, ref_mesh, sg = cpg4
    z, u, w = _body_inputs(sg, seed=4)
    parts = _host_probe(monkeypatch, mesh4, sg, z)
    mask = [torch.ones_like(p) for p in parts]
    shift = 7.25
    got = cs.diag_probes_cpg_sharded(
        sg, mask, 0, st._DIAG_STREAM, 0, K_BODY, 1, mesh4,
        _u_split(mesh4, sg, u), torch.from_numpy(w),
        torch.tensor(shift, dtype=torch.float64))
    zj, uj, wj = (jnp.asarray(a) for a in (z, u, w))
    state = ref_cs.lanczos_cpg_sharded(ref, _ref_vec(ref_mesh, z), K_BODY,
                                       ref_mesh, interpret=True)
    ans_scaled, sh = ref_expmv.multiply_out(state, log_scale=True)
    ans_s = ans_scaled * jnp.exp(sh - shift)
    ans_s = ans_s - (wj * (uj @ zj)) @ uj
    want = np.asarray(jnp.einsum("m,mn->n", wj, uj * uj) + zj * ans_s)
    assert _rel(mesh4.to_host(got), want) <= 1e-10


def test_probe_bodies_agree_across_pack_types(monkeypatch, cpg4, mesh4,
                                             ba200):
    """The ELL/COO pack's trace and diagonal bodies give the CPG pack's
    values on the same host-made vector (both f64: within 1e-10)."""
    from tpu_lanczos_torch.dist import lanczos as dl

    _, _, sg = cpg4
    ell = pack_sharded(ba200["pg"], 4, mesh=mesh4)
    z, _, w = _body_inputs(sg, seed=5, m=0)
    z_ell = ell.permute_in(sg.permute_out(z), np.float64)
    shift = torch.tensor(5.0, dtype=torch.float64)
    out = {}
    for name, pack, zz in (("cpg", sg, z), ("ell", ell, z_ell)):
        parts = _host_probe(monkeypatch, mesh4, pack, zz)
        mask = [torch.ones_like(p) for p in parts]
        u = [p.new_zeros((0, p.shape[0])) for p in parts]
        if name == "cpg":
            tr = cs.trace_probes_cpg_sharded(pack, mask, 0, 0, K_BODY, 1,
                                             mesh4, u)
            dg = cs.diag_probes_cpg_sharded(pack, mask, 0, 2, 0, K_BODY, 1,
                                            mesh4, u, torch.from_numpy(w),
                                            shift)
        else:
            tr = dl.trace_probes_sharded(pack, mask, 0, 0, K_BODY, 1, mesh4,
                                         u)
            dg = dl.diag_probes_sharded(pack, mask, 0, 2, 0, K_BODY, 1,
                                        mesh4, u, torch.from_numpy(w), shift)
        out[name] = (tr, pack.permute_out(mesh4.to_host(dg)))
    (tr_c, d_c), (tr_e, d_e) = out["cpg"], out["ell"]
    assert _rel(tr_c[0].numpy(), tr_e[0].numpy()) <= 1e-10
    assert _rel(tr_c[1][0, : K_BODY - 1].numpy(),
                tr_e[1][0, : K_BODY - 1].numpy()) <= 1e-10
    assert _rel(d_c, d_e) <= 1e-10


# ---------------------------------------------------------------- probes


def test_shard_probes_prefix_mask_dtype_and_streams(ba200, cpg4, mesh4):
    _, _, sg = cpg4
    mask = [r.double() for r in sg.realmask]
    z = dmesh.shard_probes(mesh4, mask, 0, st._TRACE_STREAM, 0, 0)
    for zs, ms in zip(z, mask):
        real = ms > 0
        assert bool((zs[real].abs() == 1).all())
        assert bool((zs[~real] == 0).all())
    z32 = dmesh.shard_probes(mesh4, [m.float() for m in mask], 0,
                             st._TRACE_STREAM, 0, 0)
    assert all(torch.equal(a.double(), b) for a, b in zip(z32, z))
    # every shard its own stream, none the single-device probe's
    ones = torch.ones(sg.n_loc, dtype=torch.float64)
    draws = [st._masked_rademacher(ones, 0, st._TRACE_STREAM, 0, 0, shard=s)
             for s in range(4)]
    draws.append(st._masked_rademacher(ones, 0, st._TRACE_STREAM, 0, 0))
    for i in range(len(draws)):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j])
    # a shard's probe is the same on a mesh of another size
    assert torch.equal(dmesh.shard_probes(dmesh.make_mesh(1, device="cpu"),
                                          [ones], 0, 1, 2, 3)[0],
                       st._masked_rademacher(ones, 0, 1, 2, 3, shard=0))
    # a run's first probes are a shorter run's, on every shard
    short, _ = st._probe_stats_sharded(sg, mask, mesh4, 3, 7, 6)
    long_, _ = st._probe_stats_sharded(sg, mask, mesh4, 8, 7, 6)
    for a, b in zip(short, long_[:3]):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------- seeded estimates


def test_estrada_sharded_vs_dense(ba200, mesh4):
    tr_true = ba200["tr_true"]
    for fmt in ("auto", "cpg"):
        r = st.estrada_index_sharded(ba200["pg"], k=40, probes=32,
                                     mesh=mesh4, dtype="float64", fmt=fmt)
        assert r.deflated > 0 and r.dropped == 0, fmt
        assert abs(r.estimate - tr_true) / tr_true < 5e-3, fmt
        assert r.rel_stderr < 2e-2, fmt


def test_estrada_sharded_plain(ba200, mesh4):
    tr_true = ba200["tr_true"]
    r = st.estrada_index_sharded(ba200["pg"], k=40, probes=32, mesh=mesh4,
                                 deflate=0, dtype="float64")
    assert r.deflated == 0 and r.rel_stderr < 0.35
    assert abs(r.estimate - tr_true) <= 3.0 * r.stderr
    assert np.isfinite(r.log_estimate)


@pytest.mark.parametrize("fmt", ["auto", "cpg"])
def test_subgraph_sharded_vs_dense(ba200, mesh4, fmt):
    diag_true = ba200["diag_true"]
    dr = st.subgraph_centrality_sharded(ba200["pg"], k=30, probes=32,
                                        mesh=mesh4, dtype="float64", fmt=fmt)
    d_est = dr.full_diag()
    assert dr.deflated > 0 and dr.retries == 0
    assert d_est.shape == (ba200["g"].n,)
    assert np.corrcoef(d_est, diag_true)[0, 1] > 0.999
    assert _rel(d_est, diag_true) < 0.05
    assert int(dr.top_nodes(1)[0]) == int(np.argmax(diag_true))


def test_subgraph_sharded_plain_runs(ba200, mesh4):
    dr = st.subgraph_centrality_sharded(ba200["pg"], k=30, probes=16,
                                        mesh=mesh4, deflate=0,
                                        dtype="float64")
    assert dr.deflated == 0 and np.isfinite(dr.log_scale)
    assert np.corrcoef(dr.full_diag(), ba200["diag_true"])[0, 1] > 0.5


def test_spectral_density_sharded_vs_dense(ba200, mesh4):
    g = ba200["g"]
    r = st.spectral_density_sharded(ba200["pg"], k=60, probes=32, mesh=mesh4,
                                    seed=0, dtype="float64", fmt="auto")
    d_true = oracle.dos_dense(ba200["pg"], r.grid, r.sigma)
    assert abs(np.trapezoid(r.density, r.grid) - 1.0) < 1e-3
    assert np.trapezoid(np.abs(r.density - d_true), r.grid) < 0.1
    ev = ba200["evals"]
    assert abs(r.lambda_max - ev[-1]) / abs(ev[-1]) < 1e-10
    assert r.probes == 32 and g.n == 200


def test_trace_fa_sharded_heat(ba200, mesh4):
    f = lambda ev: np.exp(-ev)  # noqa: E731
    tr_true = float(np.exp(-ba200["evals"]).sum())
    r = st.trace_fa_sharded(ba200["pg"], f=f, k=40, probes=32, mesh=mesh4,
                            deflate=8, k_deflate=80, seed=0, dtype="float64",
                            fmt="auto")
    assert r.deflated == 8 and r.dropped == 0
    assert abs(r.estimate - tr_true) / tr_true < 0.1


@pytest.mark.parametrize("fmt", ["auto", "cpg"])
def test_alphabeta_sharded_matches_quadrature(ba200, mesh4, fmt):
    pg = ba200["pg"]
    sg = (cs.pack_cpg_sharded(pg, 4, mesh=mesh4) if fmt == "cpg"
          else pack_sharded(pg, 4, fmt="auto", mesh=mesh4))
    if fmt == "cpg":
        assert sg.overlap and sg.n_main == 2
    x = np.ones(pg.n)
    a, b, xn = st._sharded_alphabeta_fn(sg, 30, mesh4)(
        mesh4.split(sg.permute_in(x, np.float64), sg.n_loc))
    a, b = a.numpy(), b.numpy()
    dec = oracle.lanczos(pg, x, 30)
    assert np.allclose(a[:12], dec.alpha[:12], rtol=1e-9, atol=1e-9)
    assert np.allclose(b[:12], dec.beta[:12], rtol=1e-9, atol=1e-9)
    assert abs(float(xn) - dec.x_norm) < 1e-9
    q = st.gauss_quadrature(a, b[:29], float(xn) ** 2, np.exp)
    q_dense = oracle.quadrature_dense(pg, x, np.exp)
    assert abs(q - q_dense) / q_dense < 1e-8


def test_sharded_setup_rejects_bad_fmt(ba200):
    from tpu_lanczos.core import stochastic as ref

    with pytest.raises(ValueError, match="sharded estimators support") as e:
        st.estrada_index_sharded(ba200["pg"], k=10, probes=2,
                                 mesh=dmesh.make_mesh(2, device="cpu"),
                                 fmt="cst")
    with pytest.raises(ValueError) as want:
        ref.estrada_index_sharded(ba200["g"], k=10, probes=2,
                                  mesh=ref_make_mesh(2), fmt="cst")
    assert str(e.value) == str(want.value)


def test_exports():
    import tpu_lanczos_torch as tlt

    for name in ("estrada_index_sharded", "subgraph_centrality_sharded",
                 "spectral_density_sharded", "trace_fa_sharded"):
        assert getattr(tlt, name) is getattr(st, name)
