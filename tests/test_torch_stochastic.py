"""The port's stochastic estimators (tpu_lanczos_torch/core/stochastic.py)
against the JAX package's (tpu_lanczos/core/stochastic.py) and the dense
oracle, on the CPU, on tests/test_stochastic.py's ba200 graph.

Bars and why:
- the three quadratures and the three combiners (trace, Estrada, DOS) on
  the same host-made rows within 1e-12 relative (float64): the same
  numpy/scipy arithmetic in both packages;
- ``_stats_filter`` drops, warns and raises with the reference's texts;
  ``_ritz_pairs_from`` on the same (alpha, beta_full, Q) within 1e-12:
  one host eigensolve and one small product of the same inputs;
- one trace-probe pass and one diagonal-probe body on the same host-made
  +-1 vector and the same CPG pack (the reference's, carried over, its
  Pallas kernel in interpret mode) within 1e-10 (float64) over 15 steps:
  the SpMV is bit-identical, the dots are summed in another order, and
  past ~15 steps loss of orthogonality amplifies that rounding in both
  packages (ROADMAP §3, plain Lanczos drift);
- the probes: a probe depends only on (seed, stream, attempt, index), so
  a run's first probes are a shorter run's; +-1 on real cells, 0 on
  padding; the same signs in float32 and float64; disjoint streams;
- seeded float64 estimates: torch's generator is not JAX's, so the
  estimates agree with the reference's only statistically, within 3
  times their stderrs combined in quadrature, and they are held to the
  dense-oracle bands of tests/test_stochastic.py at that file's seeds.
  One band is not a statistical bar: plain (undeflated) Hutchinson for
  the Estrada index within 0.15 of the truth, where the estimator's own
  relative stderr is 0.20-0.24 on this graph (both packages, seeds 0-11).
  The port's seed-0 probes land 1.45 stderrs low (29.6%); that case is
  held to 3 of its own stderrs instead, and to the combined-stderr bar.
  Likewise the resolvent trace's stderr reduction by deflation, more
  than 3x in the reference's test: over seeds 0-9 it is 1.96-5.64x in
  the reference and 2.34-3.77x in the port (2.99x at seed 0), so it is
  held to 2x;
- every pack of the port (CPG classic and slab, CST, GPG, ELL, COO, HYB)
  given as ``dg=`` is used as given, on its own device.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.core import expmv as ref_expmv
from tpu_lanczos.core.lanczos import lanczos as ref_lanczos_run
from tpu_lanczos.core.lanczos import lanczos_alphabeta as ref_alphabeta
from tpu_lanczos.core import stochastic as ref
from tpu_lanczos.eval import oracle as ref_oracle
from tpu_lanczos.graphs import generators
from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos_torch.core import stochastic as st
from tpu_lanczos_torch.core.lanczos import lanczos_init, lanczos_range
from tpu_lanczos_torch.kernels.cpg import pack_cpg
from tpu_lanczos_torch.kernels.cst import pack_cst
from tpu_lanczos_torch.kernels.formats import pack
from tpu_lanczos_torch.kernels.gpg import pack_gpg

from _torch_cases import port_pack, to_port_graph

K_BODY = 15


@pytest.fixture(scope="module")
def ba200():
    g = generators.barabasi_albert(200, 3, seed=1)
    evals, evecs = np.linalg.eigh(g.to_scipy().toarray())
    return dict(g=g, pg=to_port_graph(g), evals=evals, evecs=evecs,
                tr_true=float(np.exp(evals).sum()),
                diag_true=(evecs ** 2) @ np.exp(evals))


@pytest.fixture(scope="module")
def cpg_pair(ba200):
    ref_pack = ref_cpg.pack_cpg(ba200["g"])
    return ref_pack, port_pack(ref_pack)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _signs(n, seed):
    return np.random.default_rng(seed).choice([-1.0, 1.0], n)


# ------------------------------------------------------------ host stages


def _tridiag_rows(seed=0, k=20):
    rng = np.random.default_rng(seed)
    alpha = rng.standard_normal(k) * 3.0
    beta = rng.uniform(0.5, 2.0, k - 1)
    return alpha, beta


@pytest.mark.parametrize("which", ["exp", "poly4", "shifted_exp", "logexp"])
def test_quadratures_match_reference(which):
    alpha, beta = _tridiag_rows()
    calls = {
        "exp": lambda m: m.gauss_quadrature(alpha, beta, 200.0, np.exp),
        "poly4": lambda m: m.gauss_quadrature(alpha, beta, 200.0,
                                              lambda ev: ev ** 4),
        "shifted_exp": lambda m: m.gauss_quadrature_shifted_exp(
            alpha, beta, 200.0, 7.5),
        "logexp": lambda m: m.gauss_quadrature_logexp(alpha, beta, 200.0),
    }
    got, want = calls[which](st), calls[which](ref)
    assert abs(got - want) <= 1e-12 * abs(want)


def _probe_rows(ba200, probes=12, k=30, m=8, seed=5):
    """(alpha, beta (k,), x_norm, c) rows of float64 oracle Lanczos runs
    on +-1 vectors, with c = u_rows @ z for the top-m exact eigenvectors,
    and the deflation those rows belong to."""
    g = ba200["g"]
    # (m, n) rows, the top of the spectrum first
    u = np.ascontiguousarray(ba200["evecs"][:, ::-1][:, :m].T)
    theta = ba200["evals"][::-1][:m].copy()
    rows = []
    for i in range(probes):
        z = _signs(g.n, seed + i)
        dec = ref_oracle.lanczos(g, z, k)
        rows.append((dec.alpha, np.append(dec.beta, 0.0), dec.x_norm, u @ z))
    defl = dict(theta=theta, u_norm_sq=np.ones(m), shift=float(theta[0]))
    return rows, defl, u


def _result_fields(r):
    return {f: getattr(r, f) for f in ("estimate", "stderr", "log_estimate",
                                       "rel_stderr", "per_probe", "probes",
                                       "k", "deflated", "dropped")}


@pytest.mark.parametrize("case", ["trace_plain", "trace_deflated",
                                  "estrada_plain", "estrada_deflated",
                                  "dos"])
def test_combiners_match_reference(ba200, case):
    rows, defl, u = _probe_rows(ba200)
    k = rows[0][0].shape[0]
    deflated = case.endswith("_deflated")

    def stats_fn(probes, seed, u_rows=None):
        assert (u_rows is not None) == deflated
        return [r if deflated else r[:3] + (None,) for r in rows], 0

    f = lambda ev: np.exp(-0.3 * ev)
    d_ref = ref._Deflation(u_rows=jnp.asarray(u), **defl)
    d_port = st._Deflation(u_rows=torch.from_numpy(u), **defl)
    if case == "dos":
        stats = stats_fn(len(rows), 0)[0]
        got = st._dos_from_stats(stats, k, 128, None)
        want = ref._dos_from_stats(stats, k, 128, None)
        for name in ("grid", "density", "nodes", "weights"):
            assert _rel(getattr(got, name), getattr(want, name)) <= 1e-12
        for name in ("sigma", "lambda_min", "lambda_max", "probes", "k"):
            assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                       rel=1e-12)
        return
    if case.startswith("trace"):
        got = st._trace_fa_estimate(stats_fn, len(rows), 0, k, f,
                                    d_port if deflated else None)
        want = ref._trace_fa_estimate(stats_fn, len(rows), 0, k, f,
                                      d_ref if deflated else None)
    else:
        got = st._estrada_estimate(stats_fn, len(rows), 0, k,
                                   d_port if deflated else None)
        want = ref._estrada_estimate(stats_fn, len(rows), 0, k,
                                     d_ref if deflated else None)
    for name, w in _result_fields(want).items():
        g_v = _result_fields(got)[name]
        if w is None:
            assert g_v is None, name
        else:
            assert _rel(g_v, w) <= 1e-12, name


def test_stats_filter_warns_and_raises_as_reference():
    good = (np.ones(3), np.ones(2), 1.0, None)
    bad = (np.full(3, np.nan), np.ones(2), 1.0, None)
    bad_c = (np.ones(3), np.ones(2), 1.0, np.array([np.inf]))
    texts = []
    for mod in (st, ref):
        with pytest.warns(UserWarning, match="dropped 2/3") as rec:
            kept, dropped = mod._stats_filter([good, bad, bad_c])
        assert len(kept) == 1 and dropped == 2
        with pytest.raises(RuntimeError, match="non-finite") as err, \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mod._stats_filter([bad, bad])
        texts.append((str(rec[0].message), str(err.value)))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("select", ["top", "heat"])
def test_ritz_pairs_match_reference(ba200, cpg_pair, select):
    _, port = cpg_pair
    k_defl, m = 30, 8
    z0 = torch.from_numpy(port.permute_in(_signs(port.n, 11), np.float64))
    carry, _ = lanczos_init(port, z0, k_defl)
    _, _, q_basis, alpha, beta = lanczos_range(port, carry, 0, k_defl,
                                               reorthogonalize=True)
    alpha, beta = alpha.numpy(), beta.numpy()
    sel = None if select == "top" else (lambda ev: np.abs(np.exp(-ev)))
    got = st._ritz_pairs_from(alpha, beta, q_basis, m, torch.float64,
                              select=sel)
    want = ref._ritz_pairs_from(alpha, beta, jnp.asarray(q_basis.numpy()),
                                m, jnp.float64, select=sel)
    assert got.theta.shape == want.theta.shape and got.theta.size > 0
    assert _rel(got.theta, want.theta) <= 1e-12
    assert got.shift == pytest.approx(want.shift, rel=1e-12)
    assert _rel(got.u_rows.numpy(), np.asarray(want.u_rows)) <= 1e-12
    assert _rel(got.u_norm_sq, want.u_norm_sq) <= 1e-12


@pytest.mark.parametrize("m,k_defl,n_cap", [
    (8, None, 199), (8, 80, 199), (20, None, 199), (8, None, 12),
    (1, None, 0), (0, None, 199)])
def test_defl_depth_matches_reference(m, k_defl, n_cap):
    assert st._defl_depth(m, k_defl, n_cap) == ref._defl_depth(m, k_defl,
                                                               n_cap)


# ------------------------------------------------------- probes and bodies


def test_probes_prefix_mask_dtype_and_streams(ba200, cpg_pair):
    _, port = cpg_pair
    mask = port.realmask.double()
    real = mask > 0
    assert not bool(real.all())  # the pack has padding
    z = st._masked_rademacher(mask, 0, st._TRACE_STREAM, 0, 0)
    assert bool((z[real].abs() == 1).all()) and bool((z[~real] == 0).all())
    z32 = st._masked_rademacher(mask.float(), 0, st._TRACE_STREAM, 0, 0)
    assert torch.equal(z32.double(), z)
    others = [st._masked_rademacher(mask, 0, s, a, i) for s, a, i in (
        (st._DEFLATE_STREAM, 0, 0), (st._DIAG_STREAM, 0, 0),
        (st._DIAG_STREAM, 1, 0), (st._TRACE_STREAM, 0, 1))]
    others.append(st._masked_rademacher(mask, 1, st._TRACE_STREAM, 0, 0))
    for o in others:
        assert not torch.equal(o, z)
    # a run's first probes are a shorter run's (fast ELL pack)
    ell = pack(ba200["pg"], fmt="ell", device="cpu")
    m_ell = torch.zeros(ell.n_pad, dtype=torch.float64)
    m_ell[: ell.n] = 1
    short, _ = st._probe_stats_device(ell, m_ell, 3, 7, 6)
    long_, _ = st._probe_stats_device(ell, m_ell, 8, 7, 6)
    for a, b in zip(short, long_[:3]):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)


def _body_inputs(port, seed=3, m=4):
    rng = np.random.default_rng(seed)
    z = port.permute_in(_signs(port.n, seed), np.float64)
    u = rng.standard_normal((m, port.n_pad)) * port.realmask.numpy()
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = np.sort(rng.uniform(0.1, 1.0, m))[::-1].copy()
    return z, u, w


def test_trace_probe_matches_reference(cpg_pair):
    ref_pack, port = cpg_pair
    z, u, _ = _body_inputs(port)
    a, b, xn, c = st._trace_probe(port, torch.from_numpy(z), K_BODY,
                                  torch.from_numpy(u))
    ra, rb, rxn = ref_alphabeta(
        ref_pack, jnp.asarray(z), K_BODY, spmv_impl="interpret")
    assert _rel(a.numpy(), ra) <= 1e-10
    assert _rel(b.numpy()[: K_BODY - 1], np.asarray(rb)[: K_BODY - 1]) <= 1e-10
    assert float(xn) == pytest.approx(float(rxn), rel=1e-12)
    assert _rel(c.numpy(), u @ z) <= 1e-12


def test_diag_probe_matches_reference(cpg_pair):
    ref_pack, port = cpg_pair
    z, u, w = _body_inputs(port, seed=4)
    shift = 7.25
    got = st._diag_probe(port, torch.from_numpy(z), K_BODY,
                         torch.from_numpy(u), torch.from_numpy(w),
                         torch.tensor(shift, dtype=torch.float64))
    zj, uj, wj = jnp.asarray(z), jnp.asarray(u), jnp.asarray(w)
    state = ref_lanczos_run(ref_pack, zj, K_BODY, spmv_impl="interpret")
    ans_scaled, sh = ref_expmv.multiply_out(state, log_scale=True)
    ans_s = ans_scaled * jnp.exp(sh - shift)
    ans_s = ans_s - (wj * (uj @ zj)) @ uj
    want = np.asarray(zj * ans_s)
    assert _rel(got.numpy(), want) <= 1e-10


# ------------------------------------------------------- seeded estimates


def _close_in_stderr(got, want):
    """The combined-stderr bar between two seeded trace estimates."""
    tol = 3.0 * np.hypot(got.stderr, want.stderr)
    assert abs(got.estimate - want.estimate) <= tol, (got.estimate,
                                                      want.estimate, tol)


def _both(ba200, name, **kw):
    port_fn, ref_fn = getattr(st, name), getattr(ref, name)
    got = port_fn(ba200["pg"], device="cpu", **kw)
    return got, ref_fn(ba200["g"], **kw)


def test_trace_fa_tr_a_squared(ba200):
    got, want = _both(ba200, "trace_fa", f=lambda ev: ev ** 2, k=5,
                      probes=64, seed=3, dtype="float64")
    nnz = ba200["g"].nnz
    assert abs(got.estimate - nnz) / nnz < 0.05
    assert got.stderr > 0
    _close_in_stderr(got, want)


@pytest.mark.parametrize("fname", ["heat", "resolvent"])
def test_trace_fa_deflated(ba200, fname):
    f = ((lambda ev: np.exp(-ev)) if fname == "heat"
         else (lambda ev: 1.0 / (10.0 - ev)))
    tr_true = float(np.asarray(f(ba200["evals"])).sum())
    kd = dict(k_deflate=80) if fname == "heat" else {}
    r0, r0_ref = _both(ba200, "trace_fa", f=f, k=40, probes=32, deflate=0,
                       seed=0, dtype="float64")
    r8, r8_ref = _both(ba200, "trace_fa", f=f, k=40, probes=32, deflate=8,
                       seed=0, dtype="float64", **kd)
    if fname == "heat":
        assert r8.deflated == 8
        assert abs(r0.estimate - tr_true) / tr_true < 0.2
        assert r8.stderr < r0.stderr / 3
    else:
        assert r8.deflated > 0
        assert r8.stderr < r0.stderr / 2
    assert abs(r8.estimate - tr_true) / tr_true < 0.05
    _close_in_stderr(r0, r0_ref)
    _close_in_stderr(r8, r8_ref)


def test_estrada_plain_hutchinson(ba200):
    tr_true = ba200["tr_true"]
    got, want = _both(ba200, "estrada_index", k=40, probes=32, deflate=0,
                      seed=0, dtype="float64")
    assert got.deflated == 0 and got.dropped == 0
    assert abs(got.estimate - tr_true) <= 3.0 * got.stderr
    assert abs(np.exp(got.log_estimate) - got.estimate) <= 1e-9 * got.estimate
    _close_in_stderr(got, want)


def test_estrada_deflated(ba200):
    tr_true = ba200["tr_true"]
    got, want = _both(ba200, "estrada_index", k=40, probes=32, deflate=8,
                      seed=0, dtype="float64")
    assert got.deflated > 0 and got.dropped == 0
    assert abs(got.estimate - tr_true) / tr_true < 2e-3
    assert got.rel_stderr < 1e-2
    _close_in_stderr(got, want)


def test_estrada_f32(ba200):
    tr_true = ba200["tr_true"]
    got = st.estrada_index(ba200["pg"], k=40, probes=16, deflate=8, seed=0,
                           dtype="float32", device="cpu")
    assert abs(got.estimate - tr_true) / tr_true < 2e-2


def test_subgraph_centrality_deflated_and_trace_consistency(ba200):
    diag_true = ba200["diag_true"]
    dr = st.subgraph_centrality(ba200["pg"], k=30, probes=32, deflate=8,
                                seed=0, dtype="float64", device="cpu")
    d_est = dr.full_diag()
    assert dr.deflated > 0 and dr.retries == 0
    assert np.corrcoef(d_est, diag_true)[0, 1] > 0.999
    assert _rel(d_est, diag_true) < 0.02
    assert int(dr.top_nodes(1)[0]) == int(np.argmax(diag_true))
    tr_true = ba200["tr_true"]
    assert abs(d_est.sum() - tr_true) / tr_true < 0.02


def test_subgraph_centrality_plain_runs(ba200):
    dr = st.subgraph_centrality(ba200["pg"], k=30, probes=32, deflate=0,
                                seed=0, dtype="float64", device="cpu")
    assert dr.deflated == 0
    assert dr.diag_scaled.shape == (ba200["g"].n,)
    assert np.isfinite(dr.log_scale)
    assert np.corrcoef(dr.full_diag(), ba200["diag_true"])[0, 1] > 0.5


def test_spectral_density_vs_dense(ba200):
    g = ba200["g"]
    r = st.spectral_density(ba200["pg"], k=60, probes=32, seed=0,
                            dtype="float64", device="cpu")
    d_true = ref_oracle.dos_dense(g, r.grid, r.sigma)
    assert abs(np.trapezoid(r.density, r.grid) - 1.0) < 1e-3
    assert np.trapezoid(np.abs(r.density - d_true), r.grid) < 0.1
    ev = ba200["evals"]
    assert abs(r.lambda_max - ev[-1]) / abs(ev[-1]) < 1e-10
    assert abs(r.lambda_min - ev[0]) / abs(ev[0]) < 1e-6


def test_spectral_density_custom_grid(ba200):
    grid = np.linspace(-5, 10, 64)
    r = st.spectral_density(ba200["pg"], k=40, probes=8, seed=1, grid=grid,
                            sigma=0.5, dtype="float64", device="cpu")
    assert r.grid.shape == (64,)
    assert r.sigma == 0.5
    assert np.all(r.density >= 0)


# ------------------------------------------------------- packs and devices


@pytest.mark.parametrize("kind", ["cpg", "slab", "cst", "gpg", "ell", "coo",
                                  "hyb"])
def test_every_pack_given_as_dg(ba200, kind):
    pg = ba200["pg"]
    makers = {
        "cpg": lambda: pack_cpg(pg, device="cpu"),
        "slab": lambda: pack_cpg(pg, layout="slab", device="cpu"),
        "cst": lambda: pack_cst(pg, device="cpu"),
        "gpg": lambda: pack_gpg(pg, device="cpu"),
    }
    dg = makers.get(kind, lambda: pack(pg, fmt=kind, device="cpu"))()
    kw = dict(k=10, probes=2, deflate=4, k_deflate=10, dg=dg,
              dtype="float64")
    r = st.estrada_index(pg, **kw)
    assert r.deflated > 0 and r.dropped == 0
    tr_true = ba200["tr_true"]
    assert abs(r.estimate - tr_true) / tr_true < 0.05
    dr = st.subgraph_centrality(pg, **kw)
    assert dr.diag_scaled.shape == (pg.n,)
    assert _rel(dr.full_diag(), ba200["diag_true"]) < 0.1


def test_entry_points_need_a_device_or_a_pack(ba200):
    """Without ``device="cpu"`` and without a pack the estimators build
    their pack on the GPU; on a machine without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    for name in ("estrada_index", "subgraph_centrality", "spectral_density",
                 "trace_fa"):
        with pytest.raises((AssertionError, RuntimeError)):
            getattr(st, name)(ba200["pg"], k=5, probes=2)


def test_exports():
    import tpu_lanczos_torch as tlt

    for name in ("estrada_index", "subgraph_centrality", "spectral_density",
                 "trace_fa", "TraceResult", "DiagResult", "DOSResult"):
        assert getattr(tlt, name) is getattr(st, name)
