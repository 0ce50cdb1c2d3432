"""Stochastic trace and diagonal estimators for spectral functions of A.

The port of ``tpu_lanczos/core/stochastic.py``: tr(f(A)) (``trace_fa``;
the Estrada index tr(e^A), ``estrada_index``), diag(e^A) (subgraph
centrality, ``subgraph_centrality``) and the spectral density
(``spectral_density``), on one device and, as ``*_sharded``, on a
row-sharded mesh (dist/mesh.py; the section at the end), by Hutchinson
probing and Lanczos quadrature with optional top-m Ritz deflation:

- a TRACE probe is one Q-free alpha/beta pass
  (``core/lanczos.py::lanczos_alphabeta``); for the Lanczos
  decomposition of (A, z), z^T f(A) z ~= ||z||^2 sum_j V[0, j]^2
  f(theta_j), the k-point Gauss rule, and E[z^T f(A) z] = tr(f(A)) for
  Rademacher z;
- a DIAGONAL probe is one e^A z action: E[z * (e^A z)] = diag(e^A);
- DEFLATION: one reorthogonalized k-step run gives top Ritz pairs
  (theta_j, u_j = V[:, j]^T Q); with M = sum_j f(theta_j) u_j u_j^T,
  tr(M) + mean_i [z_i^T f(A) z_i - z_i^T M z_i] is unbiased for any M and
  has the variance of f(A) - M.  Likewise diag(M) + E[z * (e^A z - M z)].

Every SpMV is the pack's own (kernels/spmv.py): on a CPG pack the
hand-written CUDA level kernel on the GPU, its plain version on the CPU.
The dots, axpys, small GEMVs, ``u_rows`` products and the eigensolves are
torch ops, as they are XLA ops in the reference.

Probes.  Torch cannot reproduce JAX's PRNG (the reference draws probe i
from ``fold_in(key(seed), i)``), and its CPU and CUDA generators differ
from each other, so seeded estimates agree with the reference's only
statistically.  Each probe is drawn on the pack's device by a
``torch.Generator`` of that device, seeded from (seed, stream, attempt,
i) through numpy's ``SeedSequence``; nothing of O(n) crosses from the
host.  The streams are disjoint: 0 for the trace probes (attempt 0, i
the probe), 1 for the deflation start vector (i 0, attempt the retry),
2 for the diagonal probes (attempt the retry, i the probe).  A probe
depends on nothing else, so the first 8 probes of a 32-probe run are the
probes of an 8-probe run, as ``fold_in`` gives the reference.  Signs are
drawn as integers and then cast, so a float32 and a float64 run with one
seed see the same probes.  On a mesh each shard draws its slice from
(seed, stream, attempt, i, shard), as the reference folds the shard
index into its key.

Host syncs.  The trace probes (``trace_fa``, ``estrada_index``,
``spectral_density``) queue their coefficients into stacked device
tensors and the host fetches them once, as the reference runs them in
one program with one fetch; the deflation run adds its own fetches.  The
diagonal probes need an eigensolve each: it stays on the device in the
working dtype, as the reference's, and ``torch.linalg.eigh`` on CUDA
checks its error code on the host, one sync per probe.  The k x k
quadratures and the combiners run on the host in float64.

The Estrada combiner works in shifted space (everything scaled by
e^{-lambda_max}), so ``log_estimate`` stays finite where e^{lambda_max}
overflows float64; the diagonal accumulator is carried scaled by
e^{-shift}, so it stays finite in float32 past lambda_max ~ 88.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from tpu_lanczos_torch.core import expmv, tridiag
from tpu_lanczos_torch.core.lanczos import (
    lanczos,
    lanczos_alphabeta,
    lanczos_init,
    lanczos_range,
)
from tpu_lanczos_torch.core.pipeline import _graph_pack, _start_vector
from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.utils import numpy_dtype, torch_dtype

# probe streams (see the module docstring)
_TRACE_STREAM, _DEFLATE_STREAM, _DIAG_STREAM = 0, 1, 2


# ---------------------------------------------------------------- quadrature


def gauss_quadrature(alpha, beta, x_norm_sq: float, f) -> float:
    """k-point Gauss quadrature for z^T f(A) z from the Lanczos
    coefficients of (A, z): ||z||^2 * sum_j V[0, j]^2 f(theta_j), on the
    host in float64."""
    evals, evecs = tridiag.eigh_host(alpha, beta)
    w = evecs[0, :] ** 2
    return float(x_norm_sq) * float(np.dot(w, np.asarray(f(evals),
                                                        np.float64)))


def gauss_quadrature_shifted_exp(alpha, beta, x_norm_sq: float,
                                 shift: float) -> float:
    """e^{-shift} z^T e^A z: the quadrature at f(ev) = e^{ev - shift},
    finite for any spectrum when ``shift`` ~ lambda_max."""
    return gauss_quadrature(alpha, beta, x_norm_sq,
                            lambda ev: np.exp(ev - shift))


def gauss_quadrature_logexp(alpha, beta, x_norm_sq: float) -> float:
    """log(z^T e^A z) without forming e^{theta_j}: logsumexp of
    (2 log|V[0, j]| + theta_j) + log ||z||^2.  Finite even when
    e^{lambda_max} overflows float64."""
    from scipy.special import logsumexp

    evals, evecs = tridiag.eigh_host(alpha, beta)
    with np.errstate(divide="ignore"):  # V[0, j] == 0 -> -inf term, dropped
        logw = 2.0 * np.log(np.abs(evecs[0, :]))
    return float(logsumexp(logw + evals) + np.log(float(x_norm_sq)))


# ------------------------------------------------------------------- probes


def _masked_rademacher(mask: torch.Tensor, seed: int, stream: int,
                       attempt: int, i: int,
                       shard: int | None = None) -> torch.Tensor:
    """Rademacher probe on mask's device: +-1 on the pack's real cells, 0
    on padding, drawn by a generator seeded from (seed, stream, attempt,
    i) alone, and on a row-sharded mesh (dist/mesh.py) from (seed, stream,
    attempt, i, shard): each shard's slice is a stream of its own."""
    entropy = [seed % 2**64, stream, attempt, i]
    if shard is not None:
        entropy.append(shard)
    state = np.random.SeedSequence(entropy)
    gen = torch.Generator(device=mask.device)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    bits = torch.randint(0, 2, mask.shape, generator=gen,
                         device=mask.device, dtype=torch.int8)
    return (2 * bits - 1).to(mask.dtype) * mask


def _trace_probe(dg, z: torch.Tensor, k: int, u_rows: torch.Tensor):
    """One trace probe on the device: the alpha/beta pass of (A, z) and
    the deflation coefficients u_rows @ z (the reference's loop body,
    stochastic.py:146-151).  Returns (alpha (k,), beta (k,), x_norm,
    c (m,)), no host read."""
    alpha, beta, x_norm = lanczos_alphabeta(dg, z, k)
    return alpha, beta, x_norm, u_rows @ z


def _trace_probes_device(dg, mask: torch.Tensor, seed: int, k: int,
                         probes: int, u_rows: torch.Tensor):
    """Every trace probe queued on the device: stacked (probes, k)
    alphas and betas, (probes,) x_norms and (probes, m) coefficient rows,
    with no host read."""
    A = mask.new_zeros((probes, k))
    B = mask.new_zeros((probes, k))
    XN = mask.new_zeros((probes,))
    C = mask.new_zeros((probes, u_rows.shape[0]))
    for i in range(probes):
        z = _masked_rademacher(mask, seed, _TRACE_STREAM, 0, i)
        A[i], B[i], XN[i], C[i] = _trace_probe(dg, z, k, u_rows)
    return A, B, XN, C


def _stats_filter(rows):
    """Shared non-finite filtering + warning/raise semantics for the
    fused probe-stats runners: drop probes with non-finite coefficients
    (warning), raise when nothing survives, return (kept, dropped)."""
    kept = [t for t in rows
            if np.isfinite(t[0]).all() and np.isfinite(t[1]).all()
            and np.isfinite(t[2])
            and (t[3] is None or np.isfinite(t[3]).all())]
    if len(kept) < len(rows):
        warnings.warn(
            f"dropped {len(rows) - len(kept)}/{len(rows)} probes with "
            "non-finite Lanczos coefficients (transient device fault?)",
            stacklevel=4,
        )
    if not kept:
        raise RuntimeError(
            "every stochastic probe returned non-finite Lanczos "
            "coefficients — device state is suspect, re-run"
        )
    return kept, len(rows) - len(kept)


def _probe_stats_device(dg, mask: torch.Tensor, probes: int, seed: int,
                        k: int, u_rows=None):
    """Every trace probe on the device, then one host fetch.  Returns
    ``(kept, dropped)``: a list of (alpha, beta, x_norm, c) numpy tuples
    (c is None without deflation) and the dropped-probe count."""
    m = 0 if u_rows is None else int(u_rows.shape[0])
    u = u_rows if u_rows is not None else mask.new_zeros((0, mask.shape[0]))
    A, B, XN, C = _trace_probes_device(dg, mask, seed, k, probes, u)
    return _stats_filter(_fetch_probe_rows(A, B, XN, C, m))


def _fetch_probe_rows(A, B, XN, C, m: int) -> list:
    """Every probe's coefficients in ONE device->host copy: a list of
    (alpha, beta, x_norm, c) numpy tuples (c None when m is 0)."""
    probes, k = A.shape
    h = torch.cat([A.reshape(-1), B.reshape(-1), XN,
                   C.reshape(-1)]).cpu().numpy()
    pk = probes * k
    A, B = h[:pk].reshape(probes, k), h[pk:2 * pk].reshape(probes, k)
    XN, C = h[2 * pk:2 * pk + probes], h[2 * pk + probes:].reshape(probes, m)
    return [(A[i], B[i], float(XN[i]), C[i] if m else None)
            for i in range(probes)]


# ----------------------------------------------------------------- deflation


@dataclasses.dataclass
class _Deflation:
    theta: np.ndarray      # (m,) top Ritz values, descending
    u_rows: torch.Tensor   # (m, n_pad) Ritz vectors as device rows
    u_norm_sq: np.ndarray  # (m,) ||u_j||^2 (host; ~1 when converged)
    shift: float           # lambda_max Ritz estimate (scaled-space anchor)


def _defl_depth(m: int, k_defl: int | None, n_cap: int):
    """Resolve (k_defl, m) from the requested rank and optional depth."""
    if k_defl is None:
        k_defl = max(2 * m + 10, 30)
    k_defl = int(min(k_defl, max(n_cap, 1)))
    return k_defl, min(m, k_defl - 1)


def _ritz_select(alpha, beta_full, m: int, resid_rtol: float = 1e-2,
                 select=None):
    """The m converged Ritz pairs of a reorthogonalized run whose FULL
    (k,) beta is given (slot k-1 = residual norm beta_k), ranked by
    ``select(evals)`` (default: the eigenvalues themselves, the top of the
    spectrum, right for f = exp).  Pairs with Ritz residual beta_k
    |V[k-1, j]| above ``resid_rtol * max(|theta|, 1)`` are dropped: the
    estimator stays unbiased for any deflation basis, poor pairs only
    remove less variance.  Returns (evals, kept indices), or None."""
    k_defl = int(alpha.shape[0])
    evals, evecs = tridiag.eigh_host(alpha, beta_full[: k_defl - 1])
    b_last = abs(float(beta_full[k_defl - 1]))  # residual norm beta_k
    rank = (evals if select is None
            else np.asarray(select(evals), np.float64))
    idx = np.argsort(rank)[::-1][:m]
    resid = b_last * np.abs(evecs[-1, idx])
    keep = idx[resid <= resid_rtol * np.maximum(np.abs(evals[idx]), 1.0)]
    if keep.size == 0:
        return None
    return evals, evecs, keep


def _ritz_pairs_from(alpha, beta_full, q_basis: torch.Tensor, m: int,
                     dtype, resid_rtol: float = 1e-2,
                     select=None) -> _Deflation | None:
    """The deflation basis of :func:`_ritz_select`'s pairs: u_j = V[:, j]^T
    Q formed on Q's device.  For general f pass ``select=lambda ev:
    np.abs(f(ev))``, so the pairs where f(A) carries its mass are
    deflated."""
    picked = _ritz_select(alpha, beta_full, m, resid_rtol, select)
    if picked is None:
        return None
    evals, evecs, keep = picked
    v_sel = evecs[:, keep]  # (k_defl, m_kept)
    v_rows = np.ascontiguousarray(v_sel.T.astype(numpy_dtype(dtype)))
    u_rows = torch.from_numpy(v_rows).to(q_basis.device) @ q_basis
    u_norm_sq = (u_rows * u_rows).sum(dim=1).cpu().numpy().astype(np.float64)
    return _Deflation(theta=evals[keep], u_rows=u_rows,
                      u_norm_sq=u_norm_sq, shift=float(evals.max()))


def _deflation_warn(stacklevel: int = 4):
    warnings.warn(
        "deflation Lanczos returned non-finite coefficients repeatedly — "
        "falling back to plain (undeflated) Hutchinson",
        stacklevel=stacklevel,
    )


def _deflation_pairs(dg, mask: torch.Tensor, m: int, dtype, seed: int,
                     resid_rtol: float = 1e-2,
                     k_defl: int | None = None,
                     select=None,
                     n_cap: int | None = None) -> _Deflation | None:
    """One reorthogonalized Lanczos run (``lanczos_init`` +
    ``lanczos_range``, whose carry keeps the FULL (k,) beta) feeding
    :func:`_ritz_pairs_from`, up to 3 attempts on non-finite
    coefficients.  ``k_defl`` (default 2m+10, at least 30) sets the
    extraction depth; it clamps at graph.n - 1 (``n_cap``), since a run
    past exact breakdown on a padded pack leaves zero alpha slots that
    distort the Ritz selection."""
    k_defl, m = _defl_depth(
        m, k_defl, (n_cap if n_cap is not None else mask.shape[0]) - 1)
    if m <= 0:
        return None
    for attempt in range(3):  # retry on a transient device fault
        z0 = _masked_rademacher(mask, seed, _DEFLATE_STREAM, attempt, 0)
        carry, _ = lanczos_init(dg, z0, k_defl)
        _, _, q_basis, alpha_d, beta_d = lanczos_range(
            dg, carry, 0, k_defl, reorthogonalize=True)
        h = torch.cat([alpha_d, beta_d]).cpu().numpy()
        alpha, beta = h[:k_defl], h[k_defl:]
        if np.isfinite(h).all():
            break
    else:
        _deflation_warn()
        return None
    return _ritz_pairs_from(alpha, beta, q_basis, m, dtype, resid_rtol,
                            select=select)


# -------------------------------------------------------------------- trace


@dataclasses.dataclass
class TraceResult:
    """Hutchinson trace estimate.  On the Estrada path the combiner works
    in shifted space: ``log_estimate``/``rel_stderr`` are always finite;
    ``estimate``/``stderr`` overflow to inf past exp(~709)."""

    estimate: float        # mean over probes (linear space)
    stderr: float          # std / sqrt(probes) (linear space)
    log_estimate: float | None  # log-space estimate (Estrada path)
    rel_stderr: float      # stderr / estimate (finite even in log space)
    # per-probe values; their meaning depends on the path that produced
    # them: raw quadrature values tau_i (trace_fa), log(z^T e^A z)
    # (estrada, deflate=0), or the e^{-s}-scaled deflated residuals
    # tau_i~ - c_i~, possibly negative (estrada, deflate>0)
    per_probe: np.ndarray
    probes: int
    k: int
    deflated: int = 0      # rank of the deflation basis actually used
    dropped: int = 0       # probes discarded for non-finite coefficients


def trace_fa(
    graph: CSRGraph,
    f=np.exp,
    k: int = 30,
    probes: int = 32,
    *,
    deflate: int = 0,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype="float32",
    fmt: str = "auto",
    dg=None,
    ell_pct: float = 98.0,
    device="cuda",
) -> TraceResult:
    """Hutchinson estimate of tr(f(A)) by ``probes`` Rademacher probes,
    each resolved with a k-point Lanczos quadrature (one Q-free
    alpha/beta pass per probe, O(n) device memory).

    ``deflate=m`` subtracts the rank-m Ritz part
    M = sum_j f(theta_j) u_j u_j^T and probes only the residual; pairs
    are ranked by |f(theta)|, so the deflated rays are where f(A)'s mass
    sits (the bottom of the spectrum for a heat kernel, the top for
    growing f).  Plain linear-space combiner for any f; use
    :func:`estrada_index` for f = exp at scale.  ``device`` is where a
    pack is built when ``dg`` is None; a given ``dg`` runs on its own
    device."""
    k = int(max(min(k, graph.n - 1), 1))
    dg = _graph_pack(graph, dg, fmt, ell_pct, device)
    dt = torch_dtype(dtype)
    mask = _start_vector(dg, dt, None)
    defl = (_deflation_pairs(dg, mask, deflate, dt, seed,
                             k_defl=k_deflate,
                             select=lambda ev: np.abs(
                                 np.asarray(f(ev), np.float64)),
                             n_cap=graph.n)
            if deflate > 0 else None)

    def stats_fn(probes, seed, u_rows=None):
        return _probe_stats_device(dg, mask, probes, seed, k, u_rows)

    return _trace_fa_estimate(stats_fn, probes, seed, k, f, defl)


def _trace_fa_estimate(stats_fn, probes: int, seed: int, k: int, f,
                       defl: _Deflation | None) -> TraceResult:
    """General-f trace combiner: linear-space deflated Hutchinson,
    unbiased for any deflation basis."""
    if defl is None:
        stats, dropped = stats_fn(probes, seed)
        vals = np.array([
            gauss_quadrature(a, b[: k - 1], float(xn) ** 2, f)
            for a, b, xn, _ in stats
        ])
        tr_m = 0.0
        m_used = 0
    else:
        fe = np.asarray(f(defl.theta), np.float64)  # (m,)
        tr_m = float(np.dot(fe, defl.u_norm_sq))    # tr(M)
        stats, dropped = stats_fn(probes, seed, u_rows=defl.u_rows)
        vals = np.array([
            gauss_quadrature(a, b[: k - 1], float(xn) ** 2, f)
            - float(np.dot(fe, np.asarray(c, np.float64) ** 2))
            for a, b, xn, c in stats
        ])  # z^T f(A) z - z^T M z per probe
        m_used = int(defl.theta.size)
    n_used = vals.size
    est = tr_m + float(vals.mean())
    se = float(vals.std(ddof=1) / np.sqrt(n_used)) if n_used > 1 else 0.0
    return TraceResult(estimate=est, stderr=se, log_estimate=None,
                       rel_stderr=se / abs(est) if est else np.inf,
                       per_probe=vals, probes=n_used, k=k,
                       deflated=m_used, dropped=dropped)


def _estrada_estimate(stats_fn, probes: int, seed: int, k: int,
                      defl: _Deflation | None) -> TraceResult:
    """Estrada combiner: deflated shifted-space path when ``defl`` is
    given, plain log-space (logsumexp per probe) otherwise.
    ``stats_fn(probes, seed, u_rows=None) -> (kept, dropped)`` is the
    probe-stats runner."""
    if defl is None:
        stats, dropped = stats_fn(probes, seed)
        logs = np.array([
            gauss_quadrature_logexp(a, b[: k - 1], float(xn) ** 2)
            for a, b, xn, _ in stats
        ])
        n_used = logs.size
        lmax = float(logs.max())
        u = np.exp(logs - lmax)
        mean_u = float(u.mean())
        se_u = (float(u.std(ddof=1) / np.sqrt(n_used))
                if n_used > 1 else 0.0)
        log_est = lmax + float(np.log(mean_u))
        with np.errstate(over="ignore"):
            return TraceResult(
                estimate=float(np.exp(log_est)),
                stderr=float(se_u * np.exp(lmax)),
                log_estimate=log_est,
                rel_stderr=se_u / mean_u if mean_u else np.inf,
                per_probe=logs, probes=n_used, k=k, deflated=0,
                dropped=dropped,
            )

    s = defl.shift
    w_defl = np.exp(defl.theta - s)  # (m,) in (0, 1]
    tr_m = float(np.dot(w_defl, defl.u_norm_sq))  # e^{-s} tr(M)
    stats, dropped = stats_fn(probes, seed, u_rows=defl.u_rows)
    vals = np.array([
        gauss_quadrature_shifted_exp(a, b[: k - 1], float(xn) ** 2, s)
        - float(np.dot(w_defl, np.asarray(c, np.float64) ** 2))
        for a, b, xn, c in stats
    ])  # e^{-s} (z^T e^A z - z^T M z) per probe
    n_used = vals.size
    mean_r = float(vals.mean())
    se_r = float(vals.std(ddof=1) / np.sqrt(n_used)) if n_used > 1 else 0.0
    est_scaled = tr_m + mean_r
    log_est = (s + float(np.log(est_scaled)) if est_scaled > 0
               else -np.inf)
    with np.errstate(over="ignore"):
        return TraceResult(
            estimate=float(np.exp(log_est)),
            stderr=float(se_r * np.exp(s)),
            log_estimate=log_est,
            rel_stderr=se_r / est_scaled if est_scaled > 0 else np.inf,
            per_probe=vals, probes=n_used, k=k,
            deflated=int(defl.theta.size), dropped=dropped,
        )


def estrada_index(
    graph: CSRGraph,
    k: int = 30,
    probes: int = 32,
    *,
    deflate: int = 8,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype="float32",
    fmt: str = "auto",
    dg=None,
    ell_pct: float = 98.0,
    device="cuda",
) -> TraceResult:
    """Estrada index EE(G) = tr(e^A) = sum_i e^{lambda_i}, estimated by
    deflated Hutchinson probing with per-probe Gauss quadrature.

    ``deflate=m`` subtracts the top-m Ritz part of e^A deterministically
    and probes only the residual: on hub graphs that is the difference
    between O(1) and O(1e-2..1e-3) relative stderr at the same probe
    count.  All arithmetic is shifted by the lambda_max Ritz estimate, so
    ``log_estimate`` is finite for any graph; ``estimate`` is the linear
    value when representable."""
    k = int(max(min(k, graph.n - 1), 1))
    dg = _graph_pack(graph, dg, fmt, ell_pct, device)
    dt = torch_dtype(dtype)
    mask = _start_vector(dg, dt, None)

    defl = (_deflation_pairs(dg, mask, deflate, dt, seed,
                             k_defl=k_deflate, n_cap=graph.n)
            if deflate > 0 else None)

    def stats_fn(probes, seed, u_rows=None):
        return _probe_stats_device(dg, mask, probes, seed, k, u_rows)

    return _estrada_estimate(stats_fn, probes, seed, k, defl)


# ----------------------------------------------------- spectral density (DOS)


@dataclasses.dataclass
class DOSResult:
    """Smoothed spectral density estimate: ``density`` integrates to ~1
    over ``grid`` (trapezoid).  ``nodes``/``weights`` are the raw
    quadrature measure (all probes pooled, weights summing to ~probes*n)
    for users who want their own kernel."""

    grid: np.ndarray      # (g,) eigenvalue axis
    density: np.ndarray   # (g,) normalized DOS
    sigma: float          # Gaussian blur width used
    lambda_min: float     # smallest quadrature node seen
    lambda_max: float     # largest quadrature node seen
    nodes: np.ndarray     # (probes*k,) pooled Ritz nodes
    weights: np.ndarray   # (probes*k,) pooled quadrature weights
    probes: int
    k: int


def spectral_density(
    graph: CSRGraph,
    k: int = 80,
    probes: int = 16,
    *,
    grid: np.ndarray | int = 512,
    sigma: float | None = None,
    seed: int = 0,
    dtype="float32",
    fmt: str = "auto",
    dg=None,
    ell_pct: float = 98.0,
    device="cuda",
) -> DOSResult:
    """Spectral density (density of states) of A by stochastic Lanczos
    quadrature (Lin, Saad & Yang, SIAM Review 2016): each Rademacher
    probe's k-point Gauss rule is an unbiased sample of the spectral
    measure; pooling ``probes`` of them and blurring with a Gaussian of
    width ``sigma`` (default: spectral range / k) gives phi(lambda) with
    integral 1.  One Q-free pass per probe."""
    k = int(max(min(k, graph.n - 1), 1))
    dg = _graph_pack(graph, dg, fmt, ell_pct, device)
    mask = _start_vector(dg, torch_dtype(dtype), None)
    stats, _ = _probe_stats_device(dg, mask, probes, seed, k)
    return _dos_from_stats(stats, k, grid, sigma)


def _dos_from_stats(stats, k: int, grid, sigma) -> DOSResult:
    """DOS pooling: Ritz nodes/weights per surviving probe, Gaussian
    blur, mass-1 normalization."""
    probes = len(stats)  # survivors (non-finite probes are dropped)
    nodes, weights = [], []
    for a, b, xn, _ in stats:
        evals, evecs = tridiag.eigh_host(a, b[: k - 1])
        nodes.append(evals)
        weights.append(float(xn) ** 2 * evecs[0, :] ** 2)
    nodes = np.concatenate(nodes)
    weights = np.concatenate(weights)
    lo, hi = float(nodes.min()), float(nodes.max())
    if sigma is None:
        sigma = max((hi - lo) / k, 1e-12)
    if np.isscalar(grid) or np.ndim(grid) == 0:
        g = np.linspace(lo - 3 * sigma, hi + 3 * sigma, int(grid))
    else:
        g = np.asarray(grid, dtype=np.float64)
    # Gaussian-kernel sum over the pooled measure, normalized to mass 1
    d = (np.exp(-((g[:, None] - nodes[None, :]) ** 2) / (2 * sigma**2))
         @ weights) / (np.sqrt(2 * np.pi) * sigma * weights.sum())
    return DOSResult(grid=g, density=d, sigma=float(sigma),
                     lambda_min=lo, lambda_max=hi,
                     nodes=nodes, weights=weights,
                     probes=probes, k=k)


# ----------------------------------------------------------------- diagonal


@dataclasses.dataclass
class DiagResult:
    """Hutchinson diagonal estimate, carried in shifted form:
    true diag ~= diag_scaled * exp(log_scale)."""

    diag_scaled: np.ndarray  # (n,)
    log_scale: float
    probes: int
    k: int
    deflated: int = 0
    # the diagonal estimator never drops single probes: a non-finite
    # accumulator reruns every probe from a fresh stream; this records
    # how many reruns the result needed (0 = clean)
    retries: int = 0

    def full_diag(self) -> np.ndarray:
        """Linear-space estimate (overflows past exp(~88) in float32; use
        ``diag_scaled``/``log_scale`` directly for ranking at scale)."""
        return self.diag_scaled * np.exp(self.log_scale)

    def top_nodes(self, topk: int = 10) -> np.ndarray:
        """Node ids ranked by estimated centrality (shift-invariant)."""
        return np.argsort(self.diag_scaled)[::-1][:topk]


def _diag_probe(dg, z: torch.Tensor, k: int, u_rows: torch.Tensor,
                w_defl: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """One diagonal probe's term z * e^{-shift} (e^A z - M z) on the
    device (the reference's loop body, stochastic.py:856-862): a k-step
    Lanczos, the device eigensolve and multiply-out in shifted form, and
    the rank-m deflation correction."""
    state = lanczos(dg, z, k)
    ans_scaled, sh = expmv.multiply_out(state, log_scale=True)
    ans_s = ans_scaled * torch.exp(sh - shift)
    ans_s = ans_s - (w_defl * (u_rows @ z)) @ u_rows  # subtract M z
    return z * ans_s


def _diag_probes_device(dg, mask: torch.Tensor, seed: int, attempt: int,
                        k: int, probes: int, u_rows: torch.Tensor,
                        w_defl: torch.Tensor,
                        shift: torch.Tensor) -> torch.Tensor:
    """Every diagonal probe of one attempt on the device, accumulated in
    e^{-shift}-scaled space, plus diag(M): the (n_pad,) estimate, not yet
    fetched.  ``u_rows``/``w_defl`` may have rank 0 (the undeflated
    path)."""
    acc = torch.zeros_like(mask)
    for i in range(probes):
        z = _masked_rademacher(mask, seed, _DIAG_STREAM, attempt, i)
        acc = acc + _diag_probe(dg, z, k, u_rows, w_defl, shift)
    diag_m = torch.einsum("m,mn->n", w_defl, u_rows * u_rows)
    return diag_m + acc / probes


def subgraph_centrality(
    graph: CSRGraph,
    k: int = 20,
    probes: int = 16,
    *,
    deflate: int = 8,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype="float32",
    fmt: str = "auto",
    dg=None,
    ell_pct: float = 98.0,
    device="cuda",
) -> DiagResult:
    """Estrada-Rodriguez-Velazquez subgraph centrality diag(e^A),
    estimated for EVERY node at once by ``probes`` Hutchinson probes
    (each one e^A z action), with the top-``deflate`` Ritz part computed
    deterministically.  One vector crosses device->host.

    The per-node noise is O(1/sqrt(probes)) of the node's off-diagonal
    residual communicability; deflation removes its top-ray part, which
    dominates on hub graphs."""
    k = int(max(min(k, graph.n - 1), 1))
    dg = _graph_pack(graph, dg, fmt, ell_pct, device)
    dt = torch_dtype(dtype)
    mask = _start_vector(dg, dt, None)
    n_pad = mask.shape[0]

    defl = (_deflation_pairs(dg, mask, deflate, dt, seed,
                             k_defl=k_deflate, n_cap=graph.n)
            if deflate > 0 else None)
    if defl is not None:
        u_rows = defl.u_rows
        w_defl = torch.from_numpy(
            np.exp(defl.theta - defl.shift).astype(numpy_dtype(dt))).to(
                mask.device)
        shift = defl.shift
        m_used = int(defl.theta.size)
    else:
        u_rows = mask.new_zeros((0, n_pad))
        w_defl = mask.new_zeros((0,))
        # anchor the scale at the lambda_max Ritz estimate of a cheap
        # alpha/beta pass so the scaled accumulator stays representable;
        # the depth clamps at graph.n - 1 like every other k here
        a0, b0, xn0 = lanczos_alphabeta(
            dg, mask, max(min(max(k, 10), graph.n - 1), 1))
        a0, b0, _ = expmv.fetch_tridiag(a0, b0, xn0)
        shift = float(tridiag.eigh_host(a0, b0)[0].max())
        m_used = 0
    shift_dev = torch.tensor(shift, dtype=dt, device=mask.device)

    for attempt in range(2):  # retry once on a transient device fault
        acc = _diag_probes_device(dg, mask, seed, attempt, k, probes,
                                  u_rows, w_defl, shift_dev)
        acc_h = acc.cpu().numpy()
        if np.isfinite(acc_h).all():
            break
    else:
        raise RuntimeError(
            "diagonal estimator returned non-finite values twice — "
            "device state is suspect, re-run"
        )
    return DiagResult(
        diag_scaled=dg.permute_out(acc_h),
        log_scale=float(shift),
        probes=probes,
        k=k,
        deflated=m_used,
        retries=attempt,
    )


# ------------------------------------------------------------------ sharded
#
# The row-sharded half (the reference's ``*_sharded`` estimators): the
# same combiners over the mesh bodies of dist/mesh.py, on a ShardedCPG
# (the CUDA level kernel on every shard) or a ShardedGraph (ELL/COO torch
# ops).  The probes are shard-local: shard s of probe i is drawn from
# (seed, stream, attempt, i, s), on either kind of mesh, so seeded values
# differ from the single-device ones at the Monte-Carlo level while
# staying unbiased.  The k x k eigensolves run once per process, not once
# per shard.


def _sharded_setup(graph, mesh, fmt: str, dt, ell_pct: float):
    """The sharded estimators' preamble: resolve or pack the sharded
    graph (a ShardedCPG for fmt "cpg" and "best", whose kernel is native
    on the GPU; the reference picks CPG for "best" on a TPU only; the
    ELL/COO formats otherwise) and the ones-at-real-cells mask as a
    per-shard list."""
    from tpu_lanczos_torch.dist.cpg_sharded import (ShardedCPG,
                                                    pack_cpg_sharded)
    from tpu_lanczos_torch.dist.partition import ShardedGraph, pack_sharded

    if isinstance(graph, (ShardedGraph, ShardedCPG)):
        sg = graph
    elif fmt in ("best", "cpg"):
        sg = pack_cpg_sharded(graph, mesh.n_shards, mesh=mesh)
    elif fmt in ("auto", "ell", "hyb", "coo"):
        # pack_sharded's hybrid packer covers coo (pure COO has no
        # sharded packer)
        sg = pack_sharded(graph, mesh.n_shards,
                          fmt="auto" if fmt == "coo" else fmt,
                          ell_pct=ell_pct, mesh=mesh)
    else:
        raise ValueError(
            f"sharded estimators support fmt best/cpg/auto/ell/hyb/"
            f"coo, not {fmt!r}")
    if isinstance(sg, ShardedCPG):
        # the permuted all-ones vector IS the pack's realmask
        return sg, [r.to(dt) for r in sg.realmask]
    return sg, mesh.split(sg.permute_in(np.ones(sg.n), numpy_dtype(dt)),
                          sg.n_loc)


def _sharded_alphabeta_fn(sg, k: int, mesh):
    """The backend's Q-free pass, z (per-shard list) -> (alpha, beta,
    x_norm)."""
    from tpu_lanczos_torch.dist.lanczos import local_spmv_fn
    from tpu_lanczos_torch.dist.mesh import sharded_alphabeta_body

    local = local_spmv_fn(sg, mesh)
    return lambda z: sharded_alphabeta_body(mesh, local, z, k)


def _probe_stats_sharded(sg, mask: list, mesh, probes: int, seed: int,
                         k: int, u_rows=None):
    """Every trace probe on the mesh, then one host fetch.  Same return
    as :func:`_probe_stats_device`."""
    from tpu_lanczos_torch.dist.lanczos import local_spmv_fn
    from tpu_lanczos_torch.dist.mesh import sharded_trace_probes_body

    m = 0 if u_rows is None else int(u_rows[0].shape[0])
    u = (u_rows if u_rows is not None
         else [ms.new_zeros((0, ms.shape[0])) for ms in mask])
    A, B, XN, C = sharded_trace_probes_body(
        mesh, local_spmv_fn(sg, mesh), mask, seed, _TRACE_STREAM, k, probes,
        u)
    return _stats_filter(_fetch_probe_rows(A, B, XN, C, m))


def _deflation_pairs_sharded(sg, mask: list, mesh, m: int, dt, seed: int,
                             k_defl: int | None = None,
                             select=None) -> _Deflation | None:
    """Sharded deflation: one reorthogonalized Lanczos run on the mesh
    (full (k,) beta) feeding :func:`_ritz_select`, up to 3 attempts on
    non-finite coefficients; u_rows stays a per-shard list of (m, n_loc)
    column slices and ||u_j||^2 is psum'd."""
    from tpu_lanczos_torch.dist import mesh as dmesh
    from tpu_lanczos_torch.dist.lanczos import local_spmv_fn

    k_defl, m = _defl_depth(m, k_defl, sg.n - 1)
    if m <= 0:
        return None
    local = local_spmv_fn(sg, mesh)
    for attempt in range(3):  # retry on a transient device fault
        z0 = dmesh.shard_probes(mesh, mask, seed, _DEFLATE_STREAM, attempt,
                                0)
        alpha_d, beta_d, q_basis, _ = dmesh.sharded_lanczos_body(
            mesh, local, z0, k_defl, reorthogonalize=True)
        h = torch.cat([alpha_d, beta_d]).cpu().numpy()
        alpha, beta = h[:k_defl], h[k_defl:]
        if np.isfinite(h).all():
            break
    else:
        _deflation_warn(stacklevel=5)
        return None
    picked = _ritz_select(alpha, beta, m, select=select)
    if picked is None:
        return None
    evals, evecs, keep = picked
    v_rows = mesh.replicate(torch.from_numpy(np.ascontiguousarray(
        evecs[:, keep].T.astype(numpy_dtype(dt)))).to(mesh.devices[0]))
    u_rows = [v @ q for v, q in zip(v_rows, q_basis)]
    u_norm_sq = mesh.psum([(u * u).sum(dim=1) for u in u_rows])[0]
    return _Deflation(theta=evals[keep], u_rows=u_rows,
                      u_norm_sq=u_norm_sq.cpu().numpy().astype(np.float64),
                      shift=float(evals.max()))


def trace_fa_sharded(
    graph,
    f=np.exp,
    k: int = 30,
    probes: int = 32,
    *,
    mesh,
    deflate: int = 0,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype="float32",
    fmt: str = "auto",
    ell_pct: float = 90.0,
) -> TraceResult:
    """tr(f(A)) on a row-sharded mesh (dist/mesh.py ``make_mesh``): every
    probe one Q-free sharded alpha/beta pass, with |f(theta)|-ranked Ritz
    deflation as in :func:`trace_fa`.  ``graph`` is a CSRGraph (packed
    here) or a pre-packed ShardedGraph/ShardedCPG."""
    dt = torch_dtype(dtype)
    sg, mask = _sharded_setup(graph, mesh, fmt, dt, ell_pct)
    k = int(max(min(k, sg.n - 1), 1))
    defl = (_deflation_pairs_sharded(sg, mask, mesh, deflate, dt, seed,
                                     k_defl=k_deflate,
                                     select=lambda ev: np.abs(
                                         np.asarray(f(ev), np.float64)))
            if deflate > 0 else None)

    def stats_fn(probes, seed, u_rows=None):
        return _probe_stats_sharded(sg, mask, mesh, probes, seed, k, u_rows)

    return _trace_fa_estimate(stats_fn, probes, seed, k, f, defl)


def estrada_index_sharded(
    graph,
    k: int = 30,
    probes: int = 32,
    *,
    mesh,
    deflate: int = 8,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype="float32",
    fmt: str = "auto",
    ell_pct: float = 90.0,
) -> TraceResult:
    """The Estrada index on a row-sharded mesh: every probe one Q-free
    sharded alpha/beta pass (the CUDA CPG kernel on every shard for fmt
    "cpg"/"best", as the reference CUDA code ran its kernel on every
    card, parallel-two-cards/lib/cu_lanczos.cu:120-122; the ELL/COO
    formats otherwise), the deflation basis column-sharded on the mesh,
    and the k x k quadratures on the host as in :func:`estrada_index`.
    ``graph`` is a CSRGraph (packed here) or a pre-packed
    ShardedGraph/ShardedCPG."""
    dt = torch_dtype(dtype)
    sg, mask = _sharded_setup(graph, mesh, fmt, dt, ell_pct)
    k = int(max(min(k, sg.n - 1), 1))
    defl = (_deflation_pairs_sharded(sg, mask, mesh, deflate, dt, seed,
                                     k_defl=k_deflate)
            if deflate > 0 else None)

    def stats_fn(probes, seed, u_rows=None):
        return _probe_stats_sharded(sg, mask, mesh, probes, seed, k, u_rows)

    return _estrada_estimate(stats_fn, probes, seed, k, defl)


def spectral_density_sharded(
    graph,
    k: int = 80,
    probes: int = 16,
    *,
    mesh,
    grid: np.ndarray | int = 512,
    sigma: float | None = None,
    seed: int = 0,
    dtype="float32",
    fmt: str = "auto",
    ell_pct: float = 90.0,
) -> DOSResult:
    """The spectral density on a row-sharded mesh: every probe on the
    mesh, then the host pooling of :func:`spectral_density`.  ``graph``
    is a CSRGraph (packed here) or a pre-packed ShardedGraph/ShardedCPG."""
    dt = torch_dtype(dtype)
    sg, mask = _sharded_setup(graph, mesh, fmt, dt, ell_pct)
    k = int(max(min(k, sg.n - 1), 1))
    stats, _ = _probe_stats_sharded(sg, mask, mesh, probes, seed, k)
    return _dos_from_stats(stats, k, grid, sigma)


def subgraph_centrality_sharded(
    graph,
    k: int = 20,
    probes: int = 16,
    *,
    mesh,
    deflate: int = 8,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype="float32",
    fmt: str = "auto",
    ell_pct: float = 90.0,
) -> DiagResult:
    """Subgraph centrality diag(e^A) on a row-sharded mesh: per probe a
    sharded Lanczos, one replicated on-device (k, k) eigensolve per
    process, the local multiply-out, the rank-m deflation correction and
    the z * ans accumulation (dist/mesh.py sharded_diag_probes_body); one
    vector crosses to the host.  fmt "cpg"/"best" rides the CUDA CPG
    kernel.  ``graph`` is a CSRGraph (packed here) or a pre-packed
    ShardedGraph/ShardedCPG."""
    from tpu_lanczos_torch.dist.lanczos import local_spmv_fn
    from tpu_lanczos_torch.dist.mesh import sharded_diag_probes_body

    dt = torch_dtype(dtype)
    sg, mask = _sharded_setup(graph, mesh, fmt, dt, ell_pct)
    k = int(max(min(k, sg.n - 1), 1))
    defl = (_deflation_pairs_sharded(sg, mask, mesh, deflate, dt, seed,
                                     k_defl=k_deflate)
            if deflate > 0 else None)
    dev = mask[0].device
    if defl is not None:
        u_rows = [u.to(dt) for u in defl.u_rows]
        w_defl = torch.from_numpy(np.exp(defl.theta - defl.shift).astype(
            numpy_dtype(dt))).to(dev)
        shift = defl.shift
        m_used = int(defl.theta.size)
    else:
        u_rows = [ms.new_zeros((0, ms.shape[0])) for ms in mask]
        w_defl = mask[0].new_zeros((0,))
        k_anchor = max(min(max(k, 10), sg.n - 1), 1)
        a0, b0, xn0 = _sharded_alphabeta_fn(sg, k_anchor, mesh)(mask)
        a0, b0, _ = expmv.fetch_tridiag(a0, b0, xn0)
        shift = float(tridiag.eigh_host(a0, b0)[0].max())
        m_used = 0
    shift_dev = torch.tensor(shift, dtype=dt, device=dev)
    local = local_spmv_fn(sg, mesh)

    for attempt in range(2):  # retry once on a transient device fault
        acc = sharded_diag_probes_body(mesh, local, mask, seed, _DIAG_STREAM,
                                       attempt, k, probes, u_rows, w_defl,
                                       shift_dev)
        acc_h = mesh.to_host(acc)
        if np.isfinite(acc_h).all():
            break
    else:
        raise RuntimeError(
            "sharded diagonal estimator returned non-finite values "
            "twice — device state is suspect, re-run"
        )
    return DiagResult(
        diag_scaled=sg.permute_out(acc_h),
        log_scale=float(shift),
        probes=probes,
        k=k,
        deflated=m_used,
        retries=attempt,
    )
