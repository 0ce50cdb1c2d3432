"""End-to-end single-device pipeline: f(A)x = e^A.x, in PyTorch.

The port of ``tpu_lanczos/core/pipeline.py``'s single-device entry
points: pack the graph once on the host (index tensors on ``device``),
run Lanczos on the device, solve the k x k tridiagonal eigenproblem, then
the GEMV ``tmp @ Q``; for serving, a masked top-k on the device so only
O(topk) values come back.

- ``eig_impl="host"`` (default, accurate): LAPACK float64 eigensolve on
  the host between the Lanczos loop and the GEMV, the reference's split.
- ``eig_impl="device"``: the eigensolve runs on the device
  (``torch.linalg.eigh`` of the dense T), so the fused serving query
  (``expm_action_summary``) reads nothing back until its O(topk) fetch;
  on CUDA the eigh itself synchronises once to check its error code.
- ``low_mem=True``: the two-pass Q-free mode (an alpha/beta pass, host
  eigh, then a pass that regenerates q_j and accumulates the answer), O(n)
  device memory in place of the (k, n_pad) basis.

Formats (``fmt``): "best" and "cpg" pack CPG, whose SpMV is the
hand-written CUDA kernel on the GPU (its plain version on the CPU);
"auto", "ell", "coo" and "hyb" pack the fallback formats, whose SpMV is
plain torch ops; "cst" is not ported.  ``expm_action`` and
``expm_action_summary`` default to "best", the port's main path; the
other entry points keep the reference's default, "auto".  ``device``
("cuda" by default) is where a pack is built when ``dg`` is None; a given
``dg`` runs on its own device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.kernels.cpg import CPGGraph, pack_cpg
from tpu_lanczos_torch.kernels.formats import DeviceGraph, pack
from tpu_lanczos_torch.core.lanczos import (
    lanczos, lanczos_alphabeta, lanczos_recombine)
from tpu_lanczos_torch.core import expmv, tridiag
from tpu_lanczos_torch.utils import numpy_dtype, torch_dtype


@dataclasses.dataclass
class LanczosResult:
    """Answer vector plus decomposition byproducts (host-sliced to n)."""

    ans: np.ndarray  # (n,) e^A.x  (scaled if log_scale is set)
    log_scale: float | None  # if not None, true ans = ans * exp(log_scale)
    alpha: np.ndarray  # (k,)
    beta: np.ndarray  # (k-1,)
    x_norm: float
    k: int

    def full_ans(self) -> np.ndarray:
        if self.log_scale is None:
            return self.ans
        return self.ans * np.exp(self.log_scale)


@dataclasses.dataclass
class SummaryResult:
    """Device-reduced pipeline output: only O(topk) scalars cross
    device->host."""

    top_values: np.ndarray  # (topk,) largest entries of e^A.x (scaled)
    top_nodes: np.ndarray   # (topk,) their original vertex ids
    ans_norm: float         # ||ans_scaled||_2
    log_scale: float        # true ans = scaled * exp(log_scale)
    alpha: np.ndarray
    beta: np.ndarray
    x_norm: float
    k: int


def best_device_pack(graph: CSRGraph, device="cuda") -> CPGGraph:
    """The fastest ported format: CPG on every device (the reference picks
    CPG on the TPU; the port's CPG kernel is its CUDA kernel)."""
    return pack_cpg(graph, device=device)


def _resolve_dg(graph: CSRGraph, fmt: str, ell_pct: float = 98.0,
                device="cuda"):
    """Shared format dispatch for every pipeline entry point."""
    if fmt == "cst":
        raise NotImplementedError(
            "fmt='cst': the CST format and its kernel are ROADMAP queue 2 "
            "item 6")
    if fmt == "cpg":
        return pack_cpg(graph, device=device)
    if fmt == "best":
        return best_device_pack(graph, device=device)
    return pack(graph, fmt=fmt, ell_pct=ell_pct, device=device)


def _graph_pack(graph, dg, fmt, ell_pct, device):
    """``dg`` if given (a CPG or ELL/COO/HYB pack), else a new pack."""
    if dg is None:
        return _resolve_dg(graph, fmt, ell_pct, device)
    if not isinstance(dg, (CPGGraph, DeviceGraph)):
        raise NotImplementedError(
            f"{type(dg).__name__}: only CPG and ELL/COO/HYB packs are "
            "ported")
    return dg


def _start_vector(dg, dtype: torch.dtype,
                  x: np.ndarray | None) -> torch.Tensor:
    """Device start vector: for x=None (the all-ones centrality start,
    serial/main.cc:79) on a CPG pack the permuted ones equal the pack's
    realmask, so no O(n) host->device copy is made."""
    if x is None and isinstance(dg, CPGGraph):
        return dg.realmask.to(dtype)
    x_host = np.ones(dg.n) if x is None else np.asarray(x)
    return torch.from_numpy(dg.permute_in(x_host, numpy_dtype(dtype))).to(
        dg.device)


def _real_mask(dg) -> torch.Tensor:
    """(n_pad,) mask of the positions that hold a vertex."""
    if isinstance(dg, CPGGraph):
        return dg.realmask > 0
    return torch.arange(dg.n_pad, device=dg.device) < dg.n


def _map_nodes(dg, idx: np.ndarray) -> np.ndarray:
    """Padded positions -> original vertex ids."""
    if isinstance(dg, DeviceGraph):  # identity layout
        return idx.astype(np.int64)
    old_of_new = np.full(dg.n_pad, -1, dtype=np.int64)
    old_of_new[dg.new_of_old] = np.arange(dg.n)
    return old_of_new[idx]


def _host_coeff(tmp: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(tmp.astype(numpy_dtype(like.dtype))).to(
        like.device)


def _two_pass(dg, x_dev: torch.Tensor, k: int):
    """The Q-free answer: alpha/beta pass, host eigh, recombine pass.
    Returns (ans_scaled (n_pad,), shift, alpha, beta, x_norm), the last
    three on the host."""
    alpha, beta, x_norm = lanczos_alphabeta(dg, x_dev, k)
    alpha_h, beta_h, x_norm_h = expmv.fetch_tridiag(alpha, beta, x_norm)
    tmp, shift = expmv.host_coefficients(alpha_h, beta_h, x_norm_h)
    ans = lanczos_recombine(dg, x_dev, _host_coeff(tmp, x_dev), k)
    return ans, float(shift), alpha_h, beta_h, x_norm_h


def expm_action_device(dg, x: torch.Tensor, k: int,
                       reorthogonalize: bool = False,
                       log_scale: bool = False):
    """Lanczos and the multiply-out with the device eigensolve, all on
    the device.  Returns (ans_or_pair, state); with ``log_scale`` the
    pair's shift is a 0-d device tensor."""
    state = lanczos(dg, x, k, reorthogonalize=reorthogonalize)
    return expmv.multiply_out(state, log_scale=log_scale), state


def expm_action(
    graph: CSRGraph,
    x: np.ndarray | None = None,
    k: int = 50,
    *,
    dtype="float32",
    fmt: str = "best",
    reorthogonalize: bool = False,
    log_scale: bool = False,
    eig_impl: str = "host",
    dg=None,
    ell_pct: float = 98.0,
    low_mem: bool = False,
    device="cuda",
) -> LanczosResult:
    """e^A.x for ``graph``.  ``x`` defaults to all-ones (the centrality
    start vector); k clamps to n-1.  ``low_mem=True`` selects the
    two-pass Q-free mode, which cannot reorthogonalize (that needs the
    stored basis)."""
    if low_mem and reorthogonalize:
        raise ValueError("low_mem is incompatible with reorthogonalize")
    if eig_impl not in ("host", "device"):
        raise ValueError(f"eig_impl must be host or device, got {eig_impl!r}")
    k = int(max(min(k, graph.n - 1), 1))
    dg = _graph_pack(graph, dg, fmt, ell_pct, device)
    x_dev = _start_vector(dg, torch_dtype(dtype), x)
    if low_mem:
        ans, shift, alpha, beta, x_norm = _two_pass(dg, x_dev, k)
        if not log_scale:
            ans = expmv.unshift(ans, shift)
        return LanczosResult(
            ans=dg.permute_out(ans), log_scale=shift if log_scale else None,
            alpha=alpha, beta=beta, x_norm=x_norm, k=k)
    if eig_impl == "host":
        state = lanczos(dg, x_dev, k, reorthogonalize=reorthogonalize)
        out = expmv.multiply_out_host_eig(state, log_scale=log_scale)
    else:
        out, state = expm_action_device(dg, x_dev, k, reorthogonalize,
                                        log_scale)
    if log_scale:
        ans, shift = out
        shift_val = float(shift)
    else:
        ans, shift_val = out, None
    alpha, beta, x_norm = expmv.fetch_tridiag(state.alpha, state.beta,
                                              state.x_norm)
    return LanczosResult(ans=dg.permute_out(ans), log_scale=shift_val,
                         alpha=alpha, beta=beta, x_norm=x_norm, k=k)


def _masked_topk(ans: torch.Tensor, mask: torch.Tensor, topk: int):
    neg = torch.finfo(ans.dtype).min
    vals, idx = torch.topk(torch.where(mask, ans, neg), topk)
    return torch.linalg.vector_norm(ans), vals, idx


def expm_action_summary(
    graph: CSRGraph,
    x: np.ndarray | None = None,
    k: int = 50,
    topk: int = 20,
    *,
    dtype="float32",
    fmt: str = "best",
    dg=None,
    ell_pct: float = 98.0,
    eig_impl: str = "host",
    low_mem: bool = False,
    device="cuda",
) -> SummaryResult:
    """Serving variant: the answer is reduced ON DEVICE to its top-k
    entries and norm, so the device->host transfer is O(topk).  The
    highest-centrality vertices under e^A.1 (the reference's check_ans
    max/idx metrics).  The values are the log-scaled answer.

    ``eig_impl="device"`` fuses the whole query: Lanczos, device eigh,
    GEMV and masked top-k are queued with no host read until the final
    O(topk) fetch (the eigh's own error-check sync aside); its f32
    eigensolve puts ~1e-5-level noise on the values.  ``low_mem=True``
    serves it through the two-pass Q-free mode, which the fused program
    cannot (it stores Q)."""
    if low_mem and eig_impl == "device":
        raise ValueError("low_mem summary uses the two-pass host-eig "
                         "path (the fused device program stores Q)")
    if eig_impl not in ("host", "device"):
        raise ValueError(f"eig_impl must be host or device, got {eig_impl!r}")
    k = int(max(min(k, graph.n - 1), 1))
    dg = _graph_pack(graph, dg, fmt, ell_pct, device)
    x_dev = _start_vector(dg, torch_dtype(dtype), x)
    mask = _real_mask(dg)
    if low_mem:
        ans, shift, alpha_h, beta_h, x_norm_h = _two_pass(dg, x_dev, k)
    elif eig_impl == "device":
        (ans, shift_d), state = expm_action_device(dg, x_dev, k,
                                                   log_scale=True)
        nrm, vals, idx = _masked_topk(ans, mask, topk)
        # the one O(topk) fetch: values, norm, shift and T in one copy
        small = torch.cat([vals, nrm.reshape(1), shift_d.reshape(1),
                           state.alpha, state.beta,
                           state.x_norm.reshape(1)]).cpu().numpy()
        return SummaryResult(
            top_values=small[:topk], top_nodes=_map_nodes(
                dg, idx.cpu().numpy()),
            ans_norm=float(small[topk]), log_scale=float(small[topk + 1]),
            alpha=small[topk + 2:topk + 2 + k],
            beta=small[topk + 2 + k:-1], x_norm=float(small[-1]), k=k)
    else:
        state = lanczos(dg, x_dev, k)
        # one host sync for alpha, beta and x_norm together
        alpha_h, beta_h, x_norm_h = expmv.fetch_tridiag(
            state.alpha, state.beta, state.x_norm)
        tmp, shift = expmv.host_coefficients(alpha_h, beta_h, x_norm_h)
        ans = _host_coeff(tmp, x_dev) @ state.q_basis
    nrm, vals, idx = _masked_topk(ans, mask, topk)
    # tiny D2H: topk values + indices + one norm
    return SummaryResult(
        top_values=vals.cpu().numpy(),
        top_nodes=_map_nodes(dg, idx.cpu().numpy()),
        ans_norm=float(nrm),
        log_scale=float(shift),
        alpha=alpha_h,
        beta=beta_h,
        x_norm=x_norm_h,
        k=k,
    )


def expm_action_ks(
    graph: CSRGraph,
    ks,
    x: np.ndarray | None = None,
    *,
    dtype="float32",
    fmt: str = "auto",
    log_scale: bool = False,
    dg=None,
    ell_pct: float = 98.0,
    device="cuda",
):
    """Answers for EVERY requested Krylov dimension from ONE
    decomposition: a k_max-step Lanczos contains every smaller one as a
    prefix (alpha[:k], beta[:k-1], Q[:k]), so the reference's convergence
    study (the whole pipeline re-run per k, writeup Table 5) is one
    Lanczos pass plus a tiny host eigensolve and a GEMV per k.

    Returns ``(results, diffs)``: ``results[k]`` is a LanczosResult and
    ``diffs[k] = ||ans_k - ans_kmax|| / ||ans_kmax||``, computed on
    matching log-scale shifts."""
    ks = sorted({max(min(int(k), graph.n - 1), 1) for k in ks})
    k_max = ks[-1]
    dg = _graph_pack(graph, dg, fmt, ell_pct, device)
    x_dev = _start_vector(dg, torch_dtype(dtype), x)
    state = lanczos(dg, x_dev, k_max)
    alpha, beta, x_norm_h = expmv.fetch_tridiag(state.alpha, state.beta,
                                                state.x_norm)
    results = {}
    shifts = {}
    for k in ks:
        tmp, shift = expmv.host_coefficients(alpha[:k], beta[: k - 1],
                                             x_norm_h)
        coeff = _host_coeff(tmp, x_dev)
        ans_scaled = (coeff @ state.q_basis[:k]).cpu().numpy()
        shifts[k] = float(shift)
        ans = ans_scaled if log_scale else ans_scaled * np.exp(shift)
        results[k] = LanczosResult(
            ans=dg.permute_out(ans),
            log_scale=shifts[k] if log_scale else None,
            alpha=alpha[:k], beta=beta[: k - 1], x_norm=x_norm_h, k=k,
        )
    # compare on a COMMON scale: rescale each k's shifted answer by
    # exp(shift_k - shift_ref) instead of forming exp(shift), which
    # overflows exactly where log_scale matters
    ref = results[k_max].ans
    ref_norm = np.linalg.norm(ref)
    diffs = {}
    for k in ks:
        a = results[k].ans
        if log_scale:
            a = a * np.exp(shifts[k] - shifts[k_max])
        diffs[k] = float(np.linalg.norm(a - ref) / ref_norm)
    return results, diffs


def fa_action(
    graph: CSRGraph,
    f,
    x: np.ndarray | None = None,
    k: int = 50,
    *,
    dtype="float32",
    fmt: str = "auto",
    reorthogonalize: bool = False,
    dg=None,
    ell_pct: float = 98.0,
    device="cuda",
) -> LanczosResult:
    """General spectral-function action f(A)·x through the same Lanczos
    pipeline: ans = ||x|| · Qᵀ V f(Λ) Vᵀ e1, with ``f`` (any
    numpy-vectorised callable) evaluated on the Ritz values in float64 on
    the host: heat kernels ``lambda ev: np.exp(-t*ev)``, resolvents
    ``lambda ev: 1/(sigma-ev)`` (sigma > lambda_max), ``np.cos``.
    ``log_scale`` of the result is non-None when |f| forced a scale
    shift (see ``expmv.fa_multiply_out_host_eig``)."""
    k = int(max(min(k, graph.n - 1), 1))
    dg = _graph_pack(graph, dg, fmt, ell_pct, device)
    x_dev = _start_vector(dg, torch_dtype(dtype), x)
    state = lanczos(dg, x_dev, k, reorthogonalize=reorthogonalize)
    ans, shift = expmv.fa_multiply_out_host_eig(state, f)
    alpha, beta, x_norm = expmv.fetch_tridiag(state.alpha, state.beta,
                                              state.x_norm)
    return LanczosResult(ans=dg.permute_out(ans), log_scale=shift,
                         alpha=alpha, beta=beta, x_norm=x_norm, k=k)


def _fetch_async(t: torch.Tensor, side):
    """Start ``t``'s device->host copy on the side stream behind the work
    queued so far on the current stream; return a function that waits
    for it and gives the numpy array.  On the CPU it is a plain view."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    # the copy starts only after the GEMV that writes t has run ...
    side.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(side):
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    # ... and t's memory is not reused by the current stream until the
    # copy on the side stream has read it
    t.record_stream(side)

    def wait():
        done.synchronize()
        return host.numpy()

    return wait


def expm_action_pipelined(
    graph: CSRGraph,
    xs,
    k: int = 50,
    *,
    dtype="float32",
    fmt: str = "auto",
    log_scale: bool = False,
    dg=None,
    ell_pct: float = 98.0,
    device="cuda",
) -> "list[LanczosResult]":
    """Serve a stream of start vectors with software pipelining: query
    i's answer device->host copy and host post-processing run while
    query i+1's Lanczos executes on the device.

    The reference's ``copy_to_host_async`` becomes a copy into pinned
    host memory on a side CUDA stream, ordered after the answer's GEMV
    by a stream wait and waited for by an event only when the answer is
    drained.  Each ``xs`` element is an (n,) start vector, or None for
    the all-ones centrality vector.  Results come back in order and
    equal sequential ``expm_action`` (host eig) bit for bit.  Peak
    device memory holds two q_basis buffers plus the pack."""
    k = int(max(min(k, graph.n - 1), 1))
    dg = _graph_pack(graph, dg, fmt, ell_pct, device)
    dtype = torch_dtype(dtype)
    side = (torch.cuda.Stream(dg.device) if dg.device.type == "cuda"
            else None)
    results: "list[LanczosResult]" = []
    pending = None  # (wait_fn, shift, alpha_h, beta_h, x_norm_h)

    def drain():
        wait, shift, alpha_h, beta_h, x_norm_h = pending
        ans = wait()
        if not log_scale:
            with np.errstate(over="ignore"):
                ans = ans * np.exp(shift).astype(ans.dtype)
        results.append(LanczosResult(
            ans=dg.permute_out(ans),
            log_scale=float(shift) if log_scale else None,
            alpha=alpha_h, beta=beta_h, x_norm=x_norm_h, k=k,
        ))

    for x in xs:
        x_dev = _start_vector(dg, dtype, x)
        # queue this query's Lanczos; the device starts on it at once
        state = lanczos(dg, x_dev, k)
        if pending is not None:
            drain()  # the previous answer's copy overlapped this compute
            pending = None
        alpha_h, beta_h, x_norm_h = expmv.fetch_tridiag(
            state.alpha, state.beta, state.x_norm)
        tmp, shift = expmv.host_coefficients(alpha_h, beta_h, x_norm_h)
        ans_dev = _host_coeff(tmp, x_dev) @ state.q_basis
        pending = (_fetch_async(ans_dev, side), shift, alpha_h, beta_h,
                   x_norm_h)
        del state, ans_dev
    if pending is not None:
        drain()
    return results


def spectral_bounds(
    graph: CSRGraph,
    k: int = 30,
    *,
    dg=None,
    fmt: str = "auto",
    ell_pct: float = 98.0,
    device="cuda",
) -> "tuple[float, float]":
    """Estimate the spectral interval of A: returns ``(ritz_max, upper)``.

    ``ritz_max`` is the largest Ritz value of a k-step float32 Lanczos
    run, a sharp estimate of lambda_max (it may overshoot by O(eps *
    lambda) under the f32 recurrence); ``upper`` is the certified bound
    max degree = ||A||_inf.  For ``fa_action`` resolvents pick sigma >
    upper for a guaranteed-finite kernel.  Uses the Q-free alpha/beta
    pass, so no n x k basis is stored."""
    k = int(max(min(k, graph.n - 1), 1))
    dg = _graph_pack(graph, dg, fmt, ell_pct, device)
    x_dev = _start_vector(dg, torch.float32, None)
    alpha, beta, x_norm = lanczos_alphabeta(dg, x_dev, k)
    alpha_h, beta_h, _ = expmv.fetch_tridiag(alpha, beta, x_norm)
    evals, _ = tridiag.eigh_host(alpha_h, beta_h)
    max_deg = int(np.max(np.diff(graph.indptr))) if graph.n else 0
    return float(evals[-1]), float(max_deg)


def run_config(cfg, graph: CSRGraph | None = None,
               x: np.ndarray | None = None, device="cuda") -> LanczosResult:
    """Run the pipeline from a :class:`tpu_lanczos_torch.config.Config`
    (the one-dataclass flag surface).  Single device only: ``cfg.shards``
    raises until the row-sharded path is ported."""
    if cfg.shards:
        raise NotImplementedError(
            "Config.shards: the row-sharded multi-device path is ROADMAP "
            "queue 1 item 14")
    if graph is None:
        from tpu_lanczos_torch.graphs import generators, io as gio

        if cfg.filename:
            graph = gio.read_mtx(cfg.filename)
        elif cfg.barabasi_deg is not None:
            graph = generators.barabasi_albert(cfg.n, cfg.barabasi_deg,
                                               seed=cfg.seed)
        else:
            graph = generators.uniform_random(cfg.n, cfg.edges, seed=cfg.seed)
    dg = None
    if cfg.fmt == "cpg":
        dg = pack_cpg(graph, theta=cfg.cpg_theta, sub=cfg.cpg_sub,
                      order=cfg.cpg_order, theta_s=cfg.cpg_theta_s,
                      redeal=cfg.cpg_redeal, layout=cfg.cpg_layout,
                      device=device)
    return expm_action(graph, x, k=cfg.krylov_dim, dtype=cfg.dtype,
                       fmt=cfg.fmt, dg=dg, ell_pct=cfg.ell_pct,
                       reorthogonalize=cfg.reorthogonalize,
                       log_scale=cfg.log_scale_output, device=device)
