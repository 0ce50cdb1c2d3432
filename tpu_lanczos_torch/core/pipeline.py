"""End-to-end single-device pipeline: f(A)x = e^A.x, in PyTorch.

The port of ``tpu_lanczos/core/pipeline.py``'s host-eig paths: pack the
graph once on the host (CPG, index tensors on ``device``), run Lanczos on
the device, solve the k x k tridiagonal eigenproblem with LAPACK on the
host (the reference's architecture), then the GEMV ``tmp @ Q`` — and for
serving, a masked top-k on the device so only O(topk) values come back.

``device="cuda"`` (the default) runs the hand-written CUDA SpMV kernel;
``device="cpu"`` runs its plain PyTorch version.  Arguments this slice
does not serve yet raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.kernels.cpg import CPGGraph, pack_cpg
from tpu_lanczos_torch.core.lanczos import lanczos
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


def _check_unported(fmt: str, eig_impl: str, low_mem: bool,
                    reorthogonalize: bool = False) -> None:
    if fmt not in ("best", "cpg"):
        raise NotImplementedError(
            f"fmt={fmt!r}: only the CPG format is ported; the ell/coo/hyb "
            "formats behind 'auto' are ROADMAP queue 1 item 5")
    if eig_impl != "host":
        raise NotImplementedError(
            f"eig_impl={eig_impl!r}: the device eigensolve is ROADMAP "
            "queue 1 items 7 and 8")
    if low_mem:
        raise NotImplementedError(
            "low_mem=True (the two-pass Q-free mode) is ROADMAP queue 1 "
            "items 6 and 8")
    if reorthogonalize:
        raise NotImplementedError(
            "reorthogonalize=True is ROADMAP queue 1 item 6")


def best_device_pack(graph: CSRGraph, device="cuda") -> CPGGraph:
    """The fastest ported format: CPG on every device (the reference picks
    CPG on the TPU; the port's CPG kernel is its CUDA kernel)."""
    return pack_cpg(graph, device=device)


def _resolve_dg(graph, dg, device):
    if dg is None:
        return best_device_pack(graph, device=device)
    if not isinstance(dg, CPGGraph):
        raise NotImplementedError(
            f"{type(dg).__name__}: only CPG packs are ported")
    return dg


def _start_vector(dg: CPGGraph, dtype: torch.dtype,
                  x: np.ndarray | None) -> torch.Tensor:
    """Device start vector: for x=None (the all-ones centrality start,
    serial/main.cc:79) the permuted ones equal the pack's realmask, so
    no O(n) host->device copy is made."""
    if x is None:
        return dg.realmask.to(dtype)
    x_host = dg.permute_in(np.asarray(x), numpy_dtype(dtype))
    return torch.from_numpy(x_host).to(dg.device)


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
    dg: CPGGraph | None = None,
    low_mem: bool = False,
    device="cuda",
) -> LanczosResult:
    """e^A.x for ``graph``.  ``x`` defaults to all-ones (the centrality
    start vector); k clamps to n-1.  ``device`` is where the pack is
    built when ``dg`` is None; a given ``dg`` runs on its own device."""
    _check_unported(fmt, eig_impl, low_mem, reorthogonalize)
    k = int(max(min(k, graph.n - 1), 1))
    dg = _resolve_dg(graph, dg, device)
    x_dev = _start_vector(dg, torch_dtype(dtype), x)
    state = lanczos(dg, x_dev, k)
    out = expmv.multiply_out_host_eig(state, log_scale=log_scale)
    if log_scale:
        ans, shift_val = out
    else:
        ans, shift_val = out, None
    alpha, beta, x_norm = expmv.fetch_tridiag(state)
    return LanczosResult(
        ans=dg.permute_out(ans),
        log_scale=shift_val,
        alpha=alpha,
        beta=beta,
        x_norm=x_norm,
        k=k,
    )


def expm_action_summary(
    graph: CSRGraph,
    x: np.ndarray | None = None,
    k: int = 50,
    topk: int = 20,
    *,
    dtype="float32",
    fmt: str = "best",
    dg: CPGGraph | None = None,
    eig_impl: str = "host",
    low_mem: bool = False,
    device="cuda",
) -> SummaryResult:
    """Serving variant: the answer is reduced ON DEVICE to its top-k
    entries and norm, so the device->host transfer is O(topk).  The
    highest-centrality vertices under e^A.1 (the reference's check_ans
    max/idx metrics).  The values are the log-scaled answer."""
    _check_unported(fmt, eig_impl, low_mem)
    k = int(max(min(k, graph.n - 1), 1))
    dg = _resolve_dg(graph, dg, device)
    dtype = torch_dtype(dtype)
    x_dev = _start_vector(dg, dtype, x)
    state = lanczos(dg, x_dev, k)
    # one host sync for alpha, beta and x_norm together
    alpha_h, beta_h, x_norm_h = expmv.fetch_tridiag(state)
    evals, evecs = tridiag.eigh_host(alpha_h, beta_h)
    tmp, shift = expmv.coefficients(evals, evecs, x_norm_h)
    coeff = torch.from_numpy(tmp.astype(numpy_dtype(dtype))).to(dg.device)
    ans = coeff @ state.q_basis
    neg = torch.finfo(dtype).min
    vals, idx = torch.topk(torch.where(dg.realmask > 0, ans, neg), topk)
    nrm = torch.linalg.vector_norm(ans)
    # tiny D2H: topk values + indices + one norm
    vals_h = vals.cpu().numpy()
    idx_h = idx.cpu().numpy()
    old_of_new = np.full(dg.n_pad, -1, dtype=np.int64)
    old_of_new[dg.new_of_old] = np.arange(graph.n)
    return SummaryResult(
        top_values=vals_h,
        top_nodes=old_of_new[idx_h],
        ans_norm=float(nrm),
        log_scale=float(shift),
        alpha=alpha_h,
        beta=beta_h,
        x_norm=x_norm_h,
        k=k,
    )
