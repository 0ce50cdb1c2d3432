"""Row-sharded Lanczos and e^A.x over a 1-D mesh.

The port of ``tpu_lanczos/dist/lanczos.py``.  Communication per
iteration is the reference CUDA code's dual-GPU pattern
(parallel-two-cards/lib/cu_lanczos.cu:114-169) recast as mesh
collectives:

  reference CUDA code (2 GPUs, PCIe)      the mesh (dist/mesh.py)
  --------------------------------------  ---------------------------
  cudaMemcpyPeer broadcast of q (n words) all_gather of q shards
  gather half-result to GPU0 (n/2 words)  (not needed: y stays sharded)
  all dots/norms reduced on GPU0 only     psum across shards
  Q column D2H + host transpose           Q stays sharded (k, n_loc)

Here the ELL/COO formats, whose SpMV the JAX package leaves to XLA, are
torch ops (the reference's ``_local_spmv``); the CPG pack runs its CUDA
kernel (dist/cpg_sharded.py).  ``expm_action_sharded`` dispatches on the
pack; ``fmt="best"`` packs CPG on every device (the reference packs CPG
only on a TPU), because the port's CPG kernel is its CUDA kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_lanczos_torch.core import expmv, tridiag
from tpu_lanczos_torch.core.lanczos import LanczosState
from tpu_lanczos_torch.dist.cpg_sharded import (
    ShardedCPG, _as_shards, _local, pack_cpg_sharded)
from tpu_lanczos_torch.dist.mesh import (
    Mesh, sharded_alphabeta_body, sharded_diag_probes_body,
    sharded_lanczos_body, sharded_trace_probes_body)
from tpu_lanczos_torch.dist.partition import ShardedGraph, pack_sharded
from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.utils import numpy_dtype, torch_dtype


def _local_spmv(ell_idx, ell_deg, coo_cols, coo_offsets, x_full, n_loc):
    """One shard's SpMV of its row block against the full vector:
    ell_idx (w, n_loc) global col ids, the spill's global cols and its
    per-local-row offsets.  A masked ELL gather-sum plus a sorted segment
    sum (deterministic on CUDA too: no atomics, as the single-device COO
    SpMV, kernels/spmv.py).  Returns the local (n_loc,) slice of A x."""
    gathered = x_full[ell_idx.long()]  # (w, n_loc)
    slot_ids = torch.arange(ell_idx.shape[0], device=x_full.device)[:, None]
    mask = slot_ids < ell_deg[None, :]
    y = torch.where(mask, gathered, x_full.new_zeros(())).sum(dim=0)
    spill_vals = x_full[coo_cols.long()]
    y_spill = torch.segment_reduce(spill_vals, "sum", offsets=coo_offsets,
                                   initial=0)
    return y + y_spill[:n_loc]


def _local_ell(sg: ShardedGraph, mesh: Mesh):
    """The ELL/COO backend's exchange + local SpMV on per-shard lists: the
    whole vector is gathered (the halo), each shard multiplies its rows."""
    def local(q):
        q_full = mesh.all_gather(q)
        return [_local_spmv(e, d, c, o, x, sg.n_loc) for e, d, c, o, x in zip(
            sg.ell_indices, sg.ell_degrees, sg.coo_cols, sg.coo_offsets,
            q_full)]
    return local


def local_spmv_fn(sg, mesh: Mesh):
    """The pack's ``local_spmv`` (per-shard list -> per-shard list): the
    CPG kernel for a ShardedCPG, the ELL/COO torch ops otherwise."""
    if isinstance(sg, ShardedCPG):
        return _local(sg, mesh)
    return _local_ell(sg, mesh)


def lanczos_sharded(sg: ShardedGraph, x, k: int, mesh: Mesh,
                    reorthogonalize: bool = False) -> LanczosState:
    """k-step Lanczos on the row-sharded ELL/COO graph.  ``x`` is the
    (n_pad,) permuted start vector (see ShardedGraph.permute_in) or its
    per-shard list.  Returns alpha, beta[:k-1] and x_norm replicated and
    ``q_basis`` as the per-shard tuple of (k, n_loc)."""
    alpha, beta, q_basis, x_norm = sharded_lanczos_body(
        mesh, _local_ell(sg, mesh), _as_shards(mesh, x, sg.n_loc), k,
        reorthogonalize)
    return LanczosState(alpha=alpha, beta=beta[: k - 1],
                        q_basis=tuple(q_basis), x_norm=x_norm)


def lanczos_alphabeta_sharded(sg: ShardedGraph, x, k: int, mesh: Mesh):
    """Pass-1 Q-free Lanczos on the row-sharded ELL/COO graph, O(n_loc)
    memory per shard.  Returns (alpha, beta, x_norm) replicated; beta is
    FULL length k (slot k-1 the residual norm)."""
    return sharded_alphabeta_body(mesh, _local_ell(sg, mesh),
                                  _as_shards(mesh, x, sg.n_loc), k)


def trace_probes_sharded(sg: ShardedGraph, mask: list, seed: int,
                         stream: int, k: int, probes: int, mesh: Mesh,
                         u_rows: list):
    """Every trace probe on the row-sharded ELL/COO formats (see
    dist.mesh.sharded_trace_probes_body).  Returns replicated (alphas,
    betas, x_norms, coeffs)."""
    return sharded_trace_probes_body(mesh, _local_ell(sg, mesh), mask, seed,
                                     stream, k, probes, u_rows)


def diag_probes_sharded(sg: ShardedGraph, mask: list, seed: int,
                        stream: int, attempt: int, k: int, probes: int,
                        mesh: Mesh, u_rows: list, w_defl, shift) -> list:
    """The diagonal-probe accumulator on the row-sharded ELL/COO formats:
    the per-shard slices of the scaled diagonal estimate."""
    return sharded_diag_probes_body(mesh, _local_ell(sg, mesh), mask, seed,
                                    stream, attempt, k, probes, u_rows,
                                    w_defl, shift)


def multiply_out_sharded(state: LanczosState, mesh: Mesh,
                         eig_impl: str = "host", log_scale: bool = False):
    """The multiply-out of a sharded state (q_basis per shard): host
    LAPACK (one fetch of T) or the device eigensolve, once per process,
    then each shard's GEMV.  Returns ``(ans, shift)``: the per-shard
    answer slices and the shift (a float; None without ``log_scale``,
    where the answer is unshifted in the working dtype)."""
    q_basis = state.q_basis
    if eig_impl == "host":
        tmp, shift = expmv.host_coefficients(
            *expmv.fetch_tridiag(state.alpha, state.beta, state.x_norm))
        coeff = mesh.replicate(torch.from_numpy(tmp.astype(numpy_dtype(
            q_basis[0].dtype))).to(mesh.devices[0]))
        ans = [c @ q for c, q in zip(coeff, q_basis)]
        if log_scale:
            return ans, float(shift)
        return [expmv.unshift(a, shift) for a in ans], None
    evals, evecs = tridiag.eigh_device(state.alpha, state.beta)
    tmp, shift = expmv.coefficients(evals, evecs, state.x_norm)
    ans = [t @ q for t, q in zip(mesh.replicate(tmp), q_basis)]
    if log_scale:
        return ans, float(shift)
    return [a * s for a, s in zip(ans, mesh.replicate(torch.exp(shift)))], None


def expm_action_sharded(
    graph: CSRGraph | ShardedGraph | ShardedCPG,
    x: np.ndarray | None = None,
    k: int = 50,
    *,
    mesh: Mesh,
    dtype="float32",
    fmt: str = "auto",
    reorthogonalize: bool = False,
    log_scale: bool = False,
    eig_impl: str = "host",
    pack_kw: dict | None = None,
    ell_pct: float = 90.0,
):
    """Multi-device e^A.x.  Accepts a host CSRGraph (packed here for the
    mesh) or a pre-packed ShardedGraph/ShardedCPG.  ``fmt="cpg"`` or
    ``"best"`` packs CPG (the CUDA kernel on each shard; the reference
    picks CPG for "best" on a TPU only), the ELL/COO formats otherwise.
    ``pack_kw`` goes to pack_cpg_sharded (theta, sub, order, ...).
    Returns (ans (n,) numpy in ORIGINAL vertex order, shift or None,
    state, sharded graph)."""
    if eig_impl not in ("host", "device"):
        raise ValueError(f"eig_impl must be host or device, got {eig_impl!r}")
    if isinstance(graph, (ShardedGraph, ShardedCPG)):
        sg = graph
    elif fmt in ("cpg", "best"):
        sg = pack_cpg_sharded(graph, mesh.n_shards, mesh=mesh,
                              **(pack_kw or {}))
    else:
        sg = pack_sharded(graph, mesh.n_shards, fmt=fmt, mesh=mesh,
                          ell_pct=ell_pct)
    n = sg.n
    k = int(max(min(k, n - 1), 1))
    dt = torch_dtype(dtype)
    x_host = np.ones(n) if x is None else np.asarray(x)
    x_sh = mesh.split(sg.permute_in(x_host, numpy_dtype(dt)), sg.n_loc)
    alpha, beta, q_basis, x_norm = sharded_lanczos_body(
        mesh, local_spmv_fn(sg, mesh), x_sh, k, reorthogonalize)
    state = LanczosState(alpha=alpha, beta=beta[: k - 1],
                         q_basis=tuple(q_basis), x_norm=x_norm)
    ans, shift = multiply_out_sharded(state, mesh, eig_impl, log_scale)
    return sg.permute_out(mesh.to_host(ans)), shift, state, sg
