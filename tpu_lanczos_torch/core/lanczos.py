"""Lanczos tridiagonalization in PyTorch.

The port of ``tpu_lanczos/core/lanczos.py``: ``lanczos`` (Q stored, with
optional full reorthogonalization), its restartable pieces
``lanczos_init`` and ``lanczos_range``, and the two passes of the
memory-light Q-free mode, ``lanczos_alphabeta`` and
``lanczos_recombine``.  The reference runs each k-step recurrence as one
``lax.fori_loop`` whose step XLA fuses; here each step is the SpMV and
then ``kernels/lanczos_step.py::lanczos_step`` (on the card one
cooperative launch of a hand-written kernel: dot, update with norm,
normalize; on a CPG pack it also does the SpMV's realmask multiply).
The recurrence scalars stay on the device: alpha and beta are written
into device tensors and no step reads a value back to the host, so the
loop never syncs.  Q is stored (k, n_pad), iteration-major, the layout
the multiply-out GEMV wants.  All of them run the one step
``lanczos_step``, so the two passes regenerate stored-Q Lanczos's alpha,
beta and q_j bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.cpg import CPGGraph
from tpu_lanczos_torch.kernels.lanczos_step import lanczos_step, workspace
from tpu_lanczos_torch.kernels.spmv import spmv


@dataclasses.dataclass(frozen=True)
class LanczosState:
    """alpha (k,), beta (k-1,), q_basis (k, n_pad), x_norm scalar."""

    alpha: torch.Tensor
    beta: torch.Tensor
    q_basis: torch.Tensor
    x_norm: torch.Tensor

    @property
    def k(self) -> int:
        return self.alpha.shape[0]


def step_spmv(dg, q: torch.Tensor):
    """The SpMV a step starts from: on a CPG pack A q before its realmask
    multiply and that mask, which ``lanczos_step`` folds into its load
    (exact: the same bits); on any other pack ``spmv`` and None."""
    if isinstance(dg, CPGGraph):
        return spmv_cpg.spmv_cpg(dg, q, masked=False), dg.realmask
    return spmv(dg, q), None


def lanczos_range(dg, carry, j0: int, j1: int,
                  reorthogonalize: bool = False):
    """Run iterations [j0, j1) of the recurrence on a loop carry
    ``(q, q_prev, q_basis, alpha, beta)`` with k-sized buffers, writing
    q_j into row j of q_basis and alpha_j, beta_j into their slots (in
    place; the carry's tensors are updated).  Returns the new carry.
    Exposed so a decomposition can run in restartable chunks.
    ``reorthogonalize`` runs the masked full Gram-Schmidt against rows
    0..j each step (lanczos.py:87-92)."""
    q, q_prev, q_basis, alpha, beta = carry
    if j0 < j1:
        q_basis[j0] = q
    work = workspace(q.device)
    for j in range(j0, j1):
        # step j stores q_{j+1} in its row; the chunk's last step leaves
        # row j1 to the next chunk, as the reference's loop does
        v, mask = step_spmv(dg, q)
        q_next = lanczos_step(
            v, q, q_prev, alpha, beta, j,
            q_basis=q_basis if reorthogonalize else None,
            store=q_basis[j + 1] if j + 1 < j1 else None, work=work,
            mask=mask)
        q_prev, q = q, q_next
    return (q, q_prev, q_basis, alpha, beta)


def lanczos_init(dg, x: torch.Tensor, k: int):
    """Initial carry for ``lanczos_range``.  Returns (carry, x_norm)."""
    x_norm = torch.sqrt(torch.dot(x, x))
    q0 = x / x_norm
    carry = (
        q0,
        torch.zeros_like(q0),
        x.new_zeros((k, x.shape[0])),
        x.new_zeros((k,)),
        x.new_zeros((k,)),  # beta; slot k-1 written but unused
    )
    return carry, x_norm


def lanczos(dg, x: torch.Tensor, k: int,
            reorthogonalize: bool = False) -> LanczosState:
    """k-step Lanczos on A given by ``dg``; x is (n_pad,), zero-padded.
    ``reorthogonalize`` runs the masked full Gram-Schmidt each step."""
    carry, x_norm = lanczos_init(dg, x, k)
    _, _, q_basis, alpha, beta = lanczos_range(
        dg, carry, 0, k, reorthogonalize=reorthogonalize)
    return LanczosState(alpha=alpha, beta=beta[: k - 1], q_basis=q_basis,
                        x_norm=x_norm)


def lanczos_alphabeta(dg, x: torch.Tensor, k: int):
    """Pass 1 of the Q-free mode: the recurrence carrying only (q, q_prev).
    Returns (alpha (k,), beta (k,), x_norm), beta's slot k-1 written but
    unused, as the reference's.  Peak live vectors: a few of n_pad."""
    x_norm = torch.sqrt(torch.dot(x, x))
    q = x / x_norm
    q_prev = torch.zeros_like(q)
    alpha = x.new_zeros((k,))
    beta = x.new_zeros((k,))
    work = workspace(q.device)
    for j in range(k):
        v, mask = step_spmv(dg, q)
        q_next = lanczos_step(v, q, q_prev, alpha, beta, j, work=work,
                              mask=mask)
        q_prev, q = q, q_next
    return alpha, beta, x_norm


def lanczos_recombine(dg, x: torch.Tensor, coeff: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Pass 2 of the Q-free mode: regenerate q_j with the identical
    recurrence and accumulate ans = sum_j coeff[j] q_j on the fly.  The
    recurrence runs k-1 times: q_{k-1} needs no further SpMV.  Step j
    adds coeff[j+1] q_{j+1} to ``ans`` in place, the multiply and add of
    an eager ``ans + coeff[j+1] * q``."""
    x_norm = torch.sqrt(torch.dot(x, x))
    q = x / x_norm
    q_prev = torch.zeros_like(q)
    ans = torch.zeros_like(q) + coeff[0] * q
    alpha = x.new_zeros((k,))
    beta = x.new_zeros((k,))
    work = workspace(q.device)
    for j in range(k - 1):
        v, mask = step_spmv(dg, q)
        q_next = lanczos_step(v, q, q_prev, alpha, beta, j, ans=ans,
                              coeff=coeff, work=work, mask=mask)
        q_prev, q = q, q_next
    return ans
