"""Lanczos tridiagonalization in PyTorch.

The port of ``tpu_lanczos/core/lanczos.py``: ``lanczos`` (Q stored, with
optional full reorthogonalization), its restartable pieces
``lanczos_init`` and ``lanczos_range``, and the two passes of the
memory-light Q-free mode, ``lanczos_alphabeta`` and
``lanczos_recombine``.  The reference runs each k-step recurrence as one
``lax.fori_loop``; here it is a Python loop of eager ops whose recurrence
scalars stay on the device: alpha and beta are written into device
tensors and no step reads a value back to the host, so the loop never
syncs.  Q is stored (k, n_pad), iteration-major, the layout the
multiply-out GEMV wants.  All of them run the one step ``_step``, so the
two passes regenerate stored-Q Lanczos's alpha, beta and q_j bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

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


def _step(dg, q, q_prev, b_prev, q_basis=None, j: int = 0):
    """One step of the reference's recurrence (lanczos.py:79-96):
    v = A q_j; alpha_j = <v, q_j>; v -= alpha_j q_j + beta_{j-1} q_{j-1};
    beta_j = ||v||; q_{j+1} = v / beta_j (zero on breakdown).  Given
    ``q_basis``, v is first reorthogonalized by a masked full
    Gram-Schmidt against rows 0..j (two GEMVs over the (k, n_pad) basis,
    lanczos.py:87-92).  The dots, GEMVs and axpys are float32 (or
    float64) torch ops; no TF32 is involved.  Returns (alpha_j, beta_j,
    q_{j+1})."""
    v = spmv(dg, q)
    a = torch.dot(v, q)
    v = v - a * q - b_prev * q_prev
    if q_basis is not None:
        proj = q_basis @ v  # (k,)
        row_ids = torch.arange(q_basis.shape[0], device=v.device)
        proj = torch.where(row_ids <= j, proj, proj.new_zeros(()))
        v = v - proj @ q_basis
    b = torch.sqrt(torch.dot(v, v))
    q_next = torch.where(b > 0, v / torch.where(b > 0, b, 1),
                         torch.zeros_like(v))
    return a, b, q_next


def lanczos_range(dg, carry, j0: int, j1: int,
                  reorthogonalize: bool = False):
    """Run iterations [j0, j1) of the recurrence on a loop carry
    ``(q, q_prev, q_basis, alpha, beta)`` with k-sized buffers, writing
    q_j into row j of q_basis and alpha_j, beta_j into their slots (in
    place; the carry's tensors are updated).  Returns the new carry.
    Exposed so a decomposition can run in restartable chunks."""
    q, q_prev, q_basis, alpha, beta = carry
    for j in range(j0, j1):
        q_basis[j] = q
        b_prev = beta[j - 1] if j > 0 else beta.new_zeros(())
        a, b, q_next = _step(dg, q, q_prev, b_prev,
                             q_basis if reorthogonalize else None, j)
        alpha[j] = a
        beta[j] = b
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
    b = x.new_zeros(())
    for j in range(k):
        a, b, q_next = _step(dg, q, q_prev, b)
        alpha[j] = a
        beta[j] = b
        q_prev, q = q, q_next
    return alpha, beta, x_norm


def lanczos_recombine(dg, x: torch.Tensor, coeff: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Pass 2 of the Q-free mode: regenerate q_j with the identical
    recurrence and accumulate ans = sum_j coeff[j] q_j on the fly.  The
    recurrence runs k-1 times: q_{k-1} needs no further SpMV."""
    x_norm = torch.sqrt(torch.dot(x, x))
    q = x / x_norm
    q_prev = torch.zeros_like(q)
    ans = torch.zeros_like(q)
    b = x.new_zeros(())
    for j in range(k - 1):
        ans = ans + coeff[j] * q
        _, b, q_next = _step(dg, q, q_prev, b)
        q_prev, q = q, q_next
    return ans + coeff[k - 1] * q
