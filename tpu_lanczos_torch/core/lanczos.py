"""Lanczos tridiagonalization in PyTorch.

The port of ``tpu_lanczos/core/lanczos.py``: ``lanczos`` (Q stored) and
the two passes of the memory-light Q-free mode, ``lanczos_alphabeta``
and ``lanczos_recombine``.  The reference runs each k-step recurrence as
one ``lax.fori_loop``; here it is a Python loop of eager ops whose
recurrence scalars stay on the device: alpha and beta are written into
device tensors and no step reads a value back to the host, so the loop
never syncs.  Q is stored (k, n_pad), iteration-major, the layout the
multiply-out GEMV wants.  All three run the one step ``_step``, so the
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


def _step(dg, q, q_prev, b_prev):
    """One step of the reference's recurrence (lanczos.py:79-96):
    v = A q_j; alpha_j = <v, q_j>; v -= alpha_j q_j + beta_{j-1} q_{j-1};
    beta_j = ||v||; q_{j+1} = v / beta_j (zero on breakdown).  The dots
    and axpys are float32 (or float64) torch ops; no TF32 is involved.
    Returns (alpha_j, beta_j, q_{j+1})."""
    v = spmv(dg, q)
    a = torch.dot(v, q)
    v = v - a * q - b_prev * q_prev
    b = torch.sqrt(torch.dot(v, v))
    q_next = torch.where(b > 0, v / torch.where(b > 0, b, 1),
                         torch.zeros_like(v))
    return a, b, q_next


def _alphabeta(dg, x: torch.Tensor, k: int, q_basis=None):
    """The k-step recurrence from x, storing q_j into ``q_basis`` rows if
    one is given.  Returns (alpha (k,), beta (k,), x_norm), beta's slot
    k-1 written but unused."""
    x_norm = torch.sqrt(torch.dot(x, x))
    q = x / x_norm
    q_prev = torch.zeros_like(q)
    alpha = x.new_zeros((k,))
    beta = x.new_zeros((k,))
    b = x.new_zeros(())
    for j in range(k):
        if q_basis is not None:
            q_basis[j] = q
        a, b, q_next = _step(dg, q, q_prev, b)
        alpha[j] = a
        beta[j] = b
        q_prev, q = q, q_next
    return alpha, beta, x_norm


def lanczos(dg, x: torch.Tensor, k: int,
            reorthogonalize: bool = False) -> LanczosState:
    """k-step Lanczos on A given by ``dg``; x is (n_pad,), zero-padded."""
    if reorthogonalize:
        raise NotImplementedError(
            "reorthogonalize=True is ROADMAP queue 1 item 6")
    q_basis = x.new_zeros((k, x.shape[0]))
    alpha, beta, x_norm = _alphabeta(dg, x, k, q_basis)
    return LanczosState(alpha=alpha, beta=beta[: k - 1], q_basis=q_basis,
                        x_norm=x_norm)


def lanczos_alphabeta(dg, x: torch.Tensor, k: int):
    """Pass 1 of the Q-free mode: the recurrence carrying only (q, q_prev).
    Returns (alpha (k,), beta (k,), x_norm), beta's slot k-1 written but
    unused, as the reference's.  Peak live vectors: a few of n_pad."""
    return _alphabeta(dg, x, k)


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
