"""Lanczos tridiagonalization in PyTorch.

The port of ``tpu_lanczos/core/lanczos.py::lanczos``.  The reference runs
the k-step recurrence as one ``lax.fori_loop``; here it is a Python loop
of eager ops whose recurrence scalars stay on the device: alpha and beta
are written into device tensors and no step reads a value back to the
host, so the loop never syncs.  Q is stored (k, n_pad), iteration-major,
the layout the multiply-out GEMV wants.
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


def lanczos(dg, x: torch.Tensor, k: int,
            reorthogonalize: bool = False) -> LanczosState:
    """k-step Lanczos on A given by ``dg``; x is (n_pad,), zero-padded.

    Keeps the reference's recurrence order (lanczos.py:79-96): v = A q_j;
    alpha_j = <v, q_j>; v -= alpha_j q_j + beta_{j-1} q_{j-1};
    beta_j = ||v||; q_{j+1} = v / beta_j (zero on breakdown).  The dots
    and axpys are float32 (or float64) torch ops; no TF32 is involved.
    """
    if reorthogonalize:
        raise NotImplementedError(
            "reorthogonalize=True is ROADMAP queue 1 item 6")
    x_norm = torch.sqrt(torch.dot(x, x))
    q = x / x_norm
    q_prev = torch.zeros_like(q)
    q_basis = x.new_zeros((k, x.shape[0]))
    alpha = x.new_zeros((k,))
    beta = x.new_zeros((k,))  # slot k-1 written but unused
    zero = x.new_zeros(())
    for j in range(k):
        q_basis[j] = q
        v = spmv(dg, q)
        a = torch.dot(v, q)
        alpha[j] = a
        b_prev = beta[j - 1] if j > 0 else zero
        v = v - a * q - b_prev * q_prev
        b = torch.sqrt(torch.dot(v, v))
        beta[j] = b
        q_next = torch.where(b > 0, v / torch.where(b > 0, b, 1),
                             torch.zeros_like(v))
        q_prev, q = q, q_next
    return LanczosState(alpha=alpha, beta=beta[: k - 1], q_basis=q_basis,
                        x_norm=x_norm)
