"""Eigendecomposition of the k x k symmetric tridiagonal T.

The port of ``tpu_lanczos/core/tridiag.py``:

- ``eigh_host``: scipy ``eigh_tridiagonal`` (LAPACK) in float64 on numpy
  arrays, the analog of the reference's LAPACKE_dstevd call
  (parallel-final/lib/eigen.cu:13-21).  T is tiny, so only 2k scalars
  cross to the host.  The accurate path.
- ``eigh_device``: ``torch.linalg.eigh`` of the dense T on T's device, in
  T's dtype, as the reference's ``jnp.linalg.eigh`` (a library call, no
  Pallas kernel, in both packages).  On CUDA it is cuSOLVER, and it
  synchronises the device with the host to check its error code, which
  torch documents; the fused summary (core/pipeline.py) pays that one
  sync mid-query.
"""

from __future__ import annotations

import numpy as np
import torch


def dense_tridiagonal(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Dense symmetric tridiagonal T from diag alpha (k,) and subdiag
    beta (k-1,)."""
    t = torch.diag(alpha)
    if alpha.shape[0] > 1:
        t = t + torch.diag(beta, 1) + torch.diag(beta, -1)
    return t


def eigh_device(alpha: torch.Tensor, beta: torch.Tensor):
    """On-device eigendecomposition.  Returns (evals (k,) ascending,
    evecs (k, k) with columns evecs[:, i])."""
    return torch.linalg.eigh(dense_tridiagonal(alpha, beta))


def eigh_host(alpha, beta):
    """Host LAPACK path (float64).  Takes/returns numpy arrays:
    (evals (k,) ascending, evecs (k, k) with columns evecs[:, i])."""
    import scipy.linalg

    a = np.asarray(alpha, dtype=np.float64)
    b = np.asarray(beta, dtype=np.float64)
    if a.shape[0] == 1:
        return a.copy(), np.ones((1, 1), dtype=np.float64)
    return scipy.linalg.eigh_tridiagonal(a, b)
