"""Krylov multiply-out: ans = ||x|| * Q^T V e^Lambda V^T e1.

The port of ``tpu_lanczos/core/expmv.py`` (``coefficients`` and
``multiply_out_host_eig``).  The k x k stage runs on the host in float64
and gives the coefficient vector ``tmp = V (e^(Lambda - shift) * x_norm
* V^T e1)``; the O(nk) GEMV ``ans = tmp @ Q`` runs on the device in the
working dtype.  The exponential is evaluated shifted by lambda_max, so
f32 output stays finite past lambda_max ~ 88 when ``log_scale`` is set.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_lanczos_torch.core import tridiag
from tpu_lanczos_torch.core.lanczos import LanczosState
from tpu_lanczos_torch.utils import numpy_dtype


def coefficients(evals, evecs, x_norm):
    """tmp = V @ (e^(Lambda - shift) * x_norm * V[0, :]), plus the shift
    (numpy, float64)."""
    shift = evals[-1]  # ascending order; shift by lambda_max
    w = np.exp(evals - shift) * (x_norm * evecs[0, :])
    return evecs @ w, shift


def fetch_tridiag(alpha: torch.Tensor, beta: torch.Tensor,
                  x_norm: torch.Tensor):
    """alpha (k,), beta[:k-1] (numpy) and x_norm (float) in ONE
    device->host copy; ``beta`` may carry the unused slot k-1."""
    k = alpha.shape[0]
    h = torch.cat([alpha, beta[: k - 1], x_norm.reshape(1)])
    h = h.cpu().numpy()
    return h[:k], h[k:2 * k - 1], float(h[-1])


def host_coefficients(alpha, beta, x_norm):
    """Host LAPACK eigensolve of T (float64), then ``coefficients``:
    returns (tmp, shift)."""
    evals, evecs = tridiag.eigh_host(alpha, beta)
    return coefficients(evals, evecs, x_norm)


def unshift(ans_scaled: torch.Tensor, shift: float) -> torch.Tensor:
    """ans_scaled * exp(shift) in the working dtype: overflows to inf for
    lambda_max beyond ~88 in float32, as the reference's does."""
    with np.errstate(over="ignore"):
        scale = np.exp(shift).astype(numpy_dtype(ans_scaled.dtype))
    return ans_scaled * float(scale)


def multiply_out_host_eig(state: LanczosState, log_scale: bool = False):
    """Host LAPACK eigensolve of T (float64), then the GEMV on device.
    Returns ``ans`` (n_pad,) or ``(ans_scaled, shift)``."""
    tmp, shift = host_coefficients(
        *fetch_tridiag(state.alpha, state.beta, state.x_norm))
    q_basis = state.q_basis
    np_dtype = numpy_dtype(q_basis.dtype)
    coeff = torch.from_numpy(tmp.astype(np_dtype)).to(q_basis.device)
    ans_scaled = coeff @ q_basis
    if log_scale:
        return ans_scaled, float(shift)
    return unshift(ans_scaled, shift)
