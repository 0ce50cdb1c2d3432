"""Krylov multiply-out: ans = ||x|| * Q^T V e^Lambda V^T e1.

The port of ``tpu_lanczos/core/expmv.py``.  The k x k stage gives the
coefficient vector ``tmp = V (e^(Lambda - shift) * x_norm * V^T e1)``:
on the host in float64 (``multiply_out_host_eig``, the accurate path),
or on the device in the working dtype (``multiply_out``, after
``tridiag.eigh_device``).  The O(nk) GEMV ``ans = tmp @ Q`` runs on the
device in the working dtype.  The exponential is evaluated shifted by
lambda_max, so f32 output stays finite past lambda_max ~ 88 when
``log_scale`` is set.  ``fa_multiply_out_host_eig`` applies any f.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_lanczos_torch.core import tridiag
from tpu_lanczos_torch.core.lanczos import LanczosState
from tpu_lanczos_torch.utils import numpy_dtype


def coefficients(evals, evecs, x_norm):
    """tmp = V @ (e^(Lambda - shift) * x_norm * V[0, :]), plus the shift;
    numpy arrays (host) or torch tensors (device)."""
    exp = torch.exp if isinstance(evals, torch.Tensor) else np.exp
    shift = evals[-1]  # ascending order; shift by lambda_max
    w = exp(evals - shift) * (x_norm * evecs[0, :])
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


def multiply_out(state: LanczosState, log_scale: bool = False):
    """Multiply-out with the device eigensolve, all on T's device.
    Returns ``ans`` (n_pad,) or ``(ans_scaled, shift)`` with ``shift`` a
    0-d device tensor; no value is read back to the host.

    With ``log_scale=False`` the final ``* exp(shift)`` runs in the
    working dtype and overflows to inf past lambda_max ~ 88 (f32), as
    the reference's does."""
    evals, evecs = tridiag.eigh_device(state.alpha, state.beta)
    tmp, shift = coefficients(evals, evecs, state.x_norm)
    ans_scaled = tmp @ state.q_basis  # (n_pad,); Q stored (k, n_pad)
    if log_scale:
        return ans_scaled, shift
    return ans_scaled * torch.exp(shift)


def fa_multiply_out_host_eig(state: LanczosState, f):
    """General spectral-function multiply-out
    ans = ||x|| * Q^T V f(Lambda) V^T e1, with f evaluated on the Ritz
    values in float64 on the host (heat kernels, resolvents, cos, ...).

    Returns ``(ans_scaled, log_scale)``: when the coefficient vector
    would overflow or underflow the working dtype, or forming it would
    already overflow float64, the GEMV runs on a rescaled tmp and
    ``log_scale`` carries the shift (true ans = ans_scaled *
    e^log_scale); otherwise ``log_scale`` is None.  Raises
    FloatingPointError when f is non-finite in float64 on a Ritz value
    (a resolvent pole inside the spectrum)."""
    alpha_h, beta_h, x_norm_h = fetch_tridiag(
        state.alpha, state.beta, state.x_norm)
    evals, evecs = tridiag.eigh_host(alpha_h, beta_h)
    fe = np.asarray(f(evals), dtype=np.float64)
    if not np.all(np.isfinite(fe)):
        raise FloatingPointError(
            "f(eigenvalue) is non-finite on a Ritz value (resolvent "
            "pole inside the spectrum, or f overflows float64 — for "
            "exp-family f at scale use expm_action's log_scale path); "
            "cannot form f(A).x"
        )
    # pre-scale in f64 BEFORE forming w: fe is finite but
    # fe * x_norm * V[0,:] (or the k-term GEMV) can still overflow f64,
    # which would skip the dtype guard below on NaN
    shift = 0.0
    peak_fe = float(np.max(np.abs(fe)))
    if peak_fe > 0 and peak_fe > float(np.finfo(np.float64).max) / 1e10:
        shift = float(np.log(peak_fe))
        fe = fe * np.exp(-shift)
    w = fe * (float(x_norm_h) * evecs[0, :])
    tmp = evecs @ w
    q_basis = state.q_basis
    np_dtype = numpy_dtype(q_basis.dtype)
    fin = np.finfo(np_dtype)
    peak = float(np.max(np.abs(tmp)))
    # 1e6 headroom: the GEMV accumulates up to k terms and the answer's
    # norm can exceed the coefficient peak by ||Q|| factors
    if peak > 0 and (peak > float(fin.max) / 1e6
                     or peak < float(fin.tiny) * 1e6):
        extra = float(np.log(peak))
        tmp = tmp * np.exp(-extra)
        shift += extra
    out_shift = shift if shift != 0.0 else None
    coeff = torch.from_numpy(tmp.astype(np_dtype)).to(q_basis.device)
    return coeff @ q_basis, out_shift
