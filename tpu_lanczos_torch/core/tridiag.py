"""Eigendecomposition of the k x k symmetric tridiagonal T on the host.

The port of ``tpu_lanczos/core/tridiag.py::eigh_host``: scipy
``eigh_tridiagonal`` (LAPACK) in float64, the analog of the reference's
LAPACKE_dstevd call (parallel-final/lib/eigen.cu:13-21).  T is tiny, so
only 2k scalars cross to the host.  The device eigensolve
(``eigh_device``) is ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import numpy as np


def eigh_host(alpha, beta):
    """Host LAPACK path (float64).  Takes/returns numpy arrays:
    (evals (k,) ascending, evecs (k, k) with columns evecs[:, i])."""
    import scipy.linalg

    a = np.asarray(alpha, dtype=np.float64)
    b = np.asarray(beta, dtype=np.float64)
    if a.shape[0] == 1:
        return a.copy(), np.ones((1, 1), dtype=np.float64)
    return scipy.linalg.eigh_tridiagonal(a, b)
