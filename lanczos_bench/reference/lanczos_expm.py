"""Plain k-step Lanczos approximation of e^A x, for the check of every
answer the benchmark's queries return.

The same mathematics as the program's queries (k Lanczos steps from x
without reorthogonalization, the tridiagonal T's eigensolve, the
answer ||x|| Q^T V e^(Lambda - lambda_max) V^T e1 scaled by e^-lambda_max)
written straight from the definition with SciPy's CSR product, from the
benchmark's own CSR arrays.  It imports NumPy and SciPy only and takes
nothing the program made.

``precision`` picks the arithmetic:
- "float64": the reference that decides ``correct``;
- "float32": every operation in float32 (the control of a float64-grade
  configuration);
- "tf32": float32 accumulation with every operand of a product rounded to
  TF32's 10 mantissa bits (the control of a float32 configuration that
  keeps TF32 off).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.sparse as sp

PRECISIONS = ("float64", "float32", "tf32")


def round_tf32(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero, as a TF32 operand is formed from float32)."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    bits = a.view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def adjacency(indptr: np.ndarray, indices: np.ndarray, dtype) -> sp.csr_matrix:
    n = indptr.shape[0] - 1
    data = np.ones(indices.shape[0], dtype=dtype)
    return sp.csr_matrix((data, indices, indptr), shape=(n, n))


def expm_lanczos(indptr: np.ndarray, indices: np.ndarray, k: int,
                 precision: str = "float64", x: np.ndarray | None = None):
    """The k-step Lanczos approximation of e^A x for the graph in CSR.

    Returns ``(ans_scaled, shift, alpha, beta)`` as float64 arrays and a
    float: the answer is ``ans_scaled * exp(shift)``, ``shift`` the
    largest Ritz value.  ``x`` defaults to all ones; k clamps to n - 1."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    n = indptr.shape[0] - 1
    k = int(max(min(k, n - 1), 1))
    dtype = np.float64 if precision == "float64" else np.float32
    rnd = round_tf32 if precision == "tf32" else (lambda v: v)
    a = adjacency(indptr, indices, dtype)
    x = np.ones(n, dtype=dtype) if x is None else np.asarray(x, dtype)
    x_norm = np.linalg.norm(x)
    q_basis = np.zeros((k, n), dtype=dtype)
    alpha = np.zeros(k, dtype=dtype)
    beta = np.zeros(k, dtype=dtype)
    q = x / x_norm
    q_prev = np.zeros_like(q)
    for j in range(k):
        q_basis[j] = q
        w = a @ rnd(q)
        alpha[j] = np.dot(rnd(q), rnd(w))
        w = w - alpha[j] * q
        if j:
            w = w - beta[j - 1] * q_prev
        beta[j] = np.linalg.norm(w)
        q_prev, q = q, (w / beta[j] if beta[j] > 0 else np.zeros_like(w))
    evals, evecs = scipy.linalg.eigh_tridiagonal(
        rnd(alpha), rnd(beta[:k - 1]) if k > 1 else beta[:0])
    shift = evals[-1]
    coeff = evecs @ (np.exp(evals - shift) * (x_norm * evecs[0, :]))
    ans = rnd(coeff.astype(dtype)) @ rnd(q_basis)
    return (ans.astype(np.float64), float(shift), alpha.astype(np.float64),
            beta[:k - 1].astype(np.float64))
