"""Serial numpy/scipy oracle for the full e^A.x pipeline.

This plays the role of the reference's serial C++ implementation
(serial/lib/lanczos.cc:9-56, eigen.cc:12-15, multiplyOut.cc:17-37): every
device path of the port is cross-checked against it, exactly as the
reference cross-checks CUDA against serial (parallel-final/main.cu:156,
check_ans.cu:11-29).  A copy of ``tpu_lanczos/eval/oracle.py`` pointed at
the port's CSRGraph, so it runs where jax is not installed.

All computation is float64 numpy/scipy — independent of torch — so it is
a true second implementation, not a re-trace of the same code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg

from tpu_lanczos_torch.graphs.csr import CSRGraph


def spmv(graph: CSRGraph, x: np.ndarray) -> np.ndarray:
    """Value-free CSR SpMV: out[i] = sum_{j in row i} x[indices[j]]
    (reference: serial/lib/SPMV.cc:18-31)."""
    # segment-sum formulation (vectorized equivalent of the row loop)
    gathered = x[graph.indices]
    out = np.zeros(graph.n, dtype=x.dtype)
    np.add.at(out, graph.row_ids(), gathered)
    return out


@dataclasses.dataclass
class OracleLanczos:
    alpha: np.ndarray  # (k,)   diagonal of T
    beta: np.ndarray  # (k-1,) subdiagonal of T
    q_basis: np.ndarray  # (n, k) orthonormal Krylov basis
    x_norm: float


def lanczos(
    graph: CSRGraph,
    x: np.ndarray,
    k: int,
    reorthogonalize: bool = False,
) -> OracleLanczos:
    """k-step Lanczos three-term recurrence (serial/lib/lanczos.cc:9-56;
    the working full-reorthogonalization variant mirrors
    decompose_with_arnoldi, lanczos.cc:58-132, applied every iteration)."""
    n = graph.n
    x = np.asarray(x, dtype=np.float64)
    x_norm = float(np.linalg.norm(x))
    q_basis = np.zeros((n, k), dtype=np.float64)
    alpha = np.zeros(k, dtype=np.float64)
    beta = np.zeros(max(k - 1, 0), dtype=np.float64)
    q = x / x_norm
    q_prev = np.zeros(n, dtype=np.float64)
    for j in range(k):
        q_basis[:, j] = q
        v = spmv(graph, q)
        alpha[j] = float(v @ q)
        v = v - alpha[j] * q
        if j > 0:
            v = v - beta[j - 1] * q_prev
        if reorthogonalize:
            # full Gram-Schmidt sweep against all previous basis vectors
            v = v - q_basis[:, : j + 1] @ (q_basis[:, : j + 1].T @ v)
        if j < k - 1:
            beta[j] = float(np.linalg.norm(v))
            q_prev = q
            # exact-breakdown guard (matches the device paths' b > 0
            # masking): the Krylov space is complete, later q_j stay 0
            # and the answer is already exact in the spanned subspace
            q = v / beta[j] if beta[j] > 0 else np.zeros(n)
    return OracleLanczos(alpha=alpha, beta=beta, q_basis=q_basis, x_norm=x_norm)


def tridiag_eigh(alpha: np.ndarray, beta: np.ndarray):
    """Eigendecomposition of the symmetric tridiagonal T
    (reference: LAPACKE_dstevd, parallel-final/lib/eigen.cu:13-21).
    Returns (eigenvalues (k,), eigenvectors (k,k) column-major V[:,i])."""
    return scipy.linalg.eigh_tridiagonal(alpha, beta)


def multiply_out(dec: OracleLanczos) -> np.ndarray:
    """ans = ||x|| * Q @ V @ (e^Lambda * V^T e1)
    (reference: parallel-final/lib/multiplyOut.cu:25-49)."""
    evals, evecs = tridiag_eigh(dec.alpha, dec.beta)
    w = np.exp(evals) * dec.x_norm * evecs[0, :]
    return dec.q_basis @ (evecs @ w)


def expm_action(
    graph: CSRGraph, x: np.ndarray, k: int, reorthogonalize: bool = False
) -> np.ndarray:
    """Full oracle pipeline: f(A)x = e^A.x via k-step Lanczos."""
    k = max(min(k, graph.n - 1), 1)  # reference clamps k (serial/main.cc:64)
    dec = lanczos(graph, x, k, reorthogonalize=reorthogonalize)
    return multiply_out(dec)


def expm_action_shifted(
    graph: CSRGraph, x: np.ndarray, k: int
) -> tuple[np.ndarray, float]:
    """Overflow-safe oracle: returns (e^{A-sI}.x, s) with s = max Ritz
    value, so the finite part stays representable even when e^{lambda_max}
    overflows f64 (lambda_max > ~709 on heavy-hub power-law graphs — the
    regime where the reference's double pipeline printed inf/nan,
    final_output1.txt:154-159).  e^A.x = e^s * ans_scaled."""
    k = max(min(k, graph.n - 1), 1)
    dec = lanczos(graph, x, k)
    evals, evecs = tridiag_eigh(dec.alpha, dec.beta)
    shift = float(evals[-1])
    w = np.exp(evals - shift) * dec.x_norm * evecs[0, :]
    return dec.q_basis @ (evecs @ w), shift


def fa_action(graph: CSRGraph, x: np.ndarray, k: int, f) -> np.ndarray:
    """Oracle for the general spectral-function action f(A)x:
    ans = ||x|| * Q @ V @ (f(Lambda) * V^T e1)."""
    k = max(min(k, graph.n - 1), 1)
    dec = lanczos(graph, x, k)
    evals, evecs = tridiag_eigh(dec.alpha, dec.beta)
    w = np.asarray(f(evals), dtype=np.float64) * dec.x_norm * evecs[0, :]
    return dec.q_basis @ (evecs @ w)


def expm_action_dense(graph: CSRGraph, x: np.ndarray) -> np.ndarray:
    """Ground truth by dense eigendecomposition of A itself (only for small
    graphs) — the analog of the reference's analytic test construction
    (serial/tests/numerical_test.cc:45-116)."""
    a_dense = graph.to_scipy().toarray()
    evals, evecs = np.linalg.eigh(a_dense)
    return evecs @ (np.exp(evals) * (evecs.T @ np.asarray(x, dtype=np.float64)))


def trace_expm_dense(graph: CSRGraph) -> float:
    """Ground-truth Estrada index tr(e^A) = sum_i e^{lambda_i} by dense
    eigendecomposition (small graphs only) — oracle for the stochastic
    trace estimator (core/stochastic.py)."""
    evals = np.linalg.eigvalsh(graph.to_scipy().toarray())
    return float(np.exp(evals).sum())


def trace_fa_dense(graph: CSRGraph, f) -> float:
    """Ground-truth tr(f(A)) = sum_i f(lambda_i) by dense
    eigendecomposition (small graphs only) — oracle for the general-f
    stochastic trace estimator (core/stochastic.py trace_fa)."""
    evals = np.linalg.eigvalsh(graph.to_scipy().toarray())
    return float(np.asarray(f(evals), dtype=np.float64).sum())


def diag_expm_dense(graph: CSRGraph) -> np.ndarray:
    """Ground-truth subgraph centrality diag(e^A) by dense
    eigendecomposition (small graphs only) — oracle for the stochastic
    diagonal estimator (core/stochastic.py)."""
    evals, evecs = np.linalg.eigh(graph.to_scipy().toarray())
    return (evecs**2) @ np.exp(evals)


def quadrature_dense(graph: CSRGraph, z: np.ndarray, f) -> float:
    """Ground truth for one probe's bilinear form z^T f(A) z by dense
    eigendecomposition — oracle for the Gauss-quadrature rule."""
    evals, evecs = np.linalg.eigh(graph.to_scipy().toarray())
    w = evecs.T @ np.asarray(z, dtype=np.float64)
    return float(np.dot(w**2, np.asarray(f(evals), dtype=np.float64)))


def dos_dense(graph: CSRGraph, grid: np.ndarray, sigma: float) -> np.ndarray:
    """Ground-truth Gaussian-smoothed spectral density by dense
    eigendecomposition (small graphs only) — oracle for the stochastic
    Lanczos-quadrature DOS (core/stochastic.py spectral_density)."""
    evals = np.linalg.eigvalsh(graph.to_scipy().toarray())
    g = np.asarray(grid, dtype=np.float64)
    d = np.exp(-((g[:, None] - evals[None, :]) ** 2) / (2 * sigma**2)).sum(1)
    return d / (np.sqrt(2 * np.pi) * sigma * evals.size)


def rel_error(ans: np.ndarray, ref: np.ndarray) -> float:
    """Relative norm of difference (reference: check_ans,
    parallel-final/lib/check_ans.cu:11-29)."""
    return float(np.linalg.norm(ans - ref) / np.linalg.norm(ref))
