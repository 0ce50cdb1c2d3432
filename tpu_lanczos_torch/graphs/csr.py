"""Value-free CSR storage for undirected, unweighted graphs.

The adjacency matrix of an undirected unweighted graph has all nonzeros
equal to 1.0, so only the row-pointer (``indptr``) and column-index
(``indices``) arrays are stored — there is no value array.  This mirrors
the reference's ``adjMatrix`` design (reference: serial/lib/adjMatrix.h:19-24,
parallel-final/lib/adjMatrix.h:19-118), re-done as an immutable numpy
container that feeds the CPG packer in :mod:`tpu_lanczos_torch.kernels.cpg`.
A copy of ``tpu_lanczos/graphs/csr.py``, so the port runs without jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Symmetric adjacency matrix in value-free CSR form.

    Attributes:
      indptr:  (n+1,) int array; row i's neighbours are
               ``indices[indptr[i]:indptr[i+1]]``.
      indices: (nnz,) int array of column ids, sorted within each row.
      n:       number of nodes.

    ``nnz == 2 * edge_count`` because both orientations of every undirected
    edge are stored (reference: serial/lib/adjMatrix.cc:18-52 inserts both
    orientations into a set before building CSR).
    """

    indptr: np.ndarray
    indices: np.ndarray
    n: int

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def edge_count(self) -> int:
        """Number of undirected edges (nnz / 2, as in the reference's
        ``edge_count`` bookkeeping, parallel-final/lib/adjMatrix.cc:21-46)."""
        return self.nnz // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n else 0

    # ---------------------------------------------------------------- build

    @staticmethod
    def from_edges(n: int, edges: np.ndarray) -> "CSRGraph":
        """Build from an (E, 2) int array of undirected edges (0-indexed).

        Symmetrizes (inserts both orientations), deduplicates, drops
        self-loops, and sorts — the same normalization the reference does
        with a ``std::set<Edge>`` (serial/lib/adjMatrix.cc:18-52), but
        vectorized.
        """
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if edges.size and (edges.min() < 0 or edges.max() >= n):
            raise ValueError("edge endpoint out of range")
        # both orientations
        both = np.concatenate([edges, edges[:, ::-1]], axis=0)
        # drop self loops
        both = both[both[:, 0] != both[:, 1]]
        # dedup via linear keys
        keys = both[:, 0] * np.int64(n) + both[:, 1]
        keys = np.unique(keys)
        rows = keys // n
        cols = keys % n
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSRGraph(indptr=indptr, indices=cols.astype(np.int32), n=n)

    # ------------------------------------------------------------- convert

    def to_scipy(self):
        """Dense-value scipy CSR (values all 1.0) for oracle checks."""
        import scipy.sparse as sp

        data = np.ones(self.nnz, dtype=np.float64)
        return sp.csr_matrix(
            (data, self.indices.astype(np.int64), self.indptr), shape=(self.n, self.n)
        )

    def row_ids(self) -> np.ndarray:
        """(nnz,) row id of every stored nonzero (COO expansion)."""
        return np.repeat(
            np.arange(self.n, dtype=np.int32), np.diff(self.indptr).astype(np.int64)
        )

    def validate(self) -> None:
        """Raise ValueError on a malformed graph.  Real raises, not
        asserts: validate() must keep its contract under ``python -O``
        (asserts compile out there, silently passing invalid graphs)."""
        if self.indptr.shape != (self.n + 1,):
            raise ValueError(
                f"indptr shape {self.indptr.shape} != ({self.n + 1},)")
        if self.indptr[0] != 0 or self.indptr[-1] != self.nnz:
            raise ValueError("indptr must run 0..nnz")
        if not np.all(np.diff(self.indptr) >= 0):
            raise ValueError("indptr must be non-decreasing")
        if self.nnz and not (self.indices.min() >= 0
                             and self.indices.max() < self.n):
            raise ValueError("column index out of range")
        # symmetric: A == A^T
        s = self.to_scipy()
        if (s != s.T).nnz != 0:
            raise ValueError("adjacency must be symmetric")
