"""The 5-point stencil of a ``side`` x ``side`` grid, rows numbered
row-major: node (i, j) is i * side + j, linked to its four neighbours.

Configuration key: ``side``.  The graph does not depend on the seed.
Built straight into sorted CSR (no edge list to sort), equal array for
array to ``tpu_lanczos_torch.graphs.generators.stencil_2d``.
"""

from __future__ import annotations

import numpy as np


def stencil_2d(side: int):
    """(indptr int64 (n+1,), indices int32 (nnz,)) of the grid."""
    n = side * side
    ids = np.arange(n, dtype=np.int64)
    i, j = ids // side, ids % side
    # neighbours in ascending id order: up, left, right, down
    offsets = (-side, -1, 1, side)
    present = np.stack([i > 0, j > 0, j < side - 1, i < side - 1])
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(present.sum(axis=0), out=indptr[1:])
    cols = ids[None, :] + np.asarray(offsets, dtype=np.int64)[:, None]
    # column-major over (neighbour, node) keeps each row's ids ascending
    indices = cols.T[present.T].astype(np.int32)
    return indptr, indices


def generate(config: dict, seed: int):
    del seed  # the mesh is the same for every seed
    return stencil_2d(int(config["side"]))
