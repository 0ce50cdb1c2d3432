"""Shared inputs for the PyTorch-port tests (tests/test_torch_*.py).

The graphs are made by the JAX package's numpy generators from a seed;
``port_pack`` carries a reference pack into the port through
``tpu_lanczos_torch.kernels.cpg.from_numpy`` so both packages run on the
same arrays.
"""

import numpy as np
import torch

from tpu_lanczos.graphs import generators
from tpu_lanczos.graphs.csr import CSRGraph
from tpu_lanczos_torch.graphs.csr import CSRGraph as PortCSRGraph
from tpu_lanczos_torch.kernels import cpg as port_cpg

LEVEL_KEYS = ("l1", "l2", "s_ids", "d_ids", "run_ids", "pair_mask",
              "starts", "counts")

# The suite runs several pytest workers on one host; torch's default of
# one OpenMP thread per core in every worker oversubscribed the cores and
# made these small-tensor tests up to ~60x slower.  One thread each.
torch.set_num_threads(1)


def star_graph(n: int = 3000) -> CSRGraph:
    """The hub graph of tests/test_cpg.py::test_cpg_star_graph_deep_split."""
    hub = np.stack([np.zeros(n - 1, dtype=np.int64),
                    np.arange(1, n, dtype=np.int64)], axis=1)
    ring = np.stack([np.arange(1, n - 1), np.arange(2, n)], axis=1)
    return CSRGraph.from_edges(n, np.concatenate([hub, ring]))


# name -> (graph factory, pack sub); sub None = pack_cpg's auto pick
PACK_CASES = {
    # sub 128: a broadcast level, the main level and a reduce level
    "ba2000": (lambda: generators.barabasi_albert(2000, 8, seed=2,
                                                  use_native=False), None),
    # degree-2999 hub: deep virtual-row reduce tree
    "star": (star_graph, None),
    # sub 512: int16 l2, sparse pair masks
    "ba40000_sub512": (lambda: generators.barabasi_albert(
        40000, 6, seed=3, use_native=False), 512),
}


def to_port_graph(g: CSRGraph) -> PortCSRGraph:
    return PortCSRGraph(indptr=g.indptr, indices=g.indices, n=g.n)


def port_pack(ref_cg, device="cpu"):
    """The reference CPGGraph's arrays as the port's CPGGraph."""
    meta = dict(n=ref_cg.n, n_chunks=ref_cg.n_chunks, nnz=ref_cg.nnz,
                theta=ref_cg.theta, sub=ref_cg.sub, n_bcast=ref_cg.n_bcast,
                layout=ref_cg.layout, t_reals=ref_cg.t_reals,
                mask_sparse=ref_cg.mask_sparse)
    levels = [{k: np.asarray(lv[k]) for k in LEVEL_KEYS}
              for lv in ref_cg.levels]
    return port_cpg.from_numpy(meta, levels, np.asarray(ref_cg.realmask),
                               ref_cg.new_of_old, device=device)


def untranspose(yt: np.ndarray, n_chunks: int, sub: int) -> np.ndarray:
    """The reference kernel's (C*128, sub) output -> (C*sub, 128) y2d
    (spmv_cpg.py:388-390)."""
    return yt.reshape(n_chunks, 128, sub).transpose(0, 2, 1).reshape(-1, 128)
