"""One rank of tests/test_torch_dist.py's 2-rank gloo run: the port's
row-sharded path with one shard per process.

    python tests/_torch_dist_worker.py RANK PORT OUT_DIR

Each rank joins a gloo group on localhost, builds ``make_mesh()`` (one
shard a rank), packs the graph for 2 shards, and saves the sharded CPG
Lanczos's alpha/beta and the sharded Estrada estimate to OUT_DIR.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_lanczos_torch.core.stochastic import estrada_index_sharded  # noqa: E402
from tpu_lanczos_torch.dist import init_distributed, make_mesh  # noqa: E402
from tpu_lanczos_torch.dist.cpg_sharded import (  # noqa: E402
    lanczos_cpg_sharded, pack_cpg_sharded)
from tpu_lanczos_torch.graphs import generators  # noqa: E402

# the in-process run it is held against uses one thread too: a dot's
# reduction order may depend on the thread count
torch.set_num_threads(1)


def run(mesh):
    """The computations the test compares, on ``mesh``: (alpha, beta,
    Estrada per-probe values, log estimate)."""
    g = generators.barabasi_albert(40000, 4, seed=5)
    sg = pack_cpg_sharded(g, 2, mesh=mesh, sub=128)
    st = lanczos_cpg_sharded(sg, sg.permute_in(np.ones(g.n), np.float64), 12,
                             mesh)
    r = estrada_index_sharded(sg, k=10, probes=4, mesh=mesh, deflate=4,
                              dtype="float64")
    return (st.alpha.numpy(), st.beta.numpy(), r.per_probe,
            np.array([r.log_estimate]))


def main() -> None:
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                     world_size=2, rank=rank)
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.n_shards == 2 and mesh.shards == (rank,)
        for name, a in zip(("alpha", "beta", "per_probe", "log"), run(mesh)):
            np.save(os.path.join(out, f"{name}_{rank}.npy"), a)
    finally:
        torch.distributed.destroy_process_group()
    print("DIST_OK", flush=True)


if __name__ == "__main__":
    main()
