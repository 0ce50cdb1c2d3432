"""Multi-device distribution: row-sharded mesh Lanczos.

The port of ``tpu_lanczos/dist``, the row-sharded path: the reference
CUDA code's dual-GPU row-partitioned pipeline
(parallel-two-cards/lib/cu_lanczos.cu:21-191) on a row mesh
(dist/mesh.py: in process, each shard on a device of its own, or one
shard per rank of a ``torch.distributed`` group):

- each shard owns a contiguous block of (permuted) matrix rows,
- the per-iteration "broadcast q" becomes an ``all_gather``,
- the reference's gather-partials-then-reduce-on-GPU0 becomes ``psum``,
- nnz balance comes from a degree-aware vertex permutation (ELL/COO) or
  the CPG pack's dest-chunk split (the CUDA level kernel on each shard).

The JAX package's ``interpret=`` arguments, its ``pcast``/``vma``
annotations and its ``NamedSharding`` placement have no counterpart: a
CPU shard runs the kernels' plain versions, and a pack keeps each held
shard's arrays on that shard's device.
"""

from tpu_lanczos_torch.dist.mesh import Mesh, init_distributed, make_mesh
from tpu_lanczos_torch.dist.partition import (
    ShardedGraph, balanced_permutation, pack_sharded)
from tpu_lanczos_torch.dist.lanczos import (
    expm_action_sharded,
    lanczos_alphabeta_sharded,
    lanczos_sharded,
)

__all__ = [
    "Mesh",
    "init_distributed",
    "make_mesh",
    "balanced_permutation",
    "pack_sharded",
    "ShardedGraph",
    "lanczos_sharded",
    "lanczos_alphabeta_sharded",
    "expm_action_sharded",
]
