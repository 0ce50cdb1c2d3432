"""tpu_lanczos_torch — the PyTorch/CUDA port of tpu_lanczos: graph node
centrality via the action of the matrix exponential, f(A)x = e^A.x.

Runs on an NVIDIA Hopper GPU (H100, sm_90a) through a hand-written CUDA
SpMV kernel over the CPG format, or on the CPU through the kernel's plain
PyTorch version.  Imports torch, numpy and scipy, never jax; the JAX
package ``tpu_lanczos`` is the reference the port is tested against.

The slice served so far: CSR graphs (.mtx I/O, generators), the CPG
packer, Lanczos, host LAPACK eigensolve, and the e^A.x answer or its
top-k (``expm_action``, ``expm_action_summary``), each also in the
two-pass O(n)-memory mode (``low_mem=True``); and the f64-grade df64
pipeline on (hi, lo) float32 pairs with its compensated CUDA level
kernel (``expm_action_df`` with a pass-1 checkpoint,
``expm_action_ks_df``).
"""

from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.graphs import io as graph_io
from tpu_lanczos_torch.graphs import generators
from tpu_lanczos_torch.core.pipeline import (
    expm_action,
    expm_action_summary,
    LanczosResult,
    SummaryResult,
)
from tpu_lanczos_torch.core.lanczos_df import (
    expm_action_df,
    expm_action_ks_df,
)

__all__ = [
    "CSRGraph",
    "graph_io",
    "generators",
    "expm_action",
    "expm_action_summary",
    "expm_action_df",
    "expm_action_ks_df",
    "LanczosResult",
    "SummaryResult",
]
