"""tpu_lanczos_torch — the PyTorch/CUDA port of tpu_lanczos: graph node
centrality via the action of the matrix exponential, f(A)x = e^A.x.

Runs on an NVIDIA Hopper GPU (H100, sm_90a) through hand-written CUDA
SpMV kernels over the CPG format (classic and slab layouts, plain and
compensated), or on the CPU through the kernels' plain PyTorch versions.
Imports torch, numpy and scipy, never jax; the JAX package
``tpu_lanczos`` is the reference the port is tested against.

The slice served so far, on one device: CSR graphs (.mtx I/O,
generators), the CPG packer and the ELL/COO/HYB fallback formats,
Lanczos (with optional full reorthogonalization), the host LAPACK or
device eigensolve, and the e^A.x answer or its top-k (``expm_action``,
``expm_action_summary``, each also in the two-pass O(n)-memory mode), the
one-decomposition k-sweep (``expm_action_ks``), general f(A).x
(``fa_action``), pipelined serving (``expm_action_pipelined``),
``spectral_bounds``, ``run_config`` over ``Config``; the f64-grade df64
pipeline on (hi, lo) float32 pairs (``expm_action_df`` with a pass-1
checkpoint, ``expm_action_ks_df``); and the CLI
(``python -m tpu_lanczos_torch.cli.main``).
"""

from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.graphs import io as graph_io
from tpu_lanczos_torch.graphs import generators
from tpu_lanczos_torch.core.pipeline import (
    expm_action,
    expm_action_ks,
    expm_action_pipelined,
    expm_action_summary,
    fa_action,
    spectral_bounds,
    run_config,
    best_device_pack,
    LanczosResult,
    SummaryResult,
)
from tpu_lanczos_torch.core.lanczos_df import (
    expm_action_df,
    expm_action_ks_df,
)
from tpu_lanczos_torch.config import Config

__all__ = [
    "CSRGraph",
    "graph_io",
    "generators",
    "expm_action",
    "expm_action_ks",
    "expm_action_pipelined",
    "expm_action_summary",
    "fa_action",
    "spectral_bounds",
    "run_config",
    "best_device_pack",
    "expm_action_df",
    "expm_action_ks_df",
    "LanczosResult",
    "SummaryResult",
    "Config",
]
