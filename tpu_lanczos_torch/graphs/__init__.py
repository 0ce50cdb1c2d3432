from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.graphs import io, generators

__all__ = ["CSRGraph", "io", "generators"]
