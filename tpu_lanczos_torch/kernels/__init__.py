from tpu_lanczos_torch.kernels.cpg import CPGGraph, pack_cpg
from tpu_lanczos_torch.kernels.formats import DeviceGraph, pack
from tpu_lanczos_torch.kernels.spmv import spmv

__all__ = ["CPGGraph", "pack_cpg", "DeviceGraph", "pack", "spmv"]
