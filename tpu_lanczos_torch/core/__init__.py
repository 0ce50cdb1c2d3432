from tpu_lanczos_torch.core.pipeline import expm_action, LanczosResult
from tpu_lanczos_torch.core.lanczos import lanczos
from tpu_lanczos_torch.core import tridiag, expmv

__all__ = ["expm_action", "LanczosResult", "lanczos", "tridiag", "expmv"]
