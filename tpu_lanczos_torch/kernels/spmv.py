"""SpMV dispatch for the value-free adjacency matrix: y = A @ x.

The port of ``tpu_lanczos/kernels/spmv.py::spmv``.  Only the CPG format
is ported; every other format raises, naming the ROADMAP item that will
bring it.
"""

from __future__ import annotations

import torch

from tpu_lanczos_torch.kernels.cpg import CPGGraph

_NOT_PORTED = {
    "DeviceGraph": "the ell/coo/hyb formats are ROADMAP queue 1 item 5",
    "CSTGraph": "the CST format and its kernel are ROADMAP queue 2 item 6",
    "GPGGraph": "the GPG format and its kernel are ROADMAP queue 2 item 5",
}


def spmv(dg, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in a packed format; ``x`` is (n_pad,) with zero
    padding, and the result keeps that invariant."""
    if isinstance(dg, CPGGraph):
        from tpu_lanczos_torch.kernels import spmv_cpg

        return spmv_cpg.spmv_cpg(dg, x)
    name = type(dg).__name__
    raise NotImplementedError(
        f"no SpMV for {name}: {_NOT_PORTED.get(name, 'not ported')}")
