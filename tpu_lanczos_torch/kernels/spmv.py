"""SpMV for the value-free adjacency matrix: y = A @ x.

The port of ``tpu_lanczos/kernels/spmv.py``: ``spmv`` dispatches a CPG,
GPG or CST pack to its CUDA kernels (kernels/spmv_cpg.py, spmv_gpg.py,
spmv_cst.py) and the ELL / COO / HYB packs (kernels/formats.py) to
``spmv_xla``.  The JAX package runs those three through XLA, not Pallas,
so here they are plain torch ops: a masked gather-sum for ELL and a
sorted segment sum for COO.  Both are deterministic on CUDA too (no
atomics: ``index_add_`` would add in a different order from run to
run).
"""

from __future__ import annotations

import torch

from tpu_lanczos_torch.kernels.cpg import CPGGraph
from tpu_lanczos_torch.kernels.cst import CSTGraph
from tpu_lanczos_torch.kernels.formats import DeviceGraph
from tpu_lanczos_torch.kernels.gpg import GPGGraph


def _ell_spmv(dg: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """Slot-major ELL: y[r] = sum_s x[ell[s, r]] for s < degree[r]; one
    (w, n_pad) gather, a mask by degree and a sum over slots."""
    gathered = x[dg.ell_indices.long()]  # (w, n_pad)
    w = dg.ell_indices.shape[0]
    slot_ids = torch.arange(w, device=x.device)[:, None]
    mask = slot_ids < dg.ell_degrees[None, :]
    return torch.where(mask, gathered, x.new_zeros(())).sum(dim=0)


def _coo_spmv(dg: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """Row-sorted COO segment sum; pad entries land in an extra bucket."""
    vals = x[dg.coo_cols.long()]
    out = torch.segment_reduce(vals, "sum", offsets=dg.coo_offsets,
                               initial=0)
    return out[: dg.n_pad]


def spmv(dg, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in a packed format; ``x`` is (n_pad,) with zero
    padding, and the result keeps that invariant."""
    if isinstance(dg, GPGGraph):
        from tpu_lanczos_torch.kernels import spmv_gpg

        return spmv_gpg.spmv_gpg(dg, x)
    if isinstance(dg, CPGGraph):
        from tpu_lanczos_torch.kernels import spmv_cpg

        return spmv_cpg.spmv_cpg(dg, x)
    if isinstance(dg, CSTGraph):
        from tpu_lanczos_torch.kernels import spmv_cst

        return spmv_cst.spmv_cst(dg, x)
    if isinstance(dg, DeviceGraph):
        return spmv_xla(dg, x)
    raise NotImplementedError(f"no SpMV for {type(dg).__name__}")


def spmv_xla(dg: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """The ELL / COO / HYB SpMV in plain torch ops (the reference's XLA
    paths)."""
    if dg.fmt == "ell":
        return _ell_spmv(dg, x)
    if dg.fmt == "coo":
        return _coo_spmv(dg, x)
    if dg.fmt == "hyb":
        return _ell_spmv(dg, x) + _coo_spmv(dg, x)
    raise ValueError(f"unknown format {dg.fmt!r}")
