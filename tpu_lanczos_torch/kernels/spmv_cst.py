"""SpMV over the CST format (see kernels/cst.py): the CUDA level kernel and
its plain PyTorch version.

The port of ``tpu_lanczos/kernels/spmv_pallas2.py``, whose two Pallas
kernels, ``_stage_kernel`` (a lane-gather by IDX1) and
``_deliver_kernel`` (a sublane-gather by IDX3, added into the
accumulator), run once per slot under a ``lax.scan``.  Here one level is
one call of ``run_level_cst``: on a CUDA tensor one launch of
``csrc/spmv_cst.cu``, which walks every slot of the level per dest cell;
on a CPU tensor the plain version ``run_level_cst_ref``, the reference's
slot loop in torch ops.  Both add the slots in the reference's order from
the level's starting accumulator, so they are bit-identical to
``spmv_cst(..., interpret=True)``.  The level loop, the realmask multiply
and the reshapes stay torch ops in ``spmv_cst``.
"""

from __future__ import annotations

import torch

from tpu_lanczos_torch.kernels.cst import CLASSES, IDX3_ROW_ALIGN, CSTGraph

# the index types the kernel takes: idx1 as cst.from_numpy narrows it
IDX1_DTYPES = (torch.int16, torch.int32)
IDX3_DTYPE = torch.uint8

# CUDA launches of the CST level kernel; only run_level_cst adds to it
launches_cst = 0


def run_level_cst_ref(src: torch.Tensor, acc: torch.Tensor | None,
                      idx1: torch.Tensor, idx3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of one level: per slot s in order,
    ``acc = acc + take_along_axis(take_along_axis(src, idx1[s], 1),
    idx3[s], 0)`` (spmv_pallas2.py:67-74), from ``acc`` (+0.0 when None).
    Returns a new tensor."""
    out = torch.zeros_like(src) if acc is None else acc
    for s in range(idx1.shape[0]):
        g = torch.gather(src, 1, idx1[s].long())
        out = out + torch.gather(g, 0, idx3[s].long())
    return out


def _check(src, acc, idx1, idx3):
    if src.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"src must be float32 or float64, got {src.dtype}")
    if src.dim() != 2 or src.shape[0] != CLASSES or not src.is_contiguous():
        raise ValueError(f"src must be contiguous ({CLASSES}, n_cols), got "
                         f"{tuple(src.shape)}")
    if acc is not None and (acc.shape != src.shape or acc.dtype != src.dtype
                            or acc.device != src.device
                            or not acc.is_contiguous()):
        raise ValueError("acc must match src in shape, dtype and device")
    n_cols = src.shape[1]
    if n_cols % 8:
        raise ValueError(f"n_cols must be a multiple of 8, got {n_cols}")
    for name, a, dtypes in (("idx1", idx1, IDX1_DTYPES),
                            ("idx3", idx3, (IDX3_DTYPE,))):
        if (a.dtype not in dtypes or a.device != src.device or a.dim() != 3
                or tuple(a.shape[1:]) != tuple(src.shape)):
            raise ValueError(f"{name} must be {dtypes} (slots, {CLASSES}, "
                             f"{n_cols}) on {src.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if not idx1.is_contiguous():
        raise ValueError("idx1 must be contiguous")
    pitch = idx3.stride(1)
    if idx3.stride() != (CLASSES * pitch, pitch, 1) or pitch % IDX3_ROW_ALIGN:
        raise ValueError(f"idx3's rows must be a multiple of 16 bytes apart "
                         f"(cst.from_numpy pads them), got strides "
                         f"{idx3.stride()}")
    if idx1.shape[0] != idx3.shape[0]:
        raise ValueError("idx1 and idx3 must have the same slot count")


def run_level_cst(src: torch.Tensor, acc: torch.Tensor | None,
                  idx1: torch.Tensor, idx3: torch.Tensor) -> torch.Tensor:
    """One CST level: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor.  ``src`` is the level's (128, n_cols) source, ``acc``
    its starting accumulator (None: +0.0); the result is a new tensor
    (the kernel never writes in place: a reduce level's src is its acc).
    Launches on the current stream without syncing."""
    global launches_cst
    if src.device.type == "cpu":
        return run_level_cst_ref(src, acc, idx1, idx3)
    if src.device.type != "cuda":
        raise ValueError(f"no CST SpMV for device {src.device}")
    _check(src, acc, idx1, idx3)
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    out = torch.empty_like(src)
    err = lib.tlt_spmv_cst_level(
        src.data_ptr(), None if acc is None else acc.data_ptr(),
        idx1.data_ptr(), idx3.data_ptr(), out.data_ptr(), idx1.shape[0],
        src.shape[1], idx3.stride(1), idx1.element_size(),
        src.element_size(),
        torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_cst kernel launch failed: CUDA error {err}")
    launches_cst += 1
    return out


def _spmv(cg: CSTGraph, x: torch.Tensor, level_fn) -> torch.Tensor:
    """The reference's level loop (spmv_pallas2.py:63-83) over
    ``level_fn``: level 0 from +0.0 with x as source; each reduce level
    folds virtual partial sums into their parents with the accumulator as
    both its source and its start."""
    xT = x.reshape(CLASSES, cg.n_cols)
    acc = level_fn(xT, None, cg.idx1[0], cg.idx3[0])
    for i1, i3 in zip(cg.idx1[1:], cg.idx3[1:]):
        acc = level_fn(acc, acc, i1, i3)
    acc = acc * cg.realmask.to(acc.dtype)
    return acc.reshape(-1)


def spmv_cst(cg: CSTGraph, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x; x is (n_pad,) in CST-permuted order (zero padded).
    Every level goes through ``run_level_cst``."""
    return _spmv(cg, x, run_level_cst)


def spmv_cst_ref(cg: CSTGraph, x: torch.Tensor) -> torch.Tensor:
    """The same SpMV through ``run_level_cst_ref`` on any device (the
    plain version the kernel is held against)."""
    return _spmv(cg, x, run_level_cst_ref)
