"""SpMV over the CPG format (see kernels/cpg.py): the CUDA kernel and its
plain PyTorch version.

The port of ``tpu_lanczos/kernels/spmv_cpg.py``: ``run_level`` takes the
place of ``_run_level`` (the Pallas kernel, plain f32, classic layout)
and ``spmv_cpg`` keeps the reference's level loop.  ``run_level``
launches ``csrc/spmv_cpg.cu`` on a CUDA tensor and takes
``run_level_ref`` only for a tensor on the CPU.  Both return the
untransposed (n_chunks*sub, 128) level output, optionally added to a
``base`` after the tile sum (the reference's ``x2d + untranspose(...)``),
and both are bit-identical to the reference's kernel.
"""

from __future__ import annotations

import torch

from tpu_lanczos_torch.kernels.cpg import CPGGraph, LANE

# CUDA launches of the level kernel; only run_level adds to it
launches = 0

_INDEX_DTYPES = {"s_ids": torch.int32, "starts": torch.int32,
                 "counts": torch.int32, "l1": torch.int8}


def run_level_ref(x2d: torch.Tensor, level: dict, n_chunks: int, sub: int,
                  base: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of one level: vectorised across dest chunks,
    sequential over each chunk's tile index, each cell's sum from 0 in
    tile order."""
    starts = level["starts"].long()
    counts = level["counts"].long()
    l1 = level["l1"].view(-1, sub, LANE)        # [t, ss, lane]
    l2 = level["l2"].view(-1, LANE, sub)        # [t, ld, rd]
    s_ids = level["s_ids"].long()
    xs = x2d.reshape(-1, sub * LANE)            # source chunk, flat (ss, lane)
    acc = x2d.new_zeros((n_chunks, LANE, sub))  # [D, ld, rd]
    chunks = torch.arange(n_chunks, device=x2d.device)
    n_steps = int(counts.max()) if n_chunks else 0
    for i in range(n_steps):
        d = chunks[counts > i]
        t = starts[d] + i
        ss = l2[t].long()                                     # L2[ld, rd]
        lane = torch.gather(l1[t].long().transpose(1, 2), 2, ss)  # L1[L2, ld]
        flat = (ss * LANE + lane).view(d.numel(), -1)
        acc[d] += torch.gather(xs[s_ids[t]], 1, flat).view(-1, LANE, sub)
    out = acc.transpose(1, 2).reshape(n_chunks * sub, LANE)
    return out if base is None else base + out


def _check(x2d, level, n_chunks, sub, base):
    if x2d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x2d.dtype}")
    if x2d.shape != (n_chunks * sub, LANE) or not x2d.is_contiguous():
        raise ValueError(f"x must be contiguous ({n_chunks * sub}, {LANE}), "
                         f"got {tuple(x2d.shape)}")
    if base is not None and (base.shape != x2d.shape
                             or base.dtype != x2d.dtype
                             or base.device != x2d.device
                             or not base.is_contiguous()):
        raise ValueError("base must match x in shape, dtype and device")
    l2_dtype = torch.uint8 if sub <= 256 else torch.int16
    dtypes = dict(_INDEX_DTYPES, l2=l2_dtype)
    for k, dt in dtypes.items():
        a = level[k]
        if a.device != x2d.device or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"level[{k!r}] must be contiguous {dt} on "
                             f"{x2d.device}, got {a.dtype} on {a.device}")
    t_pad = level["s_ids"].shape[0]
    want = dict(l1=(t_pad * sub, LANE), l2=(t_pad * LANE, sub),
                starts=(n_chunks,), counts=(n_chunks,))
    for k, shape in want.items():
        if tuple(level[k].shape) != shape:
            raise ValueError(f"level[{k!r}] has shape "
                             f"{tuple(level[k].shape)}, expected {shape}")


def run_level(x2d: torch.Tensor, level: dict, n_chunks: int, sub: int,
              base: torch.Tensor | None = None) -> torch.Tensor:
    """One CPG level: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor.  Launches on the current stream without syncing."""
    global launches
    if x2d.device.type == "cpu":
        return run_level_ref(x2d, level, n_chunks, sub, base)
    if x2d.device.type != "cuda":
        raise ValueError(f"no CPG SpMV for device {x2d.device}")
    _check(x2d, level, n_chunks, sub, base)
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    out = torch.empty_like(x2d)
    err = lib.tlt_spmv_cpg_level(
        x2d.data_ptr(), level["l1"].data_ptr(), level["l2"].data_ptr(),
        level["s_ids"].data_ptr(), level["starts"].data_ptr(),
        level["counts"].data_ptr(),
        None if base is None else base.data_ptr(), out.data_ptr(),
        n_chunks, sub, level["l2"].element_size(), x2d.element_size(),
        torch.cuda.current_stream(x2d.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"spmv_cpg kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _spmv(cg: CPGGraph, x: torch.Tensor, level_fn) -> torch.Tensor:
    """The reference's level loop (spmv_cpg.py:379-416) over ``level_fn``.
    Packs are classic-layout only (every CPGGraph constructor checks)."""
    C, sub = cg.n_chunks, cg.sub
    x2d = x.reshape(cg.n_sub, LANE)
    nb = cg.n_bcast
    for level in cg.levels[:nb]:
        # broadcast pass: copy split-source parents' values into their
        # copy slots.  The sum lands in a NEW tensor: x is the caller's
        # q_j, already stored in lanczos' q_basis, whose copy slots must
        # stay zero
        x2d = level_fn(x2d, level, C, sub, base=x2d)
    y2d = level_fn(x2d, cg.levels[nb], C, sub)
    for level in cg.levels[nb + 1:]:
        # reduce pass: fold virtual-row partial sums into their parents
        y2d = level_fn(y2d, level, C, sub, base=y2d)
    return y2d.reshape(-1) * cg.realmask.to(x.dtype)


def spmv_cpg(cg: CPGGraph, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x; x is (n_pad,) in CPG-permuted order, lane-127 slots zero.
    Every level goes through ``run_level``."""
    return _spmv(cg, x, run_level)


def spmv_cpg_ref(cg: CPGGraph, x: torch.Tensor) -> torch.Tensor:
    """The same SpMV through ``run_level_ref`` on any device (the plain
    version the kernel is held against)."""
    return _spmv(cg, x, run_level_ref)
