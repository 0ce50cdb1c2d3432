"""SpMV over the GPG format (see kernels/gpg.py): the CUDA level kernel
and its plain PyTorch version.

The port of ``tpu_lanczos/kernels/spmv_gpg.py``: ``run_level_gpg`` takes
the place of ``_run_level`` (the Pallas kernel ``_make_kernel``).  On a
CUDA tensor it launches ``csrc/spmv_gpg.cu``; on a CPU tensor it takes
the plain version ``run_level_gpg_ref``.  Both return the Pallas
kernel's output layout, (n_chunks*128, sub_d) stacked [d, lane, row]
blocks, and both sum each dest cell's tile values from +0.0 in tile
order, so they are bit-identical to ``_run_level(..., interpret=True)``.
``spmv_gpg`` keeps the reference's level loop: the untranspose, the fold
``y2d + untranspose(yt)`` and the realmask multiply stay torch ops.
"""

from __future__ import annotations

import torch

from tpu_lanczos_torch.kernels.gpg import GPGGraph, LANE

# CUDA launches of the GPG level kernel; only run_level_gpg adds to it
launches_gpg = 0

_INDEX_DTYPES = {"l1": torch.int8, "l2": torch.uint8, "g_ids": torch.int32,
                 "starts": torch.int32, "counts": torch.int32}


def run_level_gpg_ref(x2d: torch.Tensor, level: dict, n_chunks: int,
                      g_s: int, sub_s: int, sub_d: int) -> torch.Tensor:
    """Plain PyTorch version of one level: for each dest chunk d and step
    i < counts[d], tile t = starts[d] + i adds, to dest cell (c, j),
    ``x2d[g_ids[t*n_slots + r//g_s]*g_s + r%g_s, l1[t*sub_s + r, c]]``
    with ``r = l2[t*128 + c, j]``.  Vectorised over the chunks that still
    have a tile at step i."""
    n_slots = sub_s // g_s
    starts = level["starts"].long()
    counts = level["counts"].long()
    l1 = level["l1"].view(-1, sub_s, LANE)        # [t, r, lane]
    l2 = level["l2"].view(-1, LANE, sub_d)        # [t, c, j]
    g_ids = level["g_ids"].view(-1, n_slots).long()
    acc = x2d.new_zeros((n_chunks, LANE, sub_d))  # [d, c, j]
    chunks = torch.arange(n_chunks, device=x2d.device)
    n_steps = int(counts.max()) if n_chunks else 0
    for i in range(n_steps):
        d = chunks[counts > i]
        t = starts[d] + i
        r = l2[t].long()                                        # [., c, j]
        lane = torch.gather(l1[t].long().transpose(1, 2), 2, r)  # l1[r, c]
        row = torch.gather(g_ids[t], 1, (r // g_s).view(d.numel(), -1))
        row = row.view_as(r) * g_s + r % g_s
        acc[d] += x2d[row, lane]
    return acc.reshape(n_chunks * LANE, sub_d)


def _check(x2d, level, n_chunks, g_s, sub_s, sub_d):
    if x2d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x2d.dtype}")
    if x2d.shape != (n_chunks * sub_d, LANE) or not x2d.is_contiguous():
        raise ValueError(f"x must be contiguous ({n_chunks * sub_d}, {LANE}),"
                         f" got {tuple(x2d.shape)}")
    if sub_s % g_s or sub_s not in (128, 256) or sub_d % LANE:
        raise ValueError(f"the GPG kernel takes g_s dividing sub_s, sub_s "
                         f"128 or 256 and sub_d a multiple of {LANE}, got "
                         f"g_s={g_s} sub_s={sub_s} sub_d={sub_d}")
    for k, dt in _INDEX_DTYPES.items():
        a = level[k]
        if a.device != x2d.device or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"level[{k!r}] must be contiguous {dt} on "
                             f"{x2d.device}, got {a.dtype} on {a.device}")
    t_pad = level["d_ids"].shape[0]
    want = dict(l1=(t_pad * sub_s, LANE), l2=(t_pad * LANE, sub_d),
                g_ids=(t_pad * (sub_s // g_s),), starts=(n_chunks,),
                counts=(n_chunks,))
    for k, shape in want.items():
        if tuple(level[k].shape) != shape:
            raise ValueError(f"level[{k!r}] has shape "
                             f"{tuple(level[k].shape)}, expected {shape}")


def run_level_gpg(x2d: torch.Tensor, level: dict, n_chunks: int, g_s: int,
                  sub_s: int, sub_d: int) -> torch.Tensor:
    """One GPG level: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor.  Returns (n_chunks*128, sub_d), the Pallas kernel's
    layout.  Launches on the current stream without syncing."""
    global launches_gpg
    if x2d.device.type == "cpu":
        return run_level_gpg_ref(x2d, level, n_chunks, g_s, sub_s, sub_d)
    if x2d.device.type != "cuda":
        raise ValueError(f"no GPG SpMV for device {x2d.device}")
    _check(x2d, level, n_chunks, g_s, sub_s, sub_d)
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    out = x2d.new_empty((n_chunks * LANE, sub_d))
    err = lib.tlt_spmv_gpg_level(
        x2d.data_ptr(), level["l1"].data_ptr(), level["l2"].data_ptr(),
        level["g_ids"].data_ptr(), level["starts"].data_ptr(),
        level["counts"].data_ptr(), out.data_ptr(), n_chunks,
        level["d_ids"].shape[0], g_s, sub_s, sub_d, x2d.element_size(),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_gpg kernel launch failed: CUDA error {err}")
    launches_gpg += 1
    return out


def _spmv(gg: GPGGraph, x: torch.Tensor, level_fn) -> torch.Tensor:
    """The reference's level loop (spmv_gpg.py:178-199) over
    ``level_fn``: the main level from x, then each reduce level from y,
    its output untransposed and added to y."""
    C, g_s, sub_s, sub_d = gg.n_chunks, gg.g_s, gg.sub_s, gg.sub_d
    n_sub = gg.n_sub

    def untranspose(yt):
        # (C*128, sub_d) stacked (ld, rd) blocks -> (n_sub, 128) layout
        return yt.reshape(C, LANE, sub_d).transpose(1, 2).reshape(n_sub, LANE)

    x2d = x.reshape(n_sub, LANE)
    y2d = untranspose(level_fn(x2d, gg.levels[0], C, g_s, sub_s, sub_d))
    for level in gg.levels[1:]:
        yt = level_fn(y2d, level, C, g_s, sub_s, sub_d)
        y2d = y2d + untranspose(yt)
    return y2d.reshape(-1) * gg.realmask.to(x.dtype)


def spmv_gpg(gg: GPGGraph, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x; x is (n_pad,) in GPG-permuted order, lane-127 slots
    zero.  Every level goes through ``run_level_gpg``."""
    return _spmv(gg, x, run_level_gpg)


def spmv_gpg_ref(gg: GPGGraph, x: torch.Tensor) -> torch.Tensor:
    """The same SpMV through ``run_level_gpg_ref`` on any device (the
    plain version the kernel is held against)."""
    return _spmv(gg, x, run_level_gpg_ref)
