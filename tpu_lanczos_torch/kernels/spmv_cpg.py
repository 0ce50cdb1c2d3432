"""SpMV over the CPG format (see kernels/cpg.py): the CUDA kernels and
their plain PyTorch versions.

The port of ``tpu_lanczos/kernels/spmv_cpg.py``: ``run_level`` takes the
place of ``_run_level`` (the Pallas kernel, plain), ``run_level_comp`` of
``_run_level(compensated=True)``, each in the classic layout and, with
``slab=True``, in the slab layout (``_run_level(slab=True)``); ``spmv_cpg``
and ``spmv_cpg_df`` keep the reference's level loops and pass the pack's
layout to every level.  Each wrapper launches ``csrc/spmv_cpg.cu`` on a
CUDA tensor and takes its plain version (``run_level_ref``,
``run_level_comp_ref``) only for a tensor on the CPU.  All return the
untransposed (n_chunks*sub, 128) level output, and all are bit-identical
to the reference's kernel.
"""

from __future__ import annotations

import torch

from tpu_lanczos_torch.core.df64 import two_sum
from tpu_lanczos_torch.kernels.cpg import CPGGraph, LANE

# CUDA launches of each kernel variant; only its wrapper adds to it:
# the plain level kernel (run_level), classic and slab layout,
launches = 0
launches_slab = 0
# and the compensated one (run_level_comp), classic and slab layout
launches_comp = 0
launches_comp_slab = 0

_INDEX_DTYPES = {"s_ids": torch.int32, "starts": torch.int32,
                 "counts": torch.int32, "l1": torch.int8}


def _tile_values(x2d: torch.Tensor, level: dict, n_chunks: int, sub: int,
                 slab: bool = False):
    """Walk a level's tiles as the kernel does: vectorised across dest
    chunks, sequential over the tile index.  Yields, for step i, the
    chunks d with counts > i and their tile's routed values (d, 128, sub)
    in [D, ld, rd] order.  The slab layout's tile reads one (128, 128)
    source slab (s_ids are global slab ids): it gathers on the low 7 bits
    of l2 and gives +0.0 where bit 7 marks a ghost cell
    (spmv_cpg.py:184-205)."""
    rows = LANE if slab else sub
    starts = level["starts"].long()
    counts = level["counts"].long()
    l1 = level["l1"].view(-1, rows, LANE)       # [t, ss, lane]
    l2 = level["l2"].view(-1, LANE, sub)        # [t, ld, rd]
    s_ids = level["s_ids"].long()
    xs = x2d.reshape(-1, rows * LANE)           # source block, flat (ss, lane)
    chunks = torch.arange(n_chunks, device=x2d.device)
    n_steps = int(counts.max()) if n_chunks else 0
    for i in range(n_steps):
        d = chunks[counts > i]
        t = starts[d] + i
        ss = l2[t].long()                                     # L2[ld, rd]
        if slab:
            ghost = ss >= LANE
            ss = ss & (LANE - 1)
        lane = torch.gather(l1[t].long().transpose(1, 2), 2, ss)  # L1[L2, ld]
        flat = (ss * LANE + lane).view(d.numel(), -1)
        g = torch.gather(xs[s_ids[t]], 1, flat).view(-1, LANE, sub)
        if slab:
            g = torch.where(ghost, g.new_zeros(()), g)
        yield d, g


def _untransposed(acc: torch.Tensor, n_chunks: int, sub: int):
    return acc.transpose(1, 2).reshape(n_chunks * sub, LANE)


def run_level_ref(x2d: torch.Tensor, level: dict, n_chunks: int, sub: int,
                  base: torch.Tensor | None = None,
                  slab: bool = False) -> torch.Tensor:
    """Plain PyTorch version of one level: each cell's sum from 0 in tile
    order, ``base`` added after it."""
    acc = x2d.new_zeros((n_chunks, LANE, sub))  # [D, ld, rd]
    for d, g in _tile_values(x2d, level, n_chunks, sub, slab):
        acc[d] += g
    out = _untransposed(acc, n_chunks, sub)
    return out if base is None else base + out


def run_level_comp_ref(x2d: torch.Tensor, level: dict, n_chunks: int,
                       sub: int, slab: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the compensated level: per cell, from 0
    in tile order, ``s = acc + g; z = s - acc; err += (acc - (s - z)) +
    (g - z); acc = s`` (spmv_cpg.py:295-301).  Returns (acc, err)."""
    acc = x2d.new_zeros((n_chunks, LANE, sub))
    err = x2d.new_zeros((n_chunks, LANE, sub))
    for d, g in _tile_values(x2d, level, n_chunks, sub, slab):
        a = acc[d]
        s = a + g
        z = s - a
        err[d] = err[d] + ((a - (s - z)) + (g - z))
        acc[d] = s
    return (_untransposed(acc, n_chunks, sub),
            _untransposed(err, n_chunks, sub))


def _check(x2d, level, n_chunks, sub, base, slab=False):
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
    # the slab layout's l2 is uint8 at every sub (bit 7 = ghost); a
    # wrong type would read the wrong bytes without any error
    l2_dtype = torch.uint8 if slab or sub <= 256 else torch.int16
    dtypes = dict(_INDEX_DTYPES, l2=l2_dtype)
    for k, dt in dtypes.items():
        a = level[k]
        if a.device != x2d.device or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"level[{k!r}] must be contiguous {dt} on "
                             f"{x2d.device}, got {a.dtype} on {a.device}")
    t_pad = level["s_ids"].shape[0]
    rows = LANE if slab else sub
    want = dict(l1=(t_pad * rows, LANE), l2=(t_pad * LANE, sub),
                starts=(n_chunks,), counts=(n_chunks,))
    for k, shape in want.items():
        if tuple(level[k].shape) != shape:
            raise ValueError(f"level[{k!r}] has shape "
                             f"{tuple(level[k].shape)}, expected {shape}")


def run_level(x2d: torch.Tensor, level: dict, n_chunks: int, sub: int,
              base: torch.Tensor | None = None,
              slab: bool = False) -> torch.Tensor:
    """One CPG level of a classic (or, with ``slab``, a slab-layout)
    pack: the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor.  Launches on the current stream without syncing."""
    global launches, launches_slab
    if x2d.device.type == "cpu":
        return run_level_ref(x2d, level, n_chunks, sub, base, slab)
    if x2d.device.type != "cuda":
        raise ValueError(f"no CPG SpMV for device {x2d.device}")
    _check(x2d, level, n_chunks, sub, base, slab)
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    out = torch.empty_like(x2d)
    err = lib.tlt_spmv_cpg_level(
        x2d.data_ptr(), level["l1"].data_ptr(), level["l2"].data_ptr(),
        level["s_ids"].data_ptr(), level["starts"].data_ptr(),
        level["counts"].data_ptr(),
        None if base is None else base.data_ptr(), out.data_ptr(),
        n_chunks, sub, level["l2"].element_size(), x2d.element_size(),
        int(slab), torch.cuda.current_stream(x2d.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"spmv_cpg kernel launch failed: CUDA error {err}")
    if slab:
        launches_slab += 1
    else:
        launches += 1
    return out


def run_level_comp(x2d: torch.Tensor, level: dict, n_chunks: int,
                   sub: int, slab: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One compensated CPG level, float32 only, classic or (``slab``)
    slab layout: the CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor.  Returns (acc, err)."""
    global launches_comp, launches_comp_slab
    if x2d.device.type == "cpu":
        return run_level_comp_ref(x2d, level, n_chunks, sub, slab)
    if x2d.device.type != "cuda":
        raise ValueError(f"no CPG SpMV for device {x2d.device}")
    if x2d.dtype != torch.float32:
        raise TypeError(f"the compensated level takes float32, "
                        f"got {x2d.dtype}")
    _check(x2d, level, n_chunks, sub, None, slab)
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    out = torch.empty_like(x2d)
    err_out = torch.empty_like(x2d)
    err = lib.tlt_spmv_cpg_level_comp(
        x2d.data_ptr(), level["l1"].data_ptr(), level["l2"].data_ptr(),
        level["s_ids"].data_ptr(), level["starts"].data_ptr(),
        level["counts"].data_ptr(), out.data_ptr(), err_out.data_ptr(),
        n_chunks, sub, level["l2"].element_size(), int(slab),
        torch.cuda.current_stream(x2d.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"spmv_cpg compensated kernel launch failed: CUDA error {err}")
    if slab:
        launches_comp_slab += 1
    else:
        launches_comp += 1
    return out, err_out


def _spmv(cg: CPGGraph, x: torch.Tensor, level_fn) -> torch.Tensor:
    """The reference's level loop (spmv_cpg.py:379-416) over ``level_fn``,
    each level run in the pack's layout."""
    C, sub = cg.n_chunks, cg.sub
    slab = cg.layout == "slab"
    x2d = x.reshape(cg.n_sub, LANE)
    nb = cg.n_bcast
    for level in cg.levels[:nb]:
        # broadcast pass: copy split-source parents' values into their
        # copy slots.  The sum lands in a NEW tensor: x is the caller's
        # q_j, already stored in lanczos' q_basis, whose copy slots must
        # stay zero
        x2d = level_fn(x2d, level, C, sub, base=x2d, slab=slab)
    y2d = level_fn(x2d, cg.levels[nb], C, sub, slab=slab)
    for level in cg.levels[nb + 1:]:
        # reduce pass: fold virtual-row partial sums into their parents
        y2d = level_fn(y2d, level, C, sub, base=y2d, slab=slab)
    return y2d.reshape(-1) * cg.realmask.to(x.dtype)


def spmv_cpg(cg: CPGGraph, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x; x is (n_pad,) in CPG-permuted order, lane-127 slots zero.
    Every level goes through ``run_level``."""
    return _spmv(cg, x, run_level)


def spmv_cpg_ref(cg: CPGGraph, x: torch.Tensor) -> torch.Tensor:
    """The same SpMV through ``run_level_ref`` on any device (the plain
    version the kernel is held against)."""
    return _spmv(cg, x, run_level_ref)


def _spmv_df(cg: CPGGraph, x_hi: torch.Tensor, x_lo: torch.Tensor,
             level_fn, comp_fn) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's double-word level loop (spmv_cpg.py:419-483) over
    ``level_fn`` and ``comp_fn``.  Routing moves values exactly; the only
    rounding is the tile sum, which ``comp_fn`` two-sums into an error
    stream.  lo rides the plain level (its own rounding is ~2^-48 of y),
    and reduce levels fold (hi, err) pairs with a two-sum here."""
    C, sub = cg.n_chunks, cg.sub
    slab = cg.layout == "slab"
    hi2d = x_hi.reshape(cg.n_sub, LANE)
    lo2d = x_lo.reshape(cg.n_sub, LANE)
    nb = cg.n_bcast
    for level in cg.levels[:nb]:
        # broadcast: one entry per copy slot, the rest structural zeros,
        # so the plain level on hi and on lo adds no rounding
        hi2d = level_fn(hi2d, level, C, sub, base=hi2d, slab=slab)
        lo2d = level_fn(lo2d, level, C, sub, base=lo2d, slab=slab)
    y2d, e2d = comp_fn(hi2d, cg.levels[nb], C, sub, slab=slab)
    e2d = e2d + level_fn(lo2d, cg.levels[nb], C, sub, slab=slab)
    for level in cg.levels[nb + 1:]:
        yt, et = comp_fn(y2d, level, C, sub, slab=slab)
        lt = level_fn(e2d, level, C, sub, slab=slab)
        y2d, t = two_sum(y2d, yt)
        e2d = ((e2d + t) + et) + lt
    # two_sum, not fast_two_sum: after cancellation in the hi stream a
    # cell's |e| can exceed |y|, where the fast form is inexact
    hi, lo = two_sum(y2d.reshape(-1), e2d.reshape(-1))
    mask = cg.realmask.to(x_hi.dtype)  # exact 0/1 multiply
    return hi * mask, lo * mask


def spmv_cpg_df(cg: CPGGraph, x_hi: torch.Tensor, x_lo: torch.Tensor):
    """Double-word SpMV: y = A @ (x_hi + x_lo) as a (hi, lo) float32 pair.
    Every level goes through ``run_level`` and ``run_level_comp``."""
    return _spmv_df(cg, x_hi, x_lo, run_level, run_level_comp)


def spmv_cpg_df_ref(cg: CPGGraph, x_hi: torch.Tensor, x_lo: torch.Tensor):
    """The same double-word SpMV through the plain versions on any
    device."""
    return _spmv_df(cg, x_hi, x_lo, run_level_ref, run_level_comp_ref)
