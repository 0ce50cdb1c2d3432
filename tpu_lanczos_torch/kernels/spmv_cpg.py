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
to the reference's kernel.  A classic level runs one of two walks,
``staged_walk`` says which: the staged walk (``cpg_staged_level_kernel``:
a tile's indices in shared memory by TMA, only x gathered) for a large
level at sub 256 whose tiles are spread over many chunks, else one
thread a dest cell (``cpg_level_kernel``).
``n_chunks`` counts the dest chunks: on a
shard of the row-sharded path (dist/cpg_sharded.py) the source holds
another number of chunks than the dest, or lies in two buffers
(``run_level(..., halo=)``).  ``run_shard_level_df`` launches the
row-sharded path's df64 level (``csrc/spmv_cpg_shard.cu``), its plain
version ``run_shard_level_df_ref``.

``spmv_cpg_df`` runs each level of a single device's df64 SpMV as one
launch of ``run_level_df`` (``csrc/spmv_cpg_shard.cu``'s classic and
``csrc/spmv_cpg.cu``'s slab kernel: both streams walked together, the
reference's two-sum folds in the kernel), whose plain version
``run_level_df_ref`` is the reference's level: ``run_level_comp_ref`` on
hi, ``run_level_ref`` on lo, and the folds as eager ops.
``spmv_cpg_df_ref`` stays the whole composition, level by level as the
reference runs it (``_spmv_df``).
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from tpu_lanczos_torch.core.df64 import two_sum
from tpu_lanczos_torch.kernels.cpg import CPGGraph, LANE

# CUDA launches of each kernel variant; only its wrapper adds to it:
# the plain level kernel (run_level), classic and slab layout,
launches = 0
launches_slab = 0
# of them, the classic launches of the staged walk (``staged_walk``)
launches_staged = 0
# and the compensated one (run_level_comp), classic and slab layout
launches_comp = 0
launches_comp_slab = 0
# the row-sharded df64 level kernel (csrc/spmv_cpg_shard.cu,
# run_shard_level_df)
launches_shard_df = 0
# the single-device df64 level kernels (run_level_df): classic
# (csrc/spmv_cpg_shard.cu) and slab layout (csrc/spmv_cpg.cu)
launches_df = 0
launches_df_slab = 0
# the serial chain of the SpMVs run: each single-device SpMV (f32/f64 or
# df, on either device) adds its pack's ``chains``, every level's
# heaviest dest chunk's real tiles (a cell's sum is taken in tile order,
# so that chunk's tiles run one after another whatever the walk)
chain_tiles = 0

# what a single-device df64 level writes (csrc/df_level.cuh, DfMode): a
# broadcast level's (hi, lo), the main level's (y, e), a reduce level's
# (y, e) folded onto its source
_DF_MODES = {"bcast": 0, "main": 1, "reduce": 2}

# the slab kernel's TMA row coordinates are int32 (csrc/spmv_cpg.cu,
# slab_map_rows)
SLAB_MAX_ROWS = 2**31 - LANE
# the staged classic walk (csrc/spmv_cpg.cu, cpg_staged_level_kernel)
# runs at sub 256 (a tile's l1 rows one TMA box, uint8 l2; at sub 128 it
# was slower than the one-thread walk on BA graphs of 100k-600k nodes),
STAGED_SUB = 256
# on levels of at least this many padded tiles (more than 240 real ones:
# a level's tile arrays are padded to 256 at least)
STAGED_MIN_TILES = 512
# whose real tiles are at least this many times its heaviest dest
# chunk's: the staged walk takes about its heaviest chunk's serial chain
# (0.65-0.76 us a tile), the one-thread walk the level's tiles spread
# over the card (0.065-0.09 us a tile).  BA main levels below it were
# slower staged in f64 (1.9 to 11.1: +3% to +119%) and in f32 but one
# (+3% to +88%; -7% at 7.7), those above it faster (13.3 to 13.8, bn1M's
# 13.4: -7% to -31%), as was stencil_2600's (~200)
STAGED_MIN_SPREAD = 12
# a level's (real tiles, heaviest chunk's tiles) by its counts tensor,
# read from the device once
_spreads = WeakIdKeyDictionary()

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
                  base: torch.Tensor | None = None, slab: bool = False,
                  halo: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of one level: each cell's sum from 0 in tile
    order, ``base`` added after it.  With ``halo`` the source is x2d's
    chunks followed by halo's."""
    if halo is not None:
        x2d = torch.cat([x2d, halo.reshape(-1, LANE)])
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
    """The wrapper's argument checks.  ``n_chunks`` is the count of dest
    chunks the level writes; the source x may hold any whole number of
    ``sub``-row chunks (a shard's level reads its own rows, the gathered
    vector or a compact exchange buffer), which the kernel reads only
    through ``s_ids``.  That every s_id lies inside the source is checked
    once where the ids are made (the packers), not per call: a check of
    device values here would sync the host."""
    if x2d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x2d.dtype}")
    if (x2d.ndim != 2 or x2d.shape[1] != LANE or x2d.shape[0] == 0
            or x2d.shape[0] % sub or not x2d.is_contiguous()):
        raise ValueError(f"x must be contiguous (m*{sub}, {LANE}) for a "
                         f"whole number m of chunks, got {tuple(x2d.shape)}")
    out_shape = (n_chunks * sub, LANE)
    if base is not None and (tuple(base.shape) != out_shape
                             or base.dtype != x2d.dtype
                             or base.device != x2d.device
                             or not base.is_contiguous()):
        raise ValueError(f"base must be contiguous {out_shape} with x's "
                         f"dtype and device")
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
    if slab:
        # the slab walk reads l1 and l2 by TMA boxes: 16-byte aligned
        # buffers, and int32 row coordinates (tile*128 + lane)
        for k in ("l1", "l2"):
            if level[k].data_ptr() % 16:
                raise ValueError(f"level[{k!r}] must be 16-byte aligned "
                                 f"for the slab kernel")
        if t_pad * LANE > SLAB_MAX_ROWS:
            raise ValueError(f"a slab level holds at most "
                             f"{SLAB_MAX_ROWS // LANE} tiles, got {t_pad}")


def _tile_spread(counts: torch.Tensor) -> tuple:
    """(real tiles, heaviest chunk's tiles) of a level's per-chunk tile
    counts; one device read the first time a counts tensor is seen."""
    got = _spreads.get(counts)
    if got is None:
        got = _spreads[counts] = tuple(torch.stack((
            counts.sum(dtype=torch.int64), counts.max().long())).tolist())
    return got


def staged_walk(level: dict, sub: int, slab: bool = False,
                halo: torch.Tensor | None = None) -> bool:
    """Whether ``run_level`` runs ``level`` by the staged classic walk
    (``cpg_staged_level_kernel``), a pure function of what the wrapper
    sees: a classic level of one source buffer at sub ``STAGED_SUB``
    (uint8 l2), l1 and l2 16-byte aligned, int32 TMA row coordinates, at
    least ``STAGED_MIN_TILES`` padded tiles, and real tiles at least
    ``STAGED_MIN_SPREAD`` times its heaviest chunk's (its chunk counts,
    read once a level).  Every other classic level keeps the
    one-thread-a-cell walk (``cpg_level_kernel``): the halo launch, packs
    at another sub, levels whose heaviest chunk holds much of the work,
    and small levels, such as bn1M's broadcast and reduce levels (one
    chunk's serial chain of 14 and 39 tiles)."""
    t_pad = level["s_ids"].shape[0]
    if not (not slab and halo is None and sub == STAGED_SUB
            and level["l2"].dtype == torch.uint8
            and t_pad >= STAGED_MIN_TILES
            and t_pad * sub <= SLAB_MAX_ROWS
            and level["l1"].data_ptr() % 16 == 0
            and level["l2"].data_ptr() % 16 == 0):
        return False
    tiles, heaviest = _tile_spread(level["counts"])
    return 0 < heaviest and STAGED_MIN_SPREAD * heaviest <= tiles


def run_level(x2d: torch.Tensor, level: dict, n_chunks: int, sub: int,
              base: torch.Tensor | None = None, slab: bool = False,
              halo: torch.Tensor | None = None) -> torch.Tensor:
    """One CPG level of a classic (or, with ``slab``, a slab-layout)
    pack: the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor.  Writes ``n_chunks`` dest chunks, (n_chunks*sub, 128); the
    source x may hold another number of chunks (see ``_check``).  With
    ``halo`` (classic only) the source is x2d's chunks followed by
    halo's, each read in place.  A classic level takes the staged walk
    where ``staged_walk`` says so.  Precondition, as ``run_level_comp``'s:
    x is +-0.0 in lane 127 of every row (the staged walk skips a ghost's
    load).  Launches on the current stream without syncing, but for the
    one read of a sub-256 level's chunk counts the first time it runs."""
    if x2d.device.type == "cpu":
        return run_level_ref(x2d, level, n_chunks, sub, base, slab, halo)
    return _run_level_cuda(x2d, level, n_chunks, sub, base, slab, halo,
                           staged_walk(level, sub, slab, halo))


def _run_level_cuda(x2d, level, n_chunks, sub, base, slab, halo,
                    staged: bool) -> torch.Tensor:
    """``run_level``'s launch on a CUDA tensor, by the staged walk where
    ``staged`` (a classic level of one source at sub 256)."""
    global launches, launches_slab, launches_staged
    if x2d.device.type != "cuda":
        raise ValueError(f"no CPG SpMV for device {x2d.device}")
    _check(x2d, level, n_chunks, sub, base, slab)
    if halo is not None:
        if slab:
            raise ValueError("a slab level reads one source buffer")
        _check(halo.reshape(-1, LANE), level, n_chunks, sub, None)
        if halo.dtype != x2d.dtype or halo.device != x2d.device:
            raise ValueError("halo must have x's dtype and device")
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    out = x2d.new_empty((n_chunks * sub, LANE))
    index = (level["l1"].data_ptr(), level["l2"].data_ptr(),
             level["s_ids"].data_ptr(), level["starts"].data_ptr(),
             level["counts"].data_ptr(),
             None if base is None else base.data_ptr(), out.data_ptr(),
             n_chunks, sub)
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    sizes = (level["l2"].element_size(), x2d.element_size())
    if staged:
        err = lib.tlt_spmv_cpg_level_staged(x2d.data_ptr(), *index,
                                            x2d.element_size(), stream)
    elif halo is None:
        err = lib.tlt_spmv_cpg_level(x2d.data_ptr(), *index, *sizes,
                                     int(slab), stream)
    else:
        err = lib.tlt_spmv_cpg_level_halo(x2d.data_ptr(), halo.data_ptr(),
                                          x2d.shape[0] // sub, *index,
                                          *sizes, stream)
    if err != 0:
        raise RuntimeError(f"spmv_cpg kernel launch failed: CUDA error {err}")
    if slab:
        launches_slab += 1
    else:
        launches += 1
        if staged:
            launches_staged += 1
    return out


def run_level_comp(x2d: torch.Tensor, level: dict, n_chunks: int,
                   sub: int, slab: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One compensated CPG level, float32 only, classic or (``slab``)
    slab layout: the CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor.  Returns (acc, err).

    Precondition: x is +-0.0 in lane 127 of every row.  The classic CUDA
    walk adds +0.0 for a ghost cell without loading x
    (csrc/spmv_cpg.cu:61-72, :155-156), while the plain version and the
    reference's kernel add x[..., 127]; they agree bit for bit only where
    that lane holds zeros.  Every level input of the df SpMV does (the
    pack keeps lane 127 empty; ``run_level_df`` walks its sources under
    the same precondition), and so does every buffer a
    shard's level reads in the row-sharded df SpMV
    (``dist/lanczos_df.py``): its own rows, the gathered vector, its rows
    followed by the halo, and the compact reduce buffer, each made of
    whole chunks of a vector that is zero there (tests/test_torch_spmv.py
    pins both)."""
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
    out = x2d.new_empty((n_chunks * sub, LANE))
    err_out = torch.empty_like(out)
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


def _count_chain(cg: CPGGraph) -> None:
    """Adds one SpMV's serial chain, the pack's ``chains`` (host ints
    made with the pack), to ``chain_tiles``: no device read."""
    global chain_tiles
    chain_tiles += sum(cg.chains)


def _spmv(cg: CPGGraph, x: torch.Tensor, level_fn,
          masked: bool = True) -> torch.Tensor:
    """The reference's level loop (spmv_cpg.py:379-416) over ``level_fn``,
    each level run in the pack's layout; with ``masked=False`` the result
    before its realmask multiply (which a Lanczos step folds in)."""
    _count_chain(cg)
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
    if not masked:
        return y2d.reshape(-1)
    return y2d.reshape(-1) * cg.realmask.to(x.dtype)


def spmv_cpg(cg: CPGGraph, x: torch.Tensor, *,
             masked: bool = True) -> torch.Tensor:
    """y = A @ x; x is (n_pad,) in CPG-permuted order, lane-127 slots zero.
    Every level goes through ``run_level``.  ``masked=False`` returns y
    before its multiply by ``cg.realmask`` (exact 0/1): the Lanczos step
    (``kernels/lanczos_step.py``, ``mask=``) does that multiply as it
    loads y."""
    return _spmv(cg, x, run_level, masked)


def spmv_cpg_ref(cg: CPGGraph, x: torch.Tensor) -> torch.Tensor:
    """The same SpMV through ``run_level_ref`` on any device (the plain
    version the kernel is held against)."""
    return _spmv(cg, x, run_level_ref)


def _check_mode(mode: str, finish: bool) -> None:
    if mode not in _DF_MODES or (mode == "bcast" and finish):
        raise ValueError(f"a df64 level is a broadcast, main or reduce "
                         f"level, finished only past a broadcast, got "
                         f"mode={mode!r}, finish={finish}")


def _df_fold(y, e, acc, err, lo):
    """A reduce level's fold of its walk's sums onto (y, e), in the
    reference's order: ``y, t = two_sum(y, acc); e = ((e + t) + err) +
    lo``."""
    y, t = two_sum(y, acc)
    return y, ((e + t) + err) + lo


def _df_finish(y, e, mask):
    """hi, lo = two_sum(y, e), times ``mask`` (exact 0/1) where given.
    two_sum, not fast_two_sum: after cancellation in the hi stream a
    cell's |e| can exceed |y|, where the fast form is inexact."""
    hi, lo = two_sum(y, e)
    if mask is not None:
        hi, lo = hi * mask, lo * mask
    return hi, lo


def _spmv_df(cg: CPGGraph, x_hi: torch.Tensor, x_lo: torch.Tensor,
             level_fn, comp_fn,
             masked: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's double-word level loop (spmv_cpg.py:419-483) over
    ``level_fn`` and ``comp_fn``.  Routing moves values exactly; the only
    rounding is the tile sum, which ``comp_fn`` two-sums into an error
    stream.  lo rides the plain level (its own rounding is ~2^-48 of y),
    and reduce levels fold (hi, err) pairs with a two-sum here."""
    _count_chain(cg)
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
        y2d, e2d = _df_fold(y2d, e2d, yt, et, lt)
    return _df_finish(y2d.reshape(-1), e2d.reshape(-1),
                      cg.realmask.to(x_hi.dtype) if masked else None)


def run_level_df_ref(x_hi: torch.Tensor, x_lo: torch.Tensor, level: dict,
                     n_chunks: int, sub: int, mode: str = "main",
                     finish: bool = False, mask: torch.Tensor | None = None,
                     slab: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one level of a single device's df64 SpMV, as the
    reference's level loop (spmv_cpg.py:450-483) runs it on the
    (n_chunks*sub, 128) source pair (x_hi, x_lo):

    - ``mode="bcast"``: ``run_level_ref`` with the source as base on each
      stream: (hi + sum(hi), lo + sum(lo)), plain adds;
    - ``"main"``: (y, e) = (acc, err + sum(lo)), (acc, err) the
      compensated level (``run_level_comp_ref``) of hi;
    - ``"reduce"``: the same walk of the source (y, e), folded onto it
      (``_df_fold``).

    ``finish`` (main and reduce levels) returns hi, lo = two_sum(y, e)
    instead, times ``mask`` where given (``_df_finish``)."""
    _check_mode(mode, finish)
    if mode == "bcast":
        return (run_level_ref(x_hi, level, n_chunks, sub, base=x_hi,
                              slab=slab),
                run_level_ref(x_lo, level, n_chunks, sub, base=x_lo,
                              slab=slab))
    acc, err = run_level_comp_ref(x_hi, level, n_chunks, sub, slab)
    lo = run_level_ref(x_lo, level, n_chunks, sub, slab=slab)
    if mode == "main":
        y, e = acc, err + lo
    else:
        y, e = _df_fold(x_hi, x_lo, acc, err, lo)
    if not finish:
        return y, e
    if mask is not None:
        mask = mask.reshape(y.shape)
    return _df_finish(y, e, mask)


def _check_df(x_hi, x_lo, level, n_chunks, sub, mode, finish, mask,
              slab) -> None:
    """``run_level_df``'s checks: float32 sources of exactly the level's
    ``n_chunks * sub`` rows (the base of a broadcast and a reduce level
    is its source), the level's arrays as ``_check`` takes them, a
    mode the kernel knows, a float32 mask of the output's size only with
    ``finish``."""
    _check_mode(mode, finish)
    shape = (n_chunks * sub, LANE)
    for x in (x_hi, x_lo):
        if (x.dtype != torch.float32 or tuple(x.shape) != shape
                or x.device != x_hi.device or not x.is_contiguous()):
            raise ValueError(f"df64 level sources must be contiguous "
                             f"float32 {shape} on one device, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    _check(x_hi, level, n_chunks, sub, None, slab)
    if mask is not None:
        if not finish:
            raise ValueError("a df64 level multiplies by the mask only "
                             "where it finishes the pair")
        _check_vector(mask, n_chunks * sub * LANE, x_hi.device, "mask")


def run_level_df(x_hi: torch.Tensor, x_lo: torch.Tensor, level: dict,
                 n_chunks: int, sub: int, mode: str = "main",
                 finish: bool = False, mask: torch.Tensor | None = None,
                 slab: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """One level of a single device's df64 SpMV in one launch, classic
    (``cpg_level_df_kernel``, csrc/spmv_cpg_shard.cu) or slab layout
    (``cpg_slab_level_df_kernel``, csrc/spmv_cpg.cu), on CUDA tensors;
    the plain version ``run_level_df_ref`` on CPU ones, bit for bit.  Each
    tile's indices are read once for both streams, and the level's folds
    run in the kernel.  Returns two new (n_chunks*sub, 128) tensors: the
    kernel never writes its source, which a reduce level folds onto.
    Precondition, as ``run_level_comp``'s: both sources are +-0.0 in lane
    127 (the classic walk skips a ghost's loads).  Launches on the current
    stream without syncing."""
    global launches_df, launches_df_slab
    if x_hi.device.type == "cpu":
        return run_level_df_ref(x_hi, x_lo, level, n_chunks, sub, mode,
                                finish, mask, slab)
    if x_hi.device.type != "cuda":
        raise ValueError(f"no CPG SpMV for device {x_hi.device}")
    _check_df(x_hi, x_lo, level, n_chunks, sub, mode, finish, mask, slab)
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    out_a, out_b = torch.empty_like(x_hi), torch.empty_like(x_hi)
    entry = (lib.tlt_spmv_cpg_slab_level_df if slab
             else lib.tlt_spmv_cpg_level_df)
    err = entry(x_hi.data_ptr(), x_lo.data_ptr(), level["l1"].data_ptr(),
                level["l2"].data_ptr(), level["s_ids"].data_ptr(),
                level["starts"].data_ptr(), level["counts"].data_ptr(),
                None if mask is None else mask.data_ptr(), out_a.data_ptr(),
                out_b.data_ptr(), n_chunks, sub,
                level["l2"].element_size(), _DF_MODES[mode], int(finish),
                torch.cuda.current_stream(x_hi.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_cpg df64 level kernel launch failed: "
                           f"CUDA error {err}")
    if slab:
        launches_df_slab += 1
    else:
        launches_df += 1
    return out_a, out_b


def _spmv_df_levels(cg: CPGGraph, x_hi: torch.Tensor, x_lo: torch.Tensor,
                    level_fn, masked: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's double-word level loop (spmv_cpg.py:450-483) with
    each level one call of ``level_fn`` (``run_level_df``'s signature):
    the broadcast levels, the main level and the reduce levels, the last
    of them finishing the pair (times the realmask unless
    ``masked=False``)."""
    _count_chain(cg)
    C, sub = cg.n_chunks, cg.sub
    slab = cg.layout == "slab"
    pair = (x_hi.reshape(cg.n_sub, LANE), x_lo.reshape(cg.n_sub, LANE))
    nb, last = cg.n_bcast, len(cg.levels) - 1
    mask = cg.realmask.to(x_hi.dtype) if masked else None  # exact 0/1
    for i, level in enumerate(cg.levels):
        mode = "bcast" if i < nb else "main" if i == nb else "reduce"
        pair = level_fn(*pair, level, C, sub, mode=mode, finish=i == last,
                        mask=mask if i == last else None, slab=slab)
    return pair[0].reshape(-1), pair[1].reshape(-1)


def spmv_cpg_df(cg: CPGGraph, x_hi: torch.Tensor, x_lo: torch.Tensor, *,
                masked: bool = True):
    """Double-word SpMV: y = A @ (x_hi + x_lo) as a (hi, lo) float32 pair.
    Every level is one call of ``run_level_df``: on a CUDA pack one
    launch a level and no elementwise op between.  ``masked=False`` as
    in ``spmv_cpg``: the df64 step folds the mask."""
    return _spmv_df_levels(cg, x_hi, x_lo, run_level_df, masked)


def spmv_cpg_df_ref(cg: CPGGraph, x_hi: torch.Tensor, x_lo: torch.Tensor):
    """The same double-word SpMV as the reference composes it, through
    the plain level versions on any device (what the kernels are held
    against)."""
    return _spmv_df(cg, x_hi, x_lo, run_level_ref, run_level_comp_ref)


# ---- the row-sharded df64 level kernel (csrc/spmv_cpg_shard.cu)
#
# A walk is one pass of a shard's level: ``(level, src_hi, src_lo)``, where
# ``level`` is the shard's level dict and each source a tuple of its (flat)
# tensors: the buffer the pass reads, or the shard's own rows followed by
# its halo, which the kernel reads in place (s_ids below the own rows'
# chunk count read them, the rest the halo).


class _Walk(ctypes.Structure):
    """csrc/spmv_cpg_shard.cu's ``Walk``."""

    _fields_ = [("x", ctypes.c_void_p * 2), ("lo", ctypes.c_void_p * 2),
                ("l1", ctypes.c_void_p), ("l2", ctypes.c_void_p),
                ("s_ids", ctypes.c_void_p), ("starts", ctypes.c_void_p),
                ("counts", ctypes.c_void_p), ("split", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _ShardArgs(ctypes.Structure):
    """csrc/spmv_cpg_shard.cu's ``ShardArgs``."""

    _fields_ = [("walk", _Walk * 2)] + [
        (name, ctypes.c_void_p) for name in (
            "base_y", "base_e", "out_y", "out_e", "out_hi", "out_lo",
            "mask", "part", "flags")] + [(name, ctypes.c_int) for name in (
                "n_walks", "n_chunks", "sub", "pad")]


def _df_outputs(keep: bool, finish: bool) -> None:
    if not (keep or finish):
        raise ValueError("a df64 shard level keeps (y, e), finishes the "
                         "pair, or both")


def run_shard_level_df_ref(walks, n_chunks: int, sub: int, base=None,
                           keep: bool = True, finish: bool = False,
                           mask: torch.Tensor | None = None):
    """Plain version of a shard's df64 level: each walk compensated on
    hi (``run_level_comp_ref``) and plain on lo (``run_level_ref``), folded
    as the row-sharded df SpMV folded them before ``run_shard_level_df``:
    without a ``base`` y = acc, e = err + lo from the first walk, then for
    every further walk, and for every walk onto the (y, e) ``base`` of a
    reduce level, ``y, t = two_sum(y, acc); e = ((e + t) + err) + lo``.
    Returns ((y, e) if ``keep``, (hi, lo) = two_sum(y, e), times ``mask``
    where given, if ``finish``), each flat, None where not asked for."""
    _df_outputs(keep, finish)
    y = e = None
    if base is not None:
        y, e = (t.reshape(-1, LANE) for t in base)
    for level, src_hi, src_lo in walks:
        c0, c1 = run_level_comp_ref(torch.cat(src_hi).reshape(-1, LANE),
                                    level, n_chunks, sub)
        b = run_level_ref(torch.cat(src_lo).reshape(-1, LANE), level,
                          n_chunks, sub)
        if y is None:
            y, e = c0, c1 + b
        else:
            y, e = _df_fold(y, e, c0, c1, b)
    y, e = y.reshape(-1), e.reshape(-1)
    if not finish:
        return (y, e), None
    return ((y, e) if keep else None), _df_finish(y, e, mask)


def _check_shard(walks, n_chunks: int, sub: int) -> None:
    """The df64 shard wrapper's checks: one or two (level, src_hi,
    src_lo) walks, each level's arrays as ``_check`` takes them, every
    source tensor contiguous float32 of whole chunks on one device, the
    lo stream's the hi stream's shapes.  That every s_id lies in its
    walk's source is checked where the pack is split
    (dist/cpg_sharded.py::_check_sources)."""
    if not 1 <= len(walks) <= 2 or any(len(w) != 3 for w in walks):
        raise ValueError("a df64 shard level takes 1 or 2 (level, src_hi, "
                         "src_lo) walks")
    x0 = walks[0][1][0]
    for level, src_hi, src_lo in walks:
        if not 1 <= len(src_hi) <= 2 or len(src_lo) != len(src_hi):
            raise ValueError("a walk reads 1 or 2 source tensors, the same "
                             "number in each stream")
        for x, x_hi in zip((*src_hi, *src_lo), (*src_hi, *src_hi)):
            if (x.dtype != torch.float32 or x.device != x0.device
                    or not x.is_contiguous() or x.numel() == 0
                    or x.numel() % (sub * LANE)
                    or x.numel() != x_hi.numel()):
                raise ValueError(
                    f"walk sources must be contiguous float32 on "
                    f"{x0.device}, whole {sub}-row chunks, the same in "
                    f"each stream")
        _check(src_hi[0].reshape(-1, LANE), level, n_chunks, sub, None)


def _check_vector(t, n: int, device, what: str) -> None:
    if (t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous() or t.numel() != n):
        raise ValueError(f"{what} must be contiguous float32 ({n},) on "
                         f"{device}")


def _shard_args(walks, n_chunks: int, sub: int
                ) -> tuple[_ShardArgs, torch.Tensor | None]:
    """The kernel's arguments for ``walks`` (outputs left null) and, for
    two walks, the call's own buffer of their partial sums (acc, err, lo
    a cell and a walk) followed by their pair flags (one a block of a
    walk, which the launch zeroes on its stream), which the caller keeps
    until the launch is queued."""
    x = walks[0][1][0]
    args = _ShardArgs(n_walks=len(walks), n_chunks=n_chunks, sub=sub)
    part = None
    if len(walks) > 1:
        n = n_chunks * sub * LANE
        part = x.new_empty((2 * 3 * n + n // 256,))
        args.part = part.data_ptr()
        args.flags = part[2 * 3 * n:].data_ptr()
    for w, (level, *srcs) in zip(args.walk, walks):
        for ptrs, src in zip((w.x, w.lo), srcs):
            ptrs[0] = src[0].data_ptr()
            ptrs[1] = src[1].data_ptr() if len(src) > 1 else None
        w.split = srcs[0][0].numel() // (sub * LANE)
        for k in ("l1", "l2", "s_ids", "starts", "counts"):
            setattr(w, k, level[k].data_ptr())
    return args, part


def run_shard_level_df(walks, n_chunks: int, sub: int, base=None,
                       keep: bool = True, finish: bool = False,
                       mask: torch.Tensor | None = None):
    """A shard's df64 level in one launch of ``cpg_shard_level_df_kernel``
    on CUDA tensors (float32 (hi, lo) sources), the plain version on CPU
    ones: every walk's tiles read once for both streams, the folds, and
    the finish, as ``run_shard_level_df_ref`` does them, bit for bit.
    Precondition, as ``run_level_comp``'s: every source is +-0.0 in lane
    127.  Launches on the current stream without syncing."""
    global launches_shard_df
    x = walks[0][1][0]
    if x.device.type == "cpu":
        return run_shard_level_df_ref(walks, n_chunks, sub, base, keep,
                                      finish, mask)
    if x.device.type != "cuda":
        raise ValueError(f"no CPG SpMV for device {x.device}")
    _df_outputs(keep, finish)
    _check_shard(walks, n_chunks, sub)
    n = n_chunks * sub * LANE
    named = list(zip(base or (), ("base y", "base e")))
    if mask is not None:
        named.append((mask, "mask"))
    for t, what in named:
        _check_vector(t, n, x.device, what)
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    args, part = _shard_args(walks, n_chunks, sub)
    ye = (x.new_empty((n,)), x.new_empty((n,))) if keep else None
    hl = (x.new_empty((n,)), x.new_empty((n,))) if finish else None
    if base is not None:
        args.base_y, args.base_e = base[0].data_ptr(), base[1].data_ptr()
    if keep:
        args.out_y, args.out_e = ye[0].data_ptr(), ye[1].data_ptr()
    if finish:
        args.out_hi, args.out_lo = hl[0].data_ptr(), hl[1].data_ptr()
        args.mask = None if mask is None else mask.data_ptr()
    err = lib.tlt_spmv_cpg_shard_df(
        ctypes.addressof(args), walks[0][0]["l2"].element_size(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmv_cpg shard kernel launch failed: CUDA "
                           f"error {err}")
    launches_shard_df += 1
    return ye, hl
