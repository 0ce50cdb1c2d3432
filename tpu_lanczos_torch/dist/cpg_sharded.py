"""Row-sharded CPG: the CUDA level kernels on each shard's tiles.

The port of ``tpu_lanczos/dist/cpg_sharded.py``, the path of row 1d:
kernel 1 (``kernels/spmv_cpg.py::run_level``) as the reference's
row-sharded body runs it, a launch a pass, on a shard's dest chunks
(``c_loc``) reading a source of another size (or two: the shard's rows
and its halo, each read in place), and in df64 the shard level kernel
(``run_shard_level_df``, in dist/lanczos_df.py).

- positions are the usual CPG layout; chunks are split into contiguous
  blocks of ``c_loc = n_chunks / n_shards``, so a shard's slice of the
  flat vector IS its chunk block;
- each shard owns the tiles whose DEST chunk it owns (the d-major tile
  order makes those contiguous ranges), ghost-padded to a common
  per-shard tile count; its d ids and starts are local, its s ids index
  the buffer the level reads;
- per SpMV the shard's vector is exchanged (all of it, or, for a
  locality-ordered pack, only the boundary chunks other shards read: the
  halo) and the kernel runs over the shard's tiles;
- reduce levels read virtual-row partial sums only, so each exchanges
  just the chunks its tiles source (computed at pack time): each shard
  contributes its owned needed chunks (padded to a common count), and
  the level's s ids are remapped into the gathered compact buffer.

With ``overlap`` (the default pack on a mesh of more than one shard) the
main level is two passes: the own-source pass reads the shard's own rows
only and the cross-source pass the exchanged buffer, its sum added to
the own pass's as the reference does.  The host decides which passes
and levels a shard runs from the pack's static per-shard tile counts
(``shard_tiles``), never from a device value: a pass or a reduce level
with no tiles on a shard is not run there (its sum would add +0.0 to a
value that is never -0.0), and a reduce level with no tiles on any
shard takes no exchange.

Every pack is built on the host by the reference's code, so its arrays
equal the reference's array for array; a held shard's slice of every
stacked (n_shards, ...) array is a contiguous tensor of the kernel's
index dtype on that shard's device.  ``fmt="best"`` packs CPG on every
device here (the reference packs CPG only on a TPU), because the CUDA
kernel is native on the GPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_lanczos_torch.core.lanczos import LanczosState
from tpu_lanczos_torch.dist.mesh import (
    LocalSpmv, Mesh, make_mesh, sharded_alphabeta_body,
    sharded_diag_probes_body, sharded_lanczos_body,
    sharded_trace_probes_body)
from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.kernels.cpg import (
    CPGGraph, GROUP_PAD, LANE, _mask_is_sparse, _round_up, pack_cpg)
from tpu_lanczos_torch.kernels.spmv_cpg import run_level, run_level_ref


@dataclasses.dataclass(frozen=True)
class ShardedCPG:
    """CPG tiles split by dest chunk over an n_shards mesh.

    ``levels`` holds, per level, one dict per shard this process holds
    (``shards``) of that shard's slice of the reference's stacked arrays
    (l1, l2, s_ids, run_ids, pair_mask, starts, counts, and ``sel`` on a
    reduce level, ``halo_sel`` on a main level that exchanges a halo), on
    the shard's device; ``realmask`` is the per-shard (n_loc,) slices.

    With ``overlap`` the MAIN level is split in two: ``levels[0]`` holds
    each shard's OWN-source tiles (source chunk inside the shard's block,
    s ids rebased local, reads the shard's own rows only) and
    ``levels[1]`` its CROSS-source tiles (reads the exchanged buffer), as
    the reference ran both cards' local SpMVs before its peer transfer
    (parallel-two-cards/lib/cu_lanczos.cu:120-125).  ``t_reals`` (the
    largest real tile count of any shard, per level) and ``mask_sparse``
    are static host metadata, kept so the pack equals the reference's;
    ``shard_tiles`` (per level, every shard's real tile count) decides on
    the host which passes each shard runs.
    """

    n: int
    n_shards: int
    n_chunks: int          # global, divisible by n_shards
    nnz: int
    theta: int
    sub: int
    levels: tuple
    realmask: tuple
    new_of_old: np.ndarray
    shards: tuple
    t_reals: tuple = ()
    mask_sparse: tuple = ()
    overlap: bool = False
    shard_tiles: tuple = ()

    @property
    def n_main(self) -> int:
        """Number of main-level passes (2 when overlap-split)."""
        return 2 if self.overlap else 1

    @property
    def n_pad(self) -> int:
        return self.n_chunks * self.sub * LANE

    @property
    def c_loc(self) -> int:
        return self.n_chunks // self.n_shards

    @property
    def n_loc(self) -> int:
        return self.c_loc * self.sub * LANE

    def permute_in(self, x: np.ndarray, dtype) -> np.ndarray:
        out = np.zeros(self.n_pad, dtype=dtype)
        out[self.new_of_old] = x
        return out

    def permute_out(self, y) -> np.ndarray:
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        return np.asarray(y).reshape(-1)[self.new_of_old]

    @classmethod
    def from_numpy(cls, meta: dict, levels, realmask: np.ndarray,
                   new_of_old: np.ndarray, mesh: Mesh) -> "ShardedCPG":
        """The port's pack of a sharded pack's host arrays (the
        reference's stacked (n_shards, ...) level arrays and (n_pad,)
        realmask as numpy) on ``mesh``: each held shard's slices on its
        device.  ``meta`` holds n, n_shards, n_chunks, nnz, theta, sub,
        t_reals, mask_sparse and overlap."""
        n_shards = int(meta["n_shards"])
        if mesh.n_shards != n_shards:
            raise ValueError(f"pack of {n_shards} shards on a mesh of "
                             f"{mesh.n_shards}")
        n_loc = int(meta["n_chunks"]) // n_shards * int(meta["sub"]) * LANE

        def put(a, dev, dtype=None):
            # writable + contiguous: on the CPU the tensor shares the array
            return torch.from_numpy(np.require(
                a, dtype=dtype, requirements="CW")).to(dev)

        lvs = tuple(
            tuple({k: put(np.asarray(v)[s], dev) for k, v in lv.items()}
                  for s, dev in zip(mesh.shards, mesh.devices))
            for lv in levels)
        rm = np.asarray(realmask).reshape(-1)
        return cls(
            n=int(meta["n"]), n_shards=n_shards,
            n_chunks=int(meta["n_chunks"]), nnz=int(meta["nnz"]),
            theta=int(meta["theta"]), sub=int(meta["sub"]), levels=lvs,
            realmask=tuple(put(rm[s * n_loc:(s + 1) * n_loc], dev,
                               np.float32)
                           for s, dev in zip(mesh.shards, mesh.devices)),
            new_of_old=np.asarray(new_of_old), shards=tuple(mesh.shards),
            t_reals=tuple(int(t) for t in meta["t_reals"]),
            mask_sparse=tuple(bool(m) for m in meta["mask_sparse"]),
            overlap=bool(meta["overlap"]),
            shard_tiles=tuple(tuple(int(c) for c in np.asarray(
                lv["counts"]).sum(axis=1)) for lv in levels))


def _stack_level(l1, l2, s_loc, run_ids, pair_mask, d_loc_all, tiles,
                 sub, c_loc, n_shards, l2_dtype):
    """Stack per-shard tile subsets into the kernel's (n_shards, ...)
    arrays.  ``tiles[s]`` are GLOBAL tile indices (d-major sorted within
    the shard), ``s_loc[s]`` the already-remapped source ids for shard
    s's subset, ``d_loc_all`` the global per-tile LOCAL dest chunk ids.
    Returns (numpy level dict, t_real)."""
    t_real = max((int(t.size) for t in tiles), default=0)
    # >= GROUP_PAD ghost tiles past the last real one on EVERY shard (the
    # single-device _finalize invariant, kept so the arrays are the
    # reference's)
    t_loc = _round_up(max(t_real, 1) + GROUP_PAD, 256)
    l1_3d = l1.reshape(-1, sub, LANE)
    l2_3d = l2.reshape(-1, LANE, sub)
    L1 = np.full((n_shards, t_loc * sub, LANE), LANE - 1, dtype=np.int8)
    L2 = np.zeros((n_shards, t_loc * LANE, sub), dtype=l2_dtype)
    S = np.zeros((n_shards, t_loc), dtype=np.int32)
    R = np.zeros((n_shards, t_loc), dtype=np.int32)
    PM = np.zeros((n_shards, t_loc), dtype=np.int32)
    ST = np.zeros((n_shards, c_loc), dtype=np.int32)
    CT = np.zeros((n_shards, c_loc), dtype=np.int32)
    for s in range(n_shards):
        ti = tiles[s]
        m = int(ti.size)
        if m:
            L1[s, : m * sub] = l1_3d[ti].reshape(m * sub, LANE)
            L2[s, : m * LANE] = l2_3d[ti].reshape(m * LANE, sub)
            S[s, :m] = s_loc[s]
            # run ids renumbered consecutive along this shard's tile list
            # (the TPU kernel's streamed-x slot assignment needed gap-free
            # numbering; kept so the arrays equal the reference's)
            r = run_ids[ti]
            chg = np.ones(m, np.int64)
            chg[1:] = (r[1:] != r[:-1]).astype(np.int64)
            R[s, :m] = (np.cumsum(chg) - 1).astype(np.int32)
            PM[s, :m] = pair_mask[ti]
        cnt = np.bincount(d_loc_all[ti] if m else np.zeros(0, np.int64),
                          minlength=c_loc).astype(np.int32)
        CT[s] = cnt
        st = np.zeros(c_loc, np.int32)
        st[1:] = np.cumsum(cnt)[:-1].astype(np.int32)
        ST[s] = st
    return dict(l1=L1, l2=L2, s_ids=S, run_ids=R, pair_mask=PM,
                starts=ST, counts=CT), t_real


def _check_sources(lvd: dict, n_src_chunks: int, what: str) -> None:
    """Every real tile's s_id of every shard lies inside the buffer of
    ``n_src_chunks`` chunks that the level reads: checked once here, on
    the host, since the kernel reads x through s_ids unchecked."""
    for s in range(lvd["s_ids"].shape[0]):
        m = int(lvd["counts"][s].sum())
        ids = lvd["s_ids"][s, :m]
        if m and not (0 <= int(ids.min()) and int(ids.max()) < n_src_chunks):
            raise ValueError(
                f"sharded CPG pack: {what} s_ids of shard {s} outside its "
                f"{n_src_chunks}-chunk source")


def split_cpg(cg: CPGGraph, n_shards: int, overlap: bool = True) -> dict:
    """Split a dest-only classic CPG pack (host tensors) into the
    reference's sharded host arrays: a dict of meta (n, n_shards,
    n_chunks, nnz, theta, sub, t_reals, mask_sparse, overlap), levels
    (per level a dict of stacked (n_shards, ...) numpy arrays), realmask
    (n_pad,) and new_of_old.  Splitting tiles along their (d-major
    sorted) dest chunks is the reference's ``pack_cpg_sharded`` after its
    ``pack_cpg`` call, line for line."""
    if cg.n_bcast or cg.layout != "classic":
        raise ValueError("split_cpg takes a dest-only classic pack")
    sub = cg.sub
    C = _round_up(cg.n_chunks, n_shards)
    c_loc = C // n_shards

    levels = []
    t_reals = []
    mask_sparse = []
    for lv_i, lv in enumerate(cg.levels):
        lv = {k: v.cpu().numpy() for k, v in lv.items()}
        d_ids, s_ids = lv["d_ids"], lv["s_ids"]
        t_real_lv = int(lv["counts"].sum())
        run_ids, pair_mask = lv["run_ids"], lv["pair_mask"]
        l1, l2 = lv["l1"], lv["l2"]
        starts, counts = lv["starts"], lv["counts"]
        # pad starts with the TOTAL tile count: padded dest chunks own an
        # empty range at the end of the tile list
        total_tiles = int(counts.sum())
        starts = np.pad(starts, (0, C - starts.size),
                        constant_values=total_tiles)
        counts = np.pad(counts, (0, C - counts.size))
        # per-shard tile ranges over the d-major-sorted tile list
        sh_start = starts[::c_loc][:n_shards]
        sh_end = np.append(sh_start[1:], total_tiles)
        d_loc_all = (d_ids % c_loc).astype(np.int64)
        sp_lv = cg.mask_sparse[lv_i] if cg.mask_sparse else True

        if lv_i >= 1:
            # reduce levels read virtual-cell partials only: the union of
            # needed source chunks, each shard's owned share (padded to a
            # common m_pad), and the remap of s_ids into the compact
            # gathered buffer (concat of per-shard slabs)
            needed = np.unique(s_ids[:t_real_lv])
            owner = needed // c_loc
            per_owner = np.bincount(np.minimum(owner, n_shards - 1),
                                    minlength=n_shards)
            m_pad = max(int(per_owner.max()), 1)
            sel = np.zeros((n_shards, m_pad), dtype=np.int32)
            remap = np.zeros(C, dtype=np.int32)
            for sh in range(n_shards):
                own = needed[owner == sh]
                sel[sh, : own.size] = (own % c_loc).astype(np.int32)
                remap[own] = sh * m_pad + np.arange(own.size, dtype=np.int32)
            s_rm = remap[s_ids]
            tiles = [np.arange(int(sh_start[sh]), int(sh_end[sh]))
                     for sh in range(n_shards)]
            s_loc = [s_rm[t].astype(np.int32) for t in tiles]
            lvd, t_real = _stack_level(l1, l2, s_loc, run_ids, pair_mask,
                                       d_loc_all, tiles, sub, c_loc,
                                       n_shards, l2.dtype)
            _check_sources(lvd, n_shards * m_pad, f"reduce level {lv_i}")
            lvd["sel"] = sel  # (n_shards, m_pad)
            levels.append(lvd)
            t_reals.append(max(t_real, 1))
            mask_sparse.append(sp_lv)
            continue

        # MAIN level.  When each shard sources few chunks outside its own
        # block (locality-ordered meshes), exchange only the union of
        # cross-shard chunks instead of gathering the whole vector;
        # power-law packs keep the full gather (their cross set is ~all
        # chunks)
        crosses = []
        own_masks = []
        for sh in range(n_shards):
            a, b = int(sh_start[sh]), int(sh_end[sh])
            seg = s_ids[a:b]
            own = (seg >= sh * c_loc) & (seg < (sh + 1) * c_loc)
            own_masks.append(own)
            crosses.append(np.unique(seg[~own]))
        union_cross = (np.unique(np.concatenate(crosses))
                       if crosses else np.zeros(0, np.int64))
        sel = None
        halo_bufpos = None
        if union_cross.size:
            owner = np.minimum(union_cross // c_loc, n_shards - 1)
            per_owner = np.bincount(owner, minlength=n_shards)
            h_pad = max(int(per_owner.max()), 1)
            # gate on the REAL transfer, n_shards * h_pad padded chunks,
            # not the raw union size
            if n_shards * h_pad * 2 <= C:
                sel = np.zeros((n_shards, h_pad), dtype=np.int32)
                halo_bufpos = np.zeros(C, dtype=np.int32)
                for sh in range(n_shards):
                    own = union_cross[owner == sh]
                    sel[sh, : own.size] = (own % c_loc).astype(np.int32)
                    halo_bufpos[own] = (
                        sh * h_pad + np.arange(own.size, dtype=np.int32))
        halo_chunks = C if sel is None else n_shards * sel.shape[1]

        if overlap and n_shards > 1:
            # own-source (reads the shard's rows, no exchange) and
            # cross-source (reads the exchanged buffer) passes; each
            # subset stays d-major sorted
            t_own, t_cross, so, sc = [], [], [], []
            for sh in range(n_shards):
                a, b = int(sh_start[sh]), int(sh_end[sh])
                idx = np.arange(a, b)
                seg = s_ids[a:b]
                own = own_masks[sh]
                t_own.append(idx[own])
                so.append((seg[own] - sh * c_loc).astype(np.int32))
                t_cross.append(idx[~own])
                cs = seg[~own]
                sc.append((halo_bufpos[cs] if halo_bufpos is not None
                           else cs).astype(np.int32))
            lv_own, tr_own = _stack_level(l1, l2, so, run_ids, pair_mask,
                                          d_loc_all, t_own, sub, c_loc,
                                          n_shards, l2.dtype)
            lv_cross, tr_cross = _stack_level(l1, l2, sc, run_ids,
                                              pair_mask, d_loc_all,
                                              t_cross, sub, c_loc,
                                              n_shards, l2.dtype)
            _check_sources(lv_own, c_loc, "own pass")
            _check_sources(lv_cross, halo_chunks, "cross pass")
            if halo_bufpos is not None:
                lv_cross["halo_sel"] = sel  # (n_shards, h_pad)
            levels += [lv_own, lv_cross]
            t_reals += [tr_own, tr_cross]

            def _sp(tiles):
                if not sp_lv:
                    return False
                pm = [pair_mask[t] for t in tiles if t.size]
                return _mask_is_sparse(
                    np.concatenate(pm) if pm else np.zeros(0, np.int32),
                    sub, "classic")

            mask_sparse += [_sp(t_own), _sp(t_cross)]
            continue

        # unsplit main level (overlap off, or a 1-shard mesh)
        tiles = [np.arange(int(sh_start[sh]), int(sh_end[sh]))
                 for sh in range(n_shards)]
        s_loc = []
        for sh in range(n_shards):
            seg = s_ids[tiles[sh]]
            if halo_bufpos is not None:
                # own chunk -> its row block in the shard's vector; cross
                # chunk -> c_loc + its slot in the halo buffer
                own = own_masks[sh]
                seg = np.where(own, seg - sh * c_loc,
                               c_loc + halo_bufpos[seg])
            s_loc.append(seg.astype(np.int32))
        lvd, t_real = _stack_level(l1, l2, s_loc, run_ids, pair_mask,
                                   d_loc_all, tiles, sub, c_loc,
                                   n_shards, l2.dtype)
        _check_sources(lvd, C if sel is None else c_loc + halo_chunks,
                       "main level")
        if halo_bufpos is not None:
            lvd["halo_sel"] = sel  # (n_shards, h_pad)
        levels.append(lvd)
        t_reals.append(max(t_real, 1))
        mask_sparse.append(sp_lv)

    realmask = cg.realmask.cpu().numpy()
    pad = C * sub * LANE - cg.n_pad
    if pad:
        realmask = np.concatenate([realmask, np.zeros(pad, realmask.dtype)])
    meta = dict(n=cg.n, n_shards=n_shards, n_chunks=C, nnz=cg.nnz,
                theta=cg.theta, sub=sub, t_reals=t_reals,
                mask_sparse=mask_sparse,
                overlap=bool(overlap and n_shards > 1))
    return dict(meta=meta, levels=levels, realmask=realmask,
                new_of_old=cg.new_of_old)


def dest_only_kw(**kw) -> dict:
    """The pack_cpg keywords of a sharded pack: the reference's two
    refusals (with its texts) and its forced dest-only classic layout."""
    # the shard splitter assumes levels = [main, reduce...]; source-split
    # broadcast levels are a single-device optimization the sharded path
    # does not carry: refuse an explicit source-split cap BEFORE paying
    # for the pack, and force dest-only
    ts = kw.get("theta_s")
    if ts is not None and ts != "off":
        raise ValueError(
            "sharded CPG packs are dest-only (source-split broadcast "
            "levels are a single-chip optimization); drop the theta_s "
            "override")
    kw["theta_s"] = None
    # the splitter slices l1 by sub rows a tile and treats s_ids as chunk
    # ids, both wrong for the slab layout
    if kw.get("layout") == "slab":
        raise ValueError(
            "sharded CPG supports the classic layout only (layout='slab' "
            "is a single-chip tile shape); drop the layout override")
    kw["layout"] = "classic"
    return kw


def pack_cpg_sharded(graph: CSRGraph, n_shards: int, mesh: Mesh | None = None,
                     overlap: bool = True, **kw) -> ShardedCPG:
    """Pack for an ``n_shards`` mesh by splitting a global dest-only CPG
    pack's tiles along their (d-major sorted) dest chunks; each held
    shard's arrays land on its device (``mesh``; default ``make_mesh
    (n_shards)``, on the GPUs).  ``kw`` goes to ``pack_cpg`` (theta, sub,
    order, redeal).  ``overlap=True`` splits the main level into
    own-source and cross-source passes (see ShardedCPG)."""
    kw = dest_only_kw(**kw)
    if mesh is None:
        mesh = make_mesh(n_shards)
    cg = pack_cpg(graph, device="cpu", **kw)
    a = split_cpg(cg, n_shards, overlap)
    return ShardedCPG.from_numpy(a["meta"], a["levels"], a["realmask"],
                                 a["new_of_old"], mesh)


# --------------------------------------------------------------- the SpMV


def _as_shards(mesh: Mesh, x, n_loc: int) -> list:
    """A per-shard list as is; a full (n_pad,) vector split by shard."""
    if isinstance(x, (list, tuple)):
        return list(x)
    return mesh.split(x, n_loc)


def _exchange(sg: ShardedCPG, mesh: Mesh, level, vec: list, key: str):
    """One level's exchange of a per-shard vector: each shard's chunks
    named by ``level[s][key]`` (the compact halo or reduce-level buffer)
    gathered in shard order, or the whole vector where the level has no
    such key."""
    if key in level[0]:
        return mesh.all_gather([
            v.reshape(sg.c_loc, -1).index_select(0, lv[key]).reshape(-1)
            for v, lv in zip(vec, level)])
    return mesh.all_gather(vec)


def _main_walks(sg: ShardedCPG, shard: int, i: int, own, gathered) -> list:
    """The walks of shard ``shard``'s (held at place ``i``) main level:
    (level, source) pairs.  Split (overlap): the own pass on its rows
    and the cross pass on the gathered buffer, each where it has tiles on
    the shard (the own pass, empty, where neither has); unsplit: the
    level on the shard's rows followed by the halo, or on the gathered
    vector."""
    if not sg.overlap:
        lv = sg.levels[0][i]
        return [(lv, (own, gathered) if "halo_sel" in lv else (gathered,))]
    walks = [(sg.levels[p][i], src)
             for p, src in ((0, (own,)), (1, (gathered,)))
             if sg.shard_tiles[p][shard]]
    return walks or [(sg.levels[0][i], (own,))]


def _main_exchange(sg: ShardedCPG, mesh: Mesh, q: list) -> list:
    """The main level's exchange of a per-shard vector: the buffer its
    cross pass (or unsplit level) reads, held shard by held shard; none
    where no shard has a cross tile."""
    lv = sg.levels[sg.n_main - 1]
    if sg.overlap and not sg.t_reals[1]:
        return [None] * len(q)
    return _exchange(sg, mesh, lv, q, "halo_sel")


def _reduce_levels(sg: ShardedCPG) -> list:
    """The reduce levels some shard has tiles on, in order (a level that
    none has takes no exchange)."""
    return [li for li in range(sg.n_main, len(sg.levels))
            if any(sg.shard_tiles[li])]


def shard_passes(sg: ShardedCPG, shard: int) -> list:
    """The levels shard ``shard`` runs in one SpMV, in order: the main
    level's passes with tiles on it (the own pass, empty, where none
    has), then the reduce levels with tiles on it."""
    main = [p for p in range(sg.n_main) if sg.shard_tiles[p][shard]]
    return (main or [0]) + [li for li in _reduce_levels(sg)
                            if sg.shard_tiles[li][shard]]


def shard_launches(sg: ShardedCPG, df: bool = False) -> list:
    """The kernel launches of one sharded SpMV on each shard of the pack:
    one a level it runs (``shard_passes``: in f32/f64 each main pass is a
    launch), in df64 (``df``) one for its main level, both passes in it,
    and one a reduce level."""
    return [len(shard_passes(sg, s)) if not df else
            1 + sum(1 for li in shard_passes(sg, s) if li >= sg.n_main)
            for s in range(sg.n_shards)]


def _local_spmv(sg: ShardedCPG, mesh: Mesh, q: list, level_fn,
                masked: bool = True) -> list:
    """Every held shard's slice of y = A q (q a per-shard list): the
    reference's per-shard body (cpg_sharded.py:416-501) with each level
    through ``level_fn`` (``run_level`` or its plain version), in its
    order of additions.  The exchange first; then each shard's main
    level, pass by pass (``_main_walks``: the own pass, then the cross
    pass); then each reduce level on the shards it has tiles on.  A pass
    that follows another passes the running y as the kernel's ``base``:
    the kernel adds its tile sum to it, the sum-then-add the reference
    writes as ``y + run(...)``.  With ``masked=False`` the last multiply
    by the realmask is left out, for the Lanczos step's passes to fold in
    (as ``spmv_cpg(..., masked=False)`` on one device)."""
    c_loc, sub = sg.c_loc, sg.sub
    rows = c_loc * sub

    def run(level, src, base):
        # src: (buffer,), or (the shard's rows, its halo), read in place
        return level_fn(src[0].reshape(-1, LANE), level, c_loc, sub,
                        None if base is None else base.reshape(rows, LANE),
                        halo=src[1] if len(src) > 1 else None).reshape(-1)

    gathered = _main_exchange(sg, mesh, q)
    y = []
    for i, (s, qs, gs) in enumerate(zip(mesh.shards, q, gathered)):
        ys = None
        for level, src in _main_walks(sg, s, i, qs, gs):
            ys = run(level, src, ys)
        y.append(ys)
    for li in _reduce_levels(sg):
        # exchange only the chunks this level's tiles source (the
        # virtual-cell partials); s_ids were remapped into the compact
        # buffer
        level = sg.levels[li]
        buf = _exchange(sg, mesh, level, y, "sel")
        y = [run(lv, (b,), ys) if sg.shard_tiles[li][s] else ys
             for s, ys, b, lv in zip(mesh.shards, y, buf, level)]
    if not masked:
        return y
    return [t * r.to(t.dtype) for t, r in zip(y, sg.realmask)]


def spmv_cpg_sharded(sg: ShardedCPG, mesh: Mesh, q) -> list:
    """y = A q on the mesh, every shard level through ``run_level`` (the
    CUDA kernel on a CUDA shard, its plain version on a CPU one).  ``q``
    is a per-shard list or the full (n_pad,) permuted vector; returns the
    per-shard list."""
    return _local_spmv(sg, mesh, _as_shards(mesh, q, sg.n_loc), run_level)


def spmv_cpg_sharded_ref(sg: ShardedCPG, mesh: Mesh, q) -> list:
    """The same SpMV through ``run_level_ref`` on any device."""
    return _local_spmv(sg, mesh, _as_shards(mesh, q, sg.n_loc),
                       run_level_ref)


def _local(sg: ShardedCPG, mesh: Mesh) -> LocalSpmv:
    """The Lanczos loops' local SpMV: the kernel's levels without the
    realmask multiply, which the step's passes fold in."""
    return LocalSpmv(lambda q: _local_spmv(sg, mesh, q, run_level,
                                           masked=False),
                     mask=list(sg.realmask))


def lanczos_cpg_sharded(sg: ShardedCPG, x, k: int, mesh: Mesh,
                        reorthogonalize: bool = False) -> LanczosState:
    """k-step Lanczos with the CPG kernel row-sharded over ``mesh``.
    ``x`` is the (n_pad,) CPG-permuted start vector or its per-shard
    list.  Returns alpha, beta[:k-1] and x_norm replicated and
    ``q_basis`` as the per-shard tuple of (k, n_loc)."""
    alpha, beta, q_basis, x_norm = sharded_lanczos_body(
        mesh, _local(sg, mesh), _as_shards(mesh, x, sg.n_loc), k,
        reorthogonalize)
    return LanczosState(alpha=alpha, beta=beta[: k - 1],
                        q_basis=tuple(q_basis), x_norm=x_norm)


def lanczos_alphabeta_cpg_sharded(sg: ShardedCPG, x, k: int, mesh: Mesh):
    """Pass-1 Q-free Lanczos with the CPG kernel row-sharded over
    ``mesh``: O(n_loc) memory per shard.  Returns (alpha, beta, x_norm)
    replicated; beta is FULL length k (slot k-1 the residual norm)."""
    return sharded_alphabeta_body(mesh, _local(sg, mesh),
                                  _as_shards(mesh, x, sg.n_loc), k)


def trace_probes_cpg_sharded(sg: ShardedCPG, mask: list, seed: int,
                             stream: int, k: int, probes: int, mesh: Mesh,
                             u_rows: list):
    """Every trace probe over the row-sharded CPG kernel (see
    dist.mesh.sharded_trace_probes_body).  Returns replicated (alphas,
    betas, x_norms, coeffs)."""
    return sharded_trace_probes_body(mesh, _local(sg, mesh), mask, seed,
                                     stream, k, probes, u_rows)


def diag_probes_cpg_sharded(sg: ShardedCPG, mask: list, seed: int,
                            stream: int, attempt: int, k: int, probes: int,
                            mesh: Mesh, u_rows: list, w_defl, shift) -> list:
    """The diagonal-probe accumulator over the row-sharded CPG kernel
    (see dist.mesh.sharded_diag_probes_body): the per-shard slices of the
    scaled diagonal estimate."""
    return sharded_diag_probes_body(mesh, _local(sg, mesh), mask, seed,
                                    stream, attempt, k, probes, u_rows,
                                    w_defl, shift)
