"""GPG — granule-packed gather format, packed on the host for the CUDA
SpMV (kernels/spmv_gpg.py, csrc/spmv_gpg.cu).

The port of ``tpu_lanczos/kernels/gpg.py``.  The host packer (row
splitting and reduce tree, ordering, per-(dest chunk, granule) edge
colouring, tiling with the collision rounds, ghost mex, padding) is the
reference's numpy code unchanged, so a pack made here equals the JAX
package's array for array; only the device half differs: ``GPGGraph`` is
a plain dataclass whose levels are dicts of torch tensors on an explicit
``device``.

The format, in the reference's words, decouples three granularities:

- granule (``g_s`` rows of 128 lanes): a tile's staging buffer (sub_s,
  128) is assembled from ``n_slots = sub_s / g_s`` granules taken from
  anywhere in x (``g_ids``);
- staging (``sub_s`` rows, <= 256 so the second-gather index is uint8);
- dest chunk (``sub_d`` rows): the output window of a tile.

Per tile t of dest chunk d, for dest cell (lane c, row j):

  r = l2[t*128 + c, j]
  xs[r, :] = x[g_ids[t*n_slots + r // g_s]*g_s + r % g_s, :]
  yt[d*128 + c, j] += xs[r, l1[t*sub_s + r, c]]

One entry per staging cell and per dest cell per tile; ghost cells read
lane 127, a structural zero of x.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.kernels.cpg import _compact, _native, _round_up
from tpu_lanczos_torch.kernels.cst import _greedy_slots, _split_rows

LANE = 128
REAL_LANES = 127  # lane 127 of every sublane is a structural zero
LEVEL_KEYS = ("l1", "l2", "g_ids", "d_ids", "starts", "counts")


@dataclasses.dataclass(frozen=True)
class GPGGraph:
    """A packed graph: host metadata plus per-level index tensors on
    ``device``.  Each level is a dict with l1 (T_pad*sub_s, 128) int8, l2
    (T_pad*128, sub_d) uint8, g_ids (T_pad*n_slots,) int32, d_ids (T_pad,)
    int32 and (n_chunks,) int32 starts and counts.  The CUDA kernel reads
    all but d_ids.  ``t_reals`` holds each level's real tile count (the
    sum of its counts)."""

    n: int
    n_chunks: int          # dest chunks (n_sub / sub_d)
    nnz: int
    theta: int
    g_s: int               # granule height in sublanes
    sub_s: int             # staging height in sublanes (n_slots * g_s)
    sub_d: int             # dest chunk height in sublanes
    levels: tuple          # tuple of per-level dicts of torch tensors
    realmask: torch.Tensor  # (n_pad,) f32 {0,1}
    new_of_old: np.ndarray
    t_reals: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.realmask.device

    @property
    def n_slots(self) -> int:
        return self.sub_s // self.g_s

    @property
    def n_sub(self) -> int:
        return self.n_chunks * self.sub_d

    @property
    def n_pad(self) -> int:
        return self.n_sub * LANE

    @property
    def total_tiles(self) -> int:
        return sum(int(lv["d_ids"].shape[0]) for lv in self.levels)

    @property
    def fill(self) -> float:
        return self.nnz / float(max(self.total_tiles, 1) * self.sub_s * LANE)

    def index_bytes(self) -> int:
        """Bytes of l1 + l2 + g_ids over the real tiles: what one SpMV
        must read at least once."""
        per_tile = self.sub_s * LANE + LANE * self.sub_d + 4 * self.n_slots
        return sum(self.t_reals) * per_tile

    @property
    def real_step_share(self) -> float:
        """Real (tile, dest cell) steps over all: a real staging cell (l1
        not lane 127) is read by exactly one dest cell of its tile; every
        other dest cell reads a ghost."""
        real = sum(int((lv["l1"][: t * self.sub_s] != LANE - 1).sum())
                   for lv, t in zip(self.levels, self.t_reals))
        return real / (sum(self.t_reals) * LANE * self.sub_d)

    # ------------------------------------------------------------ vectors

    def permute_in(self, x: np.ndarray, dtype) -> np.ndarray:
        out = np.zeros(self.n_pad, dtype=dtype)
        out[self.new_of_old] = x
        return out

    def permute_out(self, y) -> np.ndarray:
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        return np.asarray(y).reshape(-1)[self.new_of_old]


def _assign_colors(group, a_cell, b_cell, g_s, sub_d):
    """Smallest-free-color greedy edge coloring PER GROUP (= (D, granule)):
    a-side = staging cell (ur, ld), b-side = dest cell (rd, ld), both
    reset per group.  Native C++ (graphcore.cc gc_gpg_color) with a python
    round-based fallback."""
    order = np.argsort(group, kind="stable")
    native = _native(
        "gpg_color", group[order], group[order], a_cell[order],
        b_cell[order], g_s * LANE, sub_d * LANE)
    if native is not None:
        colors = np.empty(group.size, dtype=np.int32)
        colors[order] = native
        return colors
    a_key = group.astype(np.int64) * (g_s * LANE) + a_cell
    b_key = group.astype(np.int64) * (sub_d * LANE) + b_cell
    return _greedy_slots(a_key, b_key)


def _build_gpg_level(src_pos, dst_pos, g_s, sub_s, sub_d):
    """Build one delivery level's tile arrays from endpoint positions.

    Slot assignment: per-(D, granule) greedy edge coloring -> slot =
    (D, granule, color); slots sorted (D, color, granule) and chunked
    ``n_slots`` per tile, so sibling slots of one group land in different
    tiles.  Cross-group dest-cell collisions within a tile are resolved by
    bumping the colliding entries to a fresh round of coloring+tiling over
    the leftovers; tiles from every round are renumbered d-major at the
    end.

    Returns dict of numpy arrays: l1 (T*sub_s, 128) int8, l2 (T*128,
    sub_d) uint8, g_ids (T, n_slots) int32, d_ids (T,) int32.
    """
    n_slots = sub_s // g_s
    E = src_pos.size
    u = src_pos // LANE                 # source sublane
    sl = src_pos % LANE                 # source lane
    g_all = (u // g_s).astype(np.int64)  # granule
    ur_all = u % g_s                    # row within granule
    w = dst_pos // LANE
    D_all = (w // sub_d).astype(np.int64)
    rd_all = (w % sub_d).astype(np.int64)
    ld_all = dst_pos % LANE
    a_cell_all = (ur_all * LANE + ld_all).astype(np.int32)
    b_cell_all = (rd_all * LANE + ld_all).astype(np.int32)
    G = int(g_all.max()) + 1 if E else 1

    # per-entry outputs across rounds.  Tile uid packs
    # (D, round, color, chunk-within-class) so that same-group colors can
    # never share a tile and the final compact renumbering is d-major.
    full_uid = np.zeros(E, dtype=np.int64)
    pos_of = np.zeros(E, dtype=np.int32)     # slot position in tile

    active = np.arange(E)
    rnd = 0
    while active.size:
        D = D_all[active]
        g = g_all[active]
        group = _compact(D * np.int64(1 << 31) + g)
        if rnd < 12:
            color = _assign_colors(
                group, a_cell_all[active], b_cell_all[active], g_s, sub_d
            ).astype(np.int64)
            per_tile = n_slots
        else:  # safety valve: every entry its own slot and tile
            order0 = np.argsort(group, kind="stable")
            gs_ = group[order0]
            newg = np.ones(gs_.size, dtype=bool)
            newg[1:] = gs_[1:] != gs_[:-1]
            gstart = np.maximum.accumulate(
                np.where(newg, np.arange(gs_.size), 0)
            )
            color = np.empty(active.size, dtype=np.int64)
            color[order0] = np.arange(gs_.size) - gstart
            per_tile = 1
        c_mult = int(color.max()) + 1 if color.size else 1
        assert c_mult < (1 << 20), "color overflow in GPG packer"
        # slot = (D, color, g); tiles chunk slots WITHIN one (D, color)
        # class, so two colors of the same group are never tiled together
        skey = (D * c_mult + color) * G + g
        slot_of_entry, s_uniq = _compact(skey, return_unique=True)
        S = s_uniq.size
        slot_dc = s_uniq // G               # (D, color) class
        new_c = np.ones(S, dtype=bool)
        new_c[1:] = slot_dc[1:] != slot_dc[:-1]
        c_start = np.maximum.accumulate(np.where(new_c, np.arange(S), 0))
        within = np.arange(S) - c_start
        s_pos = (within % per_tile).astype(np.int32)
        s_chunk = within // per_tile
        assert S == 0 or int(s_chunk.max()) < (1 << 24)

        e_uid = (((D * 16 + rnd) << 44)
                 | (color << 24) | s_chunk[slot_of_entry])
        e_pos = s_pos[slot_of_entry]

        # collision detection: first entry per (tile, dest cell) stays
        # (compact the uid first: uid * cell would overflow int64)
        t_rank = _compact(e_uid).astype(np.int64)
        ck = t_rank * (sub_d * LANE) + b_cell_all[active]
        order = np.argsort(ck, kind="stable")
        cks = ck[order]
        head = np.ones(cks.size, dtype=bool)
        head[1:] = cks[1:] != cks[:-1]
        keep = np.zeros(active.size, dtype=bool)
        keep[order[head]] = True
        if sub_d > sub_s:
            # a fully-staged (tile, ld) column leaves no ghost staging row
            # for the column's ghost dest cells (there are sub_d of them
            # but only sub_s staging rows) — cap the column at sub_s - 1
            ck2 = t_rank * LANE + ld_all[active]
            order2 = np.argsort(ck2, kind="stable")
            s2 = ck2[order2]
            newk = np.ones(s2.size, dtype=bool)
            newk[1:] = s2[1:] != s2[:-1]
            kstart = np.maximum.accumulate(
                np.where(newk, np.arange(s2.size), 0)
            )
            rank2 = np.arange(s2.size) - kstart
            keep2 = np.zeros(active.size, dtype=bool)
            keep2[order2] = rank2 < (sub_s - 1)
            keep &= keep2

        kept = active[keep]
        full_uid[kept] = e_uid[keep]
        pos_of[kept] = e_pos[keep]
        active = active[~keep]
        rnd += 1

    # d-major tile renumbering: uid sorts by (D, round, color, chunk)
    tile_of = _compact(full_uid).astype(np.int64)
    T = int(tile_of.max()) + 1 if E else 0

    g = g_all
    ur = ur_all
    ld = ld_all
    rd = rd_all
    ss = pos_of.astype(np.int64) * g_s + ur

    T = max(T, 1)
    l1 = np.full((T * sub_s, LANE), LANE - 1, dtype=np.int8)
    l1[tile_of * sub_s + ss, ld] = sl.astype(np.int8)

    # ghost dest cells must select a staging row that is ghost for their
    # (tile, ld) column: first-free row per column via bitmask mex (same
    # scheme as the CPG packer)
    n_words = (sub_s + 63) // 64
    col = tile_of * LANE + ld
    bits = np.zeros((T * LANE, n_words), dtype=np.uint64)
    np.bitwise_or.at(
        bits, (col, ss // 64), np.uint64(1) << (ss % 64).astype(np.uint64)
    )
    inv = ~bits
    first_free = np.zeros(T * LANE, dtype=np.int64)
    found = np.zeros(T * LANE, dtype=bool)
    for wd in range(n_words):
        word = inv[:, wd]
        has = word != 0
        iso = word & (~word + np.uint64(1))
        tz = np.zeros(T * LANE, dtype=np.int64)
        nz = iso > 0
        tz[nz] = np.round(np.log2(iso[nz].astype(np.float64))).astype(np.int64)
        upd = has & ~found
        first_free[upd] = wd * 64 + tz[upd]
        found |= has
    first_free = np.minimum(first_free, sub_s - 1)

    l2 = np.repeat(first_free[:, None], sub_d, axis=1).astype(np.uint8)
    l2[col, rd] = ss.astype(np.uint8)

    g_ids = np.zeros((T, n_slots), dtype=np.int32)  # ghost slots -> granule 0
    g_ids[tile_of, pos_of] = g  # idempotent: all of a slot's entries agree

    d_ids = np.zeros(T, dtype=np.int32)
    d_ids[tile_of] = D_all  # constant per tile by construction
    return dict(l1=l1, l2=l2, g_ids=g_ids, d_ids=d_ids)


def _level_ranges(d_ids: np.ndarray, n_chunks: int):
    counts = np.bincount(d_ids, minlength=n_chunks).astype(np.int32)
    starts = np.zeros(n_chunks, dtype=np.int32)
    starts[1:] = np.cumsum(counts)[:-1]
    return starts, counts


def _to_device(arrays: dict, device) -> dict:
    # writable + contiguous: on the CPU the tensor shares the array
    return {k: torch.from_numpy(np.require(v, requirements="CW")).to(device)
            for k, v in arrays.items()}


def from_numpy(meta: dict, levels, realmask: np.ndarray,
               new_of_old: np.ndarray, device="cuda") -> GPGGraph:
    """Build a GPGGraph from host arrays, e.g. a JAX-package pack's
    (``np.asarray`` of each level array, keys ``LEVEL_KEYS``).  ``meta``
    holds n, n_chunks, nnz, theta, g_s, sub_s and sub_d."""
    levels = [{k: np.asarray(lv[k]) for k in LEVEL_KEYS} for lv in levels]
    return GPGGraph(
        n=int(meta["n"]), n_chunks=int(meta["n_chunks"]),
        nnz=int(meta["nnz"]), theta=int(meta["theta"]),
        g_s=int(meta["g_s"]), sub_s=int(meta["sub_s"]),
        sub_d=int(meta["sub_d"]),
        levels=tuple(_to_device(lv, device) for lv in levels),
        realmask=torch.from_numpy(np.require(
            realmask, dtype=np.float32, requirements="CW")).to(device),
        new_of_old=np.asarray(new_of_old),
        t_reals=tuple(int(lv["counts"].sum()) for lv in levels),
    )


_META_KEYS = ("n", "n_chunks", "nnz", "theta", "g_s", "sub_s", "sub_d")


def save_gpg(gg: GPGGraph, path: str) -> None:
    """Write the reference's ``save_gpg`` .npz (either package loads it)."""
    data = {k: getattr(gg, k) for k in _META_KEYS}
    data.update(n_levels=len(gg.levels), new_of_old=gg.new_of_old,
                realmask=gg.realmask.cpu().numpy())
    for i, lv in enumerate(gg.levels):
        for k in LEVEL_KEYS:
            data[f"lv{i}_{k}"] = lv[k].cpu().numpy()
    np.savez(path, **data)


def load_gpg(path: str, device="cuda") -> GPGGraph:
    """Read a pack written by either package's ``save_gpg``."""
    z = np.load(path)
    levels = [{k: z[f"lv{i}_{k}"] for k in LEVEL_KEYS}
              for i in range(int(z["n_levels"]))]
    meta = {k: int(z[k]) for k in _META_KEYS}
    return from_numpy(meta, levels, z["realmask"], z["new_of_old"], device)


def pack_gpg(
    graph: CSRGraph,
    theta: int | None = None,
    g_s: int = 16,
    sub_s: int = 256,
    sub_d: int | None = None,
    order: str = "auto",
    device="cuda",
) -> GPGGraph:
    """Pack a host CSR graph into the GPG format, index tensors on
    ``device``.  The host work is the reference's packer unchanged.

    ``order`` mirrors pack_cpg's dichotomy, but the skewed branch is
    degree-sorted CONTIGUOUS (descending): granules then have homogeneous
    degree, so a hub granule's slots fill all their rows together.
    """
    n = graph.n
    assert sub_s % g_s == 0 and sub_s % LANE == 0 and sub_s <= 256
    degrees0 = graph.degrees
    if order == "auto":
        d_mean0 = degrees0.mean() if n else 1.0
        cv = float(degrees0.std() / max(d_mean0, 1e-9))
        order = "locality" if cv < 0.5 else "degree"
    d_mean = max(graph.nnz / max(n, 1), 1.0)
    if theta is None:
        theta = int(min(max(2 * d_mean + 8 * np.sqrt(d_mean), 16), 120))
    if sub_d is None:
        sub_d = 512 if n >= 200_000 else sub_s

    rows = graph.row_ids().astype(np.int64)
    cols = graph.indices.astype(np.int64)
    unit, n_units, parents0 = _split_rows(rows, cols, n, theta)

    # reduce tree for virtual rows (same scheme as CPG)
    reduce_edges = []
    cur_src = np.arange(n, n_units)
    cur_dst = parents0
    while cur_src.size:
        rsort = np.argsort(cur_dst, kind="stable")
        r_rows, r_cols = cur_dst[rsort], cur_src[rsort]
        uniq, inv = np.unique(r_rows, return_inverse=True)
        unit2, n_units2, parents2 = _split_rows(inv, r_cols, uniq.size, theta)
        n_new = n_units2 - uniq.size
        new_ids = np.arange(n_units, n_units + n_new)
        unit_map = np.concatenate([uniq, new_ids])
        reduce_edges.append((r_cols, unit_map[unit2]))
        n_units += n_new
        cur_src = new_ids
        cur_dst = uniq[parents2]

    deg = np.bincount(unit, minlength=n_units)
    for s_arr, d_arr in reduce_edges:
        deg += np.bincount(d_arr, minlength=n_units)
    if order == "locality":
        rank = np.arange(n_units, dtype=np.int64)
    else:
        srt = np.argsort(-deg, kind="stable")
        rank = np.empty(n_units, dtype=np.int64)
        rank[srt] = np.arange(n_units)

    # sublane-linear positions skipping lane 127
    pos_of = (rank // REAL_LANES) * LANE + (rank % REAL_LANES)
    new_of_old = pos_of[:n]

    n_sub = (n_units + REAL_LANES - 1) // REAL_LANES
    n_chunks = max((n_sub + sub_d - 1) // sub_d, 1)
    # bucket the grid size (the reference's compile cache; kept so the
    # arrays equal the reference's)
    n_chunks = _round_up(
        n_chunks, max(4, 1 << max((n_chunks - 1).bit_length() - 2, 0))
    )
    n_sub = n_chunks * sub_d

    levels = []
    levels.append(
        _build_gpg_level(pos_of[cols], pos_of[unit], g_s, sub_s, sub_d))
    for s_arr, d_arr in reduce_edges:
        levels.append(
            _build_gpg_level(pos_of[s_arr], pos_of[d_arr], g_s, sub_s, sub_d)
        )

    n_pad = n_sub * LANE
    realmask = np.zeros(n_pad, dtype=np.float32)
    realmask[new_of_old] = 1.0

    n_slots = sub_s // g_s
    max_granule = n_sub // g_s - 1  # granule ids must stay inside x
    host_levels = []
    for lv in levels:
        T = lv["d_ids"].shape[0]
        starts, counts = _level_ranges(lv["d_ids"], n_chunks)
        # padded tile count (the reference's compile-cache bucket)
        T_pad = _round_up(
            max(T, 1),
            max(256, 1 << max((max(T, 1) - 1).bit_length() - 2, 0)),
        )
        l1 = np.full((T_pad * sub_s, LANE), LANE - 1, dtype=np.int8)
        l1[: T * sub_s] = lv["l1"]
        l2 = np.zeros((T_pad * LANE, sub_d), dtype=np.uint8)
        l2[: T * LANE] = lv["l2"]
        g_ids = np.zeros((T_pad, n_slots), dtype=np.int32)
        g_ids[:T] = np.minimum(lv["g_ids"], max_granule)
        d_ids = np.zeros(T_pad, dtype=np.int32)
        d_ids[:T] = lv["d_ids"]
        host_levels.append(dict(l1=l1, l2=l2, g_ids=g_ids.reshape(-1),
                                d_ids=d_ids, starts=starts, counts=counts))
    meta = dict(n=n, n_chunks=n_chunks, nnz=graph.nnz, theta=theta,
                g_s=g_s, sub_s=sub_s, sub_d=sub_d)
    return from_numpy(meta, host_levels, realmask, new_of_old, device)
