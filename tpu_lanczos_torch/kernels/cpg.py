"""CPG — chunk-pair gather format, packed on the host for the CUDA SpMV.

The port of ``tpu_lanczos/kernels/cpg.py``.  The host packer (ordering,
row/source splitting, dealing, level builders, masks) is the reference's
code unchanged, so a pack made here equals the JAX package's array for
array; only the device half differs: ``CPGGraph`` is a plain dataclass
whose levels are dicts of torch tensors on an explicit ``device``.

The format, in the reference's words: the matrix is blocked into
(source-chunk S, dest-chunk D) pairs of (sub, 128) positions each, and
every nonzero is routed by two index tiles per tile t of a level:

  XS = x-chunk S (sub, 128)
  G1[ss, ld] = XS[ss, L1[ss, ld]]                 stage by dest lane
  y[D*sub + rd, ld] += G1[L2[ld, rd], ld]         deliver to dest cell

Constraints per tile: one entry per staging pair (ss, ld) and one entry
per dest cell (rd, ld).  Rows beyond ``theta`` are split into virtual
rows folded back by reduce levels; heavy sources are split into copies
filled by a leading broadcast level.  Lane 127 of every sublane is a
structural zero, so in the classic layout ghost cells gather zeros and
no masking exists in the kernel (kernels/csrc/spmv_cpg.cu).

The slab layout (``layout="slab"``) makes every tile source-slab-pure:
it reads one (128, 128) slab of x (``s_ids`` are global slab ids), l1 is
(T*128, 128), and l2 is uint8 at any ``sub`` with bit 7 marking ghost
dest cells, which the kernel adds as zero.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.kernels.cst import _greedy_slots, _round_up, _split_rows

LANE = 128
REAL_LANES = 127           # lane 127 is the structural zero lane
# bump when pack output changes; equal to the reference's PACK_VERSION so
# .npz packs saved by either package load in the other
PACK_VERSION = 5
# every level keeps >= this many ghost tiles past its real ones (the TPU
# kernel's batched group DMA reads past the last real tile; kept so the
# arrays equal the reference's)
GROUP_PAD = 16


def _l2_dtype(sub: int):
    """l2 holds staging-sublane indices in [0, sub): uint8 overflows past
    sub=256, so wider chunks carry int16 index tiles (2x the l2 DMA
    bytes, still small next to the f32 source-chunk traffic)."""
    return np.uint8 if sub <= 256 else np.int16


@dataclasses.dataclass(frozen=True)
class _CPGLevel:
    """One delivery pass: flattened tile list sorted by (D, S, tier)."""

    l1: np.ndarray      # (T*sub, 128) int8 — source lane per staging cell
    # (T*128, sub) — staging sublane per dest cell; uint8 for sub <= 256,
    # int16 beyond (values range over [0, sub))
    l2: np.ndarray
    s_ids: np.ndarray   # (T,) int32 — source chunk of each tile
    d_ids: np.ndarray   # (T,) int32 — dest chunk of each tile
    # (T,) int32 — slab-pair occupancy: bit (j*n_slab + si) set iff a
    # real entry routes dest slab j <- staging slab si.  The TPU
    # kernel's second gather skipped unset units (all-ghost cells); the
    # CUDA kernel reads every cell and ignores the mask.
    pair_mask: np.ndarray


@dataclasses.dataclass(frozen=True)
class CPGGraph:
    """A packed graph: host metadata plus per-level index tensors on
    ``device``.  Each level is a dict with l1 (T_pad*sub, 128) int8 (slab
    layout: (T_pad*128, 128)), l2 (T_pad*128, sub) uint8 (sub <= 256 or
    slab layout) or int16, and (T_pad,) int32
    s_ids, d_ids, run_ids, pair_mask, plus (n_chunks,) int32 starts and
    counts.  The CUDA kernel reads l1, l2, s_ids, starts and counts;
    run_ids and pair_mask only scheduled the TPU kernel and are kept so
    a pack equals the reference's."""

    n: int
    n_chunks: int
    nnz: int
    theta: int
    sub: int               # sublanes per chunk (multiple of 128)
    levels: tuple          # tuple of per-level dicts of torch tensors
    realmask: torch.Tensor  # (n_pad,) f32 {0,1}
    new_of_old: np.ndarray
    # leading broadcast levels (source-split copy distribution): levels
    # [0, n_bcast) write into a copy of x before the main level runs
    n_bcast: int = 0
    # "classic": tiles span a full (sub, 128) source chunk.  "slab":
    # tiles are source-slab-pure, one (128, 128) source slab each; l2
    # stays uint8 at any sub and bit 7 flags ghost cells
    layout: str = "classic"
    t_reals: tuple = ()    # real (un-padded) tile count per level
    mask_sparse: tuple = ()  # per level: a real tile kept a sparse mask

    @property
    def device(self) -> torch.device:
        return self.realmask.device

    @property
    def n_pad(self) -> int:
        return self.n_chunks * self.sub * LANE  # includes zero lanes

    @property
    def n_sub(self) -> int:
        return self.n_chunks * self.sub

    @property
    def total_tiles(self) -> int:
        return sum(self.t_reals)

    @property
    def fill(self) -> float:
        """nnz over the real tiles' entry capacity: a full (sub, 128)
        staging block a tile in the classic layout, one (128, 128) source
        slab in the slab layout."""
        cap = (LANE if self.layout == "slab" else self.sub) * LANE
        return self.nnz / float(max(self.total_tiles, 1) * cap)

    def index_bytes(self) -> int:
        """Bytes of l1 + l2 over the real tiles: what one SpMV must read
        at least once (the kernel's roofline input)."""
        rows = LANE if self.layout == "slab" else self.sub
        return sum(
            t * (rows * LANE + LANE * self.sub * lv["l2"].element_size())
            for t, lv in zip(self.t_reals, self.levels))

    # ------------------------------------------------------------ vectors

    def permute_in(self, x: np.ndarray, dtype) -> np.ndarray:
        out = np.zeros(self.n_pad, dtype=dtype)
        out[self.new_of_old] = x
        return out

    def permute_out(self, y) -> np.ndarray:
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        return np.asarray(y).reshape(-1)[self.new_of_old]


_NATIVE_WARNED: set = set()


def _native(fn_name: str, *args, **kw):
    """Dispatch one call to the native core (graphcore.cc).  Returns
    None when the toolchain/library is unavailable so callers fall back
    to their numpy oracle; a native-side ERROR is warned once per
    function instead of silently degrading to the ~6x-slower path."""
    try:
        from tpu_lanczos_torch.graphs import native

        if not native.available():
            return None
        fn = getattr(native, fn_name)
    except Exception:
        return None
    try:
        return fn(*args, **kw)
    except Exception as exc:
        if fn_name not in _NATIVE_WARNED:
            _NATIVE_WARNED.add(fn_name)
            import warnings

            warnings.warn(
                f"native {fn_name} failed ({exc!r}); using numpy fallback"
            )
        return None


def _compact(keys: np.ndarray, return_unique: bool = False):
    """Sorted-rank compaction (np.unique inverse semantics); native sort
    when available (~6x faster than np.unique at 20M keys)."""
    out = _native("compact", keys, return_unique=return_unique)
    if out is not None:
        return out
    uniq, inv = np.unique(keys, return_inverse=True)
    if return_unique:
        return inv, uniq
    return inv


def _assign_tiers(a_c: np.ndarray, b_c: np.ndarray) -> np.ndarray:
    """Slot/tier assignment: Delta-optimal Konig edge coloring via the
    native core when available (tile count == max endpoint load), else
    the round-based python greedy (~1.5-2x Delta)."""
    out = _native("edge_color", a_c, b_c)
    return out if out is not None else _greedy_slots(a_c, b_c)


def _pos_of_unit(rank: np.ndarray, sub: int) -> np.ndarray:
    """Map unit rank -> padded position skipping lane 127.

    rank r -> chunk = r // (sub*127), within w, sublane-in-chunk
    w // 127, lane w % 127.
    """
    per_chunk = sub * REAL_LANES
    chunk = rank // per_chunk
    w = rank % per_chunk
    s = w // REAL_LANES
    lane = w % REAL_LANES
    return (chunk * sub + s) * LANE + lane


def _build_cpg_level(src_pos: np.ndarray, dst_pos: np.ndarray, sub: int):
    """Build tile arrays for one delivery pass from endpoint positions.

    Dispatches to the native one-shot builder (graphcore.cc
    gc_cpg_build_level: same block keys, Konig tiers, tile numbering,
    and l1/l2 ghost-mex semantics) when available — the numpy path below
    is the portable fallback and its correctness oracle
    (tests/test_cpg.py cross-checks the two)."""
    out = _native("cpg_build_level", src_pos, dst_pos, sub)
    if out is not None:
        l1, l2, s_ids, d_ids, pair_mask = out
        return _CPGLevel(l1=l1, l2=l2, s_ids=s_ids, d_ids=d_ids,
                         pair_mask=pair_mask)
    return _build_cpg_level_np(src_pos, dst_pos, sub)


def _build_cpg_level_np(src_pos: np.ndarray, dst_pos: np.ndarray, sub: int):
    """Numpy reference implementation of the level builder."""
    s_chunk = src_pos // (sub * LANE)
    ss = (src_pos // LANE) % sub
    sl = src_pos % LANE
    d_chunk = dst_pos // (sub * LANE)
    rd = (dst_pos // LANE) % sub
    ld = dst_pos % LANE

    # D-major block ordering: the kernel accumulates into a revisited
    # output block per dest chunk, so all of a dest chunk's tiles must be
    # consecutive in the grid
    block = d_chunk * np.int64(1 << 32) + s_chunk
    a_key = block * (sub * LANE) + ss * LANE + ld      # staging pair
    b_key = block * (sub * LANE) + rd * LANE + ld      # dest cell
    # compact keys to avoid giant ranges in the coloring's sorts
    a_c = _compact(a_key)
    b_c = _compact(b_key)
    tier = _assign_tiers(a_c, b_c)

    # tile id per (block, tier), ordered by (d_chunk, s_chunk, tier)
    tier_mult = int(tier.max()) + 1 if tier.size else 1
    tkey = block * tier_mult + tier
    tile_of, uniq_t = _compact(tkey, return_unique=True)
    T = uniq_t.size
    d_ids = (uniq_t // tier_mult // (1 << 32)).astype(np.int32)
    s_ids = ((uniq_t // tier_mult) % (1 << 32)).astype(np.int32)

    l1 = np.full((T * sub, LANE), LANE - 1, dtype=np.int8)  # ghost -> lane 127
    l1[tile_of * sub + ss, ld] = sl.astype(np.int8)

    # Ghost dest cells must point at a staging sublane whose l1 is ghost
    # for their (tile, ld) column.  Compute the first free ss per column
    # as the mex of the staged ss set via per-column bitmasks (O(E), no
    # (T, sub, 128) temporaries — this stage used to dominate pack time).
    n_words = (sub + 63) // 64
    col = tile_of * LANE + ld                       # (E,) column id
    bits = np.zeros((T * LANE, n_words), dtype=np.uint64)
    np.bitwise_or.at(
        bits, (col, ss // 64), np.uint64(1) << (ss % 64).astype(np.uint64)
    )
    inv = ~bits
    first_free = np.zeros(T * LANE, dtype=np.int64)
    found = np.zeros(T * LANE, dtype=bool)
    for w in range(n_words):
        word = inv[:, w]
        has = word != 0
        iso = word & (~word + np.uint64(1))         # lowest set bit
        tz = np.zeros(T * LANE, dtype=np.int64)
        nz = iso > 0
        # exact for powers of two up to 2^63
        tz[nz] = np.round(np.log2(iso[nz].astype(np.float64))).astype(np.int64)
        upd = has & ~found
        first_free[upd] = w * 64 + tz[upd]
        found |= has
    # fully-staged columns have no ghost dest cells (counting argument);
    # clamp so the unused default stays in range
    first_free = np.minimum(first_free, sub - 1)

    dt2 = _l2_dtype(sub)
    l2 = np.repeat(first_free[:, None], sub, axis=1).astype(dt2)
    l2[col, rd] = ss.astype(dt2)

    n_slab = sub // LANE
    if n_slab * n_slab > _MASK_MAX_BITS:
        # too many units for an int32 mask (sub >= 768): the kernel runs
        # its branch-free dense path unconditionally there
        pair_mask = np.full(T, -1, dtype=np.int32)
    else:
        pair_mask = np.zeros(T, dtype=np.int32)
        np.bitwise_or.at(
            pair_mask, tile_of,
            (1 << ((rd // LANE) * n_slab + ss // LANE)).astype(np.int32),
        )
    return _CPGLevel(l1=l1, l2=l2, s_ids=s_ids, d_ids=d_ids,
                     pair_mask=pair_mask)


def _build_cpg_level_slab(src_pos: np.ndarray, dst_pos: np.ndarray,
                          sub: int) -> _CPGLevel:
    """Source-slab-pure level builder (layout="slab").

    Each tile reads ONE (128, 128) source slab: block key = (dest chunk,
    global source slab).  l1 is (T*128, 128) int8 (staging sublane =
    source sublane within the slab), l2 is (T*128, sub) uint8 whose high
    bit flags ghost dest cells (the kernel masks them to zero — no mex
    fill needed, and l2 stays uint8 at any ``sub``)."""
    out = _native("cpg_build_level", src_pos, dst_pos, sub, slab=True)
    if out is not None:
        l1, l2, s_ids, d_ids, pair_mask = out
        return _CPGLevel(l1=l1, l2=l2, s_ids=s_ids, d_ids=d_ids,
                         pair_mask=pair_mask)
    return _build_cpg_level_slab_np(src_pos, dst_pos, sub)


def _build_cpg_level_slab_np(src_pos: np.ndarray, dst_pos: np.ndarray,
                             sub: int) -> _CPGLevel:
    """Numpy reference implementation of the slab-pure level builder."""
    n_slab = sub // LANE
    s_chunk = src_pos // (sub * LANE)
    ss = (src_pos // LANE) % sub
    ssl = ss % LANE                      # sublane within slab
    slab_g = s_chunk * n_slab + ss // LANE  # global source slab id
    sl = src_pos % LANE
    d_chunk = dst_pos // (sub * LANE)
    rd = (dst_pos // LANE) % sub
    ld = dst_pos % LANE

    block = d_chunk * np.int64(1 << 32) + slab_g
    a_key = block * (LANE * LANE) + ssl * LANE + ld    # staging pair
    b_key = block * (sub * LANE) + rd * LANE + ld      # dest cell
    a_c = _compact(a_key)
    b_c = _compact(b_key)
    tier = _assign_tiers(a_c, b_c)

    tier_mult = int(tier.max()) + 1 if tier.size else 1
    tkey = block * tier_mult + tier
    tile_of, uniq_t = _compact(tkey, return_unique=True)
    T = uniq_t.size
    blocks = uniq_t // tier_mult
    d_ids = (blocks // (1 << 32)).astype(np.int32)
    s_ids = (blocks % (1 << 32)).astype(np.int32)      # global slab ids

    l1 = np.full((T * LANE, LANE), LANE - 1, dtype=np.int8)
    l1[tile_of * LANE + ssl, ld] = sl.astype(np.int8)
    l2 = np.full((T * LANE, sub), 255, dtype=np.uint8)  # bit7 = ghost
    l2[tile_of * LANE + ld, rd] = ssl.astype(np.uint8)
    pair_mask = np.zeros(T, dtype=np.int32)
    if sub // LANE > 30:
        # int32 mask capacity (one bit per OUTPUT slab here): emit the
        # all-dense sentinel instead of overflowing the shift — mirrors
        # the native builder's guard (graphcore.cc slab-mask path)
        pair_mask[:] = -1
    else:
        np.bitwise_or.at(
            pair_mask, tile_of, (1 << (rd // LANE)).astype(np.int32)
        )
    return _CPGLevel(l1=l1, l2=l2, s_ids=s_ids, d_ids=d_ids,
                     pair_mask=pair_mask)


def _level_ranges(d_ids: np.ndarray, n_chunks: int):
    """Per-dest-chunk [start, count) over the d-major-sorted tile list."""
    counts = np.bincount(d_ids, minlength=n_chunks).astype(np.int32)
    starts = np.zeros(n_chunks, dtype=np.int32)
    starts[1:] = np.cumsum(counts)[:-1]
    return starts, counts


def _run_ids(s_ids: np.ndarray, d_ids: np.ndarray) -> np.ndarray:
    """Run id per tile: consecutive tiles of the same (D, S) block (its
    tiers) form a run.  The streamed-x kernel DMAs each source chunk once
    per run instead of once per tile."""
    if s_ids.size == 0:
        return np.zeros(0, dtype=np.int32)
    new_run = np.ones(s_ids.size, dtype=np.int64)
    new_run[1:] = (s_ids[1:] != s_ids[:-1]) | (d_ids[1:] != d_ids[:-1])
    return (np.cumsum(new_run) - 1).astype(np.int32)


def save_cpg(cg: CPGGraph, path: str, **extra) -> None:
    """Persist a packed CPGGraph (packing is the expensive host step).
    ``extra`` fields (e.g. the pack's wall time) are stored beside it and
    ignored by ``load_cpg``."""
    data = dict(
        extra,
        n=cg.n, n_chunks=cg.n_chunks, nnz=cg.nnz, theta=cg.theta,
        sub=cg.sub, n_levels=len(cg.levels), new_of_old=cg.new_of_old,
        realmask=cg.realmask.cpu().numpy(), n_bcast=cg.n_bcast,
        layout=cg.layout,
    )
    for i, lv in enumerate(cg.levels):
        for k in ("l1", "l2", "s_ids", "d_ids", "run_ids", "starts",
                  "counts", "pair_mask"):
            data[f"lv{i}_{k}"] = lv[k].cpu().numpy()
    np.savez(path, **data)


# The TPU kernel's masked-dispatch economics (measured on v5e by the
# JAX package, kept so pair_mask equals the reference's): a taken
# in-kernel lax.cond costs ~52 cyc, a second-gather unit ~77 cyc.  The
# kernel dispatches on mask == FULL: the pack forces the mask of every
# tile whose occupancy is past the break-even to FULL so it runs the
# branch-free dense path, and only genuinely sparse tiles (deep tiers,
# reduce levels) pay per-unit branches where skipping actually wins.
_COND_CYC = 52.0
_UNIT_CYC = 77.0
_MASK_MAX_BITS = 30  # int32 mask capacity (sub >= 768 -> always dense)


def _mask_is_sparse(pm_real: np.ndarray, sub: int, layout: str) -> bool:
    """True iff any REAL tile keeps a non-FULL mask after densify — the
    TPU kernel's static per-level switch, kept as pack metadata."""
    n_slab = sub // LANE
    if n_slab == 1 or pm_real.size == 0:
        return False
    u2 = n_slab if layout == "slab" else n_slab * n_slab
    if u2 > _MASK_MAX_BITS:
        return False
    return bool((pm_real != (1 << u2) - 1).any())


def _densify_mask(pm: np.ndarray, sub: int, layout: str) -> np.ndarray:
    n_slab = sub // LANE
    if n_slab == 1:
        return pm
    if layout == "slab":
        # the slab kernel conds every output slab unconditionally (no
        # m == FULL branch-free dispatch), so densifying only turns
        # skipped all-ghost gathers into executed ones — keep raw masks
        return pm
    u2 = n_slab * n_slab
    if u2 > _MASK_MAX_BITS:
        return np.full_like(pm, -1)
    n_conds = n_slab  # outer per-j conds on the sparse path
    full = (1 << u2) - 1
    occ = np.zeros_like(pm)
    for i in range(u2):
        occ += (pm >> i) & 1
    thresh = (_UNIT_CYC * u2 - _COND_CYC * n_conds) / (_UNIT_CYC + _COND_CYC)
    return np.where(occ <= int(thresh), pm, full).astype(pm.dtype)


def mask_from_l1l2(l1: np.ndarray, l2: np.ndarray, sub: int,
                   layout: str = "classic") -> np.ndarray:
    """Recover per-tile slab-pair occupancy masks from the index tiles
    (for packs saved before pair_mask existed).

    Classic layout: a dest cell (ld, rd) is real iff the staging cell it
    selects is itself staged (l1 != ghost lane) — ghost cells point at a
    mex staging sublane whose l1 column entry is 127.  Slab layout: bit 7
    of l2 flags ghosts directly."""
    n_slab = sub // LANE
    if layout == "slab":
        T = l2.shape[0] // LANE
        if n_slab > _MASK_MAX_BITS:
            # int32 mask capacity: same all-dense sentinel the builders
            # and the classic recovery path use past 30 bits
            return np.full(T, -1, dtype=np.int32)
        mask = np.zeros(T, dtype=np.int32)
        real = l2 < LANE                       # (T*128, sub)
        j_any = real.reshape(T, LANE, n_slab, LANE).any(axis=(1, 3))
        mask |= (j_any << np.arange(n_slab)).sum(axis=1).astype(np.int32)
        return mask
    T = l2.shape[0] // LANE
    if n_slab * n_slab > _MASK_MAX_BITS:
        return np.full(T, -1, dtype=np.int32)
    mask = np.zeros(T, dtype=np.int32)
    u2 = n_slab * n_slab
    CH = 1024
    for t0 in range(0, T, CH):
        t1 = min(t0 + CH, T)
        tt = t1 - t0
        L2 = l2[t0 * LANE: t1 * LANE].astype(np.int32)
        L2 = L2.reshape(tt, LANE, sub)          # [t, ld, rd]
        L1 = l1[t0 * sub: t1 * sub].reshape(tt, sub, LANE)
        # staged lane of the staging cell each dest cell selects
        g = np.take_along_axis(L1.transpose(0, 2, 1), L2, axis=2)
        real = g != (LANE - 1)                  # (tt, LANE, sub)
        unit = (np.arange(sub, dtype=np.int32)[None, None, :] // LANE
                ) * n_slab + (L2 >> 7)
        tidx = np.broadcast_to(
            np.arange(tt, dtype=np.int32)[:, None, None], unit.shape)
        keys = tidx[real] * u2 + unit[real]
        occ = np.bincount(keys, minlength=tt * u2).reshape(tt, u2) > 0
        mask[t0:t1] = (occ << np.arange(u2)).sum(axis=1)
    return mask


def _to_device(arrays: dict, device) -> dict:
    # writable + contiguous: on the CPU the tensor shares the array
    return {k: torch.from_numpy(np.require(v, requirements="CW")).to(device)
            for k, v in arrays.items()}


def from_numpy(meta: dict, levels, realmask: np.ndarray,
               new_of_old: np.ndarray, device="cuda") -> CPGGraph:
    """Build a CPGGraph from host arrays, e.g. a JAX-package pack's
    (``np.asarray`` of each level array).  ``meta`` holds n, n_chunks,
    nnz, theta, sub, n_bcast, layout, t_reals and mask_sparse."""
    return CPGGraph(
        n=int(meta["n"]), n_chunks=int(meta["n_chunks"]),
        nnz=int(meta["nnz"]), theta=int(meta["theta"]),
        sub=int(meta["sub"]),
        levels=tuple(_to_device(lv, device) for lv in levels),
        realmask=torch.from_numpy(np.require(
            realmask, dtype=np.float32, requirements="CW")).to(device),
        new_of_old=np.asarray(new_of_old),
        n_bcast=int(meta.get("n_bcast", 0)),
        layout=str(meta.get("layout", "classic")),
        t_reals=tuple(int(t) for t in meta["t_reals"]),
        mask_sparse=tuple(bool(m) for m in meta["mask_sparse"]),
    )


def load_cpg(path: str, device="cuda") -> CPGGraph:
    """Read a pack written by either package's ``save_cpg``, with the
    reference's upgrades for packs saved by older packer versions."""
    z = np.load(path)
    sub = int(z["sub"]) if "sub" in z else 128
    layout = str(z["layout"]) if "layout" in z else "classic"
    rows = LANE if layout == "slab" else sub

    def level(i):
        lv = {k: np.asarray(z[f"lv{i}_{k}"])
              for k in ("l1", "l2", "s_ids", "d_ids", "starts", "counts")}
        key = f"lv{i}_run_ids"
        if key in z:
            lv["run_ids"] = np.asarray(z[key])
        else:  # packs saved before run caching existed
            lv["run_ids"] = _run_ids(lv["s_ids"], lv["d_ids"])
        key = f"lv{i}_pair_mask"
        if key in z:
            pm = np.asarray(z[key])
        elif sub == LANE:
            # the mask is never read at sub=128: skip the recovery pass
            pm = np.zeros_like(lv["s_ids"])
        else:  # packs saved before the masked second gather existed
            pm = mask_from_l1l2(lv["l1"], lv["l2"], sub, layout)
        lv["pair_mask"] = _densify_mask(pm, sub, layout)
        mask_sparse.append(_mask_is_sparse(
            lv["pair_mask"][: int(lv["counts"].sum())], sub, layout))
        # packs saved before the batched group DMA lack the >= GROUP_PAD
        # ghost-tile tail — extend, so arrays equal a fresh pack's
        tail = lv["s_ids"].shape[0] - int(lv["counts"].sum())
        if tail < GROUP_PAD:
            extra = GROUP_PAD - tail
            lv["l1"] = np.concatenate([
                lv["l1"],
                np.full((extra * rows, LANE), LANE - 1, dtype=lv["l1"].dtype),
            ])
            pad2 = (np.full((extra * LANE, sub), 255, np.uint8)
                    if layout == "slab"
                    else np.zeros((extra * LANE, sub), lv["l2"].dtype))
            lv["l2"] = np.concatenate([lv["l2"], pad2])
            for k in ("s_ids", "d_ids", "run_ids", "pair_mask"):
                lv[k] = np.concatenate(
                    [lv[k], np.zeros(extra, dtype=lv[k].dtype)]
                )
        return lv

    mask_sparse: list = []
    n_levels = int(z["n_levels"])
    levels = [level(i) for i in range(n_levels)]
    meta = dict(
        n=int(z["n"]), n_chunks=int(z["n_chunks"]), nnz=int(z["nnz"]),
        theta=int(z["theta"]), sub=sub, layout=layout,
        n_bcast=int(z["n_bcast"]) if "n_bcast" in z else 0,
        t_reals=[int(np.asarray(z[f"lv{i}_counts"]).sum())
                 for i in range(n_levels)],
        mask_sparse=mask_sparse,
    )
    return from_numpy(meta, levels, z["realmask"], z["new_of_old"], device)


def _group_deal(parent: np.ndarray, opp_chunk: np.ndarray,
                n_parts_of: np.ndarray) -> np.ndarray:
    """Block-aware dealing: within each (parent, opposite-chunk) group,
    deal entries round-robin over the parent's parts, staggered by a
    per-group offset.  Returns the part index per entry (0 = parent).

    Why: an entry whose dest row was split may ride ANY virtual row of
    that row (reduce levels sum them), and an entry whose source was
    split may ride ANY copy (all copies hold the same value).  Global
    within-row dealing is block-blind, so per-(S,D)-block load matrices
    keep Poisson tails that set the Konig tile count; per-group dealing
    flattens each block's load toward the mean (measured 2-3x fewer
    tiles on R-MAT/BA expanders, docs/DESIGN.md).

    Dispatches to the native radix-sort implementation (graphcore.cc
    gc_group_deal) when available — the dominant pack-time cost is this
    function's key sort; the numpy path below is the portable fallback
    and its correctness oracle (tests/test_cpg.py cross-checks)."""
    out = _native("group_deal", parent, opp_chunk, n_parts_of)
    return out if out is not None else _group_deal_np(
        parent, opp_chunk, n_parts_of)


def _group_deal_np(parent: np.ndarray, opp_chunk: np.ndarray,
                   n_parts_of: np.ndarray) -> np.ndarray:
    """Numpy reference implementation of block-aware dealing."""
    key = parent.astype(np.int64) * (1 << 24) + opp_chunk
    srt = np.argsort(key, kind="stable")
    ks = key[srt]
    newg = np.ones(ks.size, dtype=bool)
    newg[1:] = ks[1:] != ks[:-1]
    gid = np.cumsum(newg) - 1
    gstart = np.zeros(int(gid[-1]) + 1 if ks.size else 1, dtype=np.int64)
    gstart[gid[newg]] = np.nonzero(newg)[0]
    within = np.arange(ks.size) - gstart[gid]
    npart = n_parts_of[parent[srt]]
    part_sorted = (within + gid) % np.maximum(npart, 1)
    part = np.empty(ks.size, dtype=np.int64)
    part[srt] = part_sorted
    return part


def _split_counts(deg: np.ndarray, cap: int) -> np.ndarray:
    # every unit has >= 1 part (a degree-0 unit previously got 0, which
    # any parts-consumer dividing/modding would trip over)
    return np.maximum((deg + cap - 1) // cap, 1)


def pack_cpg(
    graph: CSRGraph,
    theta: int | None = None,
    seed: int = 0,
    sub: int | None = None,
    order: str = "auto",
    theta_s: int | str | None = "auto",
    redeal: bool | None = None,
    layout: str = "auto",
    device="cuda",
) -> CPGGraph:
    """Pack a host CSR graph into the CPG format, its index tensors on
    ``device``.  The host work is the reference's packer unchanged.

    ``sub`` (chunk height in sublanes, multiple of 128) trades per-tile
    gather/select work against block density; auto: 256 for graphs with
    >= a few hundred K rows, else 128.

    ``order`` picks the vertex arrangement:
    - "locality": keep the input order (mesh/road graphs whose natural
      ordering is spatial -> entries concentrate in near-diagonal chunk
      pairs, which is what sets tile count);
    - "degree": degree-sorted strided dealing (power-law graphs -> fair
      degree mix per lane/column, bounded tier maxima);
    - "auto": by degree coefficient-of-variation (the load-balancing
      dichotomy the reference handled with get_blockrows vs
      dynamic-parallelism kernels, cu_SPMV.cu:121-251).

    ``theta_s`` caps the per-(source, tile) load by splitting heavy
    SOURCE units into copies fed by a leading broadcast level (the dual
    of the ``theta`` dest-row split).  "auto": equal to ``theta`` for
    power-law ("degree") graphs, off for meshes.  ``redeal`` switches
    the entry dealing from global round-robin to block-aware
    (_group_deal); "auto" (None) follows the same dichotomy.
    """
    # NOTE: like the reference, the library flips no process-global
    # allocator setting (mallopt) for big packs' temporaries.
    n = graph.n
    del seed  # orderings are deterministic; kept for API stability
    if sub is None:
        sub = 256 if n >= 200_000 else LANE
    if sub % LANE:
        raise ValueError(f"sub must be a multiple of {LANE}, got {sub}")
    degrees0 = graph.degrees
    if order == "auto":
        d_mean0 = degrees0.mean() if n else 1.0
        cv = float(degrees0.std() / max(d_mean0, 1e-9))
        order = "locality" if cv < 0.5 else "degree"
    if theta is None:
        # Row-split cap.  Splitting finer than the ambient per-block
        # collision tail buys nothing and pays block-opening floors, so
        # theta tracks the degree distribution's tail, not its mean:
        # theta* ~ 1.5 * p99(degree), floored by the round-1 mean-based
        # formula (which meshes/uniform graphs stay under — their packs
        # are unchanged) and capped at 360 (unsplit hubs make per-block
        # dest-cell maxima explode: theta=900+ on the extreme-skew R-MAT
        # 540k blew tiles/RAM up).  Measured optima (real packs):
        # bn1M 150 (p99=104), rmat-4M 300 (p99=184), ba-4M 200-300
        # (p99=94), rmat-540k 300+ (p99=1162); the old cap of 120 cost
        # 9-40% extra tiles.
        d_mean = max(graph.nnz / max(n, 1), 1.0)
        floor = max(2 * d_mean + 8 * np.sqrt(d_mean), 16)
        p99 = float(np.percentile(degrees0, 99)) if n else 0.0
        theta = int(min(max(floor, 1.5 * p99), 360))
    if theta_s == "auto":
        theta_s = theta if order == "degree" else None
    if redeal is None:
        redeal = order == "degree"

    if layout == "auto":
        # classic, as in the reference (cpg.py pins auto to classic)
        layout = "classic"
    if layout not in ("classic", "slab"):
        raise ValueError(f"layout must be auto, classic or slab, "
                         f"got {layout!r}")

    rows = graph.row_ids().astype(np.int64)
    cols = graph.indices.astype(np.int64)

    if theta_s is None and not redeal:
        return _pack_legacy(graph, rows, cols, n, theta, sub, order, layout,
                            device)
    return _pack_split(graph, rows, cols, n, theta, int(theta_s or 0),
                       sub, order, redeal, layout, device)


def _pack_legacy(graph, rows, cols, n, theta, sub, order, layout,
                 device) -> CPGGraph:
    """Original pack path: dest-only split, global dealing (meshes)."""
    unit, n_units, parents0 = _split_rows(rows, cols, n, theta)

    # reduce tree (same scheme as CST)
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

    # ---- permutation, then packing skipping lane 127
    deg = np.bincount(unit, minlength=n_units)
    for s_arr, d_arr in reduce_edges:
        deg += np.bincount(d_arr, minlength=n_units)
    if order == "locality":
        # natural order: unit ids ascend (virtuals trail their creation
        # order, which is row-sorted too) -> spatial locality preserved
        rank = np.arange(n_units, dtype=np.int64)
    else:
        # degree-sorted strided dealing mixes degrees across lanes/columns
        srt = np.argsort(-deg, kind="stable")
        rank = np.empty(n_units, dtype=np.int64)
        rank[srt] = np.arange(n_units)
    pos_of = _pos_of_unit(rank, sub)

    build = _build_cpg_level_slab if layout == "slab" else _build_cpg_level
    levels = []
    levels.append(build(pos_of[cols], pos_of[unit], sub))
    for s_arr, d_arr in reduce_edges:
        levels.append(build(pos_of[s_arr], pos_of[d_arr], sub))
    return _finalize(graph, n, n_units, theta, sub, pos_of, levels,
                     n_bcast=0, layout=layout, device=device)


def _pack_split(graph, rows, cols, n, theta, theta_s, sub, order,
                redeal, layout, device) -> CPGGraph:
    """Source-split + (optionally) block-aware-redeal pack path.

    Unit id space layout: [0, n) real rows, then dest virtual rows
    (row-major), then source copies (col-major), then deeper reduce-tree
    virtuals at the tail."""
    ddeg = np.bincount(rows, minlength=n)
    d_parts = _split_counts(ddeg, theta)
    d_extra = np.maximum(d_parts - 1, 0)
    d_base = np.zeros(n, dtype=np.int64)
    d_base[1:] = np.cumsum(d_extra)[:-1]
    d_base += n
    n_units = n + int(d_extra.sum())
    n_units_d = n_units

    sdeg = np.bincount(cols, minlength=n)
    if theta_s:
        s_parts = _split_counts(sdeg, theta_s)
    else:
        s_parts = np.ones(n, dtype=np.int64)
    s_extra = np.maximum(s_parts - 1, 0)
    s_base = np.zeros(n, dtype=np.int64)
    s_base[1:] = np.cumsum(s_extra)[:-1]
    s_base += n_units
    n_copies = int(s_extra.sum())
    n_units += n_copies
    # broadcast edges parent -> copy (copies allocated contiguously)
    bc_src = np.repeat(np.arange(n), s_extra)
    bc_dst = n_units_d + np.arange(n_copies)

    # reduce tree over the dest virtuals (deep rows recurse).  Only the
    # STRUCTURE (parents, part counts, virtual ids) is fixed here; WHICH
    # part a child reports to is dealt later against actual positions —
    # consecutive assignment let hub parents stack up to theta same-cell
    # entries per (child-chunk, parent-chunk) block, making the reduce
    # level tier-bound (rmat-540k: 1105 of 2684 tiles in round 2).
    reduce_rounds = []
    cur_src = n + np.arange(n_units_d - n)
    cur_dst = np.repeat(np.arange(n), d_extra)
    while cur_src.size:
        rsort = np.argsort(cur_dst, kind="stable")
        pa, ch = cur_dst[rsort], cur_src[rsort]
        uniq, counts = np.unique(pa, return_counts=True)
        parts = (counts + theta - 1) // theta
        extra = parts - 1
        base = np.zeros(uniq.size, dtype=np.int64)
        base[1:] = np.cumsum(extra)[:-1]
        base += n_units
        n_new = int(extra.sum())
        reduce_rounds.append((ch, pa, uniq, parts, base))
        n_units += n_new
        cur_src = np.arange(n_units - n_new, n_units)
        cur_dst = np.repeat(uniq, extra)

    # ---- ordering (capped-degree estimates; scanner-validated)
    deg_u = np.full(n_units, theta, dtype=np.int64)  # virtuals ~ theta
    deg_u[:n] = (np.minimum(ddeg, theta)
                 + (np.minimum(sdeg, theta_s) if theta_s else 0)
                 + d_extra + s_extra)
    if n_copies:
        deg_u[n_units_d:n_units_d + n_copies] = theta_s
    if order == "locality":
        rank = np.arange(n_units, dtype=np.int64)
    else:  # "degree"
        srt = np.argsort(-deg_u, kind="stable")
        rank = np.empty(n_units, dtype=np.int64)
        rank[srt] = np.arange(n_units)
    pos_of = _pos_of_unit(rank, sub)

    # ---- dest dealing (which part of its split row an entry rides)
    if redeal:
        s_chunk_of_entry = pos_of[cols] // (sub * LANE)
        dpart = _group_deal(rows, s_chunk_of_entry, d_parts)
    else:
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(ddeg, out=starts[1:])
        dpart = (np.arange(rows.size) - starts[rows]) // theta
    dunit = np.where(dpart == 0, rows, d_base[rows] + dpart - 1)

    # ---- source dealing (which copy an entry reads)
    if theta_s:
        d_chunk_of_entry = pos_of[dunit] // (sub * LANE)
        if redeal:
            spart = _group_deal(cols, d_chunk_of_entry, s_parts)
        else:
            csort = np.argsort(cols, kind="stable")
            sstarts = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(sdeg, out=sstarts[1:])
            within = np.empty(cols.size, dtype=np.int64)
            within[csort] = np.arange(cols.size) - sstarts[cols[csort]]
            spart = within % np.maximum(s_parts[cols], 1)
        sunit = np.where(spart == 0, cols, s_base[cols] + spart - 1)
    else:
        sunit = cols

    # ---- reduce-tree dealing (which part a child folds into)
    reduce_edges = []
    for ch, pa, uniq, parts, base in reduce_rounds:
        parts_of = np.zeros(n_units, dtype=np.int64)
        parts_of[uniq] = parts
        base_of = np.zeros(n_units, dtype=np.int64)
        base_of[uniq] = base
        if redeal:
            ch_chunk = pos_of[ch] // (sub * LANE)
            rpart = _group_deal(pa, ch_chunk, parts_of)
        else:
            # consecutive within each parent's (sorted) child run
            newp = np.ones(pa.size, dtype=bool)
            newp[1:] = pa[1:] != pa[:-1]
            gstart = np.zeros(pa.size, dtype=np.int64)
            gstart[newp] = np.nonzero(newp)[0]
            gstart = np.maximum.accumulate(gstart)
            rpart = (np.arange(pa.size) - gstart) // theta
        rdst = np.where(rpart == 0, pa, base_of[pa] + rpart - 1)
        reduce_edges.append((ch, rdst))

    build = _build_cpg_level_slab if layout == "slab" else _build_cpg_level
    levels = []
    n_bcast = 0
    if n_copies:
        levels.append(build(pos_of[bc_src], pos_of[bc_dst], sub))
        n_bcast = 1
    levels.append(build(pos_of[sunit], pos_of[dunit], sub))
    for s_arr, d_arr in reduce_edges:
        levels.append(build(pos_of[s_arr], pos_of[d_arr], sub))
    return _finalize(graph, n, n_units, theta, sub, pos_of, levels,
                     n_bcast=n_bcast, layout=layout, device=device)


def _finalize(graph, n, n_units, theta, sub, pos_of, levels,
              n_bcast, layout, device) -> CPGGraph:
    """Shared tail: chunk bucketing, realmask, padding, device tensors."""
    n_chunks = max(int(np.ceil(n_units / (sub * REAL_LANES))), 1)
    # bucket the chunk count as the reference does (it was part of the
    # TPU kernel's compile key); extra chunks have zero tiles
    n_chunks = _round_up(
        n_chunks, max(8, 1 << max((n_chunks - 1).bit_length() - 2, 0))
    )
    new_of_old = pos_of[:n]
    n_pad = n_chunks * sub * LANE
    realmask = np.zeros(n_pad, dtype=np.float32)
    realmask[new_of_old] = 1.0

    dev_levels = []
    mask_sparse = []
    for lv in levels:
        starts, counts = _level_ranges(lv.d_ids, n_chunks)
        run_ids_real = _run_ids(lv.s_ids, lv.d_ids)
        # pad the tile arrays to the reference's coarse buckets (ghost
        # tiles lie outside every chunk's [start, start+count) range)
        T = lv.s_ids.shape[0]
        T_pad = _round_up(
            max(T, 1) + GROUP_PAD,
            max(256, 1 << max((max(T, 1) - 1).bit_length() - 2, 0)),
        )
        rows = LANE if layout == "slab" else sub
        l1 = np.full((T_pad * rows, LANE), LANE - 1, dtype=np.int8)
        l1[: T * rows] = lv.l1
        if layout == "slab":
            l2 = np.full((T_pad * LANE, sub), 255, dtype=np.uint8)
        else:
            l2 = np.zeros((T_pad * LANE, sub), dtype=_l2_dtype(sub))
        l2[: T * LANE] = lv.l2
        ids_pad = np.zeros(T_pad, dtype=np.int32)
        s_ids = ids_pad.copy()
        s_ids[:T] = lv.s_ids
        d_ids = ids_pad.copy()
        d_ids[:T] = lv.d_ids
        run_ids = ids_pad.copy()
        run_ids[:T] = run_ids_real
        pm_dens = _densify_mask(lv.pair_mask, sub, layout)
        mask_sparse.append(_mask_is_sparse(pm_dens, sub, layout))
        pair_mask = ids_pad.copy()
        pair_mask[:T] = pm_dens
        dev_levels.append(_to_device(dict(
            l1=l1, l2=l2, s_ids=s_ids, d_ids=d_ids, run_ids=run_ids,
            pair_mask=pair_mask, starts=starts, counts=counts,
        ), device))
    return CPGGraph(
        n=n, n_chunks=n_chunks, nnz=graph.nnz, theta=theta, sub=sub,
        levels=tuple(dev_levels),
        realmask=torch.from_numpy(realmask).to(device),
        new_of_old=new_of_old, n_bcast=n_bcast, layout=layout,
        t_reals=tuple(lv.s_ids.shape[0] for lv in levels),
        mask_sparse=tuple(mask_sparse),
    )
