"""CST — class-staged two-phase format, packed on the host for the CUDA
SpMV (kernels/spmv_cst.py, csrc/spmv_cst.cu).

The port of ``tpu_lanczos/kernels/cst.py``.  The host packer (row
splitting, reduce tree, degree-mixing permutation, greedy slot
colouring, level builder) is the reference's numpy code unchanged, so a
pack made here equals the JAX package's array for array; only the device
half differs: ``CSTGraph`` is a plain dataclass of torch tensors on an
explicit ``device``.

The format, in the reference's words: vectors live in a (128, n_cols)
"classT" layout (position p at class p // n_cols, column p % n_cols, a
plain reshape of the flat vector), and y = A x is a sum over SLOTS, each
one lane-gather and one sublane-gather:

  G[c, j]    = src[c, IDX1[s, c, j]]            stage by source column
  acc[l, j] += G[IDX3[s, l, j], j]              deliver to the dest class

Per slot a staging cell and a dest cell hold at most one entry.  Rows
above ``theta`` are split into virtual rows that reduce levels fold back
(each level's source is the accumulator itself).  Ghost cells gather an
all-zero column, so the kernel has no masks; ``realmask`` zeroes the
virtual and ghost cells afterwards.

The reference's docstring expects the level-0 slot count near 2x the
mean degree; at bench.py's graph (BA n=1M, m=10, seed 0, native
generator) it is 131 slots, 6.55x the mean degree of 20.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_lanczos_torch.graphs.csr import CSRGraph

CLASSES = 128
# idx1 goes to the device as int16 up to this many columns (its values,
# column indices, are below n_cols), as int32 above; idx3 (classes) as
# uint8, its rows padded to a multiple of IDX3_ROW_ALIGN bytes (a TMA row
# starts 16-byte aligned)
IDX1_INT16_MAX_COLS = 32767
IDX3_ROW_ALIGN = 16


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class _Level:
    """One delivery level: slots of (IDX1 lane-gather, IDX3 sublane-gather).

    idx1: (slots, 128, n_cols) int32 — source column per staging cell
          (ghost -> the zero column)
    idx3: (slots, 128, n_cols) int32 — staging class per dest cell
          (ghost -> a staging cell that is ghost in the same slot)
    """

    idx1: np.ndarray
    idx3: np.ndarray

    @property
    def slots(self) -> int:
        return self.idx1.shape[0]


@dataclasses.dataclass(frozen=True)
class CSTGraph:
    """A packed graph: host metadata plus per-level index tensors on
    ``device``.  Level 0 delivers A's entries into unit cells (real rows
    and virtual row parts); levels 1.. fold virtual partial sums into
    their parents.  ``idx1[i]`` and ``idx3[i]`` are level i's (slots,
    128, n_cols) tensors, the reference's int32 values narrowed: idx1
    int16 (int32 past ``IDX1_INT16_MAX_COLS`` columns), contiguous; idx3
    uint8, a column slice of rows padded to ``IDX3_ROW_ALIGN`` bytes;
    ``realmask`` is (128, n_cols) float32 {0, 1}."""

    n: int
    n_cols: int             # columns of the classT layout (incl. zero col)
    nnz: int
    theta: int
    idx1: tuple             # tuple of (slots_i, 128, n_cols) int16/int32
    idx3: tuple             # ... uint8
    realmask: torch.Tensor  # (128, n_cols) f32 {0,1}
    new_of_old: np.ndarray  # (n,) vertex -> position (l * n_cols + j)

    @property
    def device(self) -> torch.device:
        return self.realmask.device

    @property
    def n_pad(self) -> int:
        return CLASSES * self.n_cols

    @property
    def total_slots(self) -> int:
        return sum(int(a.shape[0]) for a in self.idx1)

    @property
    def fill(self) -> float:
        """Real entries per processed cell (both gathers counted as one)."""
        return self.nnz / float(self.total_slots * self.n_pad)

    def index_bytes(self) -> int:
        """Bytes of idx1 + idx3 (without idx3's row padding): what one
        SpMV must read at least once."""
        return sum(a.numel() * a.element_size() for a in self.idx1 + self.idx3)

    # ------------------------------------------------------------ vectors

    def permute_in(self, x: np.ndarray, dtype) -> np.ndarray:
        out = np.zeros(self.n_pad, dtype=dtype)
        out[self.new_of_old] = x
        return out

    def permute_out(self, y) -> np.ndarray:
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        return np.asarray(y).reshape(-1)[self.new_of_old]


def _greedy_slots(a_key: np.ndarray, b_key: np.ndarray) -> np.ndarray:
    """Assign each entry a slot such that within a slot both ``a_key`` and
    ``b_key`` are unique.  Greedy bipartite edge coloring: slot(e) is the
    smallest s free on both endpoints.  Returns (E,) slot ids.

    Vectorized round-based greedy: each round selects entries that are the
    first remaining for BOTH keys, assigns them the round number.
    """
    E = a_key.size
    slot = np.full(E, -1, dtype=np.int32)
    remaining = np.arange(E)
    s = 0
    while remaining.size:
        a = a_key[remaining]
        b = b_key[remaining]
        # first occurrence per a-key among remaining
        oa = np.argsort(a, kind="stable")
        first_a = np.zeros(remaining.size, dtype=bool)
        sa = a[oa]
        head = np.ones(sa.size, dtype=bool)
        head[1:] = sa[1:] != sa[:-1]
        first_a[oa[head]] = True
        # among those, first per b-key
        cand = np.where(first_a)[0]
        bc = b[cand]
        ob = np.argsort(bc, kind="stable")
        sb = bc[ob]
        headb = np.ones(sb.size, dtype=bool)
        headb[1:] = sb[1:] != sb[:-1]
        chosen = cand[ob[headb]]
        slot[remaining[chosen]] = s
        keep = np.ones(remaining.size, dtype=bool)
        keep[chosen] = False
        remaining = remaining[keep]
        s += 1
    return slot


def _split_rows(rows: np.ndarray, cols: np.ndarray, n_units0: int, theta: int):
    """Split units with degree > theta into virtual units.

    Returns (unit_of_entry, n_units, parents) where ``parents`` maps each
    NEW virtual unit id -> its parent unit id (reduce edges, one level).
    Entries must be sorted by ``rows``.  Dispatches to the native scan
    (graphcore.cc gc_split_rows, identical id assignment) when available.
    """
    try:
        from tpu_lanczos_torch.graphs import native

        if native.available():
            return native.split_rows(rows, n_units0, theta)
    except Exception:
        pass
    deg = np.bincount(rows, minlength=n_units0)
    starts = np.zeros(n_units0 + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    within = np.arange(rows.size) - starts[rows]
    part = within // theta  # 0 = stays with parent
    n_parts = np.maximum(deg + theta - 1, 1) // theta  # parts per unit
    extra = np.maximum(n_parts - 1, 0)
    virt_base = np.zeros(n_units0, dtype=np.int64)
    virt_base[1:] = np.cumsum(extra)[:-1]
    virt_base += n_units0
    unit = np.where(part == 0, rows, virt_base[rows] + part - 1)
    n_units = n_units0 + int(extra.sum())
    parents = np.repeat(np.arange(n_units0), extra)  # virt id -> parent
    return unit.astype(np.int64), n_units, parents


def _build_level(
    src_pos: np.ndarray,   # (E,) source position (class*n_cols + col)
    dst_pos: np.ndarray,   # (E,) dest position
    n_cols: int,
    rng: np.random.Generator,
):
    """Build one delivery level's idx1/idx3 from entry endpoint positions."""
    ls = (src_pos // n_cols).astype(np.int64)
    cj = (src_pos % n_cols).astype(np.int64)
    lr = (dst_pos // n_cols).astype(np.int64)
    jd = (dst_pos % n_cols).astype(np.int64)

    a_key = ls * n_cols + jd   # staging cell
    b_key = dst_pos            # dest cell
    slot = _greedy_slots(a_key, b_key)
    n_slots = int(slot.max()) + 1 if slot.size else 1

    zero_col = n_cols - 1
    idx1 = np.full((n_slots, CLASSES, n_cols), zero_col, dtype=np.int32)
    idx1[slot, ls, jd] = cj
    idx3 = np.full((n_slots, CLASSES, n_cols), -1, dtype=np.int32)
    idx3[slot, lr, jd] = ls
    # ghost dest cells: point at a staging class that is ghost in the same
    # (slot, column) — i.e. one whose idx1 is the zero column.  At least
    # one exists unless all 128 are staged, in which case all 128 dest
    # cells are real too (counting argument) and no ghost is needed.
    for s in range(n_slots):
        ghost_mask = idx1[s] == zero_col          # (128, n_cols) free staging
        # first free class per column (argmax of mask; columns with none
        # are fully-staged => fully-delivered => unused)
        free_class = np.argmax(ghost_mask, axis=0)  # (n_cols,)
        need = idx3[s] < 0
        idx3[s][need] = np.broadcast_to(free_class, (CLASSES, n_cols))[need]
    return _Level(idx1=idx1, idx3=idx3)


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    # writable + contiguous: on the CPU the tensor shares the array
    return torch.from_numpy(np.require(a, dtype=dtype,
                                       requirements="CW")).to(device)


def _narrowed(arrays, hi: int, dtype, name: str):
    """The level arrays as ``dtype``, after checking that every value lies
    in [0, hi)."""
    for i, a in enumerate(arrays):
        a = np.asarray(a)
        if a.size and (int(a.min()) < 0 or int(a.max()) >= hi):
            raise ValueError(f"{name}[{i}] holds values outside [0, {hi}): "
                             f"{int(a.min())}..{int(a.max())}")
    return [np.asarray(a).astype(dtype, copy=False) for a in arrays]


def _padded_rows(a: np.ndarray, device) -> torch.Tensor:
    """``a`` (slots, 128, n_cols) on ``device`` as the column slice of a
    copy whose rows are padded with zeros to IDX3_ROW_ALIGN bytes."""
    n_cols = a.shape[2]
    pitch = _round_up(n_cols, IDX3_ROW_ALIGN)
    if pitch == n_cols:
        return _tensor(a, device)
    padded = np.zeros(a.shape[:2] + (pitch,), dtype=a.dtype)
    padded[..., :n_cols] = a
    return _tensor(padded, device)[..., :n_cols]


def from_numpy(meta: dict, idx1, idx3, realmask: np.ndarray,
               new_of_old: np.ndarray, device="cuda") -> CSTGraph:
    """Build a CSTGraph from host arrays, e.g. a JAX-package pack's
    (``np.asarray`` of each level array).  ``meta`` holds n, n_cols, nnz
    and theta.  The one place a pack reaches its device: idx1 is stored
    as int16 up to ``IDX1_INT16_MAX_COLS`` columns (int32 above) and idx3
    as uint8 with rows padded to ``IDX3_ROW_ALIGN`` bytes, after a check
    that the values fit."""
    n_cols = int(meta["n_cols"])
    i1_type = np.int16 if n_cols <= IDX1_INT16_MAX_COLS else np.int32
    return CSTGraph(
        n=int(meta["n"]), n_cols=n_cols, nnz=int(meta["nnz"]),
        theta=int(meta["theta"]),
        idx1=tuple(_tensor(a, device) for a in _narrowed(
            idx1, n_cols, i1_type, "idx1")),
        idx3=tuple(_padded_rows(a, device) for a in _narrowed(
            idx3, CLASSES, np.uint8, "idx3")),
        realmask=_tensor(realmask, device, np.float32),
        new_of_old=np.asarray(new_of_old),
    )


def pack_cst(graph: CSRGraph, theta: int | None = None, seed: int = 0,
             device="cuda") -> CSTGraph:
    """Pack a host CSR graph into the CST format, index tensors on
    ``device``.  The host work is the reference's packer unchanged."""
    n = graph.n
    rng = np.random.default_rng(seed)
    if theta is None:
        d_mean = max(graph.nnz / max(n, 1), 1.0)
        theta = int(min(max(2 * d_mean + 8 * np.sqrt(d_mean), 16), 128))

    rows = graph.row_ids().astype(np.int64)
    cols = graph.indices.astype(np.int64)

    # ---- level-0 row splitting (dest side only; sources stay original)
    unit, n_units, parents0 = _split_rows(rows, cols, n, theta)

    # ---- reduce tree: fold virtuals into parents, splitting reduce rows
    # that themselves exceed theta
    reduce_edges = []  # list of (src_unit, dst_unit) arrays per level
    cur_src = np.arange(n, n_units)   # virtual units to fold
    cur_dst = parents0
    while cur_src.size:
        rsort = np.argsort(cur_dst, kind="stable")
        r_rows, r_cols = cur_dst[rsort], cur_src[rsort]
        # reindex rows to compact ids for splitting bookkeeping
        uniq, inv = np.unique(r_rows, return_inverse=True)
        unit2, n_units2, parents2 = _split_rows(inv, r_cols, uniq.size, theta)
        # map back: compact unit < uniq.size -> original unit id; virtual
        # compact units -> NEW global unit ids
        n_new_virt = n_units2 - uniq.size
        new_ids = np.arange(n_units, n_units + n_new_virt)
        unit_map = np.concatenate([uniq, new_ids])
        reduce_edges.append((r_cols, unit_map[unit2]))
        n_units += n_new_virt
        cur_src = new_ids
        cur_dst = uniq[parents2]

    # ---- degree-mixing permutation over the (class, column) grid
    # local degree of every unit (level-0 entries + reduce in-edges)
    deg = np.bincount(unit, minlength=n_units)
    for s_arr, d_arr in reduce_edges:
        deg += np.bincount(d_arr, minlength=n_units)
    order = np.argsort(-deg, kind="stable")
    n_cols = _round_up(int(np.ceil(n_units / CLASSES)) + 1, 8)
    # class = strided deal (rank % 128) -> fair degree mix per class;
    # column = per-class shuffle of the class's rank sequence -> fair mix
    pos_of_unit = np.empty(n_units, dtype=np.int64)
    rank = np.empty(n_units, dtype=np.int64)
    rank[order] = np.arange(n_units)
    cls = rank % CLASSES
    within = rank // CLASSES
    for l in range(CLASSES):
        sel = cls == l
        m = int(sel.sum())
        shuf = rng.permutation(n_cols - 1)[:m] if m <= n_cols - 1 else None
        if shuf is None:
            raise ValueError("n_cols too small")
        w = within[sel]
        colmap = np.empty(m, dtype=np.int64)
        colmap[np.argsort(w, kind="stable")] = shuf[:m]
        pos_of_unit[sel] = l * n_cols + colmap
    new_of_old = pos_of_unit[:n]  # real vertices

    # ---- build levels
    levels = []
    src_pos0 = pos_of_unit[cols]    # sources are original vertices = units
    dst_pos0 = pos_of_unit[unit]
    levels.append(_build_level(src_pos0, dst_pos0, n_cols, rng))
    for s_arr, d_arr in reduce_edges:
        levels.append(
            _build_level(pos_of_unit[s_arr], pos_of_unit[d_arr], n_cols, rng)
        )

    realmask = np.zeros((CLASSES, n_cols), dtype=np.float32)
    rl = new_of_old // n_cols
    rj = new_of_old % n_cols
    realmask[rl, rj] = 1.0

    meta = dict(n=n, n_cols=n_cols, nnz=graph.nnz, theta=theta)
    return from_numpy(meta, [lv.idx1 for lv in levels],
                      [lv.idx3 for lv in levels], realmask, new_of_old,
                      device)
