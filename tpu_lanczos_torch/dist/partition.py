"""nnz-balanced row partitioning and the sharded ELL/COO pack.

The port of ``tpu_lanczos/dist/partition.py``; its host numpy is the
reference's, so the arrays equal the reference's array for array:

- ``balanced_permutation``: a degree-aware vertex relabeling that deals
  rows (sorted by degree, snake order) across shards, so every shard
  gets the same row count AND nearly the same nnz, hubs included (the
  reference CUDA code split rows at a hand-tuned ``load_balance``
  fraction, parallel-two-cards/lib/cu_lanczos.cu:62-67);
- ``pack_sharded``: the permuted graph as per-shard slot-major ELL plus a
  per-shard COO spill for rows beyond the ELL width, with identical
  shapes on every shard.

The permutation is a similarity transform P A P^T, so the pipeline is
unchanged: x is permuted in and the answer permuted out.  Where the
reference places the arrays with a ``NamedSharding`` over the mesh, the
port keeps each held shard's slice on that shard's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.kernels.formats import _pack_ell_np, _round_up
from tpu_lanczos_torch.dist.mesh import Mesh, make_mesh


def balanced_permutation(
    graph: CSRGraph, n_shards: int, n_loc: int | None = None
) -> np.ndarray:
    """Returns ``new_of_old`` (n,): vertex i is relabeled new_of_old[i],
    a position in [0, n_shards * n_loc); shard d owns positions
    [d*n_loc, (d+1)*n_loc), trailing positions in each shard are ghosts.

    Rows sorted by degree descending are dealt into shards in snake order
    (0..D-1, D-1..0, ...), so each shard receives the same number of rows
    (+-1) and a near-equal share of nnz.  Within a shard, dealt order is
    kept (heaviest rows first)."""
    n = graph.n
    order = np.argsort(-graph.degrees, kind="stable")  # heavy rows first
    pos = np.arange(n)
    rnd, off = pos // n_shards, pos % n_shards
    shard_of_pos = np.where(rnd % 2 == 0, off, n_shards - 1 - off)
    shard_sizes = np.bincount(shard_of_pos, minlength=n_shards)
    if n_loc is None:
        n_loc = int(shard_sizes.max())
    if int(shard_sizes.max()) > n_loc:
        raise ValueError(f"n_loc={n_loc} < largest bucket {shard_sizes.max()}")
    # stable sort by shard: concatenated buckets in dealt order
    bucket_order = np.argsort(shard_of_pos, kind="stable")
    starts = np.zeros(n_shards, dtype=np.int64)
    starts[1:] = np.cumsum(shard_sizes)[:-1]
    sorted_shards = shard_of_pos[bucket_order]
    within = np.arange(n) - starts[sorted_shards]
    new_pos_padded = sorted_shards * n_loc + within
    new_of_old = np.empty(n, dtype=np.int64)
    new_of_old[order[bucket_order]] = new_pos_padded
    return new_of_old


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Row-sharded ELL/COO graph over a 1-D mesh of ``n_shards`` shards.

    All column ids are in the *permuted* labeling; vectors live at length
    ``n_pad = n_shards * n_loc`` in permuted order.  Each tensor field is
    a tuple with one entry per shard this process holds (``shards``), on
    that shard's device: the reference's arrays, sliced by shard.
    ``coo_offsets`` (the port's own) holds each local row's first spill
    entry (pad bucket last) for the sorted segment sum."""

    n_shards: int
    n: int        # true vertex count
    n_pad: int    # n_shards * n_loc
    n_loc: int    # rows per shard
    nnz: int
    shards: tuple
    ell_indices: tuple   # per shard (w, n_loc) int32, global col ids
    ell_degrees: tuple   # per shard (n_loc,) int32
    coo_rows: tuple      # per shard (spill_pad,) int32, LOCAL rows (pad n_loc)
    coo_cols: tuple      # per shard (spill_pad,) int32, global col ids
    coo_offsets: tuple   # per shard (n_loc + 2,) int64
    new_of_old: np.ndarray  # (n,)

    @property
    def ell_width(self) -> int:
        return int(self.ell_indices[0].shape[0])

    def permute_in(self, x: np.ndarray, dtype) -> np.ndarray:
        """Host: (n,) vector -> (n_pad,) permuted, ghost rows zero."""
        out = np.zeros(self.n_pad, dtype=dtype)
        out[self.new_of_old] = x
        return out

    def permute_out(self, y: np.ndarray) -> np.ndarray:
        """Host: (n_pad,) permuted result -> (n,) original ordering."""
        return np.asarray(y)[self.new_of_old]

    @classmethod
    def from_numpy(cls, meta: dict, ell_indices, ell_degrees, coo_rows,
                   coo_cols, new_of_old, mesh: Mesh) -> "ShardedGraph":
        """The port's pack of a pack's global host arrays (the reference's
        ``ShardedGraph`` fields as numpy: ell (w, n_pad), degrees (n_pad,),
        coo (n_shards, spill_pad)) on ``mesh``.  ``meta`` holds n_shards,
        n, n_pad, n_loc and nnz."""
        n_loc = int(meta["n_loc"])
        if mesh.n_shards != int(meta["n_shards"]):
            raise ValueError(f"pack of {meta['n_shards']} shards on a mesh "
                             f"of {mesh.n_shards}")

        def put(a, dev):
            # writable + contiguous: on the CPU the tensor shares the array
            return torch.from_numpy(np.require(a, requirements="CW")).to(dev)

        rows = np.asarray(coo_rows)
        fields = dict(ell_indices=[], ell_degrees=[], coo_rows=[],
                      coo_cols=[], coo_offsets=[])
        for s, dev in zip(mesh.shards, mesh.devices):
            cols = slice(s * n_loc, (s + 1) * n_loc)
            fields["ell_indices"].append(put(np.asarray(ell_indices)[:, cols],
                                             dev))
            fields["ell_degrees"].append(put(np.asarray(ell_degrees)[cols],
                                             dev))
            fields["coo_rows"].append(put(rows[s], dev))
            fields["coo_cols"].append(put(np.asarray(coo_cols)[s], dev))
            offsets = np.searchsorted(rows[s], np.arange(n_loc + 2))
            fields["coo_offsets"].append(put(offsets.astype(np.int64), dev))
        return cls(n_shards=int(meta["n_shards"]), n=int(meta["n"]),
                   n_pad=int(meta["n_pad"]), n_loc=n_loc,
                   nnz=int(meta["nnz"]), shards=tuple(mesh.shards),
                   new_of_old=np.asarray(new_of_old),
                   **{k: tuple(v) for k, v in fields.items()})


def _permuted_csr(graph: CSRGraph, new_of_old: np.ndarray, n_pad: int):
    """indptr/indices of P A P^T padded with ghost (empty) rows to n_pad."""
    degrees = np.zeros(n_pad, dtype=np.int64)
    degrees[new_of_old] = graph.degrees
    indptr = np.zeros(n_pad + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    indices = np.empty(graph.nnz, dtype=np.int32)
    # scatter row blocks: entries of old row i land at indptr[new_of_old[i]]
    new_cols = new_of_old[graph.indices].astype(np.int32)
    src_starts = graph.indptr[:-1]
    dst_starts = indptr[new_of_old]
    deg = graph.degrees
    within = np.arange(graph.nnz, dtype=np.int64) - np.repeat(src_starts, deg)
    dst_pos = np.repeat(dst_starts, deg) + within
    indices[dst_pos] = new_cols
    return indptr, indices


def pack_sharded_np(graph: CSRGraph, n_shards: int, *, fmt: str = "auto",
                    ell_pct: float = 90.0, lane_tile: int = 128) -> dict:
    """The reference's ``pack_sharded`` host arrays: a dict with meta
    (n_shards, n, n_pad, n_loc, nnz) and ell_indices (w, n_pad),
    ell_degrees (n_pad,), coo_rows and coo_cols (n_shards, spill_pad),
    new_of_old (n,)."""
    n = graph.n
    n_loc = _round_up(
        max(int(np.ceil(n / n_shards)), lane_tile), lane_tile
    )
    n_pad = n_loc * n_shards
    new_of_old = balanced_permutation(graph, n_shards, n_loc)
    indptr, indices = _permuted_csr(graph, new_of_old, n_pad)

    degrees = np.diff(indptr)
    max_deg = int(degrees.max()) if n else 1
    if fmt == "ell":
        w = max(max_deg, 1)
    else:
        # percentile width over real rows only; "auto" == "hyb" here
        real_deg = graph.degrees
        w = max(int(np.percentile(real_deg, ell_pct)) if n else 1, 1)
        w = min(w, max_deg) or 1
    ell, deg, spill_rows, spill_cols = _pack_ell_np(indptr, indices, n_pad,
                                                    n_pad, w)

    # per-shard COO spill with equal padded length
    shard_of = spill_rows // n_loc
    local_rows = (spill_rows % n_loc).astype(np.int32)
    counts = np.bincount(shard_of, minlength=n_shards)
    spill_pad = _round_up(max(int(counts.max()), 1), lane_tile)
    coo_rows = np.full((n_shards, spill_pad), n_loc, dtype=np.int32)
    coo_cols = np.zeros((n_shards, spill_pad), dtype=np.int32)
    order = np.argsort(shard_of, kind="stable")
    offs = np.zeros(n_shards, dtype=np.int64)
    offs[1:] = np.cumsum(counts)[:-1]
    sr = shard_of[order]
    lr = local_rows[order]
    sc = spill_cols[order]
    within = np.arange(sr.size) - offs[sr]
    coo_rows[sr, within] = lr
    coo_cols[sr, within] = sc
    meta = dict(n_shards=n_shards, n=n, n_pad=n_pad, n_loc=n_loc,
                nnz=graph.nnz)
    return dict(meta=meta, ell_indices=ell,
                ell_degrees=deg.astype(np.int32), coo_rows=coo_rows,
                coo_cols=coo_cols, new_of_old=new_of_old)


def pack_sharded(
    graph: CSRGraph,
    n_shards: int,
    *,
    fmt: str = "auto",
    ell_pct: float = 90.0,
    lane_tile: int = 128,
    mesh: Mesh | None = None,
) -> ShardedGraph:
    """Pack ``graph`` for an ``n_shards``-way row-sharded mesh: each held
    shard's arrays on its device (``mesh``; default ``make_mesh
    (n_shards)``, on the GPUs)."""
    if mesh is None:
        mesh = make_mesh(n_shards)
    a = pack_sharded_np(graph, n_shards, fmt=fmt, ell_pct=ell_pct,
                        lane_tile=lane_tile)
    return ShardedGraph.from_numpy(a["meta"], a["ell_indices"],
                                   a["ell_degrees"], a["coo_rows"],
                                   a["coo_cols"], a["new_of_old"], mesh)
