"""Fallback device formats for the value-free sparse adjacency matrix.

The port of ``tpu_lanczos/kernels/formats.py``: the same host packing
(``_pack_ell_np``, ``_pack_coo_np``, the ``auto`` rule), so a pack made
here holds the reference's arrays, as torch tensors on an explicit
``device``.  Three formats:

- ``ell``: slot-major ELLPACK, indices stored (w, n_pad); slot s of row r
  is ``ell_indices[s, r]``.  Best for bounded-degree graphs (meshes).
- ``coo``: row-sorted COO, memory O(nnz), tolerates any degree skew.
- ``hyb``: ELL at a degree percentile plus a COO spill for heavy rows.

Padded ELL slots hold column 0 and are masked by degree; padded COO
entries carry row ``n_pad`` (an extra bucket that is dropped).  The
JAX package runs these through XLA, not Pallas; their SpMV
(kernels/spmv.py) is plain torch ops.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_lanczos_torch.graphs.csr import CSRGraph


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """ELL / COO / HYB pack: metadata plus index tensors on one device.
    ``coo_offsets`` (n_pad + 2,) int64 holds each row's first entry in
    the row-sorted COO arrays (the pad bucket last), for the sorted
    segment sum; the other fields are the reference's."""

    fmt: str  # "ell" | "coo" | "hyb"
    n: int  # true number of rows/cols
    n_pad: int  # padded row count (vectors live at this length)
    nnz: int  # true nonzero count

    # ELL part (fmt in {"ell", "hyb"}); otherwise None
    ell_indices: torch.Tensor | None = None  # (w, n_pad) int32, slot-major
    ell_degrees: torch.Tensor | None = None  # (n_pad,) int32 valid slots

    # COO part (fmt in {"coo", "hyb"}); otherwise None
    coo_cols: torch.Tensor | None = None  # (nnz_pad,) int32
    coo_rows: torch.Tensor | None = None  # (nnz_pad,) int32; pad -> n_pad
    coo_offsets: torch.Tensor | None = None  # (n_pad + 2,) int64

    @property
    def device(self) -> torch.device:
        t = self.ell_indices if self.ell_indices is not None else self.coo_cols
        return t.device

    @property
    def ell_width(self) -> int:
        return 0 if self.ell_indices is None else int(self.ell_indices.shape[0])

    # the vector interface shared with CPGGraph; these formats keep the
    # identity layout
    def permute_in(self, x, dtype):
        out = np.zeros(self.n_pad, dtype=dtype)
        out[: self.n] = x
        return out

    def permute_out(self, y):
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        return np.asarray(y)[: self.n]


def _pack_ell_np(
    indptr: np.ndarray, indices: np.ndarray, n: int, n_pad: int, width: int
):
    """Split CSR rows into a slot-major ELL block of up to ``width`` slots
    per row plus COO spill of the remainder. Returns numpy arrays."""
    degrees = np.diff(indptr)
    w = int(max(min(width, degrees.max() if n else 0), 1))
    take = np.minimum(degrees, w)
    offsets = np.repeat(indptr[:-1], take)
    within = np.arange(take.sum()) - np.repeat(np.cumsum(take) - take, take)
    rows_for_ell = np.repeat(np.arange(n), take)
    ell = np.zeros((w, n_pad), dtype=np.int32)
    ell[within, rows_for_ell] = indices[offsets + within]
    deg = np.zeros(n_pad, dtype=np.int32)
    deg[:n] = take
    # spill: entries beyond w
    spill_count = degrees - take
    spill_rows = np.repeat(np.arange(n), spill_count).astype(np.int32)
    spill_off = np.repeat(indptr[:-1] + take, spill_count)
    spill_within = np.arange(spill_count.sum()) - np.repeat(
        np.cumsum(spill_count) - spill_count, spill_count
    )
    spill_cols = indices[spill_off + spill_within].astype(np.int32)
    return ell, deg, spill_rows, spill_cols


def _pack_coo_np(rows: np.ndarray, cols: np.ndarray, n_pad: int, lane_tile: int):
    nnz_pad = _round_up(max(rows.size, 1), lane_tile)
    out_rows = np.full(nnz_pad, n_pad, dtype=np.int32)  # pad bucket
    out_cols = np.zeros(nnz_pad, dtype=np.int32)
    out_rows[: rows.size] = rows
    out_cols[: rows.size] = cols
    return out_rows, out_cols


def _coo_tensors(rows: np.ndarray, cols: np.ndarray, n_pad: int, device):
    """COO rows, cols and per-row offsets (rows are sorted, pad last)."""
    offsets = np.searchsorted(rows, np.arange(n_pad + 2), side="left")
    return dict(
        coo_rows=torch.from_numpy(rows).to(device),
        coo_cols=torch.from_numpy(cols).to(device),
        coo_offsets=torch.from_numpy(offsets.astype(np.int64)).to(device),
    )


def pack(
    graph: CSRGraph,
    fmt: str = "auto",
    *,
    ell_pct: float = 98.0,
    lane_tile: int = 128,
    n_pad: int | None = None,
    device="cuda",
) -> DeviceGraph:
    """Pack a host CSR graph into an ELL / COO / HYB pack on ``device``.

    ``auto`` picks ELL when max-degree padding is cheap (<= 1.5x nnz),
    hybrid when a percentile width captures most entries, else COO, as
    the reference does.
    """
    n = graph.n
    n_pad = n_pad if n_pad is not None else _round_up(max(n, lane_tile), lane_tile)
    degrees = graph.degrees
    max_deg = int(degrees.max()) if n else 0
    pct_w = None  # computed at most once (O(n) pass over degrees)

    def _pct_w():
        nonlocal pct_w
        if pct_w is None:
            pct_w = max(int(np.percentile(degrees, ell_pct)) if n else 1, 1)
        return pct_w

    if fmt == "auto":
        if n_pad * max(max_deg, 1) <= 1.5 * max(graph.nnz, 1):
            fmt = "ell"
        else:
            fmt = "hyb" if _pct_w() * n_pad <= 1.5 * graph.nnz else "coo"

    def ell_tensors(ell, deg):
        return dict(ell_indices=torch.from_numpy(ell).to(device),
                    ell_degrees=torch.from_numpy(deg).to(device))

    if fmt == "ell":
        ell, deg, spill_rows, _ = _pack_ell_np(
            graph.indptr, graph.indices, n, n_pad, max(max_deg, 1)
        )
        assert spill_rows.size == 0
        return DeviceGraph(fmt="ell", n=n, n_pad=n_pad, nnz=graph.nnz,
                           **ell_tensors(ell, deg))

    if fmt == "hyb":
        ell, deg, spill_rows, spill_cols = _pack_ell_np(
            graph.indptr, graph.indices, n, n_pad, _pct_w()
        )
        rows, cols = _pack_coo_np(spill_rows, spill_cols, n_pad, lane_tile)
        return DeviceGraph(fmt="hyb", n=n, n_pad=n_pad, nnz=graph.nnz,
                           **ell_tensors(ell, deg),
                           **_coo_tensors(rows, cols, n_pad, device))

    if fmt == "coo":
        rows, cols = _pack_coo_np(
            graph.row_ids(), graph.indices.astype(np.int32), n_pad, lane_tile
        )
        return DeviceGraph(fmt="coo", n=n, n_pad=n_pad, nnz=graph.nnz,
                           **_coo_tensors(rows, cols, n_pad, device))

    raise ValueError(f"unknown format {fmt!r}")
