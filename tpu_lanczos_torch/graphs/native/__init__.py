"""ctypes bindings for the native graph core (graphcore.cc).

The C++ source ``graphcore.cc`` beside this file is the port's own copy
of the JAX package's (kept byte-identical, which a test checks), compiled
with g++ into the port's build directory (``utils.BUILD_DIR``); the JAX
package's ``_graphcore.so`` is never written.  Every entry point
degrades gracefully (``available()`` returns False) when no toolchain is
present, and the numpy implementations in
:mod:`tpu_lanczos_torch.graphs.generators` /
:mod:`tpu_lanczos_torch.graphs.io` remain the portable fallback and
semantics oracle.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.utils import BUILD_DIR, build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "graphcore.cc")
_SO = os.path.join(BUILD_DIR, "_graphcore.so")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> str | None:
    """Compile graphcore.cc -> _graphcore.so if missing/stale.
    Returns an error string or None."""
    try:
        build_shared(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                      "-pthread"], [_SRC], _SO, timeout=300)
        return None
    except Exception as exc:  # no g++, no source, read-only fs, ...
        return str(exc)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        err = _build()
        if err is not None:
            _build_error = err
            return None
        try:
            lib = _bind(ctypes.CDLL(_SO))
        except Exception as exc:
            # corrupt/stale .so (interrupted build, missing symbol):
            # record the error so available() returns False instead of
            # raising — the module's documented degradation contract
            _build_error = f"failed to load {_SO}: {exc}"
            return None
        _lib = lib
        return _lib


def _bind(lib):
    c_i64, c_p = ctypes.c_int64, ctypes.c_void_p
    lib.gc_csr_from_edges.restype = c_p
    lib.gc_csr_from_edges.argtypes = [c_i64, c_i64, c_p, c_p]
    lib.gc_csr_n.restype = c_i64
    lib.gc_csr_n.argtypes = [c_p]
    lib.gc_csr_nnz.restype = c_i64
    lib.gc_csr_nnz.argtypes = [c_p]
    lib.gc_csr_fill.restype = None
    lib.gc_csr_fill.argtypes = [c_p, c_p, c_p]
    lib.gc_csr_free.restype = None
    lib.gc_csr_free.argtypes = [c_p]
    lib.gc_parse_mtx.restype = c_p
    lib.gc_parse_mtx.argtypes = [ctypes.c_char_p]
    lib.gc_edges_n.restype = c_i64
    lib.gc_edges_n.argtypes = [c_p]
    lib.gc_edges_count.restype = c_i64
    lib.gc_edges_count.argtypes = [c_p]
    lib.gc_edges_fill.restype = None
    lib.gc_edges_fill.argtypes = [c_p, c_p, c_p]
    lib.gc_edges_free.restype = None
    lib.gc_edges_free.argtypes = [c_p]
    lib.gc_barabasi.restype = c_p
    lib.gc_barabasi.argtypes = [c_i64, c_i64, ctypes.c_uint64]
    lib.gc_uniform.restype = c_p
    lib.gc_uniform.argtypes = [c_i64, c_i64, ctypes.c_uint64]
    lib.gc_edge_color.restype = c_i64
    lib.gc_edge_color.argtypes = [c_i64, c_i64, c_i64, c_p, c_p, c_p]
    lib.gc_compact_i64.restype = c_i64
    lib.gc_compact_i64.argtypes = [c_i64, c_p, c_p, c_p]
    lib.gc_gpg_color.restype = c_i64
    lib.gc_gpg_color.argtypes = [c_i64, c_i64, c_i64,
                                 c_p, c_p, c_p, c_p, c_p]
    lib.gc_cpg_build_level.restype = c_p
    lib.gc_cpg_build_level.argtypes = [c_i64, c_i64, c_i64, c_p, c_p]
    lib.gc_cpgl_tiles.restype = c_i64
    lib.gc_cpgl_tiles.argtypes = [c_p]
    lib.gc_cpgl_fill.restype = None
    lib.gc_cpgl_fill.argtypes = [c_p, c_p, c_p, c_p, c_p]
    lib.gc_cpgl_fill_mask.restype = None
    lib.gc_cpgl_fill_mask.argtypes = [c_p, c_p]
    lib.gc_cpgl_free.restype = None
    lib.gc_cpgl_free.argtypes = [c_p]
    lib.gc_split_rows.restype = c_i64
    lib.gc_split_rows.argtypes = [c_i64, c_i64, c_i64, c_p, c_p, c_p]
    lib.gc_group_deal.restype = None
    lib.gc_group_deal.argtypes = [c_i64, c_p, c_p, c_p, c_p]
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """The captured toolchain error, if native support failed to build."""
    _load()
    return _build_error


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _csr_from_handle(lib, h) -> CSRGraph:
    try:
        n = lib.gc_csr_n(h)
        nnz = lib.gc_csr_nnz(h)
        indptr = np.empty(n + 1, dtype=np.int64)
        indices = np.empty(nnz, dtype=np.int32)
        lib.gc_csr_fill(h, _ptr(indptr), _ptr(indices))
    finally:
        lib.gc_csr_free(h)
    return CSRGraph(indptr=indptr, indices=indices, n=int(n))


def _edges_to_csr(lib, h) -> CSRGraph:
    try:
        n = lib.gc_edges_n(h)
        e = lib.gc_edges_count(h)
        src = np.empty(e, dtype=np.int64)
        dst = np.empty(e, dtype=np.int64)
        lib.gc_edges_fill(h, _ptr(src), _ptr(dst))
    finally:
        lib.gc_edges_free(h)
    ch = lib.gc_csr_from_edges(n, e, _ptr(src), _ptr(dst))
    if not ch:
        raise ValueError("edge endpoint out of range")
    return _csr_from_handle(lib, ch)


def csr_from_edges(n: int, edges: np.ndarray) -> CSRGraph:
    """Native equivalent of CSRGraph.from_edges (symmetrize/dedup/sort)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    edges = np.ascontiguousarray(edges, dtype=np.int64).reshape(-1, 2)
    src = np.ascontiguousarray(edges[:, 0])
    dst = np.ascontiguousarray(edges[:, 1])
    h = lib.gc_csr_from_edges(n, edges.shape[0], _ptr(src), _ptr(dst))
    if not h:
        raise ValueError(
            "edge endpoint out of range (or allocation failure)")
    return _csr_from_handle(lib, h)


def read_mtx(path: str) -> CSRGraph:
    """Native .mtx reader with the reference's semantics
    (parallel-final/lib/adjMatrix.cc:21-46)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    h = lib.gc_parse_mtx(path.encode())
    if not h:
        raise ValueError(f"failed to parse {path}")
    return _edges_to_csr(lib, h)


def barabasi_albert(n: int, m: int, seed: int = 0) -> CSRGraph:
    """Native Barabasi-Albert (seeded, deterministic; its RNG stream differs
    from the numpy fallback's, so graphs match structurally, not bitwise)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    h = lib.gc_barabasi(n, m, seed)
    if not h:
        raise ValueError("need n >= m+1 and m >= 1")
    return _edges_to_csr(lib, h)


def uniform_random(n: int, num_edges: int, seed: int = 0) -> CSRGraph:
    """Native uniform-random graph with exactly ``num_edges`` edges."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    h = lib.gc_uniform(n, num_edges, seed)
    if not h:
        raise ValueError("invalid n/num_edges")
    return _edges_to_csr(lib, h)


def compact(keys: np.ndarray, return_unique: bool = False):
    """Sorted-rank compaction (np.unique return_inverse semantics):
    returns ranks (E,) int32, and optionally the sorted unique keys."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    k = np.ascontiguousarray(keys, dtype=np.int64)
    ranks = np.empty(k.size, dtype=np.int32)
    uniq = np.empty(k.size, dtype=np.int64) if return_unique else None
    n_u = lib.gc_compact_i64(
        k.size, _ptr(k), _ptr(ranks),
        _ptr(uniq) if uniq is not None else None,
    )
    if return_unique:
        return ranks, uniq[:n_u]
    return ranks


def cpg_build_level(src_pos: np.ndarray, dst_pos: np.ndarray, sub: int,
                    slab: bool = False):
    """Native CPG level builder (full port of cpg.py _build_cpg_level's
    hot path: compaction, Konig tiers, tile numbering, l1/l2 fill with
    ghost-dest mex; ``slab=True`` builds source-slab-pure tiles with
    uint8 ghost-bit l2).  Returns (l1, l2, s_ids, d_ids, pair_mask)
    numpy arrays."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    sp = np.ascontiguousarray(src_pos, dtype=np.int64)
    dp = np.ascontiguousarray(dst_pos, dtype=np.int64)
    h = lib.gc_cpg_build_level(sp.size, sub, int(slab), _ptr(sp), _ptr(dp))
    if not h:
        raise RuntimeError("gc_cpg_build_level failed")
    try:
        t = lib.gc_cpgl_tiles(h)
        rows = 128 if slab else sub
        l1 = np.empty((t * rows, 128), dtype=np.int8)
        l2 = np.empty(
            (t * 128, sub),
            dtype=np.uint8 if (slab or sub <= 256) else np.int16,
        )
        s_ids = np.empty(t, dtype=np.int32)
        d_ids = np.empty(t, dtype=np.int32)
        pair_mask = np.empty(t, dtype=np.int32)
        lib.gc_cpgl_fill(h, _ptr(l1), _ptr(l2), _ptr(s_ids), _ptr(d_ids))
        lib.gc_cpgl_fill_mask(h, _ptr(pair_mask))
    finally:
        lib.gc_cpgl_free(h)
    return l1, l2, s_ids, d_ids, pair_mask


def split_rows(rows: np.ndarray, n_units0: int, theta: int):
    """Native theta-split (cst.py _split_rows semantics): entries sorted by
    row; returns (unit_of_entry, n_units, parents)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    if theta < 1:
        raise ValueError(f"theta must be >= 1, got {theta}")
    r = np.ascontiguousarray(rows, dtype=np.int64)
    unit = np.empty(r.size, dtype=np.int64)
    # upper bound on virtual units: sum(ceil(deg/theta) - 1) <= E / theta
    parents = np.empty(r.size // theta + 1, dtype=np.int64)
    n_units = lib.gc_split_rows(r.size, n_units0, theta, _ptr(r),
                                _ptr(unit), _ptr(parents))
    if n_units < 0:
        raise ValueError("gc_split_rows failed (invalid arguments)")
    return unit, int(n_units), parents[: n_units - n_units0]


def gpg_color(
    group: np.ndarray,
    d_of: np.ndarray,
    a_cell: np.ndarray,
    b_cell: np.ndarray,
    n_a_cells: int,
    n_b_cells: int,
):
    """Color-concentrating greedy edge coloring for the GPG packer (see
    gc_gpg_color): entries must arrive grouped by (D, granule) with
    D-major group order; each entry gets the smallest color free on both
    its staging cell (per group) and dest cell (per D).  Returns (E,)
    int32 colors."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    grp = np.ascontiguousarray(group, dtype=np.int32)
    d = np.ascontiguousarray(d_of, dtype=np.int32)
    a = np.ascontiguousarray(a_cell, dtype=np.int32)
    b = np.ascontiguousarray(b_cell, dtype=np.int32)
    colors = np.empty(grp.size, dtype=np.int32)
    used = lib.gc_gpg_color(
        grp.size, n_a_cells, n_b_cells,
        _ptr(grp), _ptr(d), _ptr(a), _ptr(b), _ptr(colors),
    )
    if used < 0:
        raise RuntimeError("gc_gpg_color failed (color cap exceeded)")
    return colors


def edge_color(a_ids: np.ndarray, b_ids: np.ndarray) -> np.ndarray:
    """Delta-optimal proper edge coloring of a bipartite multigraph
    (Konig, alternating-path construction in C++).  ``a_ids``/``b_ids``
    are compact endpoint ids; returns (E,) int32 colors with both
    endpoints' colors unique."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    a = np.ascontiguousarray(a_ids, dtype=np.int32)
    b = np.ascontiguousarray(b_ids, dtype=np.int32)
    n_a = int(a.max()) + 1 if a.size else 0
    n_b = int(b.max()) + 1 if b.size else 0
    colors = np.empty(a.size, dtype=np.int32)
    used = lib.gc_edge_color(a.size, n_a, n_b, _ptr(a), _ptr(b), _ptr(colors))
    if used < 0:
        raise RuntimeError("gc_edge_color failed")
    return colors




def group_deal(parent: np.ndarray, opp_chunk: np.ndarray,
               n_parts_of: np.ndarray) -> np.ndarray:
    """Native block-aware dealing (cpg.py _group_deal semantics):
    radix-sorted (parent, opp_chunk) groups, round-robin part
    assignment staggered by group id."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    p = np.ascontiguousarray(parent, dtype=np.int64)
    o = np.ascontiguousarray(opp_chunk, dtype=np.int64)
    npar = np.ascontiguousarray(n_parts_of, dtype=np.int64)
    out = np.empty(p.size, dtype=np.int64)
    lib.gc_group_deal(p.size, _ptr(p), _ptr(o), _ptr(npar), _ptr(out))
    return out
