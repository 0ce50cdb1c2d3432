"""Seeded graph generators: uniform-random and Barabasi-Albert.

Reference capabilities (serial/lib/make_graph.cc:19-113, dispatch
parallel-final/lib/adjMatrix.cc:79-103):
  - ``random_adj(N, E)``     — E distinct uniform-random undirected edges
  - ``barabasi(N, m)``       — preferential attachment: a complete seed
    graph on m+1 nodes, then each new node attaches m edges with
    probability proportional to current degree.

Re-implemented here with numpy vectorization (the reference used
std::set-based rejection loops).  The C++ native generator in
``native/graphcore.cc`` is preferred automatically for large n; this module
is the portable fallback and the semantics oracle for it.
"""

from __future__ import annotations

import numpy as np

from tpu_lanczos_torch.graphs.csr import CSRGraph


def uniform_random(
    n: int, num_edges: int, seed: int = 0, use_native: bool = False
) -> CSRGraph:
    """Graph with ``num_edges`` distinct uniform-random undirected edges.

    Rejection-free: oversample pairs, dedup, repeat until enough distinct
    edges exist, then truncate deterministically.  With ``use_native`` the
    C++ core generates the graph (different RNG stream, same distribution).
    """
    if num_edges > n * (n - 1) // 2:
        raise ValueError("more edges requested than pairs available")
    if use_native:
        try:
            from tpu_lanczos_torch.graphs import native

            if native.available():
                return native.uniform_random(n, num_edges, seed)
        except Exception:
            pass
    rng = np.random.default_rng(seed)
    chosen = np.zeros((0,), dtype=np.int64)
    while chosen.size < num_edges:
        need = num_edges - chosen.size
        cand = rng.integers(0, n, size=(int(need * 1.5) + 16, 2), dtype=np.int64)
        cand = cand[cand[:, 0] != cand[:, 1]]
        lo = np.minimum(cand[:, 0], cand[:, 1])
        hi = np.maximum(cand[:, 0], cand[:, 1])
        keys = lo * np.int64(n) + hi
        chosen = np.unique(np.concatenate([chosen, keys]))
    # deterministic truncation: keep a random subset of exactly num_edges
    if chosen.size > num_edges:
        keep = rng.choice(chosen.size, size=num_edges, replace=False)
        chosen = chosen[np.sort(keep)]
    edges = np.stack([chosen // n, chosen % n], axis=1)
    return CSRGraph.from_edges(n, edges)


def barabasi_albert(n: int, m: int, seed: int = 0, use_native: bool = False) -> CSRGraph:
    """Barabasi-Albert preferential attachment.

    Seed: complete graph on m+1 nodes (as in serial/lib/make_graph.cc —
    "complete-kernel seed of m+1 nodes"); then nodes m+1..n-1 each attach
    ``m`` edges to distinct existing nodes, sampled degree-proportionally
    via the repeated-endpoints trick (every stored edge endpoint appears
    once in the pool, so a uniform draw from the pool is degree-weighted).

    ``use_native`` opts into the much faster C++ generator, whose RNG
    stream differs from numpy's: same (n, m, seed) then yields a different
    (structurally equivalent) graph.  Default False so results are
    reproducible regardless of whether a toolchain is present; callers
    that cache by an explicit key (bench) opt in.
    """
    if m < 1 or n < m + 1:
        raise ValueError("need n >= m+1 and m >= 1")
    if use_native:
        try:
            from tpu_lanczos_torch.graphs import native

            if native.available():
                return native.barabasi_albert(n, m, seed)
        except Exception:
            pass
    rng = np.random.default_rng(seed)
    seed_nodes = m + 1
    # complete seed graph edge list
    iu, ju = np.triu_indices(seed_nodes, k=1)
    n_seed_edges = iu.size
    total_edges = n_seed_edges + (n - seed_nodes) * m
    src = np.empty(total_edges, dtype=np.int64)
    dst = np.empty(total_edges, dtype=np.int64)
    src[:n_seed_edges] = iu
    dst[:n_seed_edges] = ju
    # endpoint pool: both endpoints of every edge so far
    pool = np.empty(2 * total_edges, dtype=np.int64)
    pool[: 2 * n_seed_edges : 2] = iu
    pool[1 : 2 * n_seed_edges : 2] = ju
    e = n_seed_edges
    for v in range(seed_nodes, n):
        # sample m distinct degree-proportional targets; distinctness by
        # FIRST OCCURRENCE in draw order — truncating the sorted unique
        # set (np.unique(...)[:m]) would keep the m smallest node ids
        # and bias attachment toward old nodes beyond degree weighting
        targets = np.unique(pool[rng.integers(0, 2 * e, size=m)])
        while targets.size < m:
            extra = pool[rng.integers(0, 2 * e, size=m)]
            cand = np.concatenate([targets, extra])
            _, first = np.unique(cand, return_index=True)
            targets = cand[np.sort(first)][:m]
        src[e : e + m] = v
        dst[e : e + m] = targets
        pool[2 * e : 2 * (e + m) : 2] = v
        pool[2 * e + 1 : 2 * (e + m) + 1 : 2] = targets
        e += m
    edges = np.stack([src, dst], axis=1)
    return CSRGraph.from_edges(n, edges)


def rmat(
    n: int,
    num_edges: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> CSRGraph:
    """R-MAT / Kronecker graph (Graph500 parameters by default).

    Recursive quadrant sampling produces the degree skew AND the
    hierarchical community structure of real social/web graphs — the
    right analog for the reference's com-LiveJournal benchmark graph
    (BASELINE.md; a pure Barabasi-Albert expander is strictly harder
    than the real graph, which has strong clustering).  ``n`` is rounded
    up to a power of two internally; vertices beyond ``n`` are remapped
    by modulo.  Self-loops and duplicates are dropped by CSR
    construction, so the final nnz is somewhat below 2 * num_edges.
    """
    if n < 2 or num_edges < 1:
        raise ValueError("need n >= 2 and num_edges >= 1")
    levels = int(np.ceil(np.log2(n)))
    rng = np.random.default_rng(seed)
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for _ in range(levels):
        r = rng.random(num_edges)
        # quadrants by threshold: [0,a) -> (0,0), [a,a+b) -> (0,1),
        # [a+b,a+b+c) -> (1,0), [a+b+c,1) -> (1,1)
        down = r >= a + b
        right = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src = src * 2 + down.astype(np.int64)
        dst = dst * 2 + right.astype(np.int64)
    src %= n
    dst %= n
    return CSRGraph.from_edges(n, np.stack([src, dst], axis=1))


def stencil_3d(nx: int, ny: int, nz: int) -> CSRGraph:
    """18-connectivity 3D grid graph (6 face + 12 edge neighbors): interior
    degree 18 — the class analog of the reference's
    channel-500x100x100-b050 CFD mesh (n=4.8M, nnz=85.4M, mean degree
    ~17.8; BASELINE.md)."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64).reshape(nx, ny, nz)
    offsets = [
        (1, 0, 0), (0, 1, 0), (0, 0, 1),          # faces (half)
        (1, 1, 0), (1, -1, 0), (1, 0, 1), (1, 0, -1),
        (0, 1, 1), (0, 1, -1),                     # edge diagonals (half)
    ]
    parts = []
    for dx, dy, dz in offsets:
        sx = slice(max(dx, 0), nx + min(dx, 0))
        sy = slice(max(dy, 0), ny + min(dy, 0))
        sz = slice(max(dz, 0), nz + min(dz, 0))
        tx = slice(max(-dx, 0), nx + min(-dx, 0))
        ty = slice(max(-dy, 0), ny + min(-dy, 0))
        tz = slice(max(-dz, 0), nz + min(-dz, 0))
        parts.append(np.stack(
            [idx[sx, sy, sz].ravel(), idx[tx, ty, tz].ravel()], axis=1
        ))
    return CSRGraph.from_edges(n, np.concatenate(parts, axis=0))


def clique_union(
    n: int,
    papers: int,
    seed: int = 0,
    comm: int = 64,
    size: int = 8,
    cross_frac: float = 0.1,
) -> CSRGraph:
    """Co-authorship graph: a union of small cliques inside communities.

    The reference's best-speedup benchmark graph, coPapersDBLP (n=540K,
    nnz=30M, mean degree ~56 — final_output1.txt:176, 24x CUDA-vs-serial),
    is a co-authorship network: every paper contributes a clique over its
    authors, and authors cluster into fields, so a natural vertex order
    concentrates edges near the diagonal.  This generator reproduces that
    class: ``papers`` cliques of ``size`` authors sampled (with
    replacement) from one ``comm``-sized community each; a ``cross_frac``
    fraction of papers spans two adjacent communities.  An R-MAT analog
    (see ``rmat``) carries social-graph skew instead, which is a strictly
    harder layout case — the suite benchmarks both.
    """
    if n < comm or papers < 1:
        raise ValueError("need n >= comm and papers >= 1")
    rng = np.random.default_rng(seed)
    n_comm = n // comm
    cid = rng.integers(0, n_comm, papers)
    width = np.full(papers, comm, dtype=np.int64)
    cross = rng.random(papers) < cross_frac
    width[cross & (cid < n_comm - 1)] = 2 * comm
    authors = cid[:, None] * comm + rng.integers(
        0, width[:, None], (papers, size)
    )
    iu, ju = np.triu_indices(size, k=1)
    edges = np.stack(
        [authors[:, iu].ravel(), authors[:, ju].ravel()], axis=1
    )
    return CSRGraph.from_edges(n, edges)


def stencil_2d(side: int) -> CSRGraph:
    """5-point 2D grid graph (the reference declared a stencil generator but
    left it a stub — serial/lib/make_graph.cc 'stencil stub (allocates
    only)'; here it is implemented, useful as a mesh-like low-degree case)."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return CSRGraph.from_edges(n, np.concatenate([right, down], axis=0))
