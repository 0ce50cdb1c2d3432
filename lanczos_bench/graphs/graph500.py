"""The Graph500 benchmark's Kronecker graph ("Graph 500 benchmark
specification", the Kronecker generator, kronecker_generator.m).

Configuration keys: ``scale`` (2^scale vertices) and ``edgefactor``
(edgefactor * 2^scale generated edges).  The graph seed is the run's
``--seed``; the vertex permutation comes from the same stream.

Each edge takes one bit of its (start, end) pair a level, the lowest bit
first, from the initiator (A, B, C, D) = (0.57, 0.19, 0.19, 0.05): the
start bit is 1 where a uniform draw exceeds A + B, the end bit where a
second draw exceeds C / (C + D) after a start bit of 1, A / (A + B)
after a 0.  The labels are then permuted, self-loops and duplicate
edges dropped, and both orientations of every edge stored.  Equal array
for array to ``tpu_lanczos_torch.graphs.generators.graph500``; this copy
imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

INITIATOR = (0.57, 0.19, 0.19)


def graph500(scale: int, edgefactor: int, seed: int):
    """(indptr int64 (n+1,), indices int32 (nnz,)) of the Kronecker graph
    of 2^scale vertices."""
    if scale < 1 or edgefactor < 1:
        raise ValueError("need scale >= 1 and edgefactor >= 1")
    n = 1 << scale
    m = edgefactor * n
    a, b, c = INITIATOR
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    rng = np.random.default_rng(seed)
    # one set of buffers for every level: a fresh set a level made SCALE
    # 21 take minutes of page faults on a fresh host
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    draw = np.empty(m, dtype=np.float64)
    bits = np.empty(m, dtype=np.int64)
    ii = np.empty(m, dtype=bool)
    jj = np.empty(m, dtype=bool)
    jj_c = np.empty(m, dtype=bool)
    for bit in range(scale):
        rng.random(out=draw)
        np.greater(draw, ab, out=ii)
        rng.random(out=draw)
        np.greater(draw, a_norm, out=jj)
        np.greater(draw, c_norm, out=jj_c)
        np.copyto(jj, jj_c, where=ii)
        for out, flags in ((src, ii), (dst, jj)):
            np.copyto(bits, flags)
            np.left_shift(bits, bit, out=bits)
            np.bitwise_or(out, bits, out=out)
    del draw, bits, ii, jj, jj_c
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    # both orientations, no self-loops, each (row, col) once, sorted
    keep = src != dst
    src, dst = src[keep], dst[keep]
    half = src.shape[0]
    keys = np.empty(2 * half, dtype=np.int64)
    np.left_shift(src, scale, out=keys[:half])
    np.bitwise_or(keys[:half], dst, out=keys[:half])
    np.left_shift(dst, scale, out=keys[half:])
    np.bitwise_or(keys[half:], src, out=keys[half:])
    del src, dst, keep
    keys.sort()
    first = np.empty(keys.shape[0], dtype=bool)
    first[:1] = True
    np.not_equal(keys[1:], keys[:-1], out=first[1:])
    keys = keys[first]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys >> scale, minlength=n), out=indptr[1:])
    return indptr, (keys & (n - 1)).astype(np.int32)


def generate(config: dict, seed: int):
    return graph500(int(config["scale"]), int(config["edgefactor"]), seed)
