"""MatrixMarket-style .mtx reading/writing with the reference's semantics.

Format (reference: parallel-final/lib/adjMatrix.cc:21-46, write path :53-69):
  - optional comment lines starting with '%'
  - a header line ``n n E``
  - E data lines of two 1-indexed node ids per line (extra columns, e.g. a
    weight in general MatrixMarket files, are ignored)
  - on read, both orientations are inserted and duplicates removed
  - on write, only the upper triangle is emitted, 1-indexed

When available the native C++ parser
(:mod:`tpu_lanczos_torch.graphs.native`) is used for large files; the
numpy path below is the portable fallback and the semantics oracle.  A
copy of ``tpu_lanczos/graphs/io.py`` on the port's CSRGraph.
"""

from __future__ import annotations

import io as _io
import os

import numpy as np

from tpu_lanczos_torch.graphs.csr import CSRGraph


def _read_tokens(path: str) -> tuple[int, int, np.ndarray]:
    """Returns (n, declared_edges, (E,2) 0-indexed edge array)."""
    with open(path, "rb") as f:
        data = f.read()
    # strip comment lines
    lines = data.split(b"\n")
    body_start = None
    for i, ln in enumerate(lines):
        if not ln.strip() or ln.lstrip().startswith(b"%"):
            continue
        body_start = i
        break
    if body_start is None:
        raise ValueError(f"{path}: no 'n n E' header (empty/comment-only)")
    header = lines[body_start].split()
    if len(header) < 3:
        raise ValueError(f"{path}: malformed header {header!r}")
    n = int(header[0])
    n2 = int(header[1])
    if n != n2:
        raise ValueError(f"adjacency matrix must be square, got {n}x{n2}")
    declared_e = int(header[2])
    body = b"\n".join(lines[body_start + 1 :])
    # np.fromstring parses tokens without materializing one Python bytes
    # object per token (body.split() costs several GB of object overhead
    # on a 30M-edge file); whitespace sep treats newlines like spaces
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("ignore", DeprecationWarning)
        arr = np.fromstring(body, dtype=np.float64, sep=" ")
    # fromstring STOPS at the first unparseable token without raising —
    # compare against a bytes-level token count so a corrupt body errors
    # instead of silently truncating the edge list
    bb = np.frombuffer(body, dtype=np.uint8)
    isws = (bb == 32) | (bb == 9) | (bb == 10) | (bb == 13)
    starts = ~isws
    if starts.size:
        starts = starts & np.concatenate([[True], isws[:-1]])
    n_tokens = int(starts.sum())
    if arr.size != n_tokens:
        raise ValueError(
            f"{path}: unparseable data token (parsed {arr.size} of "
            f"{n_tokens} tokens)")
    if arr.size == 0:
        return n, declared_e, np.zeros((0, 2), dtype=np.int64)
    # lines may carry 2 or 3 tokens (pattern vs weighted mtx); infer the
    # width from the FIRST DATA LINE (the declared edge count is wrong
    # often enough in the wild that keying on it reshaped weighted rows
    # into garbage edge pairs)
    first_data = b""
    for ln in lines[body_start + 1:]:
        if ln.strip():
            first_data = ln
            break
    width = max(len(first_data.split()), 2)
    if arr.size % width:
        raise ValueError(
            f"{path}: {arr.size} tokens do not tile {width}-column rows")
    arr = arr.reshape(-1, width)[:, :2]
    edges = arr.astype(np.int64) - 1  # 1-indexed on disk
    return n, declared_e, edges


def read_mtx(path: str, use_native: bool = True) -> CSRGraph:
    """Read a .mtx adjacency file into a value-free CSR graph.

    Matches the reference's reader semantics (1-indexed pairs, symmetrize,
    dedup, self-loops dropped; parallel-final/lib/adjMatrix.cc:21-46).
    """
    if use_native:
        try:
            from tpu_lanczos_torch.graphs import native

            ok = native.available()
        except Exception:
            ok = False
        if ok:
            # parse errors propagate: the numpy fallback is for a
            # missing toolchain, not for masking malformed files
            return native.read_mtx(path)
    n, _, edges = _read_tokens(path)
    return CSRGraph.from_edges(n, edges)


def write_mtx(graph: CSRGraph, path: str) -> None:
    """Write the upper triangle, 1-indexed, with an ``n n E`` header
    (reference: parallel-final/lib/adjMatrix.cc:53-69)."""
    rows = graph.row_ids().astype(np.int64)
    cols = graph.indices.astype(np.int64)
    keep = rows < cols
    rows, cols = rows[keep], cols[keep]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = _io.StringIO()
    buf.write(f"{graph.n} {graph.n} {rows.size}\n")
    np.savetxt(buf, np.stack([rows + 1, cols + 1], axis=1), fmt="%d %d")
    with open(path, "w") as f:
        f.write(buf.getvalue())
