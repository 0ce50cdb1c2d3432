"""Checkpoint / resume for the Lanczos decomposition.

The port of ``tpu_lanczos/core/checkpoint.py``: the loop carry is saved
every ``chunk`` iterations, and a compatible snapshot is resumed bit for
bit; a snapshot that cannot be read, or was written for another run,
starts a fresh one.

- ``lanczos_checkpointed``: the single-device stored-Q path (float32 or
  float64), an O(k*n) snapshot of (q, q_prev, Q, alpha, beta).
- ``lanczos_alphabeta_df_checkpointed``: pass 1 of the df64 two-pass mode,
  the long sequential stage of a large f64-grade run, an O(n) snapshot
  (two (hi, lo) vector pairs, the coefficient buffers and the df x_norm).
  Pass 2 restarts fresh.

Each snapshot is an atomic ``.npz`` with the reference's field names and
the reference's fingerprint (``run_fingerprint``), so either package
reads, and resumes, what the other wrote.  Sharded runs do not
checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import zipfile
import zlib

import numpy as np
import torch

from tpu_lanczos_torch.core.lanczos import (
    LanczosState,
    lanczos_init,
    lanczos_range,
)
from tpu_lanczos_torch.utils import numpy_dtype


def _structure_probe(dg) -> int:
    """CRC of one float32 SpMV of a fixed pseudo-random vector: captures
    the packed adjacency at O(1) host transfer.  A false mismatch only
    forces a safe restart, never a wrong resume."""
    from tpu_lanczos_torch.kernels.spmv import spmv

    r = ((np.arange(dg.n_pad, dtype=np.int64) * 2654435761) % 1000003
         ).astype(np.float32) / 1000003.0
    y = spmv(dg, torch.from_numpy(r).to(dg.device))[:65536].cpu().numpy()
    return zlib.crc32(np.ascontiguousarray(y).tobytes())


def run_fingerprint(dg, dtype, k: int, reorthogonalize: bool,
                    spmv_impl: str, x=None) -> str:
    """Identity of a decomposition run: the graph (n, nnz, permutation
    CRC, structural SpMV probe), the dtype, the start vector and every
    setting that changes the recurrence, in the reference's format.  A
    snapshot written under another fingerprint is never resumed."""
    noo = getattr(dg, "new_of_old", None)
    perm_crc = (
        zlib.crc32(np.ascontiguousarray(noo).tobytes()) if noo is not None
        else 0)
    x_crc = (zlib.crc32(np.ascontiguousarray(np.asarray(x)).tobytes())
             if x is not None else 0)
    return (
        f"{type(dg).__name__}:n={dg.n}:nnz={dg.nnz}:n_pad={dg.n_pad}:"
        f"perm={perm_crc:08x}:probe={_structure_probe(dg):08x}:"
        f"dtype={np.dtype(dtype).name}:k={k}:x={x_crc:08x}:"
        f"reorth={bool(reorthogonalize)}:spmv={spmv_impl}"
    )


def _save_atomic(path: str, **fields) -> None:
    """np.savez to a temporary file beside ``path``, then rename: a
    reader never sees a torn snapshot."""
    tmp_fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".", suffix=".tmp")
    os.close(tmp_fd)
    np.savez(tmp, **fields)
    os.replace(tmp + ".npz", path)
    if os.path.exists(tmp):
        os.unlink(tmp)


def _load_or_none(load, path: str):
    """``load(path)``, or None for a snapshot that cannot be read."""
    try:
        return load(path)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile,
            zlib.error):
        return None


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that shares no memory with it: the carry is
    updated in place by the next chunk."""
    return t.to("cpu", copy=True).numpy()


@dataclasses.dataclass
class LanczosCheckpoint:
    """Host snapshot of the stored-Q loop carry after ``j_done``
    iterations."""

    j_done: int
    k: int
    q: np.ndarray
    q_prev: np.ndarray
    q_basis: np.ndarray
    alpha: np.ndarray
    beta: np.ndarray
    x_norm: float
    fingerprint: str = ""

    _FIELDS = ("q", "q_prev", "q_basis", "alpha", "beta")

    def save(self, path: str) -> None:
        _save_atomic(path, j_done=self.j_done, k=self.k, x_norm=self.x_norm,
                     fingerprint=self.fingerprint,
                     **{f: getattr(self, f) for f in self._FIELDS})

    @staticmethod
    def load(path: str) -> "LanczosCheckpoint":
        with np.load(path) as z:
            return LanczosCheckpoint(
                j_done=int(z["j_done"]), k=int(z["k"]),
                x_norm=float(z["x_norm"]),
                fingerprint=str(z["fingerprint"]) if "fingerprint" in z
                else "",
                **{f: z[f] for f in LanczosCheckpoint._FIELDS},
            )

    def carry(self, device):
        """The carry as new tensors on ``device`` (never views of the
        snapshot's arrays: ``lanczos_range`` writes into them)."""
        return tuple(torch.tensor(getattr(self, f), device=device)
                     for f in self._FIELDS)


def lanczos_checkpointed(dg, x: torch.Tensor, k: int, *,
                         checkpoint_path: str, chunk: int = 16,
                         reorthogonalize: bool = False):
    """k-step Lanczos (``core/lanczos.py::lanczos``), saving the carry to
    ``checkpoint_path`` after every ``chunk`` iterations.  If the path
    holds a compatible snapshot (same fingerprint and k), the run resumes
    from it, and the result is bit-identical to an uninterrupted run.
    Returns a ``LanczosState``."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    # the reference's fingerprint, whose last field names its default
    # spmv_impl, so a snapshot of the same run resumes in either package
    fp = run_fingerprint(dg, numpy_dtype(x.dtype), k, reorthogonalize,
                         "auto", x=x.cpu().numpy())
    ckpt = None
    if os.path.exists(checkpoint_path):
        cand = _load_or_none(LanczosCheckpoint.load, checkpoint_path)
        if (cand is not None and cand.fingerprint == fp and cand.k == k
                and cand.q.shape == (dg.n_pad,)):
            ckpt = cand

    if ckpt is None:
        carry, x_norm = lanczos_init(dg, x, k)
        x_norm = float(x_norm)
        j = 0
    else:
        carry = ckpt.carry(x.device)
        x_norm = ckpt.x_norm
        j = ckpt.j_done

    while j < k:
        j1 = min(j + chunk, k)
        carry = lanczos_range(dg, carry, j, j1,
                              reorthogonalize=reorthogonalize)
        j = j1
        LanczosCheckpoint(
            j_done=j, k=k, x_norm=x_norm, fingerprint=fp,
            **dict(zip(LanczosCheckpoint._FIELDS, map(_host_copy, carry))),
        ).save(checkpoint_path)

    _, _, q_basis, alpha, beta = carry
    return LanczosState(
        alpha=alpha, beta=beta[: k - 1], q_basis=q_basis,
        x_norm=torch.tensor(x_norm, dtype=alpha.dtype, device=alpha.device))


@dataclasses.dataclass
class AlphaBetaDFCheckpoint:
    """Host snapshot of the df64 alpha/beta carry after ``j_done``
    iterations: (q, q_prev) as (hi, lo) float32 pairs, the coefficient
    buffers and the df x_norm.  O(n) on disk: no basis is stored."""

    j_done: int
    k: int
    qh: np.ndarray
    ql: np.ndarray
    ph: np.ndarray
    pl: np.ndarray
    ah: np.ndarray
    al: np.ndarray
    bh: np.ndarray
    bl: np.ndarray
    xnh: float
    xnl: float
    fingerprint: str = ""

    _FIELDS = ("qh", "ql", "ph", "pl", "ah", "al", "bh", "bl")

    def save(self, path: str) -> None:
        _save_atomic(path, j_done=self.j_done, k=self.k, xnh=self.xnh,
                     xnl=self.xnl, fingerprint=self.fingerprint,
                     **{f: getattr(self, f) for f in self._FIELDS})

    @staticmethod
    def load(path: str) -> "AlphaBetaDFCheckpoint":
        with np.load(path) as z:
            return AlphaBetaDFCheckpoint(
                j_done=int(z["j_done"]), k=int(z["k"]),
                xnh=float(z["xnh"]), xnl=float(z["xnl"]),
                fingerprint=str(z["fingerprint"]) if "fingerprint" in z
                else "",
                **{f: z[f] for f in AlphaBetaDFCheckpoint._FIELDS},
            )

    def carry(self, device):
        return tuple(torch.from_numpy(getattr(self, f)).to(device)
                     for f in self._FIELDS)


def lanczos_alphabeta_df_checkpointed(cg, x_hi: torch.Tensor,
                                      x_lo: torch.Tensor, k: int, *,
                                      checkpoint_path: str, chunk: int = 16):
    """df64 pass 1 (alpha/beta), saving the O(n) carry every ``chunk``
    iterations.  Returns ``(alpha, beta, x_norm)`` as (hi, lo) pairs,
    exactly like ``lanczos_alphabeta_df``; a resumed run is bit-identical
    to an uninterrupted one.  A snapshot that cannot be read, or was
    written for another graph, start vector or k, starts a fresh run."""
    from tpu_lanczos_torch.core import lanczos_df

    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    # start-vector identity without an O(n) device->host copy: the CRC of
    # the head slice plus the exact df norm, as the reference forms it
    q0h, q0l, xnh0, xnl0 = lanczos_df._alphabeta_df_init(x_hi, x_lo)
    head = min(int(cg.n_pad), 65536)
    x_crc = (zlib.crc32(x_hi[:head].cpu().numpy().tobytes())
             ^ zlib.crc32(x_lo[:head].cpu().numpy().tobytes()))
    fp = (run_fingerprint(cg, np.float32, k, False, "cpg-df64")
          + f":xdf={x_crc:08x}:xn={float(xnh0):.9e}")
    ckpt = None
    if os.path.exists(checkpoint_path):
        cand = _load_or_none(AlphaBetaDFCheckpoint.load, checkpoint_path)
        if (cand is not None and cand.fingerprint == fp and cand.k == k
                and cand.qh.shape == (cg.n_pad,)):
            ckpt = cand

    if ckpt is None:
        carry = lanczos_df._fresh_carry(q0h, q0l, k)
        xnh, xnl = float(xnh0), float(xnl0)
        j = 0
    else:
        carry = ckpt.carry(x_hi.device)
        xnh, xnl = ckpt.xnh, ckpt.xnl
        j = ckpt.j_done

    while j < k:
        j1 = min(j + chunk, k)
        carry = lanczos_df.lanczos_alphabeta_df_range(cg, carry, j, j1)
        j = j1
        host = [c.cpu().numpy() for c in carry]
        AlphaBetaDFCheckpoint(
            j_done=j, k=k, **dict(zip(AlphaBetaDFCheckpoint._FIELDS, host)),
            xnh=xnh, xnl=xnl, fingerprint=fp,
        ).save(checkpoint_path)

    _, _, _, _, ah, al, bh, bl = carry
    xn = tuple(torch.tensor(v, dtype=torch.float32, device=x_hi.device)
               for v in (xnh, xnl))
    return (ah, al), (bh, bl), xn
