"""Checkpoint / resume for pass 1 of the df64 two-pass mode.

The port of ``tpu_lanczos/core/checkpoint.py``'s df64 half
(``run_fingerprint``, ``_structure_probe``, ``AlphaBetaDFCheckpoint``,
``lanczos_alphabeta_df_checkpointed``).  Pass 1 is the long sequential
stage of a large f64-grade run; its O(n) carry (two (hi, lo) vector
pairs, the coefficient buffers and the df x_norm) is saved every
``chunk`` iterations, and a compatible snapshot is resumed bit for bit.
Pass 2 restarts fresh.  The snapshot is an atomic ``.npz`` with the
reference's field names, so either package reads what the other wrote.
The stored-Q ``lanczos_checkpointed`` is not ported yet (ROADMAP queue 1
item 12).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import zipfile
import zlib

import numpy as np
import torch


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
        tmp_fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)) or ".", suffix=".tmp")
        os.close(tmp_fd)
        np.savez(
            tmp, j_done=self.j_done, k=self.k,
            xnh=self.xnh, xnl=self.xnl, fingerprint=self.fingerprint,
            **{f: getattr(self, f) for f in self._FIELDS},
        )
        os.replace(tmp + ".npz", path)  # atomic: no torn checkpoints
        if os.path.exists(tmp):
            os.unlink(tmp)

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
        try:
            cand = AlphaBetaDFCheckpoint.load(checkpoint_path)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile, zlib.error):
            cand = None  # unreadable snapshot: fresh run
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
