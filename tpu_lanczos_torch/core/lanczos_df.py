"""Double-word (two-float32) Lanczos: f64-grade e^A.x, in PyTorch.

The port of ``tpu_lanczos/core/lanczos_df.py``.  The whole recurrence
runs in df64 arithmetic (core/df64.py): the SpMV is exact routing plus
compensated tile sums (kernels/spmv_cpg.py ``spmv_cpg_df``, CPG packs
only; on the card one launch of the df level kernel a level), dots and
norms are exact two-products with a two-sum tree,
and the updates are elementwise df ops on (hi, lo) vectors.

It is the same two-pass Q-free scheme as core/lanczos.py: an alpha/beta
pass, host eigh, then a pass that regenerates q_j and accumulates the
answer, so memory stays O(n).  As there, each pass is a Python loop
whose recurrence scalars stay on the device: each step is the df SpMV
and then ``kernels/lanczos_step.py::lanczos_step_df`` (on the card one
cooperative launch of a hand-written kernel, which also does the df
SpMV's realmask multiply as it loads v and folds the answer's
accumulation into its last phase); breakdown is a select on the device,
never a Python branch on a device value.  ``expm_action_df`` is a
``query`` span of ``tpu_lanczos_torch.obs`` (``pass1``, ``fetch_tridiag``,
``eigh``, ``pass2``, ``fetch``, ``to_f64``, ``permute_out``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_lanczos_torch import obs
from tpu_lanczos_torch.core import df64 as df
from tpu_lanczos_torch.core import expmv
from tpu_lanczos_torch.core.pipeline import LanczosResult
from tpu_lanczos_torch.kernels.cpg import CPGGraph, pack_cpg
from tpu_lanczos_torch.kernels.lanczos_step import (
    accum_df_ref, df_norm, lanczos_step_df, workspace)
from tpu_lanczos_torch.kernels.spmv_cpg import spmv_cpg_df


def _alphabeta_df_init(x_hi: torch.Tensor, x_lo: torch.Tensor, work=None):
    """Normalised df64 start state (q0_hi, q0_lo, xn_hi, xn_lo); the norm
    through the step kernel's df dot tree on the card."""
    x = (x_hi, x_lo)
    x_norm = df_norm(x, work)
    inv = df.df_div(df.df_from(1.0, device=x_hi.device), x_norm)
    q0 = df.df_scale(inv, x)
    return q0[0], q0[1], x_norm[0], x_norm[1]


def lanczos_alphabeta_df_range(cg: CPGGraph, carry, j0: int, j1: int):
    """Iterations [j0, j1) of the df64 alpha/beta recurrence on a carry
    ``(qh, ql, ph, pl, ah, al, bh, bl)`` with k-sized coefficient
    buffers.  Writes the buffers in place and returns the new carry; a
    chunked run reproduces the one-shot pass bit for bit (same ops in the
    same order)."""
    qh, ql, ph, pl, ah, al, bh, bl = carry
    work = workspace(qh.device)
    for j in range(j0, j1):
        q_next = lanczos_step_df(spmv_cpg_df(cg, qh, ql, masked=False),
                                 (qh, ql), (ph, pl), (ah, al), (bh, bl), j,
                                 work=work, mask=cg.realmask)
        (ph, pl), (qh, ql) = (qh, ql), q_next
    return qh, ql, ph, pl, ah, al, bh, bl


def _fresh_carry(q0h: torch.Tensor, q0l: torch.Tensor, k: int):
    zk = q0h.new_zeros((k,))
    zv = torch.zeros_like(q0h)
    return (q0h, q0l, zv, zv, zk, zk.clone(), zk.clone(), zk.clone())


def lanczos_alphabeta_df(cg: CPGGraph, x_hi: torch.Tensor,
                         x_lo: torch.Tensor, k: int):
    """Pass 1: df64 alpha and beta, each a (hi, lo) pair of (k,) tensors
    (beta's slot k-1 written but unused), and the df x_norm."""
    q0h, q0l, xnh, xnl = _alphabeta_df_init(x_hi, x_lo)
    carry = lanczos_alphabeta_df_range(cg, _fresh_carry(q0h, q0l, k), 0, k)
    _, _, _, _, ah, al, bh, bl = carry
    return (ah, al), (bh, bl), (xnh, xnl)


def _recombine(cg: CPGGraph, x_hi, x_lo, coeff, k: int, ans):
    """Pass 2's sweep: regenerate q_0..q_{k-1} and fold each into ``ans``
    (in place), ans = df_add(ans, df_scale(coeff[j], q_j)): q_0 here,
    q_{j+1} in step j's last pass.  The recurrence runs k-1 times:
    q_{k-1} needs no further SpMV."""
    work = workspace(x_hi.device)
    q0h, q0l, _, _ = _alphabeta_df_init(x_hi, x_lo, work)
    q, q_prev = (q0h, q0l), (torch.zeros_like(q0h), torch.zeros_like(q0h))
    accum_df_ref(ans, coeff, 0, q)
    ab = tuple(q0h.new_zeros((k,)) for _ in range(4))
    for j in range(k - 1):
        q_next = lanczos_step_df(spmv_cpg_df(cg, *q, masked=False), q,
                                 q_prev, ab[:2], ab[2:], j, ans=ans,
                                 coeff=coeff, work=work, mask=cg.realmask)
        q_prev, q = q, q_next
    return ans


def lanczos_recombine_df(cg: CPGGraph, x_hi, x_lo, coeff_hi, coeff_lo,
                         k: int):
    """Pass 2: ans = sum_j coeff[j] * q_j in df64.  Returns (hi, lo)."""
    ans = (torch.zeros_like(x_hi), torch.zeros_like(x_hi))
    return _recombine(cg, x_hi, x_lo, (coeff_hi, coeff_lo), k, ans)


def lanczos_recombine_df_multi(cg: CPGGraph, x_hi, x_lo, coeff_hi,
                               coeff_lo, k: int):
    """Multi-answer pass 2: ``coeff_*`` is (n_ks, k), row m the
    coefficients for Krylov dimension ks[m], zero past its own k.  One
    sweep accumulates every answer, ans[m] += coeff[m, j] * q_j.
    Returns (hi, lo) of (n_ks, n_pad)."""
    shape = (coeff_hi.shape[0],) + x_hi.shape
    ans = (x_hi.new_zeros(shape), x_hi.new_zeros(shape))
    return _recombine(cg, x_hi, x_lo, (coeff_hi, coeff_lo), k, ans)


def split_f64(a: np.ndarray):
    """Host: float64 array -> (hi, lo) float32 pair, hi + lo == a to
    f32x2 precision."""
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _start_df(dg: CPGGraph, x: np.ndarray | None):
    """Device (hi, lo) start vector.  x=None is the all-ones centrality
    start: exactly the pack's realmask with a zero lo part, so no O(n)
    host->device copy is made."""
    if x is None:
        x_hi = dg.realmask.to(torch.float32)
        return x_hi, torch.zeros_like(x_hi)
    hi, lo = split_f64(dg.permute_in(np.asarray(x, np.float64), np.float64))
    return (torch.from_numpy(hi).to(dg.device),
            torch.from_numpy(lo).to(dg.device))


def _fetch_df(alpha, beta, x_norm):
    """Pass 1's df pairs as float64 host values, in one device->host
    copy: alpha (k,), beta (k,) and x_norm (float)."""
    k = alpha[0].shape[0]
    h = obs.fetch(torch.cat([*alpha, *beta, x_norm[0].reshape(1),
                             x_norm[1].reshape(1)]))
    ah, al, bh, bl = h[:4 * k].reshape(4, k)
    return (df.df_to_f64((ah, al)), df.df_to_f64((bh, bl)),
            float(df.df_to_f64((h[-2], h[-1]))))


def _coeff_df(coeff: np.ndarray, device):
    ch, cl = split_f64(coeff)
    return torch.from_numpy(ch).to(device), torch.from_numpy(cl).to(device)


def expm_action_df(graph, x: np.ndarray | None = None, k: int = 50, *,
                   dg: CPGGraph | None = None, log_scale: bool = False,
                   checkpoint_path: str | None = None,
                   checkpoint_chunk: int = 16, device="cuda"):
    """f64-grade e^A.x: df64 two-pass Lanczos plus host LAPACK eig.

    Returns a :class:`tpu_lanczos_torch.core.pipeline.LanczosResult`
    whose ``ans``, ``alpha`` and ``beta`` are float64 (hi + lo collapsed
    on the host).  ``checkpoint_path`` persists pass 1's O(n) carry every
    ``checkpoint_chunk`` iterations and resumes from a compatible
    snapshot (core/checkpoint.py); pass 2 restarts fresh.  ``device`` is
    where the pack is built when ``dg`` is None."""
    k = int(max(min(k, graph.n - 1), 1))
    if dg is None:
        dg = pack_cpg(graph, device=device)
    with obs.query("expm_action_df", dg.device):
        with obs.span("start", obs.DEVICE):
            x_hi, x_lo = _start_df(dg, x)
        with obs.span("pass1", obs.DEVICE):
            if checkpoint_path is not None:
                from tpu_lanczos_torch.core.checkpoint import (
                    lanczos_alphabeta_df_checkpointed)

                alpha, beta, x_norm = lanczos_alphabeta_df_checkpointed(
                    dg, x_hi, x_lo, k, checkpoint_path=checkpoint_path,
                    chunk=checkpoint_chunk)
            else:
                alpha, beta, x_norm = lanczos_alphabeta_df(dg, x_hi, x_lo, k)
        with obs.span("fetch_tridiag", obs.SYNC):
            alpha64, beta64, xn64 = _fetch_df(alpha, beta, x_norm)
        beta64 = beta64[: k - 1]

        coeff, shift = expmv.host_coefficients(alpha64, beta64, xn64)
        with obs.span("pass2", obs.DEVICE):
            ansh, ansl = lanczos_recombine_df(dg, x_hi, x_lo,
                                              *_coeff_df(coeff, dg.device), k)
        # both halves of the answer, then their sum in float64
        with obs.span("fetch", obs.SYNC):
            ansh, ansl = obs.fetch(ansh), obs.fetch(ansl)
        with obs.span("to_f64", obs.HOST):
            ans64 = df.df_to_f64((ansh, ansl))
            if not log_scale:
                ans64 = ans64 * np.exp(shift)
        with obs.span("permute_out", obs.HOST):
            ans64 = dg.permute_out(ans64)
        return LanczosResult(
            ans=ans64, log_scale=float(shift) if log_scale else None,
            alpha=alpha64, beta=beta64, x_norm=xn64, k=k,
        )


def expm_action_ks_df(graph, ks, x: np.ndarray | None = None, *,
                      dg: CPGGraph | None = None, log_scale: bool = False,
                      device="cuda"):
    """df64 answers for every requested Krylov dimension from one
    decomposition: one alpha/beta pass and one multi-answer recombine
    pass.  Returns ``(results, diffs)``: ``results[k]`` a LanczosResult
    (float64 host arrays), ``diffs[k] = ||ans_k - ans_kmax|| /
    ||ans_kmax||`` on a common log-scale shift."""
    ks = sorted({max(min(int(k), graph.n - 1), 1) for k in ks})
    k_max = ks[-1]
    if dg is None:
        dg = pack_cpg(graph, device=device)
    x_hi, x_lo = _start_df(dg, x)
    alpha, beta, x_norm = lanczos_alphabeta_df(dg, x_hi, x_lo, k_max)
    alpha64, beta64, xn64 = _fetch_df(alpha, beta, x_norm)

    coeff = np.zeros((len(ks), k_max), np.float64)
    shifts = {}
    for m, k in enumerate(ks):
        c, shift = expmv.host_coefficients(alpha64[:k], beta64[: k - 1],
                                           xn64)
        coeff[m, :k] = c
        shifts[k] = float(shift)
    ansh, ansl = lanczos_recombine_df_multi(
        dg, x_hi, x_lo, *_coeff_df(coeff, dg.device), k_max)
    ansh, ansl = ansh.cpu().numpy(), ansl.cpu().numpy()
    results = {}
    for m, k in enumerate(ks):
        ans64 = df.df_to_f64((ansh[m], ansl[m]))
        if not log_scale:
            ans64 = ans64 * np.exp(shifts[k])
        results[k] = LanczosResult(
            ans=dg.permute_out(ans64),
            log_scale=shifts[k] if log_scale else None,
            alpha=alpha64[:k], beta=beta64[: k - 1], x_norm=xn64, k=k,
        )
    ref = results[k_max].ans
    ref_norm = np.linalg.norm(ref)
    diffs = {}
    for k in ks:
        a = results[k].ans
        if log_scale:
            a = a * np.exp(shifts[k] - shifts[k_max])
        diffs[k] = float(np.linalg.norm(a - ref) / ref_norm)
    return results, diffs
