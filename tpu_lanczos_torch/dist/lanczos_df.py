"""Row-sharded df64 Lanczos: f64-grade e^A.x over a mesh.

The port of ``tpu_lanczos/dist/lanczos_df.py``: the two-pass Q-free df64
scheme of core/lanczos_df.py on the row mesh, with

- the sharded CPG SpMV in compensated arithmetic: every level of a
  shard is one launch of the df64 shard kernel (``run_shard_level_df``):
  one walk of its tiles two-sums the hi stream (kernel 1c's sum, with its
  error stream) and adds the lo stream (kernel 1's), and the same launch
  folds the level into the shard's (y, e) pair and, on its last level,
  finishes the (hi, lo) pair: the single-device ``spmv_cpg_df`` structure
  per shard, with the exchanges carrying BOTH streams and no elementwise
  op between the launches;
- cross-shard dots done exactly in df arithmetic: each shard's df dot
  (hi, lo) pair goes to its slot (``Mesh.slots``, 2 floats a shard) and
  the pass that needs the sum folds the slots with ``df_add`` in shard
  order, the reference's ``_df_allsum``.  A plain psum of hi and lo
  separately would round the hi partials and lose the compensation;
- the main level's own/cross-source overlap split of the sharded pack,
  both passes walked in the main level's one launch;
- the step after the SpMV (the reference's ``_body_core_sh``,
  lanczos_df.py:171-188) on row 5cd's pass kernels
  (kernels/lanczos_step.py): a df dot pass on every held shard (the SpMV's
  realmask multiply folded in), an update pass that folds the dot slots
  and writes the shard's df norm, a normalize pass that folds the norm
  slots (in pass 2 folding the recombine's ``ans``), nothing between them
  when the shards share a device; the start norm is the df dot pass too.

Every operation keeps the reference's order, and every df op outside
the kernels is a chain of separate eager torch ops (core/df64.py), so no
multiply is fused into an add.  A level with no tiles on a shard is not
run there: its fold would add zeros to a pair whose e is already NaN
wherever y is not finite, and which is never -0.0.  The cross-shard fold
changes the order of summation, so results differ from single-device
df64 at the df roundoff level, not above it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_lanczos_torch.core import df64 as df
from tpu_lanczos_torch.core import expmv
from tpu_lanczos_torch.core.lanczos_df import split_f64
from tpu_lanczos_torch.core.pipeline import LanczosResult
from tpu_lanczos_torch.dist.cpg_sharded import (
    ShardedCPG, _exchange, _main_exchange, _main_walks, _reduce_levels,
    pack_cpg_sharded)
from tpu_lanczos_torch.dist.mesh import (Mesh, StepBuffers, make_mesh,
                                         one_stream, per_replica,
                                         step_buffers)
from tpu_lanczos_torch.kernels import lanczos_step as ls
from tpu_lanczos_torch.kernels.spmv_cpg import (run_shard_level_df,
                                                run_shard_level_df_ref)


def _local_spmv_df(sg: ShardedCPG, mesh: Mesh, q: list, df_fn,
                   masked: bool = True) -> list:
    """Every held shard's df y = A (q_hi + q_lo) (q a per-shard list of
    (hi, lo) pairs): the reference's per-shard body (lanczos_df.py:64-169)
    in its order of additions, each level of a shard one call of
    ``df_fn`` (``run_shard_level_df`` or its plain version): the main
    level's walks, then each reduce level the shard has tiles on, folded
    into its (y, e) pair, the last one finishing the (hi, lo) pair.  Each
    call keeps (y, e) while a later level's exchange reads them.  With
    ``masked=False`` the last multiply of hi and lo by the realmask is
    left out, for the step's passes to fold in."""
    c_loc, sub = sg.c_loc, sg.sub
    q_hi = [p[0] for p in q]
    q_lo = [p[1] for p in q]
    g_hi = _main_exchange(sg, mesh, q_hi)
    g_lo = _main_exchange(sg, mesh, q_lo)
    reduce = _reduce_levels(sg)
    # the level each held shard finishes on (0: its main level)
    last = [max((li for li in reduce if sg.shard_tiles[li][s]), default=0)
            for s in mesh.shards]
    masks = [r if masked else None for r in sg.realmask]
    ye, out = [], []
    for i, s in enumerate(mesh.shards):
        walks = [(lv, hi, lo) for (lv, hi), (_, lo) in zip(
            _main_walks(sg, s, i, q_hi[i], g_hi[i]),
            _main_walks(sg, s, i, q_lo[i], g_lo[i]))]
        pair, fin = df_fn(walks, c_loc, sub, keep=bool(reduce),
                          finish=last[i] == 0, mask=masks[i])
        ye.append(pair)
        out.append(fin)
    for n, li in enumerate(reduce):
        # the compact reduce-level exchange, of BOTH partial streams
        level = sg.levels[li]
        b_y = _exchange(sg, mesh, level, [p[0] for p in ye], "sel")
        b_e = _exchange(sg, mesh, level, [p[1] for p in ye], "sel")
        for i, s in enumerate(mesh.shards):
            if sg.shard_tiles[li][s]:
                pair, fin = df_fn([(level[i], (b_y[i],), (b_e[i],))], c_loc,
                                  sub, base=ye[i],
                                  keep=n + 1 < len(reduce),
                                  finish=last[i] == li, mask=masks[i])
                ye[i] = pair
                out[i] = fin if fin is not None else out[i]
    return out


def spmv_cpg_df_sharded(sg: ShardedCPG, mesh: Mesh, q_hi: list,
                        q_lo: list) -> list:
    """Double-word y = A (q_hi + q_lo) on the mesh, every shard level
    through ``run_shard_level_df``.  Returns the per-shard list of (hi,
    lo) float32 pairs."""
    return _local_spmv_df(sg, mesh, list(zip(q_hi, q_lo)),
                          run_shard_level_df)


def spmv_cpg_df_sharded_ref(sg: ShardedCPG, mesh: Mesh, q_hi: list,
                            q_lo: list) -> list:
    """The same df SpMV through the plain versions on any device."""
    return _local_spmv_df(sg, mesh, list(zip(q_hi, q_lo)),
                          run_shard_level_df_ref)


def _step_df(sg: ShardedCPG, mesh: Mesh, q: list, q_prev: list, ss_prev,
             bufs: StepBuffers, j: int, alpha=None, beta=None, ans=None,
             coeff=None):
    """One df64 recurrence step on the mesh, the sharded twin of
    kernels/lanczos_step.py ``lanczos_step_df_ref`` with exact-fold dots:
    the df SpMV without its realmask multiply, then row 5cd's passes on
    every held shard, each consuming pass folding the slots the passes
    before it wrote.  The first held shard's passes write (alpha)[j] and
    (beta)[j] (pairs of (k,) buffers) when given; with ``ans`` (per-shard
    pairs) and ``coeff`` (per-shard pairs of (k,)), ans += coeff[j + 1]
    q_{j+1}.  Returns (q_{j+1}, the norm slots) as per-shard lists;
    ``ss_prev`` is the last step's (None at j = 0)."""
    n = len(q)
    v = _local_spmv_df(sg, mesh, q, run_shard_level_df, masked=False)
    for vs, qs, r, w, d, s in zip(v, q, sg.realmask, bufs.work, bufs.dot,
                                  mesh.shards):
        ls.shard_df_dot(vs, qs, mask=r, work=w, slots=d, shard=s,
                        early=True)
    a = mesh.gather_slots(bufs.dot)
    norm = bufs.norm[j % 2]
    first = [s == 0 for s in range(n)]
    upd = [ls.shard_df_update(vs, qs, qp, av, sv, mask=r,
                              alpha=alpha if f else None, j=j, work=w,
                              slots=nb, shard=s, early=True)
           for vs, qs, qp, av, sv, r, f, w, nb, s in zip(
               v, q, q_prev, a, ss_prev or [None] * n, sg.realmask, first,
               bufs.work, norm, mesh.shards)]
    ss = mesh.gather_slots(norm)
    q_next = [ls.shard_df_normalize(u[0], sv, beta=beta if f else None, j=j,
                                    ans=an, coeff=cf, early=one_stream(mesh))
              for u, sv, f, an, cf in zip(upd, ss, first, ans or [None] * n,
                                          coeff or [None] * n)]
    return q_next, ss


def _df_start(mesh: Mesh, x: list, bufs: StepBuffers):
    """The normalised df start state: per-shard q0 pairs and the df
    x_norm (replicated); the shards' df dots on row 5cd's dot pass into
    the dot slots, folded as the reference's ``_df_allsum``."""
    for xs, w, d, s in zip(x, bufs.work, bufs.dot, mesh.shards):
        ls.shard_df_dot(xs, xs, work=w, slots=d, shard=s)
    x_norm = per_replica(mesh.gather_slots(bufs.dot), lambda g: df.df_sqrt(
        ls.fold_df_slots_ref(g)))
    q0 = [df.df_scale(df.df_div(df.df_from(1.0, device=xn[0].device), xn),
                      xs) for xn, xs in zip(x_norm, x)]
    return q0, x_norm


def _zero_vectors(q: list) -> list:
    return [(torch.zeros_like(p[0]), torch.zeros_like(p[0])) for p in q]


def lanczos_alphabeta_df_sharded(sg: ShardedCPG, mesh: Mesh, x: list,
                                 k: int):
    """Pass 1 on the mesh: df64 alpha and beta, each a (hi, lo) pair of
    (k,) tensors on the first held shard's device (beta's slot k-1
    written but unused), and the df x_norm.  ``x`` is the per-shard list
    of (hi, lo) pairs."""
    bufs = step_buffers(mesh, torch.float32, (2,))
    q, x_norm = _df_start(mesh, x, bufs)
    q_prev = _zero_vectors(q)
    zk = q[0][0].new_zeros((k,))
    alpha, beta = (zk, zk.clone()), (zk.clone(), zk.clone())
    ss = None
    for j in range(k):
        q_next, ss = _step_df(sg, mesh, q, q_prev, ss, bufs, j, alpha, beta)
        q_prev, q = q, q_next
    return alpha, beta, x_norm[0]


def lanczos_recombine_df_sharded(sg: ShardedCPG, mesh: Mesh, x: list,
                                 coeff_hi: torch.Tensor,
                                 coeff_lo: torch.Tensor, k: int) -> list:
    """Pass 2 on the mesh: ans = sum_j coeff[j] * q_j in df64, q_j
    regenerated by the identical recurrence (k-1 steps: q_{k-1} needs no
    further SpMV), each step's normalize pass folding in coeff[j + 1]
    q_{j+1}.  Returns the per-shard (hi, lo) pairs."""
    bufs = step_buffers(mesh, torch.float32, (2,))
    q, _ = _df_start(mesh, x, bufs)
    q_prev = _zero_vectors(q)
    coeff = list(zip(mesh.replicate(coeff_hi), mesh.replicate(coeff_lo)))
    ans = [df.df_add(z, df.df_scale((c[0][0], c[1][0]), qs))
           for z, c, qs in zip(_zero_vectors(q), coeff, q)]
    ss = None
    for j in range(k - 1):
        q_next, ss = _step_df(sg, mesh, q, q_prev, ss, bufs, j, ans=ans,
                              coeff=coeff)
        q_prev, q = q, q_next
    return ans


def expm_action_df_sharded(graph, x: np.ndarray | None = None,
                           k: int = 50, *, n_shards: int | None = None,
                           mesh: Mesh | None = None,
                           sg: ShardedCPG | None = None,
                           log_scale: bool = False, device: str = "cuda",
                           **pack_kw) -> LanczosResult:
    """f64-grade e^A.x row-sharded over ``n_shards`` devices (``mesh``;
    default ``make_mesh(n_shards, device=device)``, on the GPUs): the
    df64 two-pass Lanczos on the mesh and a host LAPACK eigensolve
    between the passes.  Returns a LanczosResult with float64 host
    arrays."""
    k = int(max(min(k, graph.n - 1), 1))
    if mesh is None:
        mesh = make_mesh(n_shards, device=device)
    if sg is None:
        sg = pack_cpg_sharded(graph, mesh.n_shards, mesh=mesh, **pack_kw)
    if x is None:
        # the all-ones start: the pack's realmask, lo part zero
        x_hi = [r.to(torch.float32) for r in sg.realmask]
        x_lo = [torch.zeros_like(t) for t in x_hi]
    else:
        hi, lo = split_f64(sg.permute_in(np.asarray(x, np.float64),
                                         np.float64))
        x_hi, x_lo = mesh.split(hi, sg.n_loc), mesh.split(lo, sg.n_loc)
    xs = list(zip(x_hi, x_lo))

    (ah, al), (bh, bl), (xh, xl) = lanczos_alphabeta_df_sharded(
        sg, mesh, xs, k)
    h = torch.cat([ah, al, bh, bl, xh.reshape(1), xl.reshape(1)])
    h = h.cpu().numpy()  # the one fetch of pass 1's coefficients
    ah, al, bh, bl = h[:4 * k].reshape(4, k)
    alpha64 = df.df_to_f64((ah, al))
    beta64 = df.df_to_f64((bh, bl))[: k - 1]
    xn64 = float(df.df_to_f64((h[-2], h[-1])))

    coeff, shift = expmv.host_coefficients(alpha64, beta64, xn64)
    ch, cl = split_f64(coeff)
    dev = x_hi[0].device
    ans = lanczos_recombine_df_sharded(
        sg, mesh, xs, torch.from_numpy(ch).to(dev),
        torch.from_numpy(cl).to(dev), k)
    ans64 = df.df_to_f64((mesh.to_host([a[0] for a in ans]),
                          mesh.to_host([a[1] for a in ans])))
    if not log_scale:
        ans64 = ans64 * np.exp(shift)
    return LanczosResult(
        ans=sg.permute_out(ans64),
        log_scale=float(shift) if log_scale else None,
        alpha=alpha64, beta=beta64, x_norm=xn64, k=k,
    )
