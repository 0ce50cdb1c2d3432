"""Europe-OSM-scale df64 on one GPU: n=50.9M, f64-grade, restartable.

The port of ``tpu_lanczos/eval/europe_df64.py``.  The reference CUDA
code's largest run was EuropeOSM (n=50,893,956) at k=20 only, double
precision, via the 2-column streaming-Q design after the full-Q version
spilled host RAM into swap (writeup §9.1-9.2).  This runs the SAME scale
(a 7134 x 7134 stencil) at k=50 in df64 through the two-pass Q-free
pipeline (the df level kernel, O(n) device memory), plus:

- df64 k-self-consistency ||ans_50 - ans_60|| / ||ans_60|| from one
  multi-answer decomposition (the reference's Table-5 metric);
- the pass-1 checkpoint (core/checkpoint.py
  lanczos_alphabeta_df_checkpointed) at full scale, including a resume
  from the penultimate snapshot, which must give alpha and beta bit for
  bit.

Run: ``python -m tpu_lanczos_torch.eval.europe_df64 [--side 7134]
[--device cuda]``: JSON lines out.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

SIDE = 7134  # 7134^2 = 50,893,956 = EuropeOSM's exact node count


def run(side: int = SIDE, k: int = 50, cache_dir: str = ".bench_cache",
        ckpt_chunk: int = 25, device="cuda") -> list[dict]:
    """The three studies on the ``side`` x ``side`` stencil; returns their
    rows (each also printed as one JSON line)."""
    from tpu_lanczos_torch.core.checkpoint import (
        AlphaBetaDFCheckpoint, lanczos_alphabeta_df_checkpointed)
    from tpu_lanczos_torch.core.lanczos_df import (
        expm_action_df, expm_action_ks_df)
    from tpu_lanczos_torch.eval.bench_suite import build, load_or_pack

    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    cfg = dict(name=f"europe_{side}", kind="stencil", side=side)
    os.makedirs(cache_dir, exist_ok=True)
    t0 = time.perf_counter()
    g = build(cfg, cache_dir)
    t_build = time.perf_counter() - t0
    dg, t_pack = load_or_pack(cfg, g, cache_dir, device)
    base = dict(n=g.n, nnz=g.nnz, k=k, backend=dg.device.type,
                sub=dg.sub, n_chunks=dg.n_chunks, build_s=t_build,
                pack_s=t_pack)

    # the whole df64 pipeline (one warm call first)
    expm_action_df(g, None, k, dg=dg, log_scale=True)
    t0 = time.perf_counter()
    r = expm_action_df(g, None, k, dg=dg, log_scale=True)
    t_whole = time.perf_counter() - t0
    emit(dict(base, study="europe_df64_whole", whole_s=t_whole,
              ans_norm=float(np.linalg.norm(r.ans)),
              log_scale=float(r.log_scale),
              note="two-pass Q-free df64, one GPU, O(n) device memory; "
                   "the reference ran this scale at k=20 f64 via "
                   "streaming-Q"))
    del r

    # self-consistency k against k+10 from ONE decomposition
    t0 = time.perf_counter()
    _, diffs = expm_action_ks_df(g, [k, k + 10], dg=dg, log_scale=True)
    emit(dict(base, study="europe_df64_self_consistency",
              rel_diff=diffs[k], vs_k=k + 10,
              wall_s=time.perf_counter() - t0))

    # the checkpointed pass 1 at full scale, and a genuine resume
    x_hi = dg.realmask.reshape(-1).to(torch.float32)
    x_lo = torch.zeros_like(x_hi)
    ckpt = os.path.join(cache_dir, f"europe_df64_ck_{side}.npz")
    mid_path = ckpt + ".mid.npz"
    for p in (ckpt, mid_path):
        if os.path.exists(p):
            os.unlink(p)
    try:
        t0 = time.perf_counter()
        a1, b1, _ = lanczos_alphabeta_df_checkpointed(
            dg, x_hi, x_lo, k, checkpoint_path=ckpt, chunk=ckpt_chunk)
        t_ck = time.perf_counter() - t0
        snap = AlphaBetaDFCheckpoint.load(ckpt)
        snap_mb = sum(getattr(snap, f).nbytes
                      for f in AlphaBetaDFCheckpoint._FIELDS) / 1e6
        ck = dict(base, study="europe_df64_checkpoint",
                  ckpt_chunk=ckpt_chunk, pass1_checkpointed_s=t_ck,
                  snapshot_mb=snap_mb)
        # rewind to the penultimate snapshot boundary and resume (skipped
        # when the run fits in one chunk: there is no mid-run state)
        j_mid = (-(-k // ckpt_chunk) - 1) * ckpt_chunk
        if j_mid <= 0:
            emit(dict(ck, note="single-chunk run: no mid-run snapshot to "
                               "resume from"))
            return rows
        lanczos_alphabeta_df_checkpointed(
            dg, x_hi, x_lo, j_mid, checkpoint_path=mid_path,
            chunk=ckpt_chunk)
        mid = AlphaBetaDFCheckpoint.load(mid_path)
        mid.k = k
        for f in ("ah", "al", "bh", "bl"):
            setattr(mid, f, np.pad(getattr(mid, f), (0, k - j_mid)))
        # the fingerprint embeds k: take the full-k run's
        mid.fingerprint = snap.fingerprint
        mid.save(ckpt)
        t0 = time.perf_counter()
        a2, b2, _ = lanczos_alphabeta_df_checkpointed(
            dg, x_hi, x_lo, k, checkpoint_path=ckpt, chunk=ckpt_chunk)
        t_resume = time.perf_counter() - t0
        identical = all(torch.equal(u, v)
                        for u, v in zip(a1 + b1, a2 + b2))
        emit(dict(ck, resume_from_j=j_mid, resume_s=t_resume,
                  resume_bit_identical=identical))
    finally:
        for p in (ckpt, mid_path):
            if os.path.exists(p):
                os.unlink(p)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=SIDE)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--cache", default=".bench_cache")
    ap.add_argument("--ckpt-chunk", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from tpu_lanczos_torch.utils import enable_heap_reuse

    enable_heap_reuse()
    run(args.side, args.k, args.cache, args.ckpt_chunk, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
