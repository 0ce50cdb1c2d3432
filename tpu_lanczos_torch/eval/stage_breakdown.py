"""Whole-pipeline stage breakdown of the e^A.x query, on the GPU.

The port of ``tpu_lanczos/eval/stage_breakdown.py``.  The reference CUDA
code commits a per-stage table for every benchmark (lanczos / eigen /
multiply-out, parallel-final/main.cu:134-150 printed into
final_output1.txt); this splits the whole e^A.x pipeline of
``expm_action`` into stages, each fenced by ``profiling.StageTimer``
(a synchronize of the device at entry and exit), so the whole-query
number is explained, not just asserted:

  lanczos      k-step decomposition (kernel 1 per level per step)
  fetch_small  one device->host copy of (alpha, beta, x_norm)
  eig          host LAPACK tridiagonal eigensolve (k x k, float64)
  coeff        tmp = V (e^(L-s) * ||x|| * V[0,:])  (host, k-length)
  gemv         ans = tmp @ Q on the device (tmp's host->device copy in it)
  d2h_ans      full n-vector device->host transfer
  permute_out  undo the pack's row permutation (host numpy)

Beside the stages: ``whole_s``, the public ``expm_action`` call's host
wall, and ``pipelined_s``, the per-query wall of
``expm_action_pipelined`` (query i's answer copy overlapped with query
i+1's Lanczos).

Run: ``python -m tpu_lanczos_torch.eval.stage_breakdown [--reps 5]
[--k 50] [--config ba_1M_m10] [--device cuda]``.  Prints the stage
table on stderr plus one JSON study line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

STAGES = ("lanczos", "fetch_small", "eig", "coeff", "gemv", "d2h_ans",
          "permute_out")
# the reference CUDA code's 'Entire algorithm' seconds on bn1M
# (final_output1.txt:20 at k=50, and its k=100 run); ``breakdown`` names
# bn1M's stand-ins "ba_1M_m10" (the suite's) and "bn1M" (bench.py's)
REF_WHOLE_S = {50: 0.455634, 100: 0.892726}
BN1M_NAMES = ("ba_1M_m10", "bn1M")


def breakdown(g, dg=None, k: int = 50, reps: int = 5, device="cuda", *,
              name: str = "ba_1M_m10", dtype="float32"):
    """Stage medians of ``reps`` runs of the e^A.1 query on ``dg`` (a CPG
    pack; packed with defaults on ``device`` when None), ``whole_s`` and
    ``pipelined_s``.  Returns ``(row, ans, shift)``: the JSON study row
    and the last staged answer (permuted out, log-scaled: e^A.1 = ans *
    e^shift)."""
    from tpu_lanczos_torch.core import expmv, tridiag
    from tpu_lanczos_torch.core.lanczos import lanczos
    from tpu_lanczos_torch.core.pipeline import (
        expm_action, expm_action_pipelined)
    from tpu_lanczos_torch.eval.profiling import StageTimer, wait
    from tpu_lanczos_torch.kernels.cpg import pack_cpg
    from tpu_lanczos_torch.utils import numpy_dtype, torch_dtype

    if dg is None:
        dg = pack_cpg(g, device=device)
    dt = torch_dtype(dtype)
    x = dg.realmask.reshape(-1).to(dt)
    runs = 0  # Lanczos decompositions run here

    # warm-up.  log_scale: e^shift overflows float32 on this graph class
    # (lambda_max >> 88); the production path keeps the answer scaled
    # (the reference CUDA code's own f32 run NaN'd here,
    # output/single_double.txt:27-31)
    r = expm_action(g, None, k, dtype=dtype, dg=dg, log_scale=True)
    runs += 1
    if not np.all(np.isfinite(r.ans[:8])):
        raise RuntimeError("non-finite warm-up answer")

    samples = {s: [] for s in STAGES}
    for _ in range(reps):
        t = StageTimer()
        with t.stage("lanczos", x) as st:
            state = lanczos(dg, x, k)
            st.fence(state)
        runs += 1
        with t.stage("fetch_small"):
            alpha_h, beta_h, x_norm_h = expmv.fetch_tridiag(
                state.alpha, state.beta, state.x_norm)
        with t.stage("eig"):
            evals, evecs = tridiag.eigh_host(alpha_h, beta_h)
        with t.stage("coeff"):
            tmp, shift = expmv.coefficients(evals, evecs, x_norm_h)
        with t.stage("gemv", state.q_basis) as st:
            # log-scale form: the e^shift factor is carried apart, as in
            # expm_action(log_scale=True)
            coeff = torch.from_numpy(tmp.astype(numpy_dtype(dt))).to(
                dg.device)
            ans_dev = coeff @ state.q_basis
            st.fence(ans_dev)
        with t.stage("d2h_ans"):
            ans_h = ans_dev.cpu().numpy()
        with t.stage("permute_out"):
            ans = dg.permute_out(ans_h)
        for s in STAGES:
            samples[s].append(t.stages[s])
        del state, ans_dev
    med = {s: float(np.median(v)) for s, v in samples.items()}
    total = sum(med.values())
    print(f"{'stage':12} {'median_s':>9} {'%':>6}", file=sys.stderr)
    for s, v in med.items():
        print(f"{s:12} {v:9.4f} {100*v/total:6.1f}", file=sys.stderr)
    print(f"{'sum':12} {total:9.4f}", file=sys.stderr)
    # the staged answer against the public call's (the warm-up run), on
    # a common log-scale
    a = ans.astype(np.float64) * np.exp(float(shift) - r.log_scale)
    b = r.ans.astype(np.float64)
    staged_rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))

    # the end-to-end number: the public expm_action call, one synchronized
    # query each (its answer comes back to the host), median of reps
    e2e = []
    for _ in range(reps):
        wait(x)
        t0 = time.perf_counter()
        expm_action(g, None, k, dtype=dtype, dg=dg, log_scale=True)
        e2e.append(time.perf_counter() - t0)
        runs += 1
    whole_s = float(np.median(e2e))

    # pipelined serving: query i's answer copy (a side stream into pinned
    # memory) overlaps query i+1's Lanczos, the analog of the reference
    # CUDA code streaming Q columns to the host during the decompose loop
    # (parallel-final/lib/cu_lanczos.cu:126)
    n_pipe = max(reps, 3)
    batches = []
    for _ in range(3):
        wait(x)
        t0 = time.perf_counter()
        rs = expm_action_pipelined(g, [None] * n_pipe, k, dtype=dtype,
                                   dg=dg, log_scale=True)
        batches.append((time.perf_counter() - t0) / n_pipe)
        runs += n_pipe
        if len(rs) != n_pipe or not np.isfinite(rs[-1].ans[0]):
            raise RuntimeError("pipelined serving lost a query")
        del rs
    # batch 0 pays the first touch of the pinned answer buffers; the
    # steady-state throughput is the median of the warm batches
    pipelined_s = float(np.median(batches[1:]))
    print("pipelined batches s/query: "
          + " ".join(f"{b:.4f}" for b in batches), file=sys.stderr)

    ref_whole = REF_WHOLE_S.get(k) if name in BN1M_NAMES else None
    row = dict(
        study=f"{name}_stage_breakdown_k{k}",
        device=(torch.cuda.get_device_name(dg.device)
                if dg.device.type == "cuda" else "cpu"),
        dtype=str(dt).replace("torch.", ""),
        stages_s=med,
        staged_sum_s=total,
        whole_s=whole_s,
        pipelined_s=pipelined_s,
        pipelined_batches_s=batches,
        pipeline_depth=n_pipe,
        staged_vs_expm_rel=staged_rel,
        lanczos_runs=runs,
        # only bn1M has a published 'Entire algorithm' reference time
        ref_cuda_whole_s=ref_whole,
        vs_ref=ref_whole / whole_s if ref_whole else None,
        vs_ref_pipelined=ref_whole / pipelined_s if ref_whole else None,
        note=(f"median of {reps}; stages fenced by device synchronizes; "
              "whole_s = public expm_action end to end (host eig, answer "
              "copied back); pipelined_s = per-query wall of "
              "expm_action_pipelined, batch 0 dropped"),
    )
    return row, ans, float(shift)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--config", default="ba_1M_m10")
    ap.add_argument("--cache", default=".bench_cache")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpu_lanczos_torch.eval.bench_suite import CONFIGS, build, load_or_pack
    from tpu_lanczos_torch.utils import enable_heap_reuse

    enable_heap_reuse()
    cfg = next(c for c in CONFIGS if c["name"] == args.config)
    g = build(cfg, args.cache)
    dg, _ = load_or_pack(cfg, g, args.cache, args.device)
    row, _, _ = breakdown(g, dg, args.k, args.reps, args.device,
                          name=args.config)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
