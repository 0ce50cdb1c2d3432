"""Per-class df64 accuracy on the GPU: one row per suite config.

The port of ``tpu_lanczos/eval/df_accuracy_suite.py``.  The reference
CUDA code committed an f64 CUDA-vs-serial rel-norm for EVERY graph it
benchmarked (parallel-final/output/final_output1.txt:31,63,95,127,223,
255,287: 3e-16..9e-13).  The suite's rel_err column is f32; this runner
gives the f64-grade twin for every class, on the df level kernel:

- n <= bench_suite.ORACLE_N_MAX: the df64 pipeline
  (core/lanczos_df.expm_action_df) against the host f64 oracle, on the
  oracle's shifted scale (finite even when e^lambda_max overflows f64),
  reusing the suite's cached oracle answers (same file key);
- larger classes (no affordable f64 oracle): df64 k-self-consistency
  ||ans_k - ans_{k+10}|| / ||ans_{k+10}|| from ONE multi-answer df64
  decomposition (expm_action_ks_df), the reference's own Table-5
  convergence metric at df64 precision.

Run: ``python -m tpu_lanczos_torch.eval.df_accuracy_suite [--k 50]
[--only X] [--device cuda]``: one JSON line per class.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def run_one(cfg, k: int, cache_dir: str, device="cuda") -> dict:
    """One class's row (graph and pack from the suite's caches)."""
    from tpu_lanczos_torch.core.lanczos_df import (
        expm_action_df, expm_action_ks_df)
    from tpu_lanczos_torch.eval import bench_suite

    t0 = time.perf_counter()
    g = bench_suite.build(cfg, cache_dir)
    t_build = time.perf_counter() - t0
    dg, t_pack = bench_suite.load_or_pack(cfg, g, cache_dir, device)
    row = dict(name=cfg["name"], n=g.n, nnz=g.nnz, k=k,
               backend=dg.device.type, build_s=t_build, pack_s=t_pack)

    if g.n <= bench_suite.ORACLE_N_MAX:
        t0 = time.perf_counter()
        ref, s_ref = bench_suite.oracle_answer(cfg, g, k, cache_dir)
        t_oracle = time.perf_counter() - t0
        t0 = time.perf_counter()
        rdf = expm_action_df(g, None, k, dg=dg, log_scale=True)
        t_df = time.perf_counter() - t0
        a = rdf.ans * np.exp(float(rdf.log_scale) - s_ref)
        err = float(np.linalg.norm(a - ref) / np.linalg.norm(ref))
        row.update(pipeline="df64_two_pass", df64_rel_err=err,
                   err_ref="oracle_f64_shifted", oracle_s=t_oracle,
                   df64_s=t_df)
    else:
        t0 = time.perf_counter()
        _, diffs = expm_action_ks_df(g, [k, k + 10], dg=dg, log_scale=True)
        t_df = time.perf_counter() - t0
        row.update(pipeline="df64_two_pass", df64_rel_err=diffs[k],
                   err_ref=f"df64_self_k{k + 10}", df64_s=t_df)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--only", default=None,
                    help="substring filter on config names")
    ap.add_argument("--cache", default=".bench_cache")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpu_lanczos_torch.eval.bench_suite import CONFIGS
    from tpu_lanczos_torch.utils import enable_heap_reuse

    enable_heap_reuse()
    os.makedirs(args.cache, exist_ok=True)
    for cfg in CONFIGS:
        if args.only and args.only not in cfg["name"]:
            continue
        row = run_one(cfg, args.k, args.cache, args.device)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
