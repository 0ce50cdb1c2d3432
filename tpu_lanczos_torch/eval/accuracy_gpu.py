"""GPU accuracy record: the f32 and df64 two-pass pipelines against the
f64 oracle.

The counterpart of ``tpu_lanczos/eval/accuracy_tpu.py``, renamed because
the record is now the H100's.  The reference CUDA code's accuracy record
is its CUDA-vs-serial rel-norm at f64, 3e-16..9e-13
(parallel-final/output/final_output1.txt:31,63,95); the north-star target
is <= 1e-10 (BASELINE.json).  This measures, on the device the pack lives
on, the end-to-end relative error of

- the f32 two-pass pipeline (``expm_action(..., low_mem=True)``, kernel
  1), and
- the df64 double-word pipeline (``core.lanczos_df.expm_action_df``,
  the df level kernel, one launch a level)

against the host float64 oracle (eval/oracle.py), on the oracle's
shifted scale, plus the wall of each.

Run: ``python -m tpu_lanczos_torch.eval.accuracy_gpu [--n 1000000]
[--m 10] [--k 50] [--device cuda]``: one JSON line per pipeline.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def run(g, dg, k: int = 50, ref=None, shift=None) -> list[dict]:
    """The two pipelines on ``dg`` (one warm call, then one timed), each
    against the shifted oracle answer ``(ref, shift)`` (e^A.1 = ref *
    e^shift), computed here when ``ref`` is None.  Returns the two rows."""
    from tpu_lanczos_torch.core.lanczos_df import expm_action_df
    from tpu_lanczos_torch.core.pipeline import expm_action
    from tpu_lanczos_torch.eval import oracle

    t_oracle = None
    if ref is None:
        t0 = time.perf_counter()
        ref, shift = oracle.expm_action_shifted(g, np.ones(g.n), k)
        t_oracle = time.perf_counter() - t0
    base = dict(backend=dg.device.type,
                device=(torch.cuda.get_device_name(dg.device)
                        if dg.device.type == "cuda" else "cpu"),
                n=g.n, nnz=g.nnz, k=k, oracle_s=t_oracle)
    rows = []
    # f32 two-pass, compared on the oracle's SHIFTED scale: full_ans()
    # forms e^shift in f32 and overflows past lambda_max ~ 88
    expm_action(g, None, k, dg=dg, low_mem=True, log_scale=True)
    t0 = time.perf_counter()
    r32 = expm_action(g, None, k, dg=dg, low_mem=True, log_scale=True)
    t32 = time.perf_counter() - t0
    a32 = r32.ans.astype(np.float64) * np.exp(float(r32.log_scale) - shift)
    rows.append(dict(base, pipeline="f32_two_pass", wall_s=t32,
                     rel_err=oracle.rel_error(a32, ref)))
    # df64 two-pass (same shifted-scale compare)
    expm_action_df(g, None, k, dg=dg, log_scale=True)
    t0 = time.perf_counter()
    rdf = expm_action_df(g, None, k, dg=dg, log_scale=True)
    tdf = time.perf_counter() - t0
    adf = rdf.ans * np.exp(float(rdf.log_scale) - shift)
    rows.append(dict(base, pipeline="df64_two_pass", wall_s=tdf,
                     rel_err=oracle.rel_error(adf, ref)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default=".bench_cache")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpu_lanczos_torch.eval.bench_suite import flagship_pack, load_graph
    from tpu_lanczos_torch.utils import enable_heap_reuse

    enable_heap_reuse()
    g = load_graph(args.n, args.m, args.seed, args.cache)
    dg, _ = flagship_pack(g, args.n, args.m, args.seed, args.cache,
                          args.device)
    for row in run(g, dg, args.k):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
