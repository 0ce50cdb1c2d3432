"""Fused single-query serving measurement on the GPU.

The port of ``tpu_lanczos/eval/fused_serving.py``.
``expm_action_summary(eig_impl="device")`` queues Lanczos, the device
eigensolve, the GEMV and the masked top-k with no host read until the
final O(topk) fetch (the device eigh's own error-check sync aside);
``eig_impl="host"`` reads T back, solves it with LAPACK in float64 and
then runs the GEMV.  This measures both on the flagship graph, one
synchronized query at a time, in turns, and records how far the device
eigensolve's top-k values lie from the host's on the same pack.

Run: ``python -m tpu_lanczos_torch.eval.fused_serving [--k 50]
[--reps 5] [--device cuda]``; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# 'Entire algorithm' of the reference CUDA code, final_output1.txt:20
REF_WHOLE_S = 0.455634


def run(g, dg, k: int = 50, topk: int = 20, reps: int = 5) -> dict:
    """Device- and host-eigensolve top-k queries on ``dg`` in turns,
    ``reps`` each after one warm query each; returns the JSON row."""
    from tpu_lanczos_torch.core.pipeline import expm_action_summary
    from tpu_lanczos_torch.eval.profiling import wait

    def query(eig_impl):
        return expm_action_summary(g, k=k, topk=topk, dg=dg,
                                   eig_impl=eig_impl)

    s_dev = query("device")
    s_host = query("host")
    walls_dev, walls_host = [], []
    for _ in range(reps):
        wait(dg.realmask)
        t0 = time.perf_counter()
        s_dev = query("device")
        walls_dev.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        s_host = query("host")
        walls_host.append(time.perf_counter() - t0)

    # accuracy delta: device eigh (working dtype) against host LAPACK
    # float64 on the same decomposition, on a common log-scale
    v_dev = np.asarray(s_dev.top_values, np.float64) * np.exp(
        s_dev.log_scale - s_host.log_scale)
    v_host = np.asarray(s_host.top_values, np.float64)
    val_rel = float(np.linalg.norm(v_dev - v_host) / np.linalg.norm(v_host))
    node_overlap = len(set(s_dev.top_nodes.tolist())
                       & set(s_host.top_nodes.tolist()))
    med_dev = float(np.median(walls_dev))
    return dict(
        study=f"bn1M_whole_fused_topk_k{k}",
        device=(torch.cuda.get_device_name(dg.device)
                if dg.device.type == "cuda" else "cpu"),
        whole_s=med_dev,
        whole_s_all=walls_dev,
        host_eig_whole_s=float(np.median(walls_host)),
        host_eig_whole_s_all=walls_host,
        ref_cuda_whole_s=REF_WHOLE_S,
        vs_ref=REF_WHOLE_S / med_dev,
        topk=topk,
        topk_value_rel_diff=val_rel,
        topk_node_overlap=f"{node_overlap}/{topk}",
        top_node=int(s_dev.top_nodes[0]),
        top_nodes=s_dev.top_nodes.tolist(),
        note=("Lanczos + device eigh + GEMV + top-k queued with one O(topk)"
              " fetch (and the eigh's error-check sync); one synchronized"
              " query a sample; value delta = device eigh in the working"
              " dtype against host LAPACK float64 on the same pack"),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--topk", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cache", default=".bench_cache")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpu_lanczos_torch.eval.bench_suite import flagship_pack, load_graph
    from tpu_lanczos_torch.utils import enable_heap_reuse

    enable_heap_reuse()
    g = load_graph(args.n, args.m, 0, args.cache)
    dg, _ = flagship_pack(g, args.n, args.m, 0, args.cache, args.device)
    print(json.dumps(run(g, dg, args.k, args.topk, args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
