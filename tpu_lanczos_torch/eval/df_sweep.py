"""df64 convergence-against-k sweep on the GPU.

The port of ``tpu_lanczos/eval/df_sweep.py``.  The reference CUDA code's
signature accuracy artifact is its k-sweep on NotreDame_yeast (n=2114,
E=2277): rel error 2.14 at k=5 -> 9.3e-4 at k=10 -> 3.5e-11 at k=20 ->
~4e-15 plateau at k>=25 (serial/output/numerical_test_output.txt; grid in
tests/numerical_test.sh:5).  This reproduces the study with the df64
(two-float32) pipeline on the df level kernel: a same-scale generated graph,
ground truth by dense f64 eigendecomposition of A itself (the data/
eigenpairs are not redistributable), every k answered from ONE
decomposition (expm_action_ks_df's multi-answer recombine).  The f32
pipeline's curve is recorded beside it; it plateaus at its arithmetic
floor, the gap df64 exists to close.

Run: ``python -m tpu_lanczos_torch.eval.df_sweep [--device cuda]``; one
JSON line per k.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

KS = [5, 10, 15, 20, 25, 30, 40, 50, 75, 100]


def run(n: int = 2114, e: int = 2277, seed: int = 1234, ks=KS,
        device="cuda") -> list[dict]:
    """The sweep's rows: df64 and f32 relative errors against the dense
    truth, and the df64 difference from the largest k, for every k."""
    from tpu_lanczos_torch.core.lanczos_df import expm_action_ks_df
    from tpu_lanczos_torch.core.pipeline import expm_action_ks
    from tpu_lanczos_torch.eval import oracle
    from tpu_lanczos_torch.graphs import generators
    from tpu_lanczos_torch.kernels.cpg import pack_cpg

    g = generators.uniform_random(n, e, seed=seed)
    truth = oracle.expm_action_dense(g, np.ones(g.n))  # exact to f64 roundoff
    tn = np.linalg.norm(truth)
    dg = pack_cpg(g, device=device)

    t0 = time.perf_counter()
    res_df, diffs_df = expm_action_ks_df(g, ks, dg=dg)
    t_df = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_f32, _ = expm_action_ks(g, ks, dg=dg)
    t_f32 = time.perf_counter() - t0
    rows = []
    for k in sorted(res_df):
        err_df = float(np.linalg.norm(res_df[k].ans - truth) / tn)
        err_f32 = float(
            np.linalg.norm(res_f32[k].ans.astype(np.float64) - truth) / tn)
        rows.append(dict(
            study="k_sweep_df64", k=k, n=g.n, nnz=g.nnz,
            rel_err_df64=err_df, rel_err_f32=err_f32,
            diff_vs_kmax_df64=diffs_df[k], backend=dg.device.type))
    print(f"df64 sweep {t_df:.2f}s, f32 sweep {t_f32:.2f}s "
          f"(one decomposition each)", file=sys.stderr)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2114)
    ap.add_argument("--e", type=int, default=2277)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.n, args.e, args.seed, device=args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
