"""Sweep harnesses: the reference CUDA code's shell-script studies as one
module.

The port of ``tpu_lanczos/eval/sweeps.py``:

- ``k_sweep``: accuracy/convergence against Krylov dimension (reference:
  serial/tests/numerical_test.sh k-grid and parallel-final/final.sh
  cross-k answer comparisons, writeup Table 5);
- ``pack_sweep``: CPG pack parameters (theta x sub) against tile count
  and Lanczos time (reference: parallel-mult-on-card/tests/linalg_test.sh
  rewriting lib/blocks.h per blocksize and rebuilding).

Both print one JSON line per point and run on ``device`` (the CPG level
kernel on a GPU).  Run as ``python -m tpu_lanczos_torch.eval.sweeps
{k,pack} [options]``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def k_sweep(n=2000, edges=8000, seed=1, ks=(5, 10, 15, 20, 25, 30, 40),
            dtype="float64", device="cuda"):
    """Relative error against dense ground truth across k (small graphs),
    the analog of the reference's NotreDame_yeast analytic study
    (BASELINE.md: 2.14 @ k=5 -> ~4e-15 plateau @ k>=25).  Every k runs
    ``expm_action`` in ``dtype`` on one CPG pack."""
    from tpu_lanczos_torch.core.pipeline import expm_action
    from tpu_lanczos_torch.eval import oracle
    from tpu_lanczos_torch.graphs import generators
    from tpu_lanczos_torch.kernels.cpg import pack_cpg

    g = generators.uniform_random(n, edges, seed=seed)
    ref = oracle.expm_action_dense(g, np.ones(g.n))
    dg = pack_cpg(g, device=device)
    out = []
    for k in ks:
        res = expm_action(g, k=k, dtype=dtype, dg=dg)
        rec = dict(k=int(k), rel_err=float(oracle.rel_error(res.ans, ref)))
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def pack_sweep(n=200_000, m=10, seed=1, thetas=(40, 75, 110),
               subs=(128, 256), k=50, device="cuda"):
    """CPG pack-parameter sweep: tiles, fill, pack seconds and, on a GPU,
    the CUDA-event time of ``lanczos`` (median of 3 after a warm run)."""
    import torch

    from tpu_lanczos_torch.core.lanczos import lanczos
    from tpu_lanczos_torch.eval.cpg_variants import cuda_ms
    from tpu_lanczos_torch.eval.profiling import wait
    from tpu_lanczos_torch.graphs import generators
    from tpu_lanczos_torch.kernels.cpg import pack_cpg

    g = generators.barabasi_albert(n, m, seed=seed)
    on_gpu = torch.device(device).type == "cuda"
    out = []
    for sub in subs:
        for theta in thetas:
            t0 = time.perf_counter()
            cg = pack_cpg(g, theta=theta, sub=sub, device=device)
            wait(cg.realmask)
            rec = dict(theta=theta, sub=sub, tiles=cg.total_tiles,
                       fill_pct=100 * cg.fill,
                       pack_s=time.perf_counter() - t0)
            if on_gpu:
                x = cg.realmask.reshape(-1).to(torch.float32)
                rec["lanczos_s"] = cuda_ms(
                    lambda: lanczos(cg, x, k), reps=3) / 1e3
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    sp = ap.add_subparsers(dest="cmd", required=True)
    pk = sp.add_parser("k")
    pk.add_argument("-n", type=int, default=2000)
    pk.add_argument("-e", type=int, default=8000)
    pp = sp.add_parser("pack")
    pp.add_argument("-n", type=int, default=200_000)
    pp.add_argument("-m", type=int, default=10)
    args = ap.parse_args(argv)
    if args.cmd == "k":
        k_sweep(n=args.n, edges=args.e, device=args.device)
    else:
        pack_sweep(n=args.n, m=args.m, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
