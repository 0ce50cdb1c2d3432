"""Record of the stochastic estimators (core/stochastic.py) on the GPU:
Estrada index and subgraph centrality on the flagship BA-1M graph.

The port of ``tpu_lanczos/eval/stochastic_bench.py``.  At n=1M no dense
oracle exists, so validation is statistical and internal (the posture of
the reference's convergence self-consistency studies, writeup Table 5):

- two estimates from DISJOINT probe seeds must agree within 3 of their
  combined stderrs (the two combined in quadrature);
- the sum of the diagonal estimate is itself a trace estimate and is
  compared with the quadrature-based trace estimate;
- deflated against plain rel stderr shows the variance reduction that
  the small-graph tests prove exactly (tests/test_stochastic.py).

Every SpMV runs the CPG level kernel.  The rows are printed as JSON
lines and written only to the file given by ``--out`` (appended).

Usage: ``python -m tpu_lanczos_torch.eval.stochastic_bench [n] [m]
[--out FILE] [--device cuda]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(g, dg) -> list[dict]:
    """The estimator rows on ``g`` packed as ``dg``; the seed-agreement
    row carries ``ok``."""
    from tpu_lanczos_torch.core import stochastic

    tag = f"bn{g.n // 1000}k"
    rows = []

    # ---- Estrada index: deflated, two disjoint seeds + plain baseline
    runs = {}
    for name, seed, deflate in (("a", 0, 8), ("b", 1, 8), ("plain", 0, 0)):
        t0 = time.perf_counter()
        r = stochastic.estrada_index(g, k=30, probes=32, deflate=deflate,
                                     seed=seed, dg=dg)
        wall = time.perf_counter() - t0
        runs[name] = r
        log(f"estrada[{name}] deflate={deflate}: log={r.log_estimate:.6f} "
            f"rel_stderr={r.rel_stderr:.3e} deflated={r.deflated} "
            f"[{wall:.2f}s]")
        rows.append(dict(
            study=f"estrada_{tag}_{name}", n=g.n, nnz=g.nnz,
            k=r.k, probes=r.probes, deflate_requested=deflate,
            deflate_used=r.deflated, log_estimate=r.log_estimate,
            rel_stderr=r.rel_stderr, wall_s=wall,
            resid_filter="beta_k",
        ))
    # disjoint-seed agreement in scaled space; independent seeds: the
    # stderrs combine in quadrature, not by sum
    ra, rb = runs["a"], runs["b"]
    diff = float(abs(np.exp(ra.log_estimate - rb.log_estimate) - 1.0))
    budget = 3.0 * float(np.hypot(ra.rel_stderr, rb.rel_stderr))
    log(f"seed agreement: rel diff {diff:.3e} vs 3-sigma budget "
        f"{budget:.3e} -> {'OK' if diff <= budget else 'FAIL'}")
    rows.append(dict(study=f"estrada_{tag}_seed_agreement",
                     rel_diff=diff, budget_3sigma=budget,
                     ok=bool(diff <= budget)))

    # ---- subgraph centrality (every node at once)
    t0 = time.perf_counter()
    dr = stochastic.subgraph_centrality(g, k=20, probes=16, deflate=8,
                                        seed=0, dg=dg)
    wall = time.perf_counter() - t0
    top = dr.top_nodes(10)
    log(f"subgraph centrality: deflated={dr.deflated} "
        f"log_scale={dr.log_scale:.4f} [{wall:.2f}s]")
    # consistency: sum(diag) is a trace estimate too
    log_sum = float(np.log(dr.diag_scaled.sum())) + dr.log_scale
    rel = float(abs(np.exp(log_sum - ra.log_estimate) - 1.0))
    log(f"sum(diag) vs estrada: rel diff {rel:.3e}")
    rows.append(dict(
        study=f"subgraph_{tag}", n=g.n, nnz=g.nnz, k=dr.k,
        probes=dr.probes, deflate_used=dr.deflated,
        log_scale=dr.log_scale, wall_s=wall,
        top10=[int(i) for i in top],
        trace_consistency_rel_diff=rel,
    ))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=1_000_000)
    ap.add_argument("m", type=int, nargs="?", default=10)
    ap.add_argument("--out", default=None,
                    help="append the rows to this file as JSON lines")
    ap.add_argument("--cache", default=".bench_cache")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpu_lanczos_torch.core.pipeline import best_device_pack
    from tpu_lanczos_torch.eval.bench_suite import load_graph
    from tpu_lanczos_torch.utils import enable_heap_reuse

    enable_heap_reuse()
    # bench.py's graph, so the record refers to the flagship graph
    g = load_graph(args.n, args.m, 0, args.cache)
    log(f"graph: BA n={g.n} nnz={g.nnz}")
    t0 = time.perf_counter()
    dg = best_device_pack(g, device=args.device)
    log(f"packed in {time.perf_counter() - t0:.1f}s")
    rows = run(g, dg)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        log(f"wrote {len(rows)} rows to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
