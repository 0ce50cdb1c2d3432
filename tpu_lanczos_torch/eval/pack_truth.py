"""Pack-time ground truth: real CPU work against page-fault overhead.

The port of ``tpu_lanczos/eval/pack_truth.py``.  A suite pack_s column
has two candidate explanations: real packing CPU, or the host's lazy
page provisioning (first-touch faults on multi-GB numpy temporaries).
The reference CUDA code builds bn1M from .mtx in seconds
(serial/lib/adjMatrix.cc:18-52), so the difference must be attributed by
measurement, not assertion.

Protocol: pack the identical graph twice in one process.
- COLD: first pack, paying first-touch faults on every new heap page.
- WARM: immediate repack; with ``enable_heap_reuse()`` (mallopt
  M_MMAP_THRESHOLD/M_TRIM_THRESHOLD) the allocator reuses the already
  provisioned pages, so WARM wall ~= real pack work.
Each leg records wall, ru_utime (user CPU), ru_stime (kernel CPU: fault
service lives here), and ru_majflt/ru_minflt deltas from
``resource.getrusage``.  COLD - WARM and the fault counts separate
provisioning from work.

Host only: the packs are made with ``device="cpu"``, so no GPU is
touched.  Run: ``python -m tpu_lanczos_torch.eval.pack_truth [--config
ba_1M_m10]``; one JSON line per leg plus a summary line.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time

import numpy as np


def _leg(name, fn):
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    rec = dict(
        leg=name,
        wall_s=wall,
        utime_s=r1.ru_utime - r0.ru_utime,
        stime_s=r1.ru_stime - r0.ru_stime,
        majflt=r1.ru_majflt - r0.ru_majflt,
        minflt=r1.ru_minflt - r0.ru_minflt,
        maxrss_gb=r1.ru_maxrss / 1e6,
    )
    print(json.dumps(rec), flush=True)
    return out, rec


def run(cfg, warm_reps: int = 2, cache_dir: str = ".bench_cache") -> dict:
    """The cold and warm legs for one suite config; returns the summary
    row."""
    from tpu_lanczos_torch.eval.bench_suite import build
    from tpu_lanczos_torch.kernels.cpg import pack_cpg

    pack_kw = cfg.get("pack") or {}
    g, _ = _leg("build_graph", lambda: build(cfg, cache_dir))

    def pack():
        return pack_cpg(g, device="cpu", **pack_kw)

    dg, cold = _leg("pack_cold", pack)
    tiles = int(dg.total_tiles)
    warms = []
    for i in range(warm_reps):
        del dg  # release the previous pack so its pages are reusable
        dg, w = _leg(f"pack_warm_{i + 1}", pack)
        warms.append(w)

    warm_wall = float(np.median([w["wall_s"] for w in warms]))
    return dict(
        study=f"{cfg['name']}_pack_truth",
        tiles=tiles,
        cold_wall_s=cold["wall_s"],
        warm_wall_s=warm_wall,
        provisioning_s=cold["wall_s"] - warm_wall,
        cold_utime_s=cold["utime_s"],
        cold_stime_s=cold["stime_s"],
        warm_utime_s=warms[-1]["utime_s"],
        warm_stime_s=warms[-1]["stime_s"],
        cold_majflt=cold["majflt"],
        warm_majflt=warms[-1]["majflt"],
        cold_minflt=cold["minflt"],
        warm_minflt=warms[-1]["minflt"],
        note=("warm repack of the identical graph in-process; "
              "wall-utime gap + fault counts attribute provisioning "
              "vs real pack CPU"),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="ba_1M_m10")
    ap.add_argument("--warm-reps", type=int, default=2)
    ap.add_argument("--cache", default=".bench_cache")
    args = ap.parse_args(argv)

    from tpu_lanczos_torch.eval.bench_suite import CONFIGS
    from tpu_lanczos_torch.utils import enable_heap_reuse

    enable_heap_reuse()
    cfg = next(c for c in CONFIGS if c["name"] == args.config)
    summary = run(cfg, args.warm_reps, args.cache)
    print(json.dumps(summary), flush=True)
    print(
        f"\ncold {summary['cold_wall_s']:.1f}s (u "
        f"{summary['cold_utime_s']:.1f} / s {summary['cold_stime_s']:.1f}, "
        f"minflt {summary['cold_minflt']:,}) -> warm "
        f"{summary['warm_wall_s']:.1f}s (u {summary['warm_utime_s']:.1f} / "
        f"s {summary['warm_stime_s']:.1f}, minflt "
        f"{summary['warm_minflt']:,})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
