"""One run of one cell of the benchmark of tpu_lanczos_torch.

    python3 lanczos_bench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout (this file finds BENCHMARK.json beside
its own folder).  The last line of standard output is the result, one
JSON object; the numbers compared and their limits are also the last
lines of standard error.  Without a CUDA card, or with fewer cards than
the cell asks for, it exits 2 and prints no result; it never falls back
to the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from lanczos_bench.harness import spec
    from lanczos_bench.harness.cell import loaded_forbidden, log, run_cell

    cell = spec.load_cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s), found {have}")
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = loaded_forbidden()
    if found:
        log(f"the run loaded {', '.join(found)}: no result")
        return 3
    for name, c in out["checks"].items():
        if c["value"] is not None and not math.isfinite(c["value"]):
            c["value"] = str(c["value"])  # JSON has no inf or nan
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {out['correct']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
