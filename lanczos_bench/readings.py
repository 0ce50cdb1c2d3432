"""Readings for the limits of ``correct``: the program's numbers and the
control's, at each cell's own size, over seeds, in one process.

    python3 lanczos_bench/readings.py --workload ba1M.topk20.f32 \
        --workload ba1M.expm.df64 --seeds 11 12 13 --control-seeds 3 \
        [--out readings.json]

For each seed the cell's graph is made and packed once and every named
cell of that configuration runs its query once through the timed path's
entry; each answer and, on the first ``--control-seeds`` seeds, the
control (the reference in the traffic's lower precision) are read by the
cell's numbers against the float64 reference.  Each reading also goes
through the verdict that decides ``correct`` in a run, under the cell's
limits (``program_correct``, ``control_correct``).  Prints one JSON line
a reading, then the largest program reading (the lower end of each
limit), the smallest control reading (the upper end) of every number,
and how many of the seeds' program and control readings the cell's
limits pass.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)

    from lanczos_bench.harness import control, correct, graphs, spec
    import tpu_lanczos_torch as tl

    cells = [spec.load_cell(w) for w in args.workload]
    by_config = {}
    for c in cells:
        by_config.setdefault(json.dumps(c.config, sort_keys=True),
                             []).append(c)
    rows = []
    for group in by_config.values():
        for i, seed in enumerate(args.seeds):
            t0 = time.perf_counter()
            indptr, indices = graphs.generate(group[0].config, seed)
            g = tl.CSRGraph(indptr=indptr, indices=indices,
                            n=indptr.shape[0] - 1)
            packs = {}
            refs = {}
            for c in group:
                t = c.traffic
                if t["pack"] not in packs:
                    packs[t["pack"]] = getattr(tl, t["pack"])(
                        g, device=args.device)
                result = getattr(tl, t["entry"])(g, dg=packs[t["pack"]],
                                                 **t["kwargs"])
                key = json.dumps(t["kwargs"], sort_keys=True)
                if key not in refs:
                    refs[key] = control.reference(t, indptr, indices)
                ref = refs[key]
                row = {"workload": c.name, "seed": seed,
                       "program": correct.numbers(t["answer"], result, ref)}
                row["program_correct"] = correct.verdict(
                    row["program"], c.limits)[0]
                if i < args.control_seeds:
                    row["control"] = control.control_numbers(
                        t, indptr, indices, ref)
                    row["control_correct"] = correct.verdict(
                        row["control"], c.limits)[0]
                rows.append(row)
                print(json.dumps(row), flush=True)
            del packs
            print(f"# seed {seed}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr, flush=True)

    summary = {}
    for c in cells:
        mine = [r for r in rows if r["workload"] == c.name]
        lower = correct.worst([r["program"] for r in mine])
        upper = {}
        for r in mine:
            for key, value in r.get("control", {}).items():
                upper[key] = min(upper.get(key, value), value)
        controls = [r for r in mine if "control" in r]
        summary[c.name] = {
            "lower": lower, "upper": upper, "limits": c.limits,
            "seeds": [r["seed"] for r in mine],
            "control_seeds": [r["seed"] for r in controls],
            "program_correct": sum(r["program_correct"] for r in mine),
            "control_correct": sum(r["control_correct"] for r in controls)}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
