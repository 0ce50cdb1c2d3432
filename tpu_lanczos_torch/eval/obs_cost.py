"""What the spans of ``tpu_lanczos_torch.obs`` cost the served queries,
on one GPU, in turns against another checkout.

    python -m tpu_lanczos_torch.eval.obs_cost --other DIR [--tag NAME]
        [--rounds N]

Each turn is a child process that imports ``tpu_lanczos_torch`` from one
checkout (this one, or ``DIR``: another commit unpacked with ``git
archive``), builds its kernels, packs the benchmark's graph shape
(Barabasi-Albert n=1M, m=10, seed 0, native generator) with
``best_device_pack`` and times, by the host wall of each call, the two
served queries: the top-20 ``expm_action_summary(k=50, eig_impl=
"device")`` and the f64-grade ``expm_action_df(k=50, log_scale=True)``.
First, after warm-up, a block of each query with recording off (what a
checkout without spans runs too), then, where the checkout has ``obs``,
pairs of one query with recording off and one inside
``obs.recording()``; the recorded trees give
each query's stage sums (the card time of ``lanczos``, ``eigh`` and the
passes, the wall of the ``host`` spans, the ``query`` span's wall) and
its counters.  Each turn hashes its answers, so two checkouts' answers
can be compared bit for bit.  The turns run other, this, this, other
(``--rounds`` times).  One JSON line per turn; the first line is the
card's name and power limit.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TURN = r"""
import hashlib, json, sys, time
root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np, torch
import tpu_lanczos_torch as tl
assert tl.__file__.startswith(root), tl.__file__
try:
    from tpu_lanczos_torch import obs
except ImportError:
    obs = None

WARM, N_F32, N_DF = 10, 150, 50
g = tl.generators.barabasi_albert(1_000_000, 10, seed=0, use_native=True)
dg = tl.best_device_pack(g, device="cuda")
torch.cuda.synchronize()
queries = {
    "f32": (N_F32, lambda: tl.expm_action_summary(
        g, k=50, topk=20, dg=dg, dtype="float32", eig_impl="device")),
    "df64": (N_DF, lambda: tl.expm_action_df(g, k=50, dg=dg,
                                             log_scale=True)),
}


def digest(out):
    h = hashlib.sha256()
    arrays = ((out.top_values, out.top_nodes) if hasattr(out, "top_nodes")
              else (out.ans, out.alpha, out.beta))
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def wall_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def stats(v):
    q1, q2, q3 = np.percentile(v, [25, 50, 75])
    return {"median": float(q2), "q1": float(q1), "q3": float(q3),
            "mean": float(np.mean(v)), "n": len(v)}


def sums(tree, match, field):
    out = 0.0
    for c in tree.children:
        if match(c):
            value = getattr(c, field)
            out += float("nan") if value is None else value
        else:
            out += sums(c, match, field)
    return out


row = {"tag": tag, "n": g.n, "levels": len(dg.levels)}
for name, (count, fn) in queries.items():
    for _ in range(WARM):
        fn()
    times, digests = [], set()
    for _ in range(count):
        t, out = wall_ms(fn)
        times.append(t)
        digests.add(digest(out))  # the answers are not kept
    row[name + "_off_ms"] = stats(times)
    row[name + "_digest"] = sorted(digests)
for name, (count, fn) in queries.items() if obs is not None else ():
    off, on, trees = [], [], []
    for _ in range(count):
        off.append(wall_ms(fn)[0])
        with obs.recording() as rec:
            on.append(wall_ms(fn)[0])
        trees += [t for t in rec.take() if t.name == "query"]
    row[name + "_pair_off_ms"] = stats(off)
    row[name + "_pair_on_ms"] = stats(on)
    stage = {
        "query_wall": [t.wall_ms for t in trees],
        "query_card": [float("nan") if t.device_ms is None else t.device_ms
                       for t in trees],
        "host": [sums(t, lambda s: s.kind == "host", "wall_ms")
                 for t in trees],
    }
    if name == "f32":
        stage["lanczos"] = [sums(t, lambda s: s.name == "lanczos",
                                 "device_ms") for t in trees]
        stage["eigh"] = [sums(t, lambda s: s.name == "eigh", "device_ms")
                         for t in trees]
        inside = [a + b + c <= w for a, b, c, w in zip(
            stage["lanczos"], stage["eigh"], stage["host"],
            stage["query_wall"])]
    else:
        stage["passes"] = [sums(t, lambda s: s.name in ("pass1", "pass2"),
                                "device_ms") for t in trees]
        inside = [a + c <= w for a, c, w in zip(
            stage["passes"], stage["host"], stage["query_wall"])]
    row[name + "_stages"] = {k: stats(v) for k, v in stage.items()}
    row[name + "_inside_query"] = f"{sum(inside)}/{len(inside)}"
    row[name + "_counts"] = trees[-1].counts
    row[name + "_table"] = obs.table(trees[-1:])
print(json.dumps(row))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True,
                   help="root of the other checkout (holds "
                        "tpu_lanczos_torch/)")
    p.add_argument("--tag", default="other", help="the other checkout's tag")
    p.add_argument("--rounds", type=int, default=1,
                   help="rounds of the four turns")
    args = p.parse_args(argv)
    other = os.path.abspath(args.other)
    if not os.path.isdir(os.path.join(other, "tpu_lanczos_torch")):
        p.error(f"{other} holds no tpu_lanczos_torch/")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    turns = ((other, args.tag), (THIS_ROOT, "this"), (THIS_ROOT, "this"),
             (other, args.tag)) * args.rounds
    for root, tag in turns:
        proc = subprocess.run([sys.executable, "-c", TURN, root, tag],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
