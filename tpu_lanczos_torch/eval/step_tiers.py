"""Time the one-launch Lanczos step at each of its residency tiers.

    python -m tpu_lanczos_torch.eval.step_tiers [--sizes N,...] [--df-sizes N,...]
    python -m tpu_lanczos_torch.eval.step_tiers --sharded [--shard-sizes N,...]

Row 5 (``kernels/lanczos_step.py::lanczos_step``, float32 and float64):
at each size, every candidate plan ``step_plan`` considers that fits the
card (4 register chunks and 0, 1, 2, 4, 8 or 16 shared chunks), each on
the fewest co-resident blocks that hold v and q or, when none do, on its
whole co-resident grid, re-reading the rest, and the plan the wrapper
picks (marked ``chosen``).  Row 5c (``lanczos_step_df``):
``df_geometry``'s plan, the same without the held row, and on half the
blocks.  Each step reads v times a 0/1 mask (``mask=``, as the loops on a
CPG pack do), q_j and q_{j-1} and writes q_{j+1}; its bound is those
bytes over 3.35 TB/s (the H100 SXM's HBM rate).  Device microseconds a
step: ``calls`` steps queued behind a sleeping kernel, so the host's
enqueue is not timed, between two CUDA events; the median of 5 samples.
One JSON line a case, the first the card's name and power limit, so the
tiers' crossovers can be read off.

With ``--sharded``, rows 5d and 5cd instead (the row-sharded loops'
per-shard passes, ``shard_step_*`` and ``shard_df_*``): one shard's step
after the SpMV (dot, update with the last norm, normalize; the mask
folded in) at each size, through the pass kernels beside the eager
passes and the bound (v, the mask, q_j, q_{j-1} read, q_{j+1} written,
and v read again).  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
SIZES = (1 << 18, 1 << 19, 1 << 20, 3 << 20, 1 << 22, 1 << 23, 1 << 24)
# bn1M's n_pad, stencil_2600's, and Europe's (7134^2 nodes in 512-row
# chunks of 128 lanes)
DF_SIZES = (1 << 20, 1 << 21, 1 << 23, 777 * 65536)
# a shard's n_loc at bn1M over 4 shards, and 8 times that
SHARD_SIZES = (1 << 18, 1 << 21)
SMEM_CANDIDATES = (0, 1, 2, 4, 8, 16)


def queued_us(fn, calls: int = 50, reps: int = 5):
    """Median and samples of a call's device microseconds, the calls
    queued behind ``torch.cuda._sleep``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(calls):
        fn()
    enqueue_s = time.time() - t0
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        torch.cuda._sleep(int(2e9 * (2 * enqueue_s + 0.01)))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls * 1e3)
    return float(np.median(samples)), samples


def _vectors(n: int, dtype, dev, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(n)
    q /= np.linalg.norm(q)
    vecs = [torch.from_numpy(a).to(dev, dtype) for a in (
        rng.standard_normal(n), q, rng.standard_normal(n) / np.sqrt(n))]
    mask = torch.from_numpy((rng.random(n) < 0.9).astype(np.float32)).to(dev)
    return vecs, mask


def row5_candidates(n: int, value_bytes: int, index: int = 0):
    """The plan the wrapper picks for n, then the others that fit the
    card."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    chunks = max(n // (16 // value_bytes), 1)
    out = [ls.plan_for(torch.device("cuda", index), n, value_bytes)]
    for s in SMEM_CANDIDATES:
        whole = min(ls._occupancy_on(index, 0, value_bytes,
                                     s * ls.SMEM_CHUNK_BYTES), ls.MAX_GRID)
        need = -(-chunks // (ls.THREADS * (ls.REG_CHUNKS + s)))
        if whole >= 1 and ls.StepPlan(min(whole, need), s) not in out:
            out.append(ls.StepPlan(min(whole, need), s))
    return out


def run_row5(sizes, dev, calls: int, emit) -> None:
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    work = ls.workspace(dev)
    for dtype in (torch.float32, torch.float64):
        vb = torch.finfo(dtype).bits // 8
        for n in sizes:
            (v, q, qp), mask = _vectors(n, dtype, dev)
            ab = [torch.zeros(8, dtype=dtype, device=dev) for _ in range(2)]
            ab[1][2] = 0.75
            bound_us = n * (4 * vb + 4) / HBM_BYTES_PER_S * 1e6
            chosen = ls.plan_for(dev, n, vb)
            for plan in row5_candidates(n, vb, dev.index or 0):
                us, samples = queued_us(
                    lambda plan=plan: ls.lanczos_step(
                        v, q, qp, *ab, 3, work=work, mask=mask, plan=plan),
                    calls)
                emit({"row": "5", "dtype": str(dtype).split(".")[-1],
                      "n": n, "grid": plan.grid,
                      "smem_chunks": plan.smem_chunks,
                      "tier": plan.tier(n, vb), "chosen": plan == chosen,
                      "device_us": us, "samples": samples,
                      "bound_us": bound_us, "bound_share": bound_us / us})
            del v, q, qp, mask
            torch.cuda.empty_cache()


def run_row5c(sizes, dev, calls: int, emit) -> None:
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    work = ls.workspace(dev)
    for n in sizes:
        vecs, mask = _vectors(n, torch.float64, dev)
        pairs = []
        for x in vecs:
            hi = x.float()
            pairs.append((hi, (x - hi.double()).float()))
        del vecs
        v, q, qp = pairs
        ab = [torch.zeros(8, device=dev) for _ in range(4)]
        ab[2][2] = 0.75
        bound_us = n * (8 * 4 + 4) / HBM_BYTES_PER_S * 1e6
        chosen = ls.df_plan_for(dev, n)
        plans = [chosen]
        if chosen.hold:
            plans.append(ls.DfPlan(chosen.grid, chosen.rows_log, 0))
        if chosen.grid > 1:
            plans.append(ls.DfPlan(chosen.grid // 2, chosen.rows_log + 1,
                                   chosen.hold))
        for plan in plans:
            us, samples = queued_us(
                lambda plan=plan: ls.lanczos_step_df(
                    v, q, qp, ab[:2], ab[2:], 3, work=work, mask=mask,
                    plan=plan), calls)
            emit({"row": "5c", "n": n, "grid": plan.grid,
                  "rows_log": plan.rows_log, "hold": plan.hold,
                  "chosen": plan == chosen, "device_us": us,
                  "samples": samples, "bound_us": bound_us,
                  "bound_share": bound_us / us})
        del v, q, qp, mask
        torch.cuda.empty_cache()


def shard_step(v, q, qp, mask, df: bool, kernel: bool):
    """One shard's step after the SpMV (rows 5d / 5cd: dot, update,
    normalize; q_{j-1} with beta_{j-1} = 0) through the pass kernels on a
    private copy of v, or without ``kernel`` through the eager passes (the
    plain versions)."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    if not kernel:
        if df:
            def eager():
                a = ls.shard_df_dot_ref(v, q, mask)
                w, p = ls.shard_df_update_ref(v, q, qp, (a[0], a[1]), None,
                                              mask)
                ls.shard_df_normalize_ref(w, (p[0], p[1]))
        else:
            def eager():
                a = ls.shard_step_dot_ref(v, q, mask)
                w, p = ls.shard_step_update_ref(v, q, qp, a, None, mask)
                ls.shard_step_normalize_ref(w, p)
        return eager
    work = ls.workspace(mask.device)
    if df:
        vk = (v[0].clone(), v[1].clone())

        def step():
            a = ls.shard_df_dot(vk, q, mask=mask, work=work)
            _, p = ls.shard_df_update(vk, q, qp, (a[0], a[1]), None,
                                      mask=mask, work=work)
            ls.shard_df_normalize(vk, (p[0], p[1]))
    else:
        vk = v.clone()

        def step():
            a = ls.shard_step_dot(vk, q, mask=mask, work=work)
            _, p = ls.shard_step_update(vk, q, qp, a, None, mask=mask,
                                        work=work)
            ls.shard_step_normalize(vk, p)
    return step


def run_sharded(sizes, dev, calls: int, emit) -> None:
    """Rows 5d and 5cd: the pass kernels and the eager passes."""
    for kind in ("float32", "float64", "df64"):
        df = kind == "df64"
        for n in sizes:
            vecs, mask = _vectors(n, torch.float64 if df else
                                  getattr(torch, kind), dev)
            if df:
                vecs = [(x.float(), (x - x.float().double()).float())
                        for x in vecs]
            v, q, qp = vecs
            vb = 8 if df else torch.finfo(getattr(torch, kind)).bits // 8
            bound_us = n * (5 * vb + 4) / HBM_BYTES_PER_S * 1e6
            row = {"row": "5cd" if df else "5d", "dtype": kind, "n": n,
                   "bound_us": bound_us}
            for kernel in (True, False):
                us, samples = queued_us(
                    shard_step(v, q, qp, mask, df, kernel),
                    calls if kernel else max(calls // 10, 2))
                row["kernel" if kernel else "eager"] = {
                    "device_us": us, "samples": samples}
            emit(row)
            del v, q, qp, mask, vecs
            torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="row 5's vector lengths, comma-separated")
    ap.add_argument("--df-sizes", default=",".join(map(str, DF_SIZES)),
                    help="row 5c's vector lengths, comma-separated")
    ap.add_argument("--calls", type=int, default=50,
                    help="steps queued a sample")
    ap.add_argument("--sharded", action="store_true",
                    help="time rows 5d and 5cd (the per-shard passes)")
    ap.add_argument("--shard-sizes",
                    default=",".join(map(str, SHARD_SIZES)),
                    help="rows 5d/5cd's shard lengths, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_tiers needs a CUDA GPU")
    dev = torch.device("cuda", 0)

    def emit(row):
        print(json.dumps(row), flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.strip()})
    parse = (lambda s: [int(x) for x in s.split(",") if x])
    if args.sharded:
        run_sharded(parse(args.shard_sizes), dev, args.calls, emit)
        return
    run_row5(parse(args.sizes), dev, args.calls, emit)
    run_row5c(parse(args.df_sizes), dev, args.calls, emit)


if __name__ == "__main__":
    main()
