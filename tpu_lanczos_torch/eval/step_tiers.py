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
per-shard passes, ``shard_step_*`` and ``shard_df_*``): at each size,
one shard's step after the SpMV (dot, update with the last norm,
normalize; the mask folded in) and the whole step of a 4-shard mesh on
the card (12 passes, their slots shared, nothing else between them:
``mesh_step``), each behind one ordinary one-value kernel that stands in
for the SpMV's last level (timed alone beside them), through the pass
kernels (with and without their early loads) beside the eager passes
and the bound (v, the mask, q_j, q_{j-1} read, q_{j+1} written, and v
read again; four times that for the mesh).  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
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
MESH_SHARDS = 4
# rows 5d and 5cd's wrappers (kernels/lanczos_step.py)
PASSES = ("shard_step_dot", "shard_step_update", "shard_step_sub_norm",
          "shard_step_normalize", "shard_df_dot", "shard_df_update",
          "shard_df_normalize")
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


@contextlib.contextmanager
def eager_shard_passes():
    """Every sharded loop (and ``mesh_step``) runs the plain versions of
    rows 5d and 5cd in the block, under their wrappers' names (``work``
    and ``early`` dropped): the eager step, to time beside the kernels in
    one run."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    real = {n: getattr(ls, n) for n in PASSES}
    for n in PASSES:
        setattr(ls, n, lambda *a, ref=getattr(ls, n + "_ref"), work=None,
                early=False, **kw: ref(*a, **kw))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(ls, n, fn)


def spmv_stand_in(dev):
    """One ordinary one-value kernel a call: it stands in for the SpMV's
    last level kernel, which the loops queue before every step's first
    pass."""
    tick = torch.zeros(1, device=dev)
    return lambda: tick.add_(1)


def mesh_step(vs, qs, qps, masks, df: bool, early: bool = True):
    """The step after the SpMV of a mesh whose shards share one device,
    as the loops run it: the SpMV's stand-in (``spmv_stand_in``, so no
    call's first pass overlaps the last call's normalize by dependent
    launch, as none can in the loops), every shard's dot pass, every
    shard's update
    (folding the dot slots, and the last call's norm slots as b_prev,
    the norm buffers taken by parity), every shard's normalize (folding
    the norm slots).  Each shard's v is a private copy, overwritten call
    after call (the plain versions' new vectors carried on).  The passes
    are the wrappers looked up at each call (the kernels, or the plain
    versions inside ``eager_shard_passes``); ``early`` their early loads,
    which the loop's order allows."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    n = len(qs)
    dev = masks[0].device
    width = (2,) if df else ()
    dt = torch.float32 if df else qs[0].dtype
    dots = torch.zeros((n, *width), dtype=dt, device=dev)
    norms = [torch.zeros_like(dots) for _ in range(2)]
    work = ls.workspace(dev)
    spmv_end = spmv_stand_in(dev)
    vk = [tuple(t.clone() for t in v) if df else v.clone() for v in vs]
    parity = [0]
    names = (("shard_df_dot", "shard_df_update", "shard_df_normalize")
             if df else ("shard_step_dot", "shard_step_update",
                         "shard_step_normalize"))

    def step():
        p = parity[0]
        parity[0] ^= 1
        dot, upd, nrm = (getattr(ls, name) for name in names)
        spmv_end()
        for s in range(n):
            dot(vk[s], qs[s], mask=masks[s], work=work, slots=dots, shard=s,
                early=early)
        for s in range(n):
            vk[s] = upd(vk[s], qs[s], qps[s], dots, norms[1 - p],
                        mask=masks[s], work=work, slots=norms[p], shard=s,
                        early=early)[0]
        for s in range(n):
            vk[s] = nrm(vk[s], norms[p], early=early and n > 1)
    return step


def run_sharded(sizes, dev, calls: int, emit) -> None:
    """Rows 5d and 5cd: one shard's step and the whole 4-shard step
    through the pass kernels (early loads on and off) and the eager
    passes."""
    for kind in ("float32", "float64", "df64"):
        df = kind == "df64"
        for n in sizes:
            shards = []
            for s in range(MESH_SHARDS):
                vecs, mask = _vectors(n, torch.float64 if df else
                                      getattr(torch, kind), dev, seed=s)
                if df:
                    vecs = [(x.float(), (x - x.float().double()).float())
                            for x in vecs]
                shards.append((*vecs, mask))
            vb = 8 if df else torch.finfo(getattr(torch, kind)).bits // 8
            bound_us = n * (5 * vb + 4) / HBM_BYTES_PER_S * 1e6
            for tag, part in (("shard", shards[:1]), ("mesh", shards)):
                stand_in = queued_us(spmv_stand_in(dev), calls)
                row = {"row": "5cd" if df else "5d", "dtype": kind, "n": n,
                       "step": tag, "shards": len(part),
                       "bound_us": bound_us * len(part),
                       "spmv_stand_in": {"device_us": stand_in[0],
                                         "samples": stand_in[1]}}
                for name, early in (("kernel", True),
                                    ("kernel_no_early", False),
                                    ("eager", True)):
                    eager = name == "eager"
                    with (eager_shard_passes() if eager
                          else contextlib.nullcontext()):
                        us, samples = queued_us(
                            mesh_step(*(list(t) for t in zip(*part)), df,
                                      early),
                            max(calls // 10, 2) if eager else calls)
                    row[name] = {"device_us": us, "samples": samples}
                emit(row)
            del shards
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
