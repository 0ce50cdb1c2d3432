"""Time the main path of two checkouts of the port on one GPU, in turns.

    python -m tpu_lanczos_torch.eval.main_path_times --other DIR [--tag NAME]

Each turn is a child process that imports ``tpu_lanczos_torch`` from one
checkout (this one, or ``DIR``: another commit unpacked with ``git
archive``), builds its kernels, packs bench.py's graph (Barabasi-Albert
n=1M, m=10, seed 0, native generator; sub=512) and times what chip_smoke
phase 3 times on it: one SpMV and ``lanczos(dg, realmask, 50)`` (CUDA
events) and the top-20 query ``expm_action_summary`` with the host and
the device eigensolve (host wall, synchronised); medians of 5 after one
warm run; the df64 query ``expm_action_df`` (median of 3); and the
Lanczos step alone (rows 5 and 5c, device microseconds a step queued
behind a sleeping kernel) at bn1M's n_pad, at 2^23 (stencil_2600's) and,
for df64, at Europe's size, with and without the pack's realmask
multiply; and the row-sharded path on 4 shards of the card
(``make_mesh(devices=[cuda:0] * 4)``, the shards in turn):
``lanczos_cpg_sharded`` at k=50 (CUDA events, median of 3) and the df64
query ``expm_action_df_sharded`` (host wall, median of 3).  The turns
run other, this, this, other, so drift on the card
or its host shows in the other checkout's two rows.  One JSON line per
turn; the first line is the card's name and power limit.  Needs a CUDA
GPU.
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
import json, sys, time
root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np, torch
import tpu_lanczos_torch
assert tpu_lanczos_torch.__file__.startswith(root), tpu_lanczos_torch.__file__
from tpu_lanczos_torch import generators, expm_action_summary
from tpu_lanczos_torch.core.lanczos_df import expm_action_df
from tpu_lanczos_torch.core.lanczos import lanczos
from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.cpg import pack_cpg


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return float(np.median(out)), out


def wall_s(fn, reps=5):
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        out.append(time.time() - t0)
    return float(np.median(out)), out


g = generators.barabasi_albert(1_000_000, 10, seed=0, use_native=True)
dg = pack_cpg(g, sub=512, device="cuda")
x1 = dg.realmask.clone()
row = {"tag": tag, "root": root, "device": torch.cuda.get_device_name(0)}
row["spmv_ms"], row["spmv_samples"] = cuda_ms(
    lambda: spmv_cpg.spmv_cpg(dg, x1))
row["lanczos_k50_ms"], row["lanczos_samples"] = cuda_ms(
    lambda: lanczos(dg, x1, 50))
row["query_host_eig_s"], row["query_host_eig_samples"] = wall_s(
    lambda: expm_action_summary(g, k=50, topk=20, dg=dg))
row["query_device_eig_s"], row["query_device_eig_samples"] = wall_s(
    lambda: expm_action_summary(g, k=50, topk=20, dg=dg, eig_impl="device"))
row["df64_query_s"], row["df64_query_samples"] = wall_s(
    lambda: expm_action_df(g, k=50, dg=dg, log_scale=True), reps=3)

# the row-sharded path, 4 shards in turn on the card
from tpu_lanczos_torch.dist import make_mesh
from tpu_lanczos_torch.dist.cpg_sharded import (lanczos_cpg_sharded,
                                                pack_cpg_sharded)
from tpu_lanczos_torch.dist.lanczos_df import expm_action_df_sharded
mesh4 = make_mesh(devices=["cuda:0"] * 4)
sg4 = pack_cpg_sharded(g, 4, mesh=mesh4, sub=512)
x4 = [r.clone() for r in sg4.realmask]
row["lanczos_4_shard_k50_ms"], row["lanczos_4_shard_samples"] = cuda_ms(
    lambda: lanczos_cpg_sharded(sg4, x4, 50, mesh4), reps=3)
row["df64_query_4_shard_s"], row["df64_query_4_shard_samples"] = wall_s(
    lambda: expm_action_df_sharded(g, k=50, mesh=mesh4, sg=sg4,
                                   log_scale=True), reps=3)
del sg4, x4
torch.cuda.empty_cache()

# the Lanczos step alone, device microseconds a step (queued behind a
# sleeping kernel, so the host's enqueue is not timed), on seeded vectors:
# "step" without the realmask, "step_masked" with it as a Lanczos on a CPG
# pack pays for it (the step's mask= where the checkout has it, else the
# SpMV's separate multiply)
import inspect
from tpu_lanczos_torch.kernels import lanczos_step as ls
folds = "mask" in inspect.signature(ls.lanczos_step).parameters
row["step_folds_mask"] = folds


def queued_us(fn, calls=50, reps=5):
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(calls):
        fn()
    enqueue = time.time() - t0
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda._sleep(int(2e9 * (2 * enqueue + 0.01)))
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / calls * 1e3)
    return float(np.median(out)), out


def step_times(n, df):
    rng = np.random.default_rng(0)
    q = rng.standard_normal(n)
    q /= np.linalg.norm(q)
    xs = [rng.standard_normal(n), q, rng.standard_normal(n) / np.sqrt(n)]
    mask = torch.from_numpy((rng.random(n) < 0.9).astype(np.float32)).cuda()
    work = ls.workspace("cuda")
    if df:
        vecs = []
        for x in xs:
            hi = x.astype(np.float32)
            vecs.append((torch.from_numpy(hi).cuda(), torch.from_numpy(
                (x - hi.astype(np.float64)).astype(np.float32)).cuda()))
        v, q, qp = vecs
        ab = [torch.zeros(8, device="cuda") for _ in range(4)]
        ab[2][2] = 0.75
        step = lambda vv, **kw: ls.lanczos_step_df(vv, q, qp, ab[:2], ab[2:],
                                                   3, work=work, **kw)
        masked = ((lambda: step(v, mask=mask)) if folds else
                  (lambda: step((v[0] * mask, v[1] * mask))))
    else:
        v, q, qp = (torch.from_numpy(x).float().cuda() for x in xs)
        ab = [torch.zeros(8, device="cuda") for _ in range(2)]
        ab[1][2] = 0.75
        step = lambda vv, **kw: ls.lanczos_step(vv, q, qp, *ab, 3, work=work,
                                                **kw)
        masked = ((lambda: step(v, mask=mask)) if folds else
                  (lambda: step(v * mask)))
    plain = queued_us(lambda: step(v))
    with_mask = queued_us(masked)
    return {"n": n, "step_us": plain[0], "step_samples": plain[1],
            "step_masked_us": with_mask[0],
            "step_masked_samples": with_mask[1]}


# bn1M's n_pad, stencil_2600's, and (df64) Europe's 7134^2 nodes padded to
# 512-row chunks of 128 lanes
row["step_f32"] = [step_times(n, False) for n in (dg.n_pad, 1 << 23)]
row["step_df64"] = [step_times(n, True)
                    for n in (dg.n_pad, 1 << 23, 777 * 65536)]
print(json.dumps(row), flush=True)
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True,
                   help="root of the other checkout (holds "
                        "tpu_lanczos_torch/)")
    p.add_argument("--tag", default="other", help="the other checkout's tag")
    args = p.parse_args(argv)
    other = os.path.abspath(args.other)
    if not os.path.isdir(os.path.join(other, "tpu_lanczos_torch")):
        p.error(f"{other} holds no tpu_lanczos_torch/")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root, tag in ((other, args.tag), (THIS_ROOT, "this"),
                      (THIS_ROOT, "this"), (other, args.tag)):
        # each turn builds its own checkout's kernels into its build/
        proc = subprocess.run([sys.executable, "-c", TURN, root, tag],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
