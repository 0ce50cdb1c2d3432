"""Time the main path of two checkouts of the port on one GPU, in turns.

    python -m tpu_lanczos_torch.eval.main_path_times --other DIR [--tag NAME]
        [--rounds N] [--sharded]

Each turn is a child process that imports ``tpu_lanczos_torch`` from one
checkout (this one, or ``DIR``: another commit unpacked with ``git
archive``), builds its kernels, packs bench.py's graph (Barabasi-Albert
n=1M, m=10, seed 0, native generator; sub=512) and times what chip_smoke
phase 3 times on it: one SpMV and ``lanczos(dg, realmask, 50)`` (CUDA
events) and the top-20 query ``expm_action_summary`` with the host and
the device eigensolve (host wall, synchronised); medians of 5 after one
warm run; the df64 query ``expm_action_df`` (median of 3) and one
single-device df SpMV ``spmv_cpg_df`` (CUDA events, median of 5); and the
Lanczos step alone (rows 5 and 5c, device microseconds a step queued
behind a sleeping kernel) at bn1M's n_pad, at 2^23 (stencil_2600's) and,
for df64, at Europe's size, with and without the pack's realmask
multiply; and the row-sharded path on 4 shards of the card
(``make_mesh(devices=[cuda:0] * 4)``, the shards in turn):
``lanczos_cpg_sharded`` at k=50 (CUDA events, median of 5), the df64
query ``expm_action_df_sharded`` (host wall, median of 3), one SpMV and
one df SpMV (CUDA events, median of 5), each shard's local SpMV and df
SpMV alone with the exchanges it reads made beforehand (the slowest one
a real mesh's critical path), the whole
4-shard step after the SpMV, f32 and df64 (the loops' own step function
on the stored products of one SpMV, behind one ordinary one-value
kernel that stands in for the SpMV's last level, queued behind a sleep),
and the f32 loop step with its real SpMV; each queued measure with the
host's enqueue time a call.  The turns run other, this, this, other
(``--rounds`` times), so drift on the card or its host shows in the
other checkout's rows; ``--sharded`` times only the row-sharded path.
One JSON line per turn; the first line is the card's name and power
limit.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# each turn times one shard alone through this checkout's helper
SHARD_ALONE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "shard_alone.py")

TURN = r"""
import json, sys, time
root, tag, only_sharded = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
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
row = {"tag": tag, "root": root, "device": torch.cuda.get_device_name(0)}
if not only_sharded:
    dg = pack_cpg(g, sub=512, device="cuda")
    x1 = dg.realmask.clone()
    row["spmv_ms"], row["spmv_samples"] = cuda_ms(
        lambda: spmv_cpg.spmv_cpg(dg, x1))
    row["lanczos_k50_ms"], row["lanczos_samples"] = cuda_ms(
        lambda: lanczos(dg, x1, 50))
    row["query_host_eig_s"], row["query_host_eig_samples"] = wall_s(
        lambda: expm_action_summary(g, k=50, topk=20, dg=dg))
    row["query_device_eig_s"], row["query_device_eig_samples"] = wall_s(
        lambda: expm_action_summary(g, k=50, topk=20, dg=dg,
                                    eig_impl="device"))
    row["df64_query_s"], row["df64_query_samples"] = wall_s(
        lambda: expm_action_df(g, k=50, dg=dg, log_scale=True), reps=3)
    lo1 = torch.full_like(x1, 2.0 ** -30) * x1
    row["df_spmv_ms"], row["df_spmv_samples"] = cuda_ms(
        lambda: spmv_cpg.spmv_cpg_df(dg, x1, lo1))

# the row-sharded path, 4 shards in turn on the card
from tpu_lanczos_torch.dist import make_mesh
from tpu_lanczos_torch.dist.cpg_sharded import (lanczos_cpg_sharded,
                                                pack_cpg_sharded)
from tpu_lanczos_torch.dist.lanczos_df import expm_action_df_sharded
mesh4 = make_mesh(devices=["cuda:0"] * 4)
sg4 = pack_cpg_sharded(g, 4, mesh=mesh4, sub=512)
x4 = [r.clone() for r in sg4.realmask]
row["lanczos_4_shard_k50_ms"], row["lanczos_4_shard_samples"] = cuda_ms(
    lambda: lanczos_cpg_sharded(sg4, x4, 50, mesh4))
row["df64_query_4_shard_s"], row["df64_query_4_shard_samples"] = wall_s(
    lambda: expm_action_df_sharded(g, k=50, mesh=mesh4, sg=sg4,
                                   log_scale=True), reps=3)

# the 4-shard SpMV and df SpMV, and each shard's local SpMV and df SpMV
# alone with the exchanges it reads made beforehand (the slowest one is a
# real mesh's critical path), through this script's checkout's
# eval/shard_alone.py
import importlib.util
from tpu_lanczos_torch.dist.cpg_sharded import spmv_cpg_sharded
from tpu_lanczos_torch.dist.lanczos_df import spmv_cpg_df_sharded
spec = importlib.util.spec_from_file_location("shard_alone", sys.argv[4])
shard_alone = importlib.util.module_from_spec(spec)
spec.loader.exec_module(shard_alone)
lo4 = [torch.zeros_like(t) for t in x4]
row["spmv_4_shard_ms"], row["spmv_4_shard_samples"] = cuda_ms(
    lambda: spmv_cpg_sharded(sg4, mesh4, x4))
row["df_spmv_4_shard_ms"], row["df_spmv_4_shard_samples"] = cuda_ms(
    lambda: spmv_cpg_df_sharded(sg4, mesh4, x4, lo4))
alone = shard_alone.alone_fn(spmv_cpg_sharded, sg4, mesh4, x4)
alone_df = shard_alone.alone_fn(spmv_cpg_df_sharded, sg4, mesh4, x4, lo4)
row["shard_alone_ms"] = [cuda_ms(lambda: alone(s))[0] for s in range(4)]
row["shard_alone_df_ms"] = [cuda_ms(lambda: alone_df(s))[0]
                            for s in range(4)]


def queued_us(fn, calls=50, reps=5):
    # (median device us a call, samples, the host's enqueue us a call)
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
    return float(np.median(out)), out, enqueue / calls * 1e6


def queued(name, fn, calls=50):
    us, samples, host_us = queued_us(fn, calls)
    row[name + "_us"], row[name + "_samples"] = us, samples
    row[name + "_host_us"] = host_us


# the whole 4-shard step after the SpMV: the loops' own step function
# with the SpMV replaced by the stored products of one real SpMV, its
# passes and whatever runs between them, queued behind a sleep.  The
# stand-in SpMV queues one ordinary one-value kernel, as the real one
# ends in its last level kernel: so no call's first pass overlaps the
# last call's normalize by dependent launch, which no loop step can
# (its time alone: spmv_stand_in).  loop_step_4_shard_f32: the loop's
# step with the real SpMV, device and host enqueue a step.
from tpu_lanczos_torch.dist import lanczos_df as dldf
from tpu_lanczos_torch.dist import mesh as dmesh
from tpu_lanczos_torch.dist.cpg_sharded import _local


def step_state(width=()):
    if hasattr(dmesh, "step_buffers"):
        return dmesh.step_buffers(mesh4, torch.float32, width)
    return dmesh.workspaces(mesh4)


nrm = float(torch.cat(x4).norm())
q4 = [t / nrm for t in x4]
qp4 = [torch.zeros_like(t) for t in q4]
v4 = _local(sg4, mesh4)(q4)
tick = torch.zeros(1, device="cuda")
spmv4 = dmesh.LocalSpmv(lambda q: (tick.add_(1), v4)[1],
                        mask=list(sg4.realmask))
ab4 = [torch.zeros(8, device="cuda") for _ in range(4)]
queued("spmv_stand_in", lambda: tick.add_(1))


def mesh_step(spmv):
    carry = {"ss": None, "j": 1, "bufs": step_state()}

    def step():
        j = carry["j"]
        carry["j"] = 3 - j  # steps 1, 2, 1, ...: both norm parities
        carry["ss"] = dmesh._step_passes(mesh4, spmv, q4, qp4, carry["ss"],
                                         ab4[0], ab4[1], j,
                                         carry["bufs"])[1]
    return step


queued("step_4_shard_f32", mesh_step(spmv4))
queued("loop_step_4_shard_f32", mesh_step(_local(sg4, mesh4)), calls=20)
qd4 = [(t, torch.zeros_like(t)) for t in q4]
pd4 = [(torch.zeros_like(t), torch.zeros_like(t)) for t in q4]
# the df SpMV's product, masked: the step's passes multiply it by the
# 0/1 realmask again, which changes no value
vd4 = spmv_cpg_df_sharded(sg4, mesh4, [p[0] for p in qd4],
                          [p[1] for p in qd4])
real_df_spmv = dldf._local_spmv_df
dldf._local_spmv_df = lambda *a, **kw: (tick.add_(1), vd4)[1]
carry = {"ss": None, "j": 1, "bufs": step_state((2,))}


def mesh_df_step():
    j = carry["j"]
    carry["j"] = 3 - j
    carry["ss"] = dldf._step_df(sg4, mesh4, qd4, pd4, carry["ss"],
                                carry["bufs"], j, (ab4[0], ab4[1]),
                                (ab4[2], ab4[3]))[1]


queued("step_4_shard_df64", mesh_df_step, calls=20)
dldf._local_spmv_df = real_df_spmv
del sg4, x4, v4, vd4
torch.cuda.empty_cache()
if only_sharded:
    print(json.dumps(row), flush=True)
    sys.exit(0)

# the Lanczos step alone, device microseconds a step (queued behind a
# sleeping kernel, so the host's enqueue is not timed), on seeded vectors:
# "step" without the realmask, "step_masked" with it as a Lanczos on a CPG
# pack pays for it (the step's mask= where the checkout has it, else the
# SpMV's separate multiply)
import inspect
from tpu_lanczos_torch.kernels import lanczos_step as ls
folds = "mask" in inspect.signature(ls.lanczos_step).parameters
row["step_folds_mask"] = folds


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
    p.add_argument("--rounds", type=int, default=1,
                   help="rounds of the four turns")
    p.add_argument("--sharded", action="store_true",
                   help="time only the row-sharded path")
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
        # each turn builds its own checkout's kernels into its build/
        proc = subprocess.run([sys.executable, "-c", TURN, root, tag,
                               "1" if args.sharded else "0", SHARD_ALONE],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
