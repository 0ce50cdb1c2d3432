"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (sm_90a), nvcc and g++; imports nothing of
jax or of the JAX package.  Each phase prints one JSON line:

  0  toolchain: torch/CUDA versions, card, capability, nvcc, triton;
  1  build: the CUDA kernels (nvcc) and the native graph core (g++),
     from this checkout's sources, with their build seconds;
  2  the SpMV kernels (plain and compensated, classic and slab layout,
     and the df level kernels that run a df SpMV's level in one launch)
     against their plain PyTorch versions on the card, on every level of
     small classic and slab packs (f32 and f64) and on whole SpMVs and df
     SpMVs: exact equality; the f64 and df64 SpMVs against scipy; and the
     Lanczos step kernels (rows 5 and 5c, one cooperative launch a
     step) on each pack's SpMV output: alpha and beta within 1e-6 (f32),
     1e-13 (f64) and 5e-11 (df64) of the plain version's (row 5c's hi
     word equal), q_{j+1}, the stored row and the recombine fold
     bit-identical given the kernel's scalars, the run with the pack's
     realmask folded in (``mask=``) bit-identical to the run on the
     masked SpMV;
  3  the main path at bench.py's size (Barabasi-Albert n=1M, m=10,
     seed 0, native generator; pack sub=512; k=50) through
     ``expm_action`` and ``expm_action_summary`` (host and device
     eigensolve), with the kernel launch counts of that run (level and
     step kernels), CUDA-event timings (per level with its per-chunk tile
     counts and its bound), the cuSPARSE SpMV time beside the kernel's,
     the host syncs of each summary path, and row 5 at full size: the
     step kernel against its plain version, its device time per step
     beside the eager step's and its bound, and Lanczos k=50 through the
     kernel and through the eager step in turns;
  3b the same graph packed as the main path packs it
     (``best_device_pack``: sub 256, the benchmark's pack): every level
     against its plain version in f32 and f64, the main level by the
     staged walk and the small ones by the one-thread walk
     (``spmv_cpg.staged_walk``), ``expm_action``'s launches of each walk,
     and the staged main level timed beside the one-thread walk on the
     same level, its plain version and its bound;
  4  accuracy of the f32 answer against the float64 numpy oracle;
  5  the two-pass paths on the same graph, pack and oracle answer: the
     f32 ``low_mem=True`` queries (alpha/beta bit-equal to stored-Q
     Lanczos, launch count, accuracy, top-20, peak memory) and the df64
     pipeline (``expm_action_df``, ``expm_action_ks_df``, the pass-1
     checkpoint), each with its launch counts (one df level launch a
     level, none of kernels 1 and 1c), accuracy and timings, the df SpMV
     through the df level kernel and composed of kernels 1c and 1 in
     turns, each level beside its bound, and row 5c at full size as row
     5 in phase 3;
  6  the slab layout on the same graph: its pack beside the classic one,
     the slab kernels == plain on every level, ``expm_action`` and
     ``expm_action_df`` on the slab pack (launch counts, accuracy, top-20)
     and the slab SpMV, each level, the compensated main level, the df
     SpMV (as in phase 5) and Lanczos timed beside the classic, each
     beside its bound and the plain version, with the cuSPARSE SpMV timed
     again;
  7  the CLI (``tpu_lanczos_torch.cli.main.main``) in process: the
     full-width slab --topk query with the device and the host
     eigensolve, and each single-device mode on a small graph against
     the serial oracle; ``--shards 2`` fails on one GPU with the
     reference's "need 2 devices, have 1";
  8  the lineage formats on the same graph and oracle answer: GPG and CST
     packs (the CST pack, ~5 min of host numpy, is built by a child
     process while phases 2-7 run), their kernels == plain on every level
     of bn1M and of the small packs of tests/test_cst.py and
     tests/test_gpg.py, the f64 SpMVs against scipy, ``expm_action``
     through each (launch counts, accuracy, top-20), the GPG top-20
     query, SpMV, per-level and Lanczos timings beside each bound (CST:
     its int16/uint8 device indices and the TPU's int32 pair) and
     cuSPARSE, GPG's per-chunk tile counts and real-step share, and
     ``--fmt cst`` in the CLI;
  9  the tensor-core dense-block probe (``python -m
     tpu_lanczos_torch.eval.mxu_probe``): its check, its default run of
     16,384 blocks in three variants (each with the device time of its
     two launches, the block stream and the reduce), the kernel against
     the plain version at that size, and a bf16 matmul as the yardstick,
     timed as the probe is and by its device time;
 10  the stochastic estimators on phase 3's pack (``estrada_index``,
     ``subgraph_centrality``, ``spectral_density`` at their library
     defaults): kernel 1's launches per call, CUDA-event and wall time,
     host syncs, the first two Estrada probes against the float64
     oracle, float32 against float64, tests/test_stochastic.py's ba200
     graph through the CLI against its dense oracle; and the stored-Q
     checkpoint at k=50 (cut after one chunk, resumed, uninterrupted),
     bit for bit against ``lanczos``;
 11  the row-sharded path (``tpu_lanczos_torch.dist``) on phase 3's
     graph, 4 shards of this one card (``make_mesh(devices=[cuda:0] *
     4)``): the pack, kernel 1 on every f32/f64 pass and reduce level
     (the unsplit halo pack's level reading the shard's rows and its halo
     in place) and the df64 shard kernel (``kernels/csrc/
     spmv_cpg_shard.cu``: every df64 level of a shard with its folds in
     one launch) == their plain versions on every shard level, the
     1-shard SpMV == single-device, the exact launch
     counts of ``lanczos_cpg_sharded``, ``expm_action_sharded`` and
     ``expm_action_df_sharded``, their accuracy against phase 4's oracle,
     the halo path on a 2-D stencil, the sharded estimators against
     phase 10, one NCCL rank, the CLI's ``--shards``, and CUDA-event
     times (the shards run in turn on one card: kernel work and
     launches, no collective over a link) of the SpMV, the df SpMV and
     each shard's alone with its exchanges made beforehand
     (``eval/shard_alone.py``); and rows 5d and 5cd, the
     step's per-shard passes: each pass kernel with its slots against its
     plain version at a shard's n_loc and at an odd chunk count, the
     exact pass counts of every sharded loop, the device time of one
     shard's step and of the whole 4-shard step after the SpMV beside the
     eager passes' and their bounds, the 4-shard Lanczos and df64 query
     through the kernels and through the eager passes in turns, and
     (after phase 9, in child processes) a traced 4-shard Lanczos with no
     kernel between a step's passes, and a traced SpMV and df SpMV;
 12  the eval harness (``tpu_lanczos_torch.eval``) on phase 3's graph,
     pack and phase 4's oracle answer: the stage breakdown (kernel 1's
     launches per Lanczos, the staged answer against ``expm_action``'s;
     profiler traces, run after phase 9, of a bn1M Lanczos and df SpMV
     and of a stencil_2600 Lanczos, the first profile of a mesh), fused
     serving
     (top-20 overlap and
     values), the accuracy record (f32 and df64 against the oracle, the
     launches of kernels 1 and 1c), two bench-suite rows (copapers_540k
     packed at sub=128, stencil_2600 with more than 64 dest chunks; every
     level of each pack held against the plain versions before timing,
     launches counted) and the small jobs (the k and pack sweeps, the
     df64 sweep, stochastic_bench's seed agreement, europe_df64 at side
     1000 with a bit-identical resume).

Phases 10, 11 and 12 run after phase 7, while the CST pack child that
phase 8 waits for is still packing; then phases 8 and 9, and the traced
Lanczos runs of phases 12 and 11.  Then the card's name
and power limit (nvidia-smi), one JSON line of
per-kernel results (with each kernel's bound: the larger of its bytes
over the HBM rate and its operations over their peak rate; the step
kernels' ``launches`` count steps, one cooperative launch each), and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
nonzero and prints no final line.
"""

from __future__ import annotations

import atexit
import contextlib
import importlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

N, M, K, SEED, SUB, TOPK = 1_000_000, 10, 50, 0, 512, 20
REPS = 5
KERNEL_SOURCE = "tpu_lanczos_torch/kernels/csrc/spmv_cpg.cu"
KERNEL_REPLACES = "tpu_lanczos/kernels/spmv_cpg.py:85"
COMP_REPLACES = "tpu_lanczos/kernels/spmv_cpg.py:85 (compensated=True)"
STAGED_REPLACES = ("tpu_lanczos/kernels/spmv_cpg.py:85 (a classic level "
                   "that spmv_cpg.staged_walk routes to the staged walk)")
SLAB_REPLACES = "tpu_lanczos/kernels/spmv_cpg.py:85 (slab=True, :184-205)"
COMP_SLAB_REPLACES = ("tpu_lanczos/kernels/spmv_cpg.py:85 (compensated=True,"
                      " slab=True)")
# the single-device df64 level: kernels 1c (hi) and 1 (lo) of a level and
# the eager folds between (spmv_cpg_df :450-483), one launch a level
DF_SOURCE = "tpu_lanczos_torch/kernels/csrc/spmv_cpg_shard.cu"
DF_REPLACES = ("tpu_lanczos/kernels/spmv_cpg.py:85 (pallas_call :342 "
               "compensated=True on hi and plain on lo, a level of "
               "spmv_cpg_df :419-483 with its two-sum folds)")
DF_SLAB_REPLACES = ("tpu_lanczos/kernels/spmv_cpg.py:85 (slab=True; "
                    "compensated=True on hi and plain on lo, a level of "
                    "spmv_cpg_df :419-483 with its two-sum folds)")
CST_SOURCE = "tpu_lanczos_torch/kernels/csrc/spmv_cst.cu"
CST_REPLACES = "tpu_lanczos/kernels/spmv_pallas2.py:42 and :52"
GPG_SOURCE = "tpu_lanczos_torch/kernels/csrc/spmv_gpg.cu"
GPG_REPLACES = "tpu_lanczos/kernels/spmv_gpg.py:154"
PROBE_SOURCE = "tpu_lanczos_torch/kernels/csrc/mxu_probe.cu"
PROBE_REPLACES = "tpu_lanczos/eval/mxu_probe.py:106"
STEP_SOURCE = "tpu_lanczos_torch/kernels/csrc/lanczos_step.cu"
STEP_REPLACES = ("tpu_lanczos/core/lanczos.py:84-96 (the XLA-fused step of "
                 "the fori_loop; no Pallas kernel)")
STEP_DF_REPLACES = ("tpu_lanczos/core/lanczos_df.py:30-40 (_body_core after "
                    "the SpMV, XLA-fused; no Pallas kernel)")
# the step kernel of a float32 Lanczos, counted by the trace
# (csrc/lanczos_step.cu: one launch a step)
STEP_KERNELS = ("lanczos_step_kernel",)
# kernel 1's two classic walks (spmv_cpg.staged_walk picks one a level)
LEVEL_KERNELS = ("cpg_level_kernel", "cpg_staged_level_kernel")
KS = (10, 30, 50)
CKPT_CHUNK = 16
# the H100 SXM's published peaks (700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# every kernel's launch counter, (module, name): its wrapper adds one per
# launch
COUNTERS = tuple(("tpu_lanczos_torch.kernels.spmv_cpg", c) for c in (
    "launches", "launches_slab", "launches_comp", "launches_comp_slab",
    "launches_shard_df", "launches_df", "launches_df_slab")) + (
    ("tpu_lanczos_torch.kernels.spmv_cst", "launches_cst"),
    ("tpu_lanczos_torch.kernels.spmv_gpg", "launches_gpg"),
    ("tpu_lanczos_torch.eval.mxu_probe", "launches_mxu"),
    ("tpu_lanczos_torch.kernels.lanczos_step", "launches_step"),
    ("tpu_lanczos_torch.kernels.lanczos_step", "launches_step_df"),
    ("tpu_lanczos_torch.kernels.lanczos_step", "launches_step_sharded"),
    ("tpu_lanczos_torch.kernels.lanczos_step", "launches_step_df_sharded"),
)
CLI_SMALL = ["-b", "4", "-n", "20000", "-k", "50"]
# phase 10: the library defaults of estrada_index and subgraph_centrality,
# spectral_density's default k and probes, and tests/test_stochastic.py's
# ba200 graph through the CLI against its dense oracle
ESTRADA = dict(k=30, probes=32, deflate=8)
SUBGRAPH = dict(k=20, probes=16, deflate=8)
DOS = dict(k=80, probes=16)
CLI_ESTIMATORS = ["-b", "3", "-n", "200", "--seed", "1", "-k", "40",
                  "--dtype", "float64", "--estrada", "32", "--subgraph",
                  "32", "--dos", "32", "--deflate", "8"]
CKPT_Q_CHUNK = 25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def run_text(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          check=True).stdout.strip()


def cuda_ms(torch, fn, reps: int = REPS):
    """Median and all samples of fn's time in ms (CUDA events), after one
    warm run."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples)), samples


def wall_s(torch, fn, reps: int = REPS):
    """Median and all samples of fn's host wall in s, synchronised, after
    one warm run."""
    fn()
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        samples.append(time.time() - t0)
    return float(np.median(samples)), samples


def syncs(torch, fn) -> int:
    """Host syncs torch reports while fn runs (sync debug mode)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def run_cli(argv):
    """The port's CLI in process: (rc, stdout, stderr, wall seconds)."""
    from tpu_lanczos_torch.cli import main as cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue(), time.time() - t0


def reset_counts() -> None:
    for mod, name in COUNTERS:
        setattr(importlib.import_module(mod), name, 0)


def read_counts(torch) -> dict:
    torch.cuda.synchronize()
    return {name: getattr(importlib.import_module(mod), name)
            for mod, name in COUNTERS}


def check_counts(counts: dict, want: dict, what: str) -> None:
    """Exactly ``want`` launches of each named counter, none of the rest."""
    full = {name: want.get(name, 0) for _, name in COUNTERS}
    check(counts == full, f"{what}: kernel launches {counts} == {full}")


def level_cost(cg, i: int, value_bytes: int, n_out: int, base: bool,
               adds_per_entry: int = 1):
    """(bytes, adds) one level must move and do at least: its real
    tiles' l1 + l2 + s_ids and the chunk ranges read once, x (and base)
    read once, each output written once; one add per tile cell
    (``adds_per_entry`` for the compensated two-sum), one per cell for
    the base."""
    t, sub = cg.t_reals[i], cg.sub
    rows = 128 if cg.layout == "slab" else sub
    l2b = cg.levels[i]["l2"].element_size()
    idx = t * (rows * 128 + 128 * sub * l2b + 4) + 2 * cg.n_chunks * 4
    vec = cg.n_pad * value_bytes * (1 + n_out + int(base))
    adds = t * sub * 128 * adds_per_entry + (cg.n_pad if base else 0)
    return idx + vec, adds


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over their peak rate (float32 adds by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spmv_cost(cg, value_bytes: int = 4):
    """(bytes, adds) of one whole SpMV: every level, the realmask read
    and the masked y written."""
    nbytes, adds = 0, 0
    for i in range(len(cg.levels)):
        b, a = level_cost(cg, i, value_bytes, 1, i != cg.n_bcast)
        nbytes, adds = nbytes + b, adds + a
    return nbytes + cg.n_pad * (4 + value_bytes), adds + cg.n_pad


def df_level_cost(cg, i: int):
    """(bytes, ops) of level i of a single-device df SpMV as its level
    kernel runs it: the real tiles' l1 + l2 + s_ids and the chunk ranges
    read once for both streams, the source pair read once (a broadcast or
    a reduce level's base is that source), the output pair written once,
    and on the last level the realmask read.  The two-sum's seven adds
    and lo's one a tile cell; a cell's two base adds in a broadcast level,
    one add on the main level, the fold's ten on a reduce level, and the
    finish's six adds and two multiplies on the last
    (``sharded_spmv_cost``'s counts)."""
    sub, nb, n = cg.sub, cg.n_bcast, cg.n_pad
    rows = 128 if cg.layout == "slab" else sub
    t, l2b = cg.t_reals[i], cg.levels[i]["l2"].element_size()
    last = int(i == len(cg.levels) - 1)
    nbytes = (t * (rows * 128 + 128 * sub * l2b + 4) + 2 * cg.n_chunks * 4
              + 2 * n * 8 + last * n * 4)
    ops = (t * sub * 128 * 8 + n * (2 if i < nb else 1 if i == nb else 10)
           + last * n * 8)
    return nbytes, ops


def df_spmv_cost(cg):
    """(bytes, ops) of one single-device df SpMV: its levels'
    ``df_level_cost``."""
    costs = [df_level_cost(cg, i) for i in range(len(cg.levels))]
    return sum(c[0] for c in costs), sum(c[1] for c in costs)


def cst_spmv_cost(cg, value_bytes: int = 4, index_bytes=None):
    """(bytes, adds) of one CST SpMV: idx1 and idx3 read once (as stored,
    or ``index_bytes``), each level's source (a reduce level's source is
    its start) read once and its output written once, the realmask read
    and y written; one add per slot cell, one multiply per cell for the
    mask."""
    levels = len(cg.idx1)
    if index_bytes is None:
        index_bytes = cg.index_bytes()
    nbytes = (index_bytes + levels * 2 * cg.n_pad * value_bytes
              + cg.n_pad * (4 + value_bytes))
    return nbytes, cg.total_slots * cg.n_pad + cg.n_pad


def gpg_spmv_cost(gg, value_bytes: int = 4):
    """(bytes, adds) of one GPG SpMV: the real tiles' l1, l2 and g_ids and
    the chunk ranges read once, each level's x read and output written
    once (a reduce level also reads y to fold into), the realmask read
    and y written; one add per tile cell, one per cell per fold."""
    levels = len(gg.levels)
    vec = gg.n_pad * value_bytes
    nbytes = (gg.index_bytes() + levels * 2 * gg.n_chunks * 4
              + levels * 2 * vec + (levels - 1) * 2 * vec
              + gg.n_pad * 4 + vec)
    adds = (sum(gg.t_reals) * 128 * gg.sub_d + (levels - 1) * gg.n_pad
            + gg.n_pad)
    return nbytes, adds


# bn1M's CST pack is host numpy (~5 min on the card's machine): a child
# process builds it while phases 2-7 run, and hands it over in a file
CST_CHILD = """
import json, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
from tpu_lanczos_torch import generators
from tpu_lanczos_torch.kernels.cst import pack_cst
n, m, seed = (int(a) for a in sys.argv[2:5])
path = sys.argv[5]
g = generators.barabasi_albert(n, m, seed=seed, use_native=True)
t0 = time.time()
cg = pack_cst(g, device="cpu")
pack_s = time.time() - t0
arrays = {f"idx1_{i}": a.numpy() for i, a in enumerate(cg.idx1)}
arrays.update({f"idx3_{i}": a.numpy() for i, a in enumerate(cg.idx3)})
np.savez(path, n=cg.n, n_cols=cg.n_cols, nnz=cg.nnz, theta=cg.theta,
         n_levels=len(cg.idx1), realmask=cg.realmask.numpy(),
         new_of_old=cg.new_of_old, **arrays)
print(json.dumps({"pack_s": pack_s}))
"""


def _die_with_parent() -> None:
    import ctypes
    import signal

    ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def start_cst_pack(path: str):
    """Start the child that packs bn1M (the phase-3 graph, from the same
    seed) into CST on the host and saves it to ``path``.  It is killed
    when this process exits, however it exits."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", CST_CHILD, root, str(N), str(M), str(SEED),
         path], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=_die_with_parent)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def finish_cst_pack(torch, proc, path: str, dev):
    """Wait for the child and move its pack to ``dev``.  Returns (pack,
    the child's pack seconds, load and host-to-device seconds)."""
    from tpu_lanczos_torch.kernels import cst

    out, err = proc.communicate(timeout=900)
    check(proc.returncode == 0,
          f"CST pack child: rc {proc.returncode}: {err[-2000:]}")
    pack_s = json.loads(out.strip().splitlines()[-1])["pack_s"]
    t0 = time.time()
    with np.load(path) as z:
        L = int(z["n_levels"])
        cg = cst.from_numpy(
            {k: int(z[k]) for k in ("n", "n_cols", "nnz", "theta")},
            [z[f"idx1_{i}"] for i in range(L)],
            [z[f"idx3_{i}"] for i in range(L)],
            z["realmask"], z["new_of_old"], dev)
    torch.cuda.synchronize()
    os.remove(path)
    return cg, pack_s, time.time() - t0


def lineage_chain(torch, spmv_mod, pack, x, kernel, plain):
    """One SpMV of a CST or GPG pack (``spmv_mod._spmv``) with every level
    through the kernel and its plain version on the same inputs, the
    kernel's output carried on.  Returns the max |kernel - plain|."""
    err = 0.0

    def level(*args):
        nonlocal err
        got, want = kernel(*args), plain(*args)
        check(torch.equal(got, want),
              f"{kernel.__name__} == {plain.__name__}")
        err = max(err, float((got - want).abs().max()))
        return got

    spmv_mod._spmv(pack, x, level)
    return err


def lineage_level_ms(torch, spmv_mod, pack, x, kernel):
    """CUDA-event medians of each level of one CST or GPG SpMV through
    ``kernel``, on the inputs ``spmv_mod._spmv`` gives each level."""
    inputs = []

    def record(*args):
        inputs.append(args)
        return kernel(*args)

    spmv_mod._spmv(pack, x, record)
    return [cuda_ms(torch, lambda: kernel(*args))[0] for args in inputs]


def ptxas_report(log: str) -> list:
    """One entry per compiled kernel: its mangled name, whether it is a
    slab-layout kernel (``cpg_slab_level_kernel``, its compensated twin
    and the df level) and ptxas's register line."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "registers" in ln and name is not None:
            out.append({"kernel": name, "slab": "cpg_slab_level" in name,
                        "usage": ln.split(":", 1)[1].strip()})
            name = None
    return out


def star_graph(CSRGraph, n: int = 3000):
    hub = np.stack([np.zeros(n - 1, dtype=np.int64),
                    np.arange(1, n, dtype=np.int64)], axis=1)
    ring = np.stack([np.arange(1, n - 1), np.arange(2, n)], axis=1)
    return CSRGraph.from_edges(n, np.concatenate([hub, ring]))


def level_chain(torch, spmv_cpg, cg, x):
    """Run every level of the pack through the kernel and its plain
    version on the same inputs (the inputs spmv_cpg gives each level).
    Returns the max |kernel - plain| over all levels."""
    C, sub, nb = cg.n_chunks, cg.sub, cg.n_bcast
    slab = cg.layout == "slab"
    x2d = x.reshape(cg.n_sub, 128)
    err = 0.0

    def one(inp, level, base):
        nonlocal err
        got = spmv_cpg.run_level(inp, level, C, sub, base=base, slab=slab)
        want = spmv_cpg.run_level_ref(inp, level, C, sub, base=base,
                                      slab=slab)
        check(torch.equal(got, want),
              f"level kernel == plain (sub={sub}, {cg.layout})")
        err = max(err, float((got - want).abs().max()))
        return got

    for level in cg.levels[:nb]:
        x2d = one(x2d, level, x2d)
    y2d = one(x2d, cg.levels[nb], None)
    for level in cg.levels[nb + 1:]:
        y2d = one(y2d, level, y2d)
    return err


def df_level_chain(torch, spmv_cpg, cg, hi, lo):
    """Run one df SpMV with every level through the df level kernel
    (``run_level_df``) and its plain version on the same inputs (the
    inputs ``spmv_cpg_df`` gives each level), the kernel's outputs carried
    on, and compared in int views; then the reference's composition
    (``_spmv_df``) with kernels 1 and 1c held against their plain
    versions on every level.  Returns the max |kernel - plain| of the df
    levels and of the compensated levels (acc and err), and the df
    SpMV's (hi, lo) through the df level kernel."""
    df_err, err = 0.0, 0.0

    def df_level(x_hi, x_lo, level, n_chunks, sub, **kw):
        nonlocal df_err
        got = spmv_cpg.run_level_df(x_hi, x_lo, level, n_chunks, sub, **kw)
        want = spmv_cpg.run_level_df_ref(x_hi, x_lo, level, n_chunks, sub,
                                         **kw)
        for g_t, w_t in zip(got, want):
            check(torch.equal(g_t.view(torch.int32), w_t.view(torch.int32)),
                  f"df level kernel == plain (sub={sub}, {cg.layout}, "
                  f"{kw['mode']})")
            df_err = max(df_err, float((g_t - w_t).abs().max()))
        return got

    out = spmv_cpg._spmv_df_levels(cg, hi, lo, df_level)

    def plain(inp, level, n_chunks, sub, base=None, slab=False):
        got = spmv_cpg.run_level(inp, level, n_chunks, sub, base, slab)
        want = spmv_cpg.run_level_ref(inp, level, n_chunks, sub, base, slab)
        check(torch.equal(got, want),
              f"df level kernel == plain (sub={sub}, {cg.layout})")
        return got

    def comp(inp, level, n_chunks, sub, slab=False):
        nonlocal err
        got = spmv_cpg.run_level_comp(inp, level, n_chunks, sub, slab)
        want = spmv_cpg.run_level_comp_ref(inp, level, n_chunks, sub, slab)
        for g_t, w_t in zip(got, want):
            check(torch.equal(g_t, w_t),
                  f"compensated level kernel == plain (sub={sub}, "
                  f"{cg.layout})")
            err = max(err, float((g_t - w_t).abs().max()))
        return got

    want = spmv_cpg._spmv_df(cg, hi, lo, plain, comp)
    check(all(torch.equal(a, b) for a, b in zip(out, want)),
          f"df level chain == composed chain (sub={cg.sub}, {cg.layout})")
    return df_err, err, out


def df_spmv_turns(torch, spmv_cpg, cg, hi, lo) -> dict:
    """CUDA-event samples of one df SpMV through the df level kernel
    (``spmv_cpg_df``, "fused") and composed as the reference composes it,
    kernels 1c and 1 a level with the eager folds between ("composed":
    ``_spmv_df`` over ``run_level`` and ``run_level_comp``), in turns
    composed, fused, fused, composed; REPS samples a turn."""
    fns = {"fused": lambda: spmv_cpg.spmv_cpg_df(cg, hi, lo),
           "composed": lambda: spmv_cpg._spmv_df(
               cg, hi, lo, spmv_cpg.run_level, spmv_cpg.run_level_comp)}
    out = {"fused": [], "composed": []}
    for tag in ("composed", "fused", "fused", "composed"):
        out[tag] += cuda_ms(torch, fns[tag])[1]
    return out


def df_levels_ms(torch, spmv_cpg, cg, hi, lo):
    """CUDA-event medians of each df level kernel launch of one df SpMV
    on the inputs ``spmv_cpg_df`` gives it, and each level's bound
    (``df_level_cost``)."""
    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return spmv_cpg.run_level_df(*a, **kw)

    spmv_cpg._spmv_df_levels(cg, hi, lo, record)
    ms = [cuda_ms(torch, lambda: spmv_cpg.run_level_df(*a, **kw))[0]
          for a, kw in calls]
    return ms, [bound(*df_level_cost(cg, i))[0] for i in range(len(calls))]


def split_dev(torch, cg, x64, dev):
    """A float64 host vector as a permuted (hi, lo) float32 pair on dev."""
    from tpu_lanczos_torch.core.lanczos_df import split_f64

    hi, lo = split_f64(cg.permute_in(x64, np.float64))
    return torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)


class _Preempted(Exception):
    """Raised by a spy to cut a checkpointed run after its first chunk."""


def timed_call(torch, fn):
    """fn() once: (result, CUDA-event ms, host wall s, launch counts),
    the counters set to 0 just before and read just after."""
    reset_counts()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    wall = time.time() - t0
    return out, start.elapsed_time(end), wall, read_counts(torch)


def queued_ms(torch, fn, calls: int, reps: int = REPS):
    """Device milliseconds a call of fn takes, without the host's enqueue:
    ``calls`` calls are queued behind a sleeping kernel that outlasts
    their enqueue, then run back to back between two CUDA events; the
    median of ``reps`` such samples, per call.  Returns (median, samples,
    the host's enqueue ms per call)."""
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
        samples.append(start.elapsed_time(end) / calls)
    return float(np.median(samples)), samples, enqueue_s / calls * 1e3


def step_case(torch, v_raw, q, qp, mask, j: int = 3):
    """Row 5 on one SpMV's output before its realmask multiply ``v_raw``
    of q (q_prev ``qp``), at step j: the kernel with ``mask=`` on v_raw
    and without it on v = v_raw * mask (equal bit for bit: the mask fold
    is exact and two runs agree), the plain version, and the plain version
    given the kernel's scalars (q_{j+1}, the stored row and the recombine
    fold equal bit for bit).  Checks alpha and beta within 1e-6 (float32)
    or 1e-13 (float64) relative of the plain version's; returns (the
    largest |kernel - plain| of alpha, beta and q_{j+1}, the larger
    relative alpha or beta difference)."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    v = v_raw * mask.to(v_raw.dtype)
    k = j + 3
    beta0 = torch.zeros(k, dtype=v.dtype, device=v.device)
    beta0[j - 1] = 0.75
    coeff = torch.linspace(0.5, 1.5, k, dtype=v.dtype, device=v.device)
    ans0 = 3.0 * qp
    runs = []
    for vin, m in ((v_raw, mask), (v, None)):
        a, b = torch.zeros_like(beta0), beta0.clone()
        store, ans = torch.zeros_like(v), ans0.clone()
        qn = ls.lanczos_step(vin.clone(), q, qp, a, b, j, store=store,
                             ans=ans, coeff=coeff, mask=m)
        runs.append((a, b, qn, store, ans))
    check(all(torch.equal(x, y) for x, y in zip(*runs)),
          "row 5: the run with mask= and the run on v * mask bit-identical")
    a, b, qn, store, ans = runs[0]
    ar, br = torch.zeros_like(beta0), beta0.clone()
    qr = ls.lanczos_step_ref(v.clone(), q, qp, ar, br, j)
    rel = max(float(abs(a[j] - ar[j]) / abs(ar[j])),
              float(abs(b[j] - br[j]) / abs(br[j])))
    bar = 1e-6 if v.dtype == torch.float32 else 1e-13
    check(rel < bar, f"row 5 ({v.dtype}): alpha and beta within {bar} of "
          f"the plain version ({rel})")
    want = ls.normalize_ref(ls.update_ref(v, q, qp, a[j], b[j - 1]), b[j])
    check(torch.equal(qn, want) and torch.equal(store, want)
          and torch.equal(ans, ans0 + coeff[j + 1] * want),
          f"row 5 ({v.dtype}): q_(j+1), stored row and fold == plain given "
          f"the kernel's scalars")
    err = max(float((qn - qr).abs().max()), float(abs(a[j] - ar[j])),
              float(abs(b[j] - br[j])))
    return err, rel


def step_df_case(torch, v_raw, q, qp, mask, j: int = 3):
    """Row 5c as ``step_case`` on (hi, lo) pairs: the runs with and
    without ``mask=`` bit-identical, alpha and beta within 5e-11 of the
    plain version's df values (as float64) and alpha's hi word equal to
    the plain version's (the same pairwise tree), q_{j+1} and the
    recombine fold bit-identical given the kernel's scalars; df_norm
    within 5e-11 of core.df64's.  Returns the largest |kernel - plain|
    (as float64) and relative alpha/beta difference."""
    from tpu_lanczos_torch.core import df64 as df
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    v = (v_raw[0] * mask, v_raw[1] * mask)
    k = j + 3
    z = torch.zeros(k, device=v[0].device)
    bh0, bl0 = z.clone(), z.clone()
    bh0[j - 1], bl0[j - 1] = 0.75, 1e-9
    coeff = (torch.linspace(0.5, 1.5, k, device=z.device),
             torch.full((k,), 1e-9, device=z.device))
    ans0 = (3.0 * qp[0], 3.0 * qp[1])
    runs = []
    for vin, m in ((v_raw, mask), (v, None)):
        ab = [z.clone(), z.clone(), bh0.clone(), bl0.clone()]
        ans = (ans0[0].clone(), ans0[1].clone())
        qn = ls.lanczos_step_df((vin[0].clone(), vin[1].clone()), q, qp,
                                ab[:2], ab[2:], j, ans=ans, coeff=coeff,
                                mask=m)
        runs.append((*ab, *qn, *ans))
    check(all(torch.equal(x, y) for x, y in zip(*runs)),
          "row 5c: the run with mask= and the run on v * mask "
          "bit-identical")
    ah, al, bh, bl, qh, ql, sh, sl = runs[0]
    ref = [z.clone(), z.clone(), bh0.clone(), bl0.clone()]
    qr = ls.lanczos_step_df_ref(v, q, qp, ref[:2], ref[2:], j)

    def f64(h, lo):
        return df.df_to_f64((h, lo))

    rel = max(float(abs(f64(ah[j], al[j]) - f64(ref[0][j], ref[1][j]))
                    / abs(f64(ref[0][j], ref[1][j]))),
              float(abs(f64(bh[j], bl[j]) - f64(ref[2][j], ref[3][j]))
                    / abs(f64(ref[2][j], ref[3][j]))))
    check(rel < 5e-11, f"row 5c: alpha and beta within 5e-11 ({rel})")
    check(float(ah[j]) == float(ref[0][j]),
          "row 5c: alpha's hi word equals the plain tree's")
    want = ls.normalize_df_ref(ls.update_df_ref(
        v, q, qp, (ah[j], al[j]), (bh[j - 1], bl[j - 1])), (bh[j], bl[j]))
    acc = (ans0[0].clone(), ans0[1].clone())
    ls.accum_df_ref(acc, coeff, j + 1, want)
    check(torch.equal(qh, want[0]) and torch.equal(ql, want[1])
          and torch.equal(sh, acc[0]) and torch.equal(sl, acc[1]),
          "row 5c: q_(j+1) and the fold == plain given the kernel's scalars")
    nk, nr = ls.df_norm(q), df.df_norm(q)
    n_rel = float(abs(f64(*nk) - f64(*nr)) / f64(*nr))
    check(n_rel < 5e-11, f"df_norm kernel within 5e-11 ({n_rel})")
    err = float(np.abs(f64(qh, ql) - f64(*qr)).max())
    return max(err, float(abs(f64(ah[j], al[j]) - f64(ref[0][j],
                                                      ref[1][j])))), rel


def step_inputs(torch, cg, x64, dev, df: bool = False):
    """q (the pack's permuted x, normalized), q_prev (ones on the real
    rows, scaled) and v = A q before its realmask multiply on the card:
    float32/float64 tensors or, with ``df``, (hi, lo) pairs and the df
    SpMV."""
    from tpu_lanczos_torch.kernels import spmv_cpg

    xp = cg.permute_in(x64 / np.linalg.norm(x64), np.float64)
    pp = cg.permute_in(np.ones(cg.n) / np.sqrt(cg.n), np.float64)
    if df:
        q, qp = split_dev(torch, cg, x64 / np.linalg.norm(x64), dev), \
            split_dev(torch, cg, np.ones(cg.n) / np.sqrt(cg.n), dev)
        return spmv_cpg.spmv_cpg_df(cg, *q, masked=False), q, qp
    out = []
    for dt in (torch.float32, torch.float64):
        q = torch.from_numpy(xp).to(dev, dt)
        qp = torch.from_numpy(pp).to(dev, dt)
        out.append((spmv_cpg.spmv_cpg(cg, q, masked=False), q, qp))
    return out


@contextlib.contextmanager
def eager_steps():
    """Every single-device loop runs the plain (eager) step in the block:
    the first port's step, to time beside the kernels in one run."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    lz_mod = importlib.import_module("tpu_lanczos_torch.core.lanczos")
    ldf = importlib.import_module("tpu_lanczos_torch.core.lanczos_df")
    real = (lz_mod.lanczos_step, ldf.lanczos_step_df, ldf.df_norm)
    lz_mod.lanczos_step = lambda *a, work=None, **kw: ls.lanczos_step_ref(
        *a, **kw)
    ldf.lanczos_step_df = lambda *a, work=None, **kw: (
        ls.lanczos_step_df_ref(*a, **kw))
    ldf.df_norm = lambda x, work=None: ls.df.df_norm(x)
    try:
        yield
    finally:
        lz_mod.lanczos_step, ldf.lanczos_step_df, ldf.df_norm = real


def step_bound(n_pad: int, df: bool):
    """Row 5 (float32) or 5c bound at n_pad: read v, the pack's float32
    realmask (the SpMV's multiply, which the step folds in), q_j and
    q_{j-1} and write q_{j+1} once (each vector a (hi, lo) pair in
    df64); the operations
    counted as float32 adds and multiplies (row 5: a dot, the update and
    the norm, a divide, 9 an element; row 5c: the df ops of
    core/df64.py, 209 an element: the dot 39, the update and the norm's
    dot 133, the scale 37) at the float32 peak."""
    vecs = 4 * n_pad * (8 if df else 4) + 4 * n_pad
    ops = n_pad * (209 if df else 9)
    return bound(vecs, ops)


def estimators_phase(torch, g, dg, top_ritz: float) -> dict:
    """Phase 10: the stochastic estimators and the stored-Q checkpoint on
    the bn1M classic pack ``dg``: kernel 1's launches per call (exactly,
    with the deflation attempts and diagonal retries), CUDA-event and
    wall times, host syncs, accuracy against the float64 oracle and
    between float32 and float64, the ba200 CLI run against its dense
    oracle, and a bit-identical resume at bn1M."""
    from tpu_lanczos_torch.core import checkpoint, stochastic, tridiag
    from tpu_lanczos_torch.core.lanczos import lanczos, lanczos_alphabeta
    from tpu_lanczos_torch.eval import oracle
    from tpu_lanczos_torch.utils import BUILD_DIR

    L = len(dg.levels)
    k_defl = stochastic._defl_depth(ESTRADA["deflate"], None, g.n - 1)[0]
    attempts = []  # one entry per deflation run (one lanczos_init each)
    real_init = stochastic.lanczos_init

    def counting_init(*a, **kw):
        attempts.append(1)
        return real_init(*a, **kw)

    out = {"phase": 10, "graph": f"ba_{N}_{M}_{SEED}_native", "levels": L,
           "k_deflate": k_defl}
    stochastic.lanczos_init = counting_init
    try:
        # ---- the Estrada index, f32 and f64, each counted and timed; a
        # first f32 call counts the host syncs and warms the path
        out["estrada_syncs"] = syncs(torch, lambda: stochastic.estrada_index(
            g, dg=dg, **ESTRADA))
        runs = {}
        for dt in ("float32", "float64"):
            attempts.clear()
            r, ms, wall, counts = timed_call(torch, lambda: (
                stochastic.estrada_index(g, dtype=dt, dg=dg, **ESTRADA)))
            steps = len(attempts) * k_defl + ESTRADA["probes"] * ESTRADA["k"]
            check_counts(counts, {"launches": steps * L,
                                  "launches_step": steps},
                         f"estrada_index {dt}: (attempts*k_defl + "
                         f"probes*k)*levels, as many steps")
            check(np.isfinite(r.log_estimate) and np.isfinite(r.estimate)
                  and r.dropped == 0 and r.deflated > 0,
                  f"estrada_index {dt}: finite, nothing dropped, deflated")
            runs[dt] = r
            out[f"estrada_{dt}"] = {
                "launches": counts["launches"], "attempts": len(attempts),
                "cuda_ms": ms, "wall_s": wall,
                "log_estimate": r.log_estimate,
                "rel_stderr": r.rel_stderr, "deflated": r.deflated,
                "dropped": r.dropped}
        d_log = abs(runs["float32"].log_estimate
                    - runs["float64"].log_estimate)
        check(d_log < 1e-3, f"estrada f32 vs f64 log_estimate {d_log}")
        out["estrada_log_f32_vs_f64"] = d_log

        # the first two Estrada probes against the float64 oracle: the
        # probes of a 2-probe run are the first two of any longer run
        k = ESTRADA["k"]
        per_probe = {}
        for dt in ("float32", "float64"):
            rows, _ = stochastic._probe_stats_device(
                dg, dg.realmask.to(getattr(torch, dt)), 2, 0, k)
            per_probe[dt] = [stochastic.gauss_quadrature_logexp(
                a, b[: k - 1], xn ** 2) for a, b, xn, _ in rows]
        mask64 = dg.realmask.double()
        oracle_logs = []
        t0 = time.time()
        for i in range(2):
            z = dg.permute_out(stochastic._masked_rademacher(
                mask64, 0, stochastic._TRACE_STREAM, 0, i))
            dec = oracle.lanczos(g, z, k)
            oracle_logs.append(stochastic.gauss_quadrature_logexp(
                dec.alpha, dec.beta, float(z @ z)))
        err64 = max(abs(a - b) for a, b in zip(per_probe["float64"],
                                               oracle_logs))
        err32 = max(abs(a - b) for a, b in zip(per_probe["float32"],
                                               oracle_logs))
        check(err64 < 1e-7, f"f64 per-probe log(z^T e^A z) vs oracle {err64}")
        check(err32 < 1e-3, f"f32 per-probe log(z^T e^A z) vs oracle {err32}")
        out["probe_logs"] = {"oracle": oracle_logs, **per_probe,
                             "f64_abs_err": err64, "f32_abs_err": err32,
                             "oracle_s": time.time() - t0}

        # ---- subgraph centrality as the Estrada index, and its eigh
        out["subgraph_syncs"] = syncs(
            torch, lambda: stochastic.subgraph_centrality(g, dg=dg,
                                                          **SUBGRAPH))
        diag = {}
        for dt in ("float32", "float64"):
            attempts.clear()
            dr, ms, wall, counts = timed_call(torch, lambda: (
                stochastic.subgraph_centrality(g, dtype=dt, dg=dg,
                                               **SUBGRAPH)))
            steps = (len(attempts) * k_defl + (dr.retries + 1)
                     * SUBGRAPH["probes"] * SUBGRAPH["k"])
            check_counts(counts, {"launches": steps * L,
                                  "launches_step": steps},
                         f"subgraph_centrality {dt}: (attempts*k_defl + "
                         f"(retries+1)*probes*k)*levels, as many steps")
            check(bool(np.all(np.isfinite(dr.diag_scaled)))
                  and dr.diag_scaled.shape == (N,) and dr.deflated > 0,
                  f"subgraph_centrality {dt}: finite (n,), deflated")
            diag[dt] = dr
            out[f"subgraph_{dt}"] = {
                "launches": counts["launches"], "attempts": len(attempts),
                "retries": dr.retries, "cuda_ms": ms, "wall_s": wall,
                "log_scale": dr.log_scale, "deflated": dr.deflated,
                "top_nodes": dr.top_nodes(10).tolist()}
        d32, d64 = diag["float32"], diag["float64"]
        # full_diag() compared in float64 on the float64 run's scale
        a = d32.diag_scaled.astype(np.float64) * np.exp(
            d32.log_scale - d64.log_scale)
        rel = float(np.linalg.norm(a - d64.diag_scaled)
                    / np.linalg.norm(d64.diag_scaled))
        top_eq = int(d32.top_nodes(1)[0]) == int(d64.top_nodes(1)[0])
        check(top_eq, "subgraph f32 and f64: the same top-1 node")
        check(rel < 5e-3, f"subgraph f32 vs f64 full_diag rel l2 {rel}")
        out["subgraph_f32_vs_f64_rel_l2"] = rel
        a0, b0, _ = lanczos_alphabeta(dg, dg.realmask, SUBGRAPH["k"])
        b0 = b0[: SUBGRAPH["k"] - 1]
        eigh_ms = cuda_ms(torch, lambda: tridiag.eigh_device(a0, b0))[0]
        eigh_wall = wall_s(torch, lambda: tridiag.eigh_device(a0, b0))[0]
        out["eigh_per_probe"] = {
            "k": SUBGRAPH["k"], "cuda_ms": eigh_ms, "wall_ms": eigh_wall * 1e3,
            "syncs": syncs(torch, lambda: tridiag.eigh_device(a0, b0)),
            "per_call_wall_ms": eigh_wall * 1e3 * SUBGRAPH["probes"]}

        # ---- the spectral density, likewise
        dos_syncs = syncs(torch, lambda: stochastic.spectral_density(
            g, dg=dg, **DOS))
        d, ms, wall, counts = timed_call(torch, lambda: (
            stochastic.spectral_density(g, dg=dg, **DOS)))
        check_counts(counts, {"launches": DOS["probes"] * DOS["k"] * L,
                              "launches_step": DOS["probes"] * DOS["k"]},
                     "spectral_density: probes*k*levels, probes*k steps")
        mass = float(np.trapezoid(d.density, d.grid))
        lmax_rel = abs(d.lambda_max - top_ritz) / abs(top_ritz)
        check(abs(mass - 1.0) < 1e-3, f"DOS mass {mass}")
        check(lmax_rel < 1e-3, f"DOS lambda_max {d.lambda_max} vs the top "
              f"Ritz value {top_ritz}")
        check(bool(np.all(np.isfinite(d.density))), "DOS finite")
        out["dos"] = {"launches": counts["launches"], "cuda_ms": ms,
                      "wall_s": wall, "mass": mass,
                      "lambda_min": d.lambda_min,
                      "lambda_max": d.lambda_max,
                      "lambda_max_rel_vs_ritz": lmax_rel,
                      "syncs": dos_syncs}
    finally:
        stochastic.lanczos_init = real_init

    # ---- tests/test_stochastic.py's ba200 through the CLI on the card
    reset_counts()
    rc, cli_out, cli_err, secs = run_cli(CLI_ESTIMATORS)
    counts = read_counts(torch)
    check(rc == 0, f"CLI estimators: rc {rc}: {cli_err[-2000:]}")
    est_rel = float(cli_out.split("Estrada index")[1].split("rel err ")[1]
                    .split()[0])
    sub_rel = float(cli_out.split("rel l2 err ")[1].split(",")[0])
    cli_mass = float(cli_out.split("mass=")[1].split()[0])
    # every SpMV of the CLI's single-device estimators is one Lanczos
    # step's: levels*steps level launches
    check(counts["launches"] > 0 and counts["launches_step"] > 0
          and counts["launches"] % counts["launches_step"] == 0
          and sum(counts.values()) == (counts["launches"]
                                       + counts["launches_step"]),
          f"CLI estimators ran the classic CPG kernel and the step kernel "
          f"only, one step an SpMV ({counts})")
    check(est_rel < 2e-3, f"CLI deflated Estrada rel err {est_rel} < 2e-3")
    check(sub_rel < 0.02 and "top-1 match: True" in cli_out,
          f"CLI subgraph rel l2 {sub_rel} < 0.02, top-1 equal")
    check(abs(cli_mass - 1.0) < 1e-3, f"CLI DOS mass {cli_mass}")
    out["cli_ba200"] = {"rc": rc, "wall_s": secs, "launches": counts,
                        "estrada_rel_err": est_rel,
                        "subgraph_rel_l2": sub_rel, "dos_mass": cli_mass}

    # ---- the stored-Q checkpoint at bn1M: preempted after one chunk,
    # resumed, and uninterrupted, each against lanczos bit for bit
    kq = K
    x1 = dg.realmask.clone()
    want = lanczos(dg, x1, kq)
    real_range = checkpoint.lanczos_range
    chunks = []

    def cut_after_one(*a, **kw):
        if chunks:
            raise _Preempted
        chunks.append(1)
        return real_range(*a, **kw)

    def same(st, what):
        check(torch.equal(st.alpha, want.alpha)
              and torch.equal(st.beta, want.beta)
              and torch.equal(st.q_basis, want.q_basis),
              f"{what}: alpha, beta and Q equal lanczos bit for bit")

    os.makedirs(BUILD_DIR, exist_ok=True)
    ck = {"k": kq, "chunk": CKPT_Q_CHUNK}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        p, p2 = os.path.join(tmp, "q.npz"), os.path.join(tmp, "q2.npz")

        def run(path):
            return checkpoint.lanczos_checkpointed(
                dg, x1, kq, checkpoint_path=path, chunk=CKPT_Q_CHUNK)

        checkpoint.lanczos_range = cut_after_one
        try:
            reset_counts()
            try:
                run(p)
                check(False, "the cut checkpointed run was not cut")
            except _Preempted:
                pass
        finally:
            checkpoint.lanczos_range = real_range
        ck["launches_cut"] = read_counts(torch)["launches"]
        j_done = checkpoint.LanczosCheckpoint.load(p).j_done
        check(j_done == CKPT_Q_CHUNK, f"snapshot after one chunk: {j_done}")
        st, _, ck["resume_wall_s"], counts = timed_call(torch, lambda: run(p))
        check_counts(counts, {"launches": L + (kq - CKPT_Q_CHUNK) * L,
                              "launches_step": kq - CKPT_Q_CHUNK},
                     "resume: structure probe + the second chunk")
        same(st, "resumed checkpointed run")
        ck["launches_resume"] = counts["launches"]
        st, _, ck["full_wall_s"], counts = timed_call(torch, lambda: run(p2))
        check_counts(counts, {"launches": L + kq * L, "launches_step": kq},
                     "uninterrupted: structure probe + k*levels, k steps")
        same(st, "uninterrupted checkpointed run")
        ck["launches_full"] = counts["launches"]
        ck["snapshot_bytes"] = os.path.getsize(p2)
        t0 = time.time()
        snap = checkpoint.LanczosCheckpoint.load(p2)
        ck["snapshot_load_s"] = time.time() - t0
        t0 = time.time()
        snap.save(p)
        ck["snapshot_save_s"] = time.time() - t0
        del snap, st
    ck["lanczos_wall_s"] = wall_s(torch, lambda: lanczos(dg, x1, kq),
                                  reps=3)[0]
    out["checkpoint"] = ck
    return out


# phase 11: the row-sharded path, 4 shards of one card
SHARDS = 4
# launches of a 4-shard SpMV of bench.py's graph (checked in phase 11):
# f32/f64, kernel 1 on every shard's own and cross pass and on shard 0's
# one reduce level with tiles; df64, a main-level launch a shard and
# shard 0's reduce level
SHARD_SPMV_LAUNCHES = 9
SHARD_DF_SPMV_LAUNCHES = 5
HALO_SIDE, HALO_K = 1000, 30
SHARD_REPLACES = ("tpu_lanczos/dist/cpg_sharded.py:439 (_local_spmv; "
                  "tpu_lanczos/kernels/spmv_cpg.py:342)")
SHARD_DF_REPLACES = ("tpu_lanczos/dist/lanczos_df.py:64-166 (_local_spmv_df"
                     "'s levels and folds; tpu_lanczos/kernels/spmv_cpg.py:"
                     "342, compensated and plain)")
SHARD_SOURCE = "tpu_lanczos_torch/kernels/csrc/spmv_cpg_shard.cu"
SHARD_STEP_REPLACES = ("tpu_lanczos/dist/mesh.py:82-107 and :189-220 (the "
                       "XLA-fused step of the sharded fori_loops around "
                       "their psums; no Pallas kernel)")
SHARD_STEP_DF_REPLACES = ("tpu_lanczos/dist/lanczos_df.py:171-188 "
                          "(_body_core_sh after the df SpMV, _df_allsum :48 "
                          "between; no Pallas kernel)")
# one 512-row chunk of 128 lanes: the odd chunk count of the pass checks
CHUNK = SUB * 128


def shard_level_checks(torch, spmv_cpg, errs: dict, what: str):
    """The sharded SpMVs' kernel functions, checked: each runs the kernel
    (kernel 1 on a pass or a reduce level, its halo read in place; the
    df shard kernel) and its plain version on the same inputs (every
    source +-0.0 in lane 127), checks them equal bit for bit and carries
    the kernel's output on.  Returns (level_fn, df_fn)."""
    def lane_127_zero(x):
        check(not bool(x.reshape(-1, 128)[:, 127].any()),
              f"{what}: shard level input is zero in lane 127")

    def note(key, got, want):
        check(torch.equal(got, want), f"{what}: {key} kernel == plain "
              f"({got.dtype})")
        errs[key] = max(errs[key], float((got - want).abs().max()))

    def level(x2d, level, n_chunks, sub, base=None, halo=None):
        lane_127_zero(x2d)
        if halo is not None:
            lane_127_zero(halo)
            errs["halo_calls"] += 1
        got = spmv_cpg.run_level(x2d, level, n_chunks, sub, base, halo=halo)
        note("level", got, spmv_cpg.run_level_ref(x2d, level, n_chunks, sub,
                                                  base, halo=halo))
        errs["level_calls"] += 1
        return got

    def df(walks, n_chunks, sub, **kw):
        for _, hi, lo in walks:
            for x in (*hi, *lo):
                lane_127_zero(x)
        got = spmv_cpg.run_shard_level_df(walks, n_chunks, sub, **kw)
        want = spmv_cpg.run_shard_level_df_ref(walks, n_chunks, sub, **kw)
        for g_p, w_p in zip(got, want):
            check((g_p is None) == (w_p is None), f"{what}: df outputs")
            for g_t, w_t in zip(g_p or (), w_p or ()):
                note("df", g_t, w_t)
        errs["df_calls"] += 1
        return got

    return level, df


def shard_errs() -> dict:
    return {"level": 0.0, "df": 0.0, "level_calls": 0, "halo_calls": 0,
            "df_calls": 0}


def shard_spmv_counts(sg, n_spmv: int, df: bool = False) -> dict:
    """The sharded SpMV's launches of ``n_spmv`` SpMVs (``shard_launches``):
    in f32/f64 kernel 1 once a main pass and a reduce level with tiles on
    a shard; in df64 the df shard kernel once a shard's main level and
    once a reduce level with tiles on it."""
    from tpu_lanczos_torch.dist.cpg_sharded import shard_launches

    per = sum(shard_launches(sg, df=df))
    return {"launches_shard_df" if df else "launches": n_spmv * per}


def shard_pass_case(torch, v_raw, q, qp, mask):
    """Row 5d on one shard's inputs (v before its realmask multiply), as
    shard 1 of 3 with slots: the dot (written to slot 1) within 1e-6
    (f32) or 1e-13 (f64) relative of torch.dot and equal in two runs;
    v' from the update pass given 3 dot slots and 3 last-step norm slots
    (the kernel's fold), then reorthogonalization's pass on v' with w the
    two GEMVs' result against the basis (q_{j-1}, q_j), and q_{j+1} and
    the stored row from the normalize pass given 3 norm slots, equal to
    the plain versions bit for bit, alpha[j] and beta[j] the plain folds'
    bits; each norm within the same bar; the update and the dot once
    more with their early loads, the same bits.  The vectors the passes
    write keep v_raw's alignment, so inputs sliced off a 16-byte boundary
    run the one-value (V = 1) builds.  Returns (largest |kernel -
    plain|, largest relative dot or norm difference)."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    off = v_raw.data_ptr() % 16 // v_raw.element_size()

    def fresh(t):  # a copy of t at v_raw's offset from 16 bytes
        return t.new_empty(t.numel() + off)[off:].copy_(t)

    dt = v_raw.dtype
    tol = 1e-6 if dt == torch.float32 else 1e-13
    what = f"row 5d ({dt}, offset {off})"
    dots = torch.tensor([0.75, 0.0, -0.125], dtype=dt, device=q.device)
    ls.shard_step_dot(v_raw, q, mask=mask, slots=dots, shard=1)
    a = dots[1].clone()
    check(torch.equal(a, ls.shard_step_dot(v_raw, q, mask=mask)[0]),
          "row 5d: two runs of the dot pass bit-identical")
    a_ref = ls.shard_step_dot_ref(v_raw, q, mask)[0]
    ss_prev = torch.tensor([0.5625, 0.25, 1e-3], dtype=dt, device=q.device)
    ab = [torch.zeros(4, dtype=dt, device=q.device) for _ in "ab"]
    v_k, part = ls.shard_step_update(fresh(v_raw), q, qp, dots, ss_prev,
                                     mask=mask, alpha=ab[0], j=2)
    v_r, part_r = ls.shard_step_update_ref(v_raw, q, qp, dots, ss_prev, mask)
    check(torch.equal(v_k, v_r) and torch.equal(
        ab[0][2], ls.fold_slots_ref(dots)), f"{what}: v' and alpha == plain "
        f"given the kernel's dot slots")
    v_e = fresh(v_raw)
    torch.cuda.synchronize()  # nothing the early loads read is in flight
    v_e, part_e = ls.shard_step_update(v_e, q, qp, dots, ss_prev, mask=mask,
                                       early=True)
    e_dot = ls.shard_step_dot(v_raw, q, mask=mask, early=True)
    check(torch.equal(v_e, v_k) and torch.equal(part_e, part)
          and torch.equal(e_dot[0], a), f"{what}: early loads, same bits")
    basis = torch.stack((qp, q))
    w = torch.matmul(basis.T, torch.matmul(basis, v_k))
    v_s, sub = ls.shard_step_sub_norm(v_k, fresh(w))
    v_sr, sub_r = ls.shard_step_sub_norm_ref(v_r, w)
    check(torch.equal(v_s, v_sr), f"{what}: v' - w of the sub-norm pass == "
          f"plain")
    norms = torch.cat([sub, ss_prev[1:]])
    store = fresh(torch.zeros_like(q))
    q_k = ls.shard_step_normalize(fresh(v_s), norms, beta=ab[1], j=2,
                                  store=store)
    q_r = ls.shard_step_normalize_ref(v_sr, norms)
    check(torch.equal(q_k, q_r) and torch.equal(store, q_r)
          and torch.equal(ab[1][2], torch.sqrt(ls.fold_slots_ref(norms))),
          f"{what}: q_(j+1), the stored row and beta == plain given the "
          f"kernel's norm slots")
    diffs = [(a, a_ref), (part[0], part_r[0]), (sub[0], sub_r[0])]
    rel = max(float(abs(x - y) / abs(y)) for x, y in diffs)
    check(rel < tol, f"{what}: dot and norms within {tol} ({rel})")
    return max(float(abs(x - y)) for x, y in diffs), rel


def shard_df_pass_case(torch, v_raw, q, qp, mask):
    """Row 5cd as ``shard_pass_case`` on (hi, lo) pairs, shard 1 of 3:
    the df dot's and the norm's hi words equal to the plain tree's, both
    within 5e-11 of its df value, two runs equal; v', q_{j+1}, alpha,
    beta and the recombine fold bit-identical to the plain versions given
    the kernel's slots (the df folds); the early loads the same bits."""
    from tpu_lanczos_torch.core import df64 as df
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    def f64(p):
        return float(df.df_to_f64((p[0], p[1])))

    dev = q[0].device
    dots = torch.tensor([[0.75, 1e-9], [0.0, 0.0], [-0.125, -3e-10]],
                        device=dev)
    ls.shard_df_dot(v_raw, q, mask=mask, slots=dots, shard=1)
    a = dots[1].clone()
    check(torch.equal(a, ls.shard_df_dot(v_raw, q, mask=mask)[0]),
          "row 5cd: two runs of the df dot pass bit-identical")
    a_ref = ls.shard_df_dot_ref(v_raw, q, mask)[0]
    ssp = torch.tensor([[0.5625, 1e-9], [0.25, 0.0], [1e-3, 2e-12]],
                       device=dev)
    ab = [torch.zeros(4, device=dev) for _ in range(4)]
    v_k, part = ls.shard_df_update((v_raw[0].clone(), v_raw[1].clone()), q,
                                   qp, dots, ssp, mask=mask, alpha=ab[:2],
                                   j=2)
    v_r, part_r = ls.shard_df_update_ref(v_raw, q, qp, dots, ssp, mask)
    fa = ls.fold_df_slots_ref(dots)
    check(torch.equal(v_k[0], v_r[0]) and torch.equal(v_k[1], v_r[1])
          and torch.equal(ab[0][2], fa[0]) and torch.equal(ab[1][2], fa[1]),
          "row 5cd: v' and alpha == plain given the kernel's dot slots")
    v_e = (v_raw[0].clone(), v_raw[1].clone())
    torch.cuda.synchronize()  # nothing the early loads read is in flight
    v_e, part_e = ls.shard_df_update(v_e, q, qp, dots, ssp, mask=mask,
                                     early=True)
    e_dot = ls.shard_df_dot(v_raw, q, mask=mask, early=True)
    check(torch.equal(v_e[0], v_k[0]) and torch.equal(v_e[1], v_k[1])
          and torch.equal(part_e, part) and torch.equal(e_dot[0], a),
          "row 5cd: early loads, same bits")
    part, part_r = part[0], part_r[0]
    check(float(a[0]) == float(a_ref[0])
          and float(part[0]) == float(part_r[0]),
          "row 5cd: the dot's and the norm's hi words == the plain tree's")
    rel = max(abs(f64(a) - f64(a_ref)) / abs(f64(a_ref)),
              abs(f64(part) - f64(part_r)) / abs(f64(part_r)))
    check(rel < 5e-11, f"row 5cd: dot and norm within 5e-11 ({rel})")
    norms = torch.stack([part, ssp[1], ssp[2]])
    k = 4
    coeff = (torch.linspace(0.5, 1.5, k, device=dev),
             torch.full((k,), 1e-9, device=dev))
    ans = (3.0 * qp[0], 3.0 * qp[1])
    acc = (ans[0].clone(), ans[1].clone())
    q_k = ls.shard_df_normalize((v_k[0].clone(), v_k[1].clone()), norms,
                                beta=ab[2:], j=2, ans=ans, coeff=coeff)
    q_r = ls.shard_df_normalize_ref(v_r, norms, j=2, ans=acc, coeff=coeff)
    b = df.df_sqrt(ls.fold_df_slots_ref(norms))
    check(all(torch.equal(x, y) for x, y in zip((*q_k, *ans, ab[2][2],
                                                 ab[3][2]),
                                                (*q_r, *acc, *b))),
          "row 5cd: q_(j+1), beta and the fold == plain given the kernel's "
          "norm slots")
    err = max(abs(f64(a) - f64(a_ref)), abs(f64(part) - f64(part_r)))
    return err, rel


def shard_step_bound(n_loc: int, df: bool):
    """A shard's step after the SpMV at least: v, the realmask, q_j and
    q_{j-1} read and q_{j+1} written once, plus the second read of v that
    the split at the psums adds (each vector a (hi, lo) pair in df64);
    the operations as ``step_bound`` counts them."""
    vb = 8 if df else 4
    return bound(n_loc * (5 * vb + 4), n_loc * (209 if df else 9))


def shard_step_phase(torch, g, sg4, mesh4, xr, rng) -> dict:
    """Rows 5d and 5cd at bn1M on 4 shards: ``shard_pass_case`` and
    ``shard_df_pass_case`` on every shard's inputs of one step (the
    unmasked SpMV of x / ||x||, q_{j-1} the normalized ones), on
    random inputs of 3 chunks and (row 5d) on those sliced one value off
    16 bytes; then one shard's step (shard 1) and the whole step of the 4
    shards after the SpMV (12 passes, nothing between them:
    ``eval/step_tiers.py`` ``mesh_step``, each call behind the one-value
    kernel that stands in for the SpMV's last level, timed alone too)
    through the pass kernels and the eager passes
    (``eager_shard_passes``), queued behind a sleep, in turns, beside
    their bounds (the mesh's 4 times a shard's), the mesh's kernels also
    without their early loads.  Returns the part's numbers."""
    from tpu_lanczos_torch.core.lanczos_df import split_f64
    from tpu_lanczos_torch.dist.cpg_sharded import _local_spmv
    from tpu_lanczos_torch.dist.lanczos_df import _local_spmv_df
    from tpu_lanczos_torch.eval.step_tiers import (eager_shard_passes,
                                                   mesh_step, spmv_stand_in)
    from tpu_lanczos_torch.kernels.spmv_cpg import (run_level,
                                                    run_shard_level_df)

    n_loc = sg4.n_loc
    xq = sg4.permute_in(xr / np.linalg.norm(xr), np.float64)
    xp = sg4.permute_in(np.ones(N) / np.sqrt(N), np.float64)
    err = {"5d": 0.0, "5cd": 0.0}
    rel = {"5d": 0.0, "5cd": 0.0}

    def note(row, er):
        err[row] = max(err[row], er[0])
        rel[row] = max(rel[row], er[1])

    inputs = {}
    for dt in (torch.float32, torch.float64):
        q = mesh4.split(xq, n_loc, dtype=dt)
        qp = mesh4.split(xp, n_loc, dtype=dt)
        v = _local_spmv(sg4, mesh4, q, run_level, masked=False)
        for s in range(SHARDS):
            note("5d", shard_pass_case(torch, v[s], q[s], qp[s],
                                       sg4.realmask[s]))
        inputs[dt] = (v, q, qp)
    pairs = [list(zip(*(mesh4.split(t, n_loc) for t in split_f64(a))))
             for a in (xq, xp)]
    v_df = _local_spmv_df(sg4, mesh4, pairs[0], run_shard_level_df,
                          masked=False)
    for s in range(SHARDS):
        note("5cd", shard_df_pass_case(torch, v_df[s], pairs[0][s],
                                       pairs[1][s], sg4.realmask[s]))
    # an odd chunk count: 3 chunks of random inputs
    n3 = 3 * CHUNK
    dev = sg4.realmask[0].device
    m3 = torch.from_numpy((rng.random(n3) < 0.9).astype(np.float32)).to(dev)
    r3 = [rng.standard_normal(n3) for _ in range(3)]
    r3[1] /= np.linalg.norm(r3[1])
    r3[2] /= np.linalg.norm(r3[2])
    for dt in (torch.float32, torch.float64):
        t3 = [torch.from_numpy(a).to(dev, dt) for a in r3]
        note("5d", shard_pass_case(torch, *t3, m3))
        # off 16 bytes: the one-value builds
        note("5d", shard_pass_case(torch, *(t[1:] for t in t3), m3[1:]))
    note("5cd", shard_df_pass_case(torch, *(tuple(
        torch.from_numpy(t).to(dev) for t in split_f64(a)) for a in r3),
        m3))
    out = {"n_loc": n_loc, "odd_chunks_n": n3,
           "max_abs_err_5d": err["5d"], "max_rel_5d": rel["5d"],
           "max_abs_err_5cd": err["5cd"], "max_rel_5cd": rel["5cd"]}
    # one shard's step and the 4-shard step, kernels and eager in turns
    out["spmv_stand_in_ms"] = queued_ms(torch, spmv_stand_in(dev), 100)[0]
    masks = list(sg4.realmask)
    # calls a sample (shard kernel, shard eager, mesh kernel, mesh
    # eager): a sample queues at most ~650 launches, since at 1,300 the
    # host's enqueue blocked and the samples' tail ran at its pace
    cases = {"f32": (*inputs[torch.float32], False, (100, 20, 50, 5)),
             "df64": (v_df, pairs[0], pairs[1], True, (50, 5, 50, 2))}
    for name, (v, q, qp, df, calls_of) in cases.items():
        for part, sl, scale in (("", slice(1, 2), 1),
                                ("mesh_", slice(0, SHARDS), SHARDS)):
            k_calls, e_calls = calls_of[2:] if part else calls_of[:2]
            args = (v[sl], q[sl], qp[sl], masks[sl], df)
            fns = {"kernel": (mesh_step(*args), k_calls),
                   "eager": (mesh_step(*args), e_calls)}
            tags = ["eager_1", "kernel_1", "kernel_2", "eager_2"]
            if part:
                fns["no_early"] = (mesh_step(*args, early=False), k_calls)
                tags[2:2] = ["no_early_1", "no_early_2"]
            turns = {}
            for tag in tags:
                fn, calls = fns[tag.rsplit("_", 1)[0]]
                with (eager_shard_passes() if tag.startswith("eager")
                      else contextlib.nullcontext()):
                    ms, samples, host_ms = queued_ms(torch, fn, calls)
                turns[tag] = {"device_ms": ms, "samples": samples,
                              "host_enqueue_ms": host_ms, "calls": calls}
            b_ms, b_by = shard_step_bound(n_loc, df)

            def med(kind):
                return float(np.median([turns[f"{kind}_{i}"]["device_ms"]
                                        for i in (1, 2)]))
            k_ms = med("kernel")
            out[part + name] = {
                "shards": scale, "device_ms": k_ms,
                "eager_device_ms": med("eager"), "bound_ms": scale * b_ms,
                "bound_by": b_by, "bound_share": scale * b_ms / k_ms,
                "turns": turns}
            if part:
                out[part + name]["no_early_device_ms"] = med("no_early")
    del inputs, v_df, pairs
    return out


def sharded_spmv_cost(sg, value_bytes: int = 4, df: bool = False):
    """(bytes, ops) one sharded SpMV must move and do at least, as its
    kernels run it, summed over shards: each level a shard runs
    (``shard_passes``) reads its real tiles' l1 + l2 + s_ids and chunk
    ranges once and its source buffer once, in df64 both streams of it
    (the tile's indices once for the two); a pass after the first of a
    shard (in df64: a reduce level) reads the running base (y, or (y,
    e)); each launch writes its output once (in df64 (y, e) where a later
    exchange reads them and the finished (hi, lo)); each exchange's
    gathered buffers are written once; the realmask is read (and, in
    f32/f64, y written again by its multiply).  One add a tile cell and
    one a base cell (df64: the two-sum's seven and lo's one a tile cell,
    the fold's ten a cell a walk or base)."""
    from tpu_lanczos_torch.dist.cpg_sharded import (_reduce_levels,
                                                    shard_passes)

    sub, c_loc, n_loc = sg.sub, sg.c_loc, sg.n_loc
    streams = 2 if df else 1
    chunk = sub * 128 * value_bytes
    reduce = _reduce_levels(sg)

    def src_chunks(li):
        level = sg.levels[li]
        if li >= sg.n_main:
            return sg.n_shards * int(level[0]["sel"].shape[0])
        halo = (sg.n_shards * int(level[0]["halo_sel"].shape[0])
                if "halo_sel" in level[0] else sg.n_chunks)
        if sg.overlap:
            return c_loc if li == 0 else halo
        return halo + c_loc if "halo_sel" in level[0] else halo

    nbytes, ops = 0, 0
    # the exchanges: the main level's (cross pass or unsplit level), then
    # each reduce level's
    if not sg.overlap or sg.t_reals[1]:
        lv = sg.levels[sg.n_main - 1][0]
        nbytes += streams * chunk * (
            sg.n_shards * int(lv["halo_sel"].shape[0]) if "halo_sel" in lv
            else sg.n_chunks)
    for li in reduce:
        nbytes += streams * chunk * src_chunks(li)
    out_vec = n_loc * value_bytes * streams
    for s in range(sg.n_shards):
        levels = shard_passes(sg, s)
        for i, li in enumerate(levels):
            t = sg.shard_tiles[li][s]
            lv = sg.levels[li][s]
            l2b = lv["l2"].element_size()
            nbytes += (t * (sub * 128 + 128 * sub * l2b + 4) + 2 * c_loc * 4
                       + streams * src_chunks(li) * chunk)
            ops += t * sub * 128 * (8 if df else 1)
            if li >= sg.n_main or (i and not df):  # the base, folded in
                nbytes += out_vec
                ops += n_loc * (10 if df else 1)
            elif df and li == 1:
                ops += n_loc * 10  # the cross walk's fold
        # the outputs: one a launch (df64: the (y, e) a later exchange
        # reads, and the finished pair), the realmask
        runs = [li for li in levels if li >= sg.n_main]
        if df:
            keeps = bool(reduce) + sum(1 for li in runs if li != reduce[-1])
            nbytes += (keeps + 1) * out_vec + n_loc * 4
        else:
            nbytes += len(levels) * out_vec + n_loc * (4 + value_bytes)
    return nbytes, ops


def sharded_phase(torch, g, dev, ref, ref_shift, top_ref, p10,
                  spmv_default_ms: float, cli_top20: list) -> list:
    """Phase 11: the row-sharded path on the card, 4 shards of one GPU
    (``make_mesh(devices=[cuda:0] * 4)``) on phase 3's graph: the pack,
    kernels 1 and 1c == their plain versions on every shard level, the
    1-shard SpMV == single-device, the launch counters of the sharded
    queries (exact), accuracy against phase 4's oracle, the halo path on
    a 2-D stencil, the sharded estimators against phase 10, one NCCL
    rank, the CLI's --shards, and CUDA-event times.  The shards run in
    turn on one card, so the times measure kernel work and launches, not
    collectives.  Prints one JSON line a part; returns the kernel
    entries of row 1d."""
    import torch.distributed as tdist

    from tpu_lanczos_torch.core import stochastic
    from tpu_lanczos_torch.dist import mesh as dmesh
    from tpu_lanczos_torch.dist import (expm_action_sharded,
                                        init_distributed, make_mesh)
    from tpu_lanczos_torch.dist.cpg_sharded import (
        ShardedCPG, _local_spmv, dest_only_kw, lanczos_cpg_sharded,
        pack_cpg_sharded, shard_launches, split_cpg, spmv_cpg_sharded,
        spmv_cpg_sharded_ref)
    from tpu_lanczos_torch.dist.lanczos_df import (
        _local_spmv_df, expm_action_df_sharded, spmv_cpg_df_sharded,
        spmv_cpg_df_sharded_ref)
    from tpu_lanczos_torch.eval import oracle, shard_alone
    from tpu_lanczos_torch.graphs import generators
    from tpu_lanczos_torch.kernels import spmv_cpg
    from tpu_lanczos_torch.kernels.cpg import pack_cpg
    from tpu_lanczos_torch.utils import BUILD_DIR

    entries = []
    rng = np.random.default_rng(11)
    mesh4 = make_mesh(devices=[dev] * SHARDS)
    mesh1 = make_mesh(devices=[dev])
    check(mesh4.n_shards == SHARDS and mesh4.group is None,
          "in-process mesh of 4 shards on one card")

    def rel_to_oracle(ans, shift):
        return oracle.rel_error(ans * np.exp(shift - ref_shift), ref)

    # ---- the pack: the user path, then the dest-only single-device pack
    # the 1-shard mesh and the NCCL rank split
    t0 = time.time()
    sg4 = pack_cpg_sharded(g, SHARDS, mesh=mesh4, sub=SUB)
    torch.cuda.synchronize()
    pack_s = time.time() - t0
    t0 = time.time()
    cgd = pack_cpg(g, sub=SUB, device=dev, **dest_only_kw())
    split1 = split_cpg(cgd, 1)
    sg1 = ShardedCPG.from_numpy(split1["meta"], split1["levels"],
                                split1["realmask"], split1["new_of_old"],
                                mesh1)
    torch.cuda.synchronize()
    pack1_s = time.time() - t0
    per_shard = shard_launches(sg4)
    per_spmv = sum(per_shard)
    per_shard_df = shard_launches(sg4, df=True)
    per_df_spmv = sum(per_shard_df)
    check(per_spmv == SHARD_SPMV_LAUNCHES
          and per_df_spmv == SHARD_DF_SPMV_LAUNCHES,
          f"{per_spmv} and {per_df_spmv} launches a 4-shard SpMV and df "
          f"SpMV ({per_shard}, {per_shard_df}), want {SHARD_SPMV_LAUNCHES} "
          f"and {SHARD_DF_SPMV_LAUNCHES}")
    main_halo = any("halo_sel" in sg4.levels[i][0]
                    for i in range(sg4.n_main))
    check(sg4.overlap and sg4.n_main == 2, "4-shard pack: overlap split")
    check(not main_halo, "the power-law pack gathers the whole vector")
    tiles = [[int(lv["counts"].sum()) for lv in level]
             for level in sg4.levels]
    emit({"phase": 11, "part": "pack", "shards": SHARDS, "sub": sg4.sub,
          "pack_s": pack_s, "dest_only_pack_and_1_shard_split_s": pack1_s,
          "n_chunks": sg4.n_chunks, "c_loc": sg4.c_loc,
          "overlap": sg4.overlap, "main_level_halo": main_halo,
          "levels": len(sg4.levels), "t_reals": list(sg4.t_reals),
          "shard_tiles_per_level": tiles,
          "launches_per_shard": per_shard, "launches_per_spmv": per_spmv,
          "launches_per_shard_df": per_shard_df,
          "launches_per_df_spmv": per_df_spmv,
          "dest_only_single_device_levels": len(cgd.levels),
          "dest_only_single_device_tiles": list(cgd.t_reals)})

    # ---- kernel 1 and the df shard kernel == plain on every shard level,
    # one f32, one f64 and one df SpMV
    errs = shard_errs()
    level_k, df_k = shard_level_checks(torch, spmv_cpg, errs,
                                       "bn1M 4 shards")
    xr = rng.standard_normal(N)
    x1 = [r.clone() for r in sg4.realmask]
    x64 = mesh4.split(sg4.permute_in(xr, np.float64), sg4.n_loc)
    y_ones = _local_spmv(sg4, mesh4, x1, level_k)
    y64 = _local_spmv(sg4, mesh4, x64, level_k)
    from tpu_lanczos_torch.core.lanczos_df import split_f64

    hi, lo = split_f64(sg4.permute_in(xr, np.float64))
    hi, lo = mesh4.split(hi, sg4.n_loc), mesh4.split(lo, sg4.n_loc)
    y_df = _local_spmv_df(sg4, mesh4, list(zip(hi, lo)), df_k)
    check(errs["level_calls"] == 2 * per_spmv
          and errs["df_calls"] == per_df_spmv,
          f"every shard level checked ({errs})")
    want = g.to_scipy() @ xr
    got64 = sg4.permute_out(mesh4.to_host(y64))
    rel64 = float(np.linalg.norm(got64 - want) / np.linalg.norm(want))
    check(rel64 < 1e-13, f"4-shard f64 SpMV vs scipy {rel64}")
    got_df = sg4.permute_out(mesh4.to_host([p[0] for p in y_df]).astype(
        np.float64) + mesh4.to_host([p[1] for p in y_df]))
    x_df = sg4.permute_out(mesh4.to_host(hi).astype(np.float64)
                           + mesh4.to_host(lo))
    want_df = g.to_scipy() @ x_df
    rel_df_spmv = float(np.linalg.norm(got_df - want_df)
                        / np.linalg.norm(want_df))
    check(rel_df_spmv < 1e-13, f"4-shard df SpMV vs scipy {rel_df_spmv}")
    # the 1-shard sharded SpMV == single-device spmv_cpg, same pack
    for x_t in (cgd.realmask.clone(),
                torch.from_numpy(cgd.permute_in(xr, np.float64)).to(dev)):
        (y1,) = spmv_cpg_sharded(sg1, mesh1, x_t)
        check(torch.equal(y1, spmv_cpg.spmv_cpg(cgd, x_t)),
              f"1-shard SpMV == single-device spmv_cpg ({x_t.dtype})")
    emit({"phase": 11, "part": "levels", "checked": errs,
          "lane_127_zero": True, "f64_spmv_rel_vs_scipy": rel64,
          "df_spmv_rel_vs_scipy": rel_df_spmv,
          "one_shard_equals_single_device": True})
    del y64, y_df, x64, hi, lo

    # ---- the main path, each query counted exactly
    xr1 = sg4.permute_in(np.ones(N), np.float32)
    # row 5d: 3 pass launches a shard a step; row 5cd: 3 a shard a step
    # of the 2k - 1 and each pass's start norm (a df dot a shard)
    steps_f32 = 3 * K * SHARDS
    steps_df = SHARDS * (3 * (2 * K - 1) + 2)
    st, ms_l, wall_l, counts = timed_call(
        torch, lambda: lanczos_cpg_sharded(sg4, xr1, K, mesh4))
    check_counts(counts, {**shard_spmv_counts(sg4, K),
                          "launches_step_sharded": steps_f32},
                 "lanczos_cpg_sharded: k SpMVs (kernel 1 a pass and a "
                 "reduce level with tiles on a shard), 3 * k * shards step "
                 "passes")
    lanczos_launches = counts["launches"]
    (ans, shift, _, _), _, wall_e, counts = timed_call(
        torch, lambda: expm_action_sharded(sg4, k=K, mesh=mesh4, fmt="cpg",
                                           log_scale=True))
    check_counts(counts, {**shard_spmv_counts(sg4, K),
                          "launches_step_sharded": steps_f32},
                 "expm_action_sharded: k SpMVs, 3 * k * shards step passes")
    expm_launches = counts["launches"]
    expm_step_launches = counts["launches_step_sharded"]
    rel32 = rel_to_oracle(ans, shift)
    top32 = set(np.argsort(ans)[-TOPK:].tolist())
    check(rel32 < 1e-4, f"sharded f32 rel_error {rel32} < 1e-4")
    check(top32 == top_ref, "sharded f32 top-20 == the oracle's")
    res_df, _, wall_df, counts = timed_call(
        torch, lambda: expm_action_df_sharded(g, k=K, mesh=mesh4, sg=sg4,
                                              log_scale=True))
    check_counts(counts, {**shard_spmv_counts(sg4, 2 * K - 1, df=True),
                          "launches_step_df_sharded": steps_df},
                 "expm_action_df_sharded: 2k-1 df SpMVs (the df shard "
                 "kernel alone), shards * (3 (2k-1) + 2) df step passes")
    df_launches = counts["launches_shard_df"]
    df_step_launches = counts["launches_step_df_sharded"]
    rel_df = rel_to_oracle(res_df.ans, res_df.log_scale)
    top_df = set(np.argsort(res_df.ans)[-TOPK:].tolist())
    check(rel_df < 1e-10, f"sharded df64 rel_error {rel_df} < 1e-10")
    check(top_df == top_ref, "sharded df64 top-20 == the oracle's")
    t0 = time.time()
    (ans_a, shift_a, _, sga), _, wall_a, counts = timed_call(
        torch, lambda: expm_action_sharded(g, k=K, mesh=mesh4, fmt="auto",
                                           log_scale=True))
    check_counts(counts, {"launches_step_sharded": steps_f32},
                 "fmt auto (ELL/COO torch ops): no SpMV kernel, 3 * k * "
                 "shards step passes")
    rel_a = rel_to_oracle(ans_a, shift_a)
    check(rel_a < 1e-4, f"sharded fmt auto rel_error {rel_a} < 1e-4")
    emit({"phase": 11, "part": "main_path", "k": K,
          "launches_lanczos": lanczos_launches,
          "launches_expm": expm_launches,
          "launches_df_shard": df_launches,
          "launches_step_sharded": expm_step_launches,
          "launches_step_df_sharded": df_step_launches,
          "rel_error_f32": rel32, "rel_error_df64": rel_df,
          "rel_error_fmt_auto": rel_a, "top20_equal": True,
          "fmt_auto_ell_width": sga.ell_width,
          "wall_s": {"lanczos": wall_l, "expm_action_sharded": wall_e,
                     "expm_action_df_sharded": wall_df,
                     "fmt_auto_with_pack": wall_a},
          "lanczos_k50_event_ms": ms_l, "shift": shift,
          "oracle_shift": ref_shift})
    del st, sga

    from tpu_lanczos_torch.eval.step_tiers import eager_shard_passes

    # ---- rows 5d and 5cd: every pass kernel against its plain version,
    # on each shard's inputs of one bn1M step (n_loc = 2^18) and on an odd
    # chunk count; then the per-shard step and the loops timed in turns
    # with the eager passes
    step = shard_step_phase(torch, g, sg4, mesh4, xr, rng)
    t_step = {}
    x1 = [r.clone() for r in sg4.realmask]
    for tag in ("kernel_1", "eager_1", "eager_2", "kernel_2"):
        with (eager_shard_passes() if tag.startswith("eager")
              else contextlib.nullcontext()):
            t_step[tag] = {
                "lanczos_4_shard_k50_ms": cuda_ms(
                    torch, lambda: lanczos_cpg_sharded(sg4, x1, K, mesh4),
                    reps=3)[0],
                "df64_query_4_shard_s": wall_s(
                    torch, lambda: expm_action_df_sharded(
                        g, k=K, mesh=mesh4, sg=sg4, log_scale=True),
                    reps=2)[0]}
    for key in ("lanczos_4_shard_k50_ms", "df64_query_4_shard_s"):
        for kind in ("kernel", "eager"):
            step[f"{key}_{kind}"] = float(np.median(
                [t_step[f"{kind}_{i}"][key] for i in (1, 2)]))
    step["loop_turns"] = t_step
    emit({"phase": 11, "part": "step", **step})

    # ---- the halo path: a locality-ordered 2-D stencil
    gs = generators.stencil_2d(HALO_SIDE)
    t0 = time.time()
    sgs = pack_cpg_sharded(gs, SHARDS, mesh=mesh4)
    halo_pack_s = time.time() - t0
    check(sgs.overlap and "halo_sel" in sgs.levels[1][0],
          "the stencil's 4-shard pack takes the halo path")
    h_pad = int(sgs.levels[1][0]["halo_sel"].shape[0])
    errs_h = shard_errs()
    level_h, df_h = shard_level_checks(torch, spmv_cpg, errs_h, "stencil")
    xs64 = rng.standard_normal(gs.n)
    want_s = gs.to_scipy() @ xs64
    rel_hs = {}
    # the overlap split (the cross pass reads the halo buffer) and the
    # unsplit main level (the shard's rows, then the halo, read in place):
    # each kernel == plain on every shard, f64 and df SpMVs vs scipy
    for name, sgh in (("overlap", sgs), ("unsplit", pack_cpg_sharded(
            gs, SHARDS, mesh=mesh4, overlap=False))):
        check("halo_sel" in sgh.levels[sgh.n_main - 1][0],
              f"stencil {name}: the halo path")
        _local_spmv(sgh, mesh4, [r.clone() for r in sgh.realmask], level_h)
        xp = sgh.permute_in(xs64, np.float64)
        ys = _local_spmv(sgh, mesh4, mesh4.split(xp, sgh.n_loc), level_h)
        hi_s, lo_s = split_f64(xp)
        yd = _local_spmv_df(sgh, mesh4, list(zip(
            mesh4.split(hi_s, sgh.n_loc), mesh4.split(lo_s, sgh.n_loc))),
            df_h)
        got_d = (mesh4.to_host([p[0] for p in yd]).astype(np.float64)
                 + mesh4.to_host([p[1] for p in yd]))
        rel_hs[name] = [float(np.linalg.norm(sgh.permute_out(y) - want_s)
                              / np.linalg.norm(want_s))
                        for y in (mesh4.to_host(ys), got_d)]
        check(max(rel_hs[name]) < 1e-13, f"stencil {name} 4-shard f64 and "
              f"df SpMVs vs scipy {rel_hs[name]}")
    check(errs_h["halo_calls"] == 2 * SHARDS,
          f"the unsplit stencil pack's levels read their halo in place "
          f"({errs_h})")
    del sgh, ys, yd
    (ans_s, shift_s, _, _), _, _, counts = timed_call(
        torch, lambda: expm_action_sharded(sgs, k=HALO_K, mesh=mesh4,
                                           fmt="cpg", log_scale=True))
    check_counts(counts, {**shard_spmv_counts(sgs, HALO_K),
                          "launches_step_sharded": 3 * HALO_K * SHARDS},
                 "stencil expm_action_sharded: k SpMVs, 3 * k * shards "
                 "step passes")
    t0 = time.time()
    ref_s, ref_s_shift = oracle.expm_action_shifted(gs, np.ones(gs.n),
                                                    HALO_K)
    halo_oracle_s = time.time() - t0
    rel_s = oracle.rel_error(ans_s * np.exp(shift_s - ref_s_shift), ref_s)
    check(rel_s < 1e-4, f"stencil sharded f32 rel_error {rel_s} < 1e-4")
    emit({"phase": 11, "part": "halo", "graph": f"stencil_2d({HALO_SIDE})",
          "n": gs.n, "pack_s": halo_pack_s, "n_chunks": sgs.n_chunks,
          "c_loc": sgs.c_loc, "h_pad": h_pad,
          "exchanged_chunks": SHARDS * h_pad, "t_reals": list(sgs.t_reals),
          "checked": errs_h, "f64_df_spmv_rel_vs_scipy": rel_hs,
          "k": HALO_K, "launches_expm": counts, "rel_error_f32": rel_s,
          "oracle_s": halo_oracle_s})
    del sgs, gs, ref_s

    # ---- the sharded estimators on the 4-shard pack
    attempts = []
    real_probes = dmesh.shard_probes

    def counting_probes(mesh, mask, seed, stream, attempt, i):
        if stream == stochastic._DEFLATE_STREAM:
            attempts.append(1)
        return real_probes(mesh, mask, seed, stream, attempt, i)

    k_defl = stochastic._defl_depth(ESTRADA["deflate"], None, N - 1)[0]
    est = {"k_deflate": k_defl}
    dmesh.shard_probes = counting_probes
    try:
        attempts.clear()
        r, ms, wall, counts = timed_call(
            torch, lambda: stochastic.estrada_index_sharded(
                sg4, mesh=mesh4, fmt="cpg", **ESTRADA))
        want_l = shard_spmv_counts(
            sg4, len(attempts) * k_defl + ESTRADA["probes"] * ESTRADA["k"])
        # the deflation's reorthogonalized steps run 4 passes a shard
        want_s = (4 * len(attempts) * k_defl
                  + 3 * ESTRADA["probes"] * ESTRADA["k"]) * SHARDS
        check_counts(counts, {**want_l, "launches_step_sharded": want_s},
                     "estrada_index_sharded: attempts*k_defl + probes*k "
                     "SpMVs; (4 attempts*k_defl + 3 probes*k) * shards "
                     "step passes")
        e10 = p10["estrada_float32"]
        d_log = abs(r.log_estimate - e10["log_estimate"])
        tol = 3.0 * float(np.hypot(r.rel_stderr, e10["rel_stderr"]))
        check(np.isfinite(r.log_estimate) and r.dropped == 0
              and d_log <= tol, f"sharded Estrada log {r.log_estimate} vs "
              f"phase 10's {e10['log_estimate']}: {d_log} <= {tol}")
        est["estrada"] = {"launches": want_l,
                          "step_passes": counts["launches_step_sharded"],
                          "attempts": len(attempts), "cuda_ms": ms,
                          "wall_s": wall, "log_estimate": r.log_estimate,
                          "rel_stderr": r.rel_stderr,
                          "deflated": r.deflated,
                          "phase10_log_estimate": e10["log_estimate"],
                          "abs_log_diff": d_log, "bar": tol}
        attempts.clear()
        dr, ms, wall, counts = timed_call(
            torch, lambda: stochastic.subgraph_centrality_sharded(
                sg4, mesh=mesh4, fmt="cpg", **SUBGRAPH))
        want_l = shard_spmv_counts(
            sg4, len(attempts) * k_defl
            + (dr.retries + 1) * SUBGRAPH["probes"] * SUBGRAPH["k"])
        want_s = (4 * len(attempts) * k_defl + 3 * (dr.retries + 1)
                  * SUBGRAPH["probes"] * SUBGRAPH["k"]) * SHARDS
        check_counts(counts, {**want_l, "launches_step_sharded": want_s},
                     "subgraph_centrality_sharded: attempts*k_defl + "
                     "(retries+1)*probes*k SpMVs; (4 attempts*k_defl + 3 "
                     "(retries+1)*probes*k) * shards step passes")
        top1 = int(dr.top_nodes(1)[0])
        top1_10 = p10["subgraph_float32"]["top_nodes"][0]
        check(top1 == top1_10 and bool(np.all(np.isfinite(dr.diag_scaled))),
              f"sharded subgraph top-1 {top1} == phase 10's {top1_10}")
        est["subgraph"] = {"launches": want_l,
                           "step_passes": counts["launches_step_sharded"],
                           "attempts": len(attempts),
                           "retries": dr.retries, "cuda_ms": ms,
                           "wall_s": wall, "top_nodes": dr.top_nodes(
                               10).tolist(), "deflated": dr.deflated}
        d, ms, wall, counts = timed_call(
            torch, lambda: stochastic.spectral_density_sharded(
                sg4, mesh=mesh4, fmt="cpg", **DOS))
        want_l = shard_spmv_counts(sg4, DOS["probes"] * DOS["k"])
        check_counts(counts, {**want_l, "launches_step_sharded": 3
                              * DOS["probes"] * DOS["k"] * SHARDS},
                     "spectral_density_sharded: probes*k SpMVs; 3 "
                     "probes*k * shards step passes")
        mass = float(np.trapezoid(d.density, d.grid))
        check(abs(mass - 1.0) < 1e-3, f"sharded DOS mass {mass}")
        est["dos"] = {"launches": want_l,
                      "step_passes": counts["launches_step_sharded"],
                      "cuda_ms": ms,
                      "wall_s": wall, "mass": mass,
                      "lambda_max": d.lambda_max}
    finally:
        dmesh.shard_probes = real_probes
    emit({"phase": 11, "part": "estimators", **est})

    # ---- one rank over NCCL: the distributed mesh's code path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        store = tdist.FileStore(os.path.join(tmp, "store"), 1)
        init_distributed(backend="nccl", store=store, world_size=1, rank=0)
        try:
            mesh_d = make_mesh()
            check(mesh_d.group is not None and mesh_d.n_shards == 1,
                  "make_mesh() spans the one-rank world")
            sg1d = ShardedCPG.from_numpy(
                split1["meta"], split1["levels"], split1["realmask"],
                split1["new_of_old"], mesh_d)
            x_d = sg1.permute_in(np.ones(N), np.float32)
            st_d = lanczos_cpg_sharded(sg1d, x_d, K, mesh_d)
            st_1 = lanczos_cpg_sharded(sg1, x_d, K, mesh1)
            nccl_equal = (torch.equal(st_d.alpha, st_1.alpha)
                          and torch.equal(st_d.beta, st_1.beta))
            check(nccl_equal, "one NCCL rank == the in-process 1-shard run")
        finally:
            tdist.destroy_process_group()
    emit({"phase": 11, "part": "nccl_one_rank", "backend": "nccl",
          "alpha_beta_equal": nccl_equal})
    del sg1d, st_d, st_1

    # ---- the CLI's --shards, in process
    cli = {}
    reset_counts()
    rc, out, err, secs = run_cli(["-b", str(M), "-n", str(N), "-k", str(K),
                                  "--fmt", "cpg", "--cpg-sub", str(SUB),
                                  "--shards", "1", "--no-serial", "-v",
                                  "--log-scale"])
    counts = read_counts(torch)
    check(rc == 0, f"CLI --shards 1 full width: rc {rc}: {err[-2000:]}")
    # the CLI generates its graph with the numpy generator, not phase 3's
    # native one: its top-10 is held against phase 7's single-device CLI
    # query of the same argv (the top-20 of its f32 answer)
    top10 = [int(v) for v in out.split("top-10 central nodes: ")[1]
             .split("\n")[0].split(", ")]
    check(set(top10) == set(cli_top20[:10]),
          "CLI --shards 1: phase 7's single-device top-10")
    cli["full_width"] = {"rc": rc, "wall_s": secs, "launches": counts,
                         "top10": top10}
    for name, extra, bar in (
            ("f32", ["--shards", "1"], 1e-4),
            ("df64", ["--shards", "1", "--dtype", "df64"], 1e-12)):
        reset_counts()
        rc, out, err, secs = run_cli(CLI_SMALL + extra)
        counts = read_counts(torch)
        check(rc == 0, f"CLI {name}: rc {rc}: {err[-2000:]}")
        rel_c = float(out.split("relative ")[1].split(")")[0])
        check(rel_c < bar, f"CLI --shards 1 {name}: vs serial {rel_c}")
        cli[name] = {"rc": rc, "wall_s": secs, "launches": counts,
                     "rel_vs_serial": rel_c}
    logs = {}
    for name, extra in (("estrada_sharded", ["--shards", "1"]),
                        ("estrada_single", [])):
        rc, out, err, secs = run_cli(CLI_SMALL + extra + ["--estrada", "8"])
        check(rc == 0, f"CLI {name}: rc {rc}: {err[-2000:]}")
        logs[name] = (float(out.split("(log: ")[1].split(")")[0]),
                      float(out.split("rel stderr=")[1].split()[0]))
        cli[name] = {"rc": rc, "wall_s": secs, "log_estimate": logs[name][0],
                     "rel_stderr": logs[name][1]}
    d_cli = abs(logs["estrada_sharded"][0] - logs["estrada_single"][0])
    tol = 3.0 * float(np.hypot(logs["estrada_sharded"][1],
                               logs["estrada_single"][1]))
    check(d_cli <= tol, f"CLI --shards 1 --estrada 8 vs single device: "
          f"{d_cli} <= {tol}")
    try:
        run_cli(CLI_SMALL + ["--shards", "2"])
        check(False, "CLI --shards 2 on one GPU did not fail")
    except ValueError as exc:
        check(str(exc) == "need 2 devices, have 1",
              f"CLI --shards 2 on one GPU: {exc}")
        cli["shards_2"] = str(exc)
    emit({"phase": 11, "part": "cli", **cli})

    # ---- CUDA-event times, the kernel line's numbers, host syncs
    x1d = cgd.realmask.clone()
    times = {
        "spmv_4_shard_ms": cuda_ms(
            torch, lambda: spmv_cpg_sharded(sg4, mesh4, x1))[0],
        "spmv_1_shard_ms": cuda_ms(
            torch, lambda: spmv_cpg_sharded(sg1, mesh1, [x1d]))[0],
        "spmv_single_dest_only_ms": cuda_ms(
            torch, lambda: spmv_cpg.spmv_cpg(cgd, x1d))[0],
        "spmv_single_default_pack_ms": spmv_default_ms,
        "spmv_4_shard_plain_ms": cuda_ms(
            torch, lambda: spmv_cpg_sharded_ref(sg4, mesh4, x1), reps=2)[0],
        "lanczos_4_shard_k50_ms": cuda_ms(
            torch, lambda: lanczos_cpg_sharded(sg4, x1, K, mesh4),
            reps=3)[0],
    }
    hi1 = [r.clone() for r in sg4.realmask]
    lo1 = [torch.zeros_like(r) for r in hi1]
    times["df_spmv_4_shard_ms"] = cuda_ms(
        torch, lambda: spmv_cpg_df_sharded(sg4, mesh4, hi1, lo1))[0]
    times["df_spmv_4_shard_plain_ms"] = cuda_ms(
        torch, lambda: spmv_cpg_df_sharded_ref(sg4, mesh4, hi1, lo1),
        reps=2)[0]
    # each shard's local SpMV and df SpMV alone, its exchanges made
    # beforehand (eval/shard_alone.py; the slowest one a real mesh's
    # critical path), each equal to its part of the 4-shard SpMV
    alone = shard_alone.alone_fn(spmv_cpg_sharded, sg4, mesh4, x1)
    alone_df = shard_alone.alone_fn(spmv_cpg_df_sharded, sg4, mesh4, hi1,
                                    lo1)
    y_all = spmv_cpg_sharded(sg4, mesh4, x1)
    yd_all = spmv_cpg_df_sharded(sg4, mesh4, hi1, lo1)
    for s in range(SHARDS):
        got_d = alone_df(s)
        check(torch.equal(alone(s), y_all[s])
              and torch.equal(got_d[0], yd_all[s][0])
              and torch.equal(got_d[1], yd_all[s][1]),
              f"shard {s} alone == its part of the 4-shard SpMVs")
    alone_ms = [cuda_ms(torch, lambda: alone(s))[0] for s in range(SHARDS)]
    alone_df_ms = [cuda_ms(torch, lambda: alone_df(s))[0]
                   for s in range(SHARDS)]
    slow = int(np.argmax(alone_ms))
    slow_df = int(np.argmax(alone_df_ms))
    times.update({
        "shard_alone_ms": alone_ms, "shard_alone_df_ms": alone_df_ms,
        "slowest_shard": slow, "slowest_shard_df": slow_df,
        "slowest_shard_alone_ms": alone_ms[slow],
        "slowest_shard_alone_df_ms": alone_df_ms[slow_df]})
    syncs_expm = syncs(torch, lambda: expm_action_sharded(
        sg4, k=K, mesh=mesh4, fmt="cpg", log_scale=True))
    check(syncs_expm == 4, f"expm_action_sharded: 4 host syncs "
          f"({syncs_expm}): the step passes add no host read")
    # the library yardstick: each shard's row block of the permuted
    # matrix as a cuSPARSE CSR times the full vector, summed over shards
    rows, cols = g.row_ids(), g.indices
    noo = sg4.new_of_old
    import scipy.sparse as sp

    a_pad = sp.csr_matrix((np.ones(g.nnz, np.float32),
                           (noo[rows], noo[cols])),
                          shape=(sg4.n_pad, sg4.n_pad))
    blocks = []
    for s in range(SHARDS):
        b = a_pad[s * sg4.n_loc:(s + 1) * sg4.n_loc]
        blocks.append(torch.sparse_csr_tensor(
            torch.from_numpy(b.indptr.astype(np.int64)),
            torch.from_numpy(b.indices.astype(np.int64)),
            torch.from_numpy(b.data), size=b.shape).to(dev))
    x_full = torch.cat(x1)
    lib_y = torch.cat([b @ x_full for b in blocks])
    kern_y = torch.cat(spmv_cpg_sharded(sg4, mesh4, x1))
    lib_rel = float((lib_y - kern_y).norm() / kern_y.norm())
    check(lib_rel < 1e-5, f"row-block cuSPARSE agrees ({lib_rel})")
    times["library_row_blocks_ms"] = cuda_ms(
        torch, lambda: [b @ x_full for b in blocks])[0]
    bound_ms, bound_by = bound(*sharded_spmv_cost(sg4))
    # the df SpMV reads each tile's indices once for both streams
    df_bound = bound(*sharded_spmv_cost(sg4, df=True))
    emit({"phase": 11, "part": "times", **times,
          "note": "4 shards run in turn on one card: kernel work and "
                  "launches, no collective over a link",
          "syncs_expm_action_sharded": syncs_expm,
          "library_rel_diff": lib_rel, "bound_ms": bound_ms,
          "bound_by": bound_by, "df_bound_ms": df_bound[0],
          "df_bound_by": df_bound[1], "launches_per_spmv": per_spmv,
          "launches_per_shard": per_shard,
          "launches_per_df_spmv": per_df_spmv})
    # row 1d: ms and plain_ms are the whole 4-shard SpMV (df SpMV) through
    # the kernels and through the plain versions; launches count the
    # kernel's own in expm_action_sharded (expm_action_df_sharded)
    entries.append({
        "name": "spmv_cpg_level_sharded", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": SHARD_REPLACES,
        "launches": expm_launches, "max_abs_err": errs["level"],
        "ms": times["spmv_4_shard_ms"],
        "plain_ms": times["spmv_4_shard_plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": times["library_row_blocks_ms"]})
    entries.append({
        "name": "spmv_cpg_shard_level_df", "route": "cuda",
        "source": SHARD_SOURCE, "replaces": SHARD_DF_REPLACES,
        "launches": df_launches, "max_abs_err": errs["df"],
        "ms": times["df_spmv_4_shard_ms"],
        "plain_ms": times["df_spmv_4_shard_plain_ms"],
        "bound_ms": df_bound[0], "bound_by": df_bound[1],
        "library_ms": None})
    # rows 5d and 5cd: ms and plain_ms are one shard's step (three pass
    # launches) and the eager passes' at bn1M's n_loc, each behind the
    # SpMV's one-value stand-in kernel (phase 11's spmv_stand_in_ms);
    # launches count pass launches
    for name, key, row, launches, replaces in (
            ("lanczos_step_sharded", "f32", "5d", expm_step_launches,
             SHARD_STEP_REPLACES),
            ("lanczos_step_df_sharded", "df64", "5cd", df_step_launches,
             SHARD_STEP_DF_REPLACES)):
        entries.append({
            "name": name, "route": "cuda", "source": STEP_SOURCE,
            "replaces": replaces, "launches": launches,
            "max_abs_err": step[f"max_abs_err_{row}"],
            "ms": step[key]["device_ms"],
            "plain_ms": step[key]["eager_device_ms"],
            "bound_ms": step[key]["bound_ms"],
            "bound_by": step[key]["bound_by"], "library_ms": None})
    return entries



# phase 12: the eval harness (tpu_lanczos_torch/eval/) at full width
SUITE_ROWS = ("copapers_540k", "stencil_2600")
EUROPE_SIDE = 1000
# the suite's f32 accuracy column against the f64 oracle (copapers) or
# the df64 pipeline (stencil_2600): phase 4's bar of 1e-4 is for bn1M;
# other classes are held to this sanity bound and their values recorded
SUITE_F32_BAR = 1e-3


def suite_row(torch, name: str, cache_dir: str, dev) -> dict:
    """``bench_suite.run_one`` on one config (it holds every level of the
    pack against the plain versions, plain and compensated, before
    timing), with kernel 1's and 1c's launches and the steps of rows 5
    and 5c counted exactly."""
    from tpu_lanczos_torch.eval import bench_suite

    cfg = next(c for c in bench_suite.CONFIGS if c["name"] == name)
    reset_counts()
    row = bench_suite.run_one(cfg, k=K, reps=REPS, cache_dir=cache_dir,
                              device=dev)
    counts = read_counts(torch)
    L, nb = row["levels"], row["n_bcast"]
    # the level checks (one f32 and one df SpMV), 4 + reps Lanczos runs,
    # the f32 two-pass query and, past ORACLE_N_MAX, the df64 query; one
    # step (or df step) for each SpMV of the runs and queries
    plain = 2 * L + nb + (4 + REPS) * K * L + (2 * K - 1) * L
    comp, df = L - nb, L
    steps, df_steps = (4 + REPS) * K + (2 * K - 1), 0
    if row["err_ref"] == "df64_selfcheck":
        df += (2 * K - 1) * L
        df_steps = 2 * K - 1
    check_counts(counts, {"launches": plain, "launches_comp": comp,
                          "launches_df": df, "launches_step": steps,
                          "launches_step_df": df_steps},
                 f"bench_suite.run_one({name})")
    check(row["levels_checked"] == {"plain": 2 * L + nb, "comp": L - nb,
                                    "df": L},
          f"{name}: every level held against its plain version")
    check(row["rel_err"] is not None and row["rel_err"] < SUITE_F32_BAR,
          f"{name}: f32 rel_err {row['rel_err']} ({row['err_ref']}) < "
          f"{SUITE_F32_BAR}")
    return dict(row, launches=counts)


def traced_kernels(torch, fn) -> tuple:
    """The kernel events of one ``profiling.trace`` of ``fn()`` after a
    warm run, by start time, and the trace's event categories."""
    from tpu_lanczos_torch.eval import profiling
    from tpu_lanczos_torch.utils import BUILD_DIR

    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        fn()
        torch.cuda.synchronize()
        with profiling.trace(tmp):
            fn()
        with open(os.path.join(tmp, profiling.TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    return kernels, sorted({str(e.get("cat")) for e in events})


def kernel_stats(kernels: list, keys) -> dict:
    """Launches and device milliseconds by kernel (each of ``keys`` that
    a name holds, the rest by name), the union of the kernel intervals
    (busy) over the span from the first kernel's start to the last one's
    end, and the idle share 1 - busy/span."""
    by_name = {}
    for e in kernels:
        name = str(e.get("name", ""))
        key = next((k for k in keys if k in name), name[:70])
        row = by_name.setdefault(key, {"launches": 0, "ms": 0.0})
        row["launches"] += 1
        row["ms"] += e.get("dur", 0) / 1e3
    busy, end = 0.0, None
    for e in kernels:  # the union of the kernel intervals, in us
        t0, t1 = e["ts"], e["ts"] + e.get("dur", 0)
        if end is None or t0 >= end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    span = (end - kernels[0]["ts"]) if kernels else 0.0
    return {"kernel_events": len(kernels), "by_name": by_name,
            "kernel_ms": sum(r["ms"] for r in by_name.values()),
            "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1 - busy / span if span else None}


def main_pack_phase(torch, g, spmv_cpg) -> dict:
    """Phase 3b: ``g`` packed by ``best_device_pack`` (sub 256), the pack
    the main path and the benchmark run.  Holds every level against
    ``run_level_ref`` in f32 and f64 (``level_chain``: the main level by
    the staged walk, the rest by the one-thread walk), counts
    ``expm_action``'s launches (the staged walk once a SpMV, counted
    from 0 just before), and times the staged main level beside the
    one-thread walk on the same level (in turns) and the plain
    version."""
    from tpu_lanczos_torch import best_device_pack, expm_action
    from tpu_lanczos_torch.eval.cpg_variants import chunk_counts

    dg = best_device_pack(g, device="cuda")
    C, sub, nb, L = dg.n_chunks, dg.sub, dg.n_bcast, len(dg.levels)
    route = [spmv_cpg.staged_walk(lv, sub) for lv in dg.levels]
    check(sub == 256 and route == [i == nb for i in range(L)],
          f"main-path pack: sub {sub}, staged route {route}, want sub 256 "
          f"and the main level ({nb}) alone")
    x1 = dg.realmask.clone()
    err = max(level_chain(torch, spmv_cpg, dg, x1),
              level_chain(torch, spmv_cpg, dg, x1.double()))
    check(torch.equal(spmv_cpg.spmv_cpg(dg, x1),
                      spmv_cpg.spmv_cpg_ref(dg, x1)),
          "main-path pack: spmv_cpg == plain")
    reset_counts()
    spmv_cpg.launches_staged = 0
    expm_action(g, k=K, log_scale=True, dg=dg)
    counts = read_counts(torch)
    staged = spmv_cpg.launches_staged
    check_counts(counts, {"launches": K * L, "launches_step": K},
                 "main-path pack: k*levels and k steps")
    check(staged == K, f"main-path pack: {staged} staged launches, want "
          f"k = {K}, one a SpMV")
    x2d = x1.reshape(dg.n_sub, 128)
    x64 = x2d.double()
    main = dg.levels[nb]
    walks = {
        "staged": lambda x: spmv_cpg.run_level(x, main, C, sub),
        "thread": lambda x: spmv_cpg._run_level_cuda(
            x, main, C, sub, None, False, None, False)}
    turns = {}
    for tag in ("staged_1", "thread_1", "thread_2", "staged_2"):
        walk = walks[tag.split("_")[0]]
        turns[tag] = [cuda_ms(torch, lambda: walk(x2d))[0],
                      cuda_ms(torch, lambda: walk(x64))[0]]
    ms = {w: np.median([turns[f"{w}_{i}"] for i in (1, 2)], axis=0).tolist()
          for w in walks}
    plain_ms = cuda_ms(torch, lambda: spmv_cpg.run_level_ref(
        x2d, main, C, sub), reps=3)[0]
    spmv_ms = cuda_ms(torch, lambda: spmv_cpg.spmv_cpg(dg, x1))[0]
    level_bound = [bound(*level_cost(dg, nb, vb, 1, False))
                   for vb in (4, 8)]
    return {"phase": "3b", "sub": sub, "n_chunks": C, "levels": L,
            "n_bcast": nb, "tiles": list(dg.t_reals), "route": route,
            "level_tile_counts": chunk_counts(dg), "max_abs_err": err,
            "launches": counts["launches"], "launches_staged": staged,
            "main_level_ms": {"staged_f32_f64": ms["staged"],
                              "one_thread_f32_f64": ms["thread"],
                              "plain_f32": plain_ms, "turns": turns},
            "main_level_bound_ms": [b[0] for b in level_bound],
            "main_level_bound_by": [b[1] for b in level_bound],
            "spmv_ms": spmv_ms, "spmv_bound_ms": bound(*spmv_cost(dg))[0],
            "index_bytes": dg.index_bytes()}


def traced_lanczos(torch, dg) -> dict:
    """One traced ``lanczos(dg, realmask, k)`` (``traced_kernels``): the
    level kernel's walks, each step kernel and the rest by name
    (``kernel_stats``)."""
    from tpu_lanczos_torch.core.lanczos import lanczos

    x1 = dg.realmask.reshape(-1).clone()
    kernels, cats = traced_kernels(torch, lambda: lanczos(dg, x1, K))
    return dict(kernel_stats(kernels, (*LEVEL_KERNELS, *STEP_KERNELS)),
                categories=cats)


def traced_df_spmv(torch, dg) -> dict:
    """One traced single-device ``spmv_cpg_df`` (``traced_kernels``): its
    kernels by name, the df level kernel's launches and the elementwise
    ops among them."""
    from tpu_lanczos_torch.kernels.spmv_cpg import spmv_cpg_df

    hi = dg.realmask.reshape(-1).clone()
    lo = torch.full_like(hi, 2.0 ** -30) * hi
    kernels, cats = traced_kernels(torch, lambda: spmv_cpg_df(dg, hi, lo))
    by = kernel_stats(kernels, ("cpg_level_df_kernel",))["by_name"]
    return {"kernels": len(kernels), "by_name": by, "categories": cats,
            "df_level_kernels": by.get("cpg_level_df_kernel",
                                       {}).get("launches", 0),
            "elementwise": sum(r["launches"] for n, r in by.items()
                               if "elementwise" in n)}


# row 5d's pass kernels, three a shard a step
SHARD_PASS_KERNELS = ("shard_dot_kernel", "shard_update_kernel",
                      "shard_normalize_kernel")
# the sharded SpMV's kernels (kernel 1 on a reduce level)
SHARD_SPMV_KERNELS = ("cpg_shard_level_df_kernel", *LEVEL_KERNELS)


def sharded_bn1m():
    """bench.py's graph packed for 4 shards of the card, as phase 11
    packs it, and the mesh."""
    from tpu_lanczos_torch import generators
    from tpu_lanczos_torch.dist import make_mesh
    from tpu_lanczos_torch.dist.cpg_sharded import pack_cpg_sharded

    g = generators.barabasi_albert(N, M, seed=SEED, use_native=True)
    mesh = make_mesh(devices=["cuda:0"] * SHARDS)
    return pack_cpg_sharded(g, SHARDS, mesh=mesh, sub=SUB), mesh


def traced_sharded_spmvs(torch) -> dict:
    """One traced 4-shard SpMV and df SpMV of bn1M: their kernels by
    name, the SpMV kernels' launches and the elementwise ops among the
    rest (the exchanges' copies are not; in f32 the realmask multiply
    is)."""
    from tpu_lanczos_torch.dist.cpg_sharded import spmv_cpg_sharded
    from tpu_lanczos_torch.dist.lanczos_df import spmv_cpg_df_sharded

    sg, mesh = sharded_bn1m()
    x1 = [r.clone() for r in sg.realmask]
    lo1 = [torch.zeros_like(t) for t in x1]
    out = {}
    for key, fn in (("spmv", lambda: spmv_cpg_sharded(sg, mesh, x1)),
                    ("df_spmv", lambda: spmv_cpg_df_sharded(sg, mesh, x1,
                                                            lo1))):
        ks, _ = traced_kernels(torch, fn)
        by = kernel_stats(ks, SHARD_SPMV_KERNELS)["by_name"]
        out[key] = {"kernels": len(ks), "by_name": by,
                    "spmv_kernels": sum(by.get(k, {}).get("launches", 0)
                                        for k in SHARD_SPMV_KERNELS),
                    "elementwise": sum(r["launches"] for n, r in by.items()
                                       if "elementwise" in n)}
    return out


def traced_sharded_lanczos(torch) -> dict:
    """One traced ``lanczos_cpg_sharded`` of bn1M on 4 shards of the card
    (as phase 11 packs it): the kernels by name, the kernels a step, and
    the kernels that run between the first and the last of a step's
    3 * shards passes that are not passes (with the fold in the passes,
    none)."""
    from tpu_lanczos_torch.dist.cpg_sharded import lanczos_cpg_sharded

    sg, mesh = sharded_bn1m()
    x1 = [r.clone() for r in sg.realmask]
    kernels, cats = traced_kernels(
        torch, lambda: lanczos_cpg_sharded(sg, x1, K, mesh))
    is_pass = [any(k in str(e.get("name", "")) for k in SHARD_PASS_KERNELS)
               for e in kernels]
    at = [i for i, p in enumerate(is_pass) if p]
    per_step = len(SHARD_PASS_KERNELS) * SHARDS
    between = ([at[i + per_step - 1] - at[i] + 1 - per_step
                for i in range(0, len(at), per_step)]
               if at and len(at) % per_step == 0 else [-1])
    stats = kernel_stats(kernels, (*LEVEL_KERNELS, *SHARD_PASS_KERNELS))
    return dict(stats, categories=cats, n_pad=sg.n_pad,
                levels=len(sg.levels), pass_kernels=len(at),
                kernels_per_step=stats["kernel_events"] / K,
                kernels_between_passes=sum(between),
                kernels_between_passes_max_step=max(between))


TRACE_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
print(json.dumps(chip_smoke.trace_child(sys.argv[2], sys.argv[3])))
"""


def trace_child(name: str, suite_cache: str) -> dict:
    """Run in a child process of its own: pack ``name`` (bench.py's
    graph, phase 3's seed, or a suite config from phase 12's cache) and
    trace one Lanczos of it (``traced_lanczos``); "bn1M_4_shards": the
    4-shard one (``traced_sharded_lanczos``)."""
    import torch

    from tpu_lanczos_torch import generators
    from tpu_lanczos_torch.eval import bench_suite
    from tpu_lanczos_torch.kernels.cpg import pack_cpg

    if name == "bn1M_4_shards":
        return traced_sharded_lanczos(torch)
    if name == "bn1M_4_shard_spmvs":
        return traced_sharded_spmvs(torch)
    if name == "bn1M":
        g = generators.barabasi_albert(N, M, seed=SEED, use_native=True)
        pack = pack_cpg(g, sub=SUB, device="cuda")
    else:
        cfg = next(c for c in bench_suite.CONFIGS if c["name"] == name)
        with contextlib.redirect_stdout(io.StringIO()):
            g = bench_suite.build(cfg, suite_cache)
            pack, _ = bench_suite.load_or_pack(cfg, g, suite_cache, "cuda")
    del g
    out = dict(traced_lanczos(torch, pack), n_pad=pack.n_pad,
               levels=len(pack.levels))
    if name == "bn1M":
        out["df_spmv"] = traced_df_spmv(torch, pack)
    return out


def trace_part(suite_cache: str, t_all: float) -> None:
    """The traced Lanczos runs: phase 12's of bench.py's graph (the trace
    must name kernel 1 (``LEVEL_KERNELS``) k * levels times and the step
    kernel k times, one launch a step, and fewer than k other kernels: no
    per-step realmask multiply; and a traced df SpMV, whose kernels must
    be the df level kernel once a level and nothing else) and of the
    suite's stencil_2600, a mesh's
    profile (its graph and pack from phase 12's suite cache); and phase
    11's of bn1M on 4 shards of the card (k * shards launches of each of
    row 5d's three passes, and no kernel between a step's passes) and of
    one 4-shard SpMV and df SpMV (9 launches of kernel 1 and 5 of the df
    shard kernel, no elementwise op in the df SpMV).  Each runs in a
    child process with a profiler of its own: in this process, after the
    profiled probe calls of phase 9, a trace lost kernel records (once
    one kernel's, once every launch of a traced SpMV's ctypes-launched
    kernel), and a profiler session before phase 9 once left the probe's
    profiled calls with no CUDA events."""
    root = os.path.dirname(os.path.abspath(__file__))

    def child(name):
        proc = subprocess.run(
            [sys.executable, "-c", TRACE_CHILD, root, name, suite_cache],
            capture_output=True, text=True, timeout=600,
            preexec_fn=_die_with_parent)
        check(proc.returncode == 0,
              f"trace child for {name} failed: {proc.stderr[-3000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])

    for name in ("bn1M", "stencil_2600"):
        t = child(name)
        L = t["levels"]
        got = {k: t["by_name"].get(k, {}).get("launches", 0)
               for k in STEP_KERNELS}
        got["kernel 1"] = sum(t["by_name"].get(k, {}).get("launches", 0)
                              for k in LEVEL_KERNELS)
        want = {"kernel 1": K * L, **{k: K for k in STEP_KERNELS}}
        check(got == want, f"{name}: the trace names the level and step "
              f"kernels {got} times, want {want} (categories "
              f"{t['categories']})")
        others = t["kernel_events"] - sum(got.values())
        check(others < K, f"{name}: {others} kernels besides the level and "
              f"step kernels in a Lanczos of k={K}: one a step or more "
              f"(the realmask multiply is folded into the step)")
        step_ms = sum(t["by_name"][k]["ms"] for k in STEP_KERNELS)
        if name == "bn1M":
            d = t["df_spmv"]
            check(d["kernels"] == d["df_level_kernels"] == L
                  and d["elementwise"] == 0,
                  f"bn1M traced df SpMV: {d['kernels']} kernels, "
                  f"{d['df_level_kernels']} of the df level kernel, want "
                  f"{L} and only those; {d['elementwise']} elementwise ops")
        emit({"phase": 12, "part": f"trace_{name}", **t,
              "step_kernels_ms": step_ms,
              "kernels_per_lanczos": t["kernel_events"],
              "other_kernels": others,
              "ms_by_kernel": {k: r["ms"] for k, r in t["by_name"].items()},
              "launches_per_step": sum(got[k] for k in STEP_KERNELS) / K,
              "total_s": time.time() - t_all})
    t = child("bn1M_4_shards")
    got = {k: t["by_name"].get(k, {}).get("launches", 0)
           for k in SHARD_PASS_KERNELS}
    check(got == {k: K * SHARDS for k in SHARD_PASS_KERNELS},
          f"4-shard trace: pass launches {got}, want {K * SHARDS} each "
          f"(categories {t['categories']})")
    check(t["kernels_between_passes"] == 0,
          f"4-shard trace: {t['kernels_between_passes']} kernels between a "
          f"step's passes, want 0")
    emit({"phase": 11, "part": "trace_4_shards", **t,
          "pass_kernels_ms": sum(t["by_name"][k]["ms"]
                                 for k in SHARD_PASS_KERNELS),
          "ms_by_kernel": {k: r["ms"] for k, r in t["by_name"].items()},
          "total_s": time.time() - t_all})
    t = child("bn1M_4_shard_spmvs")
    spmv_t, df_t = t["spmv"], t["df_spmv"]
    check(spmv_t["spmv_kernels"] == SHARD_SPMV_LAUNCHES
          and df_t["spmv_kernels"] == SHARD_DF_SPMV_LAUNCHES
          and df_t["elementwise"] == 0,
          f"4-shard SpMV traces: {spmv_t['spmv_kernels']} and "
          f"{df_t['spmv_kernels']} SpMV kernels a SpMV and a df SpMV, want "
          f"{SHARD_SPMV_LAUNCHES} and {SHARD_DF_SPMV_LAUNCHES}; "
          f"{df_t['elementwise']} elementwise ops in the df SpMV, want 0")
    emit({"phase": 11, "part": "trace_4_shard_spmvs", **t,
          "total_s": time.time() - t_all})


def eval_phase(torch, g, dg, ref, ref_shift, t_all: float, suite_cache: str,
               dev="cuda") -> None:
    """Phase 12: the eval harness on phase 3's graph and pack and phase
    4's oracle answer: the stage breakdown (kernel 1's launches, the
    staged answer against ``expm_action``'s), fused serving, the accuracy
    record (kernels 1 and 1c), two suite rows (copapers_540k at sub=128
    with its oracle column, stencil_2600 past 64 dest chunks with its
    df64 column) and the small jobs (k and pack sweeps, the df64 sweep,
    stochastic_bench, and europe_df64 at side 1000).  One JSON line a
    part."""
    from tpu_lanczos_torch.eval import (
        accuracy_gpu, df_sweep, europe_df64, fused_serving, stage_breakdown,
        stochastic_bench, sweeps)
    from tpu_lanczos_torch.utils import BUILD_DIR

    L, nb = len(dg.levels), dg.n_bcast

    # ---- the stage breakdown and its launches
    reset_counts()
    row, _, _ = stage_breakdown.breakdown(g, dg, K, REPS, name="bn1M")
    counts = read_counts(torch)
    check_counts(counts, {"launches": row["lanczos_runs"] * K * L,
                          "launches_step": row["lanczos_runs"] * K},
                 "stage_breakdown: k*levels and k steps per Lanczos run")
    check(row["staged_vs_expm_rel"] < 1e-6,
          f"staged answer == expm_action's ({row['staged_vs_expm_rel']})")
    check(row["ref_cuda_whole_s"] == 0.455634, "bn1M reference time")
    emit({"phase": 12, "part": "stage_breakdown", **row,
          "launches": counts, "total_s": time.time() - t_all})

    # ---- fused serving: device- and host-eigensolve top-20 in turns
    row = fused_serving.run(g, dg, K, TOPK, REPS)
    check(row["topk_node_overlap"] == f"{TOPK}/{TOPK}",
          f"fused serving top-{TOPK} overlap {row['topk_node_overlap']}")
    check(row["topk_value_rel_diff"] <= 1e-3, f"fused serving top-{TOPK} "
          f"values within 1e-3 ({row['topk_value_rel_diff']})")
    emit({"phase": 12, "part": "fused_serving", **row,
          "total_s": time.time() - t_all})

    # ---- the accuracy record against phase 4's oracle answer
    reset_counts()
    rows = accuracy_gpu.run(g, dg, K, ref, ref_shift)
    counts = read_counts(torch)
    # two f32 two-pass queries and two df64 queries (a warm one each)
    check_counts(counts, {
        "launches": 2 * (2 * K - 1) * L, "launches_df": 2 * (2 * K - 1) * L,
        "launches_step": 2 * (2 * K - 1),
        "launches_step_df": 2 * (2 * K - 1)},
        "accuracy_gpu.run: as phase 5 counts each query")
    f32, df = rows
    check(f32["rel_err"] < 1e-4, f"accuracy_gpu f32 {f32['rel_err']} < 1e-4")
    check(df["rel_err"] < 1e-10, f"accuracy_gpu df64 {df['rel_err']} < 1e-10")
    emit({"phase": 12, "part": "accuracy_gpu", "rows": rows,
          "launches": counts, "total_s": time.time() - t_all})

    # ---- two suite rows: sub=128 with the oracle column, and > 64 dest
    # chunks with the df64 column (their caches kept for the traces)
    for name in SUITE_ROWS:
        with contextlib.redirect_stdout(io.StringIO()):
            row = suite_row(torch, name, suite_cache, dev)
        if name == "copapers_540k":
            check(row["sub"] == 128 and row["err_ref"] == "oracle_f64",
                  f"{name}: sub=128 pack, oracle column")
        else:
            check(row["n_chunks"] > 64
                  and row["err_ref"] == "df64_selfcheck",
                  f"{name}: {row['n_chunks']} > 64 dest chunks, df64 "
                  "column")
        emit({"phase": 12, "part": "bench_suite", **row,
              "total_s": time.time() - t_all})
        torch.cuda.empty_cache()

    # ---- the small jobs (their own JSON prints quieted: each part is
    # one line here)
    quiet = io.StringIO()
    with contextlib.redirect_stdout(quiet):
        rows = sweeps.k_sweep(dtype="float64", device=dev)
        pack_rows = sweeps.pack_sweep(device=dev)
    err30 = next(r["rel_err"] for r in rows if r["k"] == 30)
    check(err30 < 1e-9, f"k_sweep f64 rel_err at k=30 {err30} < 1e-9")
    check(all(r["tiles"] > 0 and r["lanczos_s"] > 0 for r in pack_rows),
          "pack_sweep: tiles and a Lanczos time per point")
    with contextlib.redirect_stderr(io.StringIO()):
        df_rows = df_sweep.run(device=dev)
    worst = max(r["rel_err_df64"] for r in df_rows if r["k"] >= 25)
    check(worst < 1e-12, f"df_sweep df64 rel_err {worst} < 1e-12 for k>=25")
    st_rows = stochastic_bench.run(g, dg)
    agree = next(r for r in st_rows if r["study"].endswith("agreement"))
    check(agree["ok"], f"stochastic_bench: disjoint seeds agree within 3 "
          f"combined stderrs ({agree['rel_diff']} <= "
          f"{agree['budget_3sigma']})")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as cache, \
            contextlib.redirect_stdout(quiet):
        eu_rows = europe_df64.run(EUROPE_SIDE, K, cache, 25, dev)
    check(eu_rows[-1].get("resume_bit_identical") is True,
          "europe_df64: the resume is bit-identical")
    emit({"phase": 12, "part": "small_jobs", "k_sweep": rows,
          "pack_sweep": pack_rows, "df_sweep": df_rows,
          "stochastic_bench": st_rows, "europe_df64": eu_rows,
          "total_s": time.time() - t_all})


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_lanczos_torch import CSRGraph, generators
    from tpu_lanczos_torch import expm_action, expm_action_summary
    from tpu_lanczos_torch import expm_action_df, expm_action_ks_df
    from tpu_lanczos_torch.core.df64 import df_to_f64
    from tpu_lanczos_torch.core.lanczos import lanczos, lanczos_alphabeta
    from tpu_lanczos_torch.core.lanczos_df import lanczos_alphabeta_df
    from tpu_lanczos_torch.utils import BUILD_DIR
    from tpu_lanczos_torch.eval import oracle
    from tpu_lanczos_torch.eval.cpg_variants import chunk_counts
    from tpu_lanczos_torch.graphs import native
    from tpu_lanczos_torch.kernels import _build, spmv_cpg
    from tpu_lanczos_torch.kernels.cpg import pack_cpg

    check("jax" not in sys.modules, "jax is never imported")
    dev = torch.device("cuda")
    t_all = time.time()

    # ---- 0: toolchain
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": 0, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "capability": list(cap),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "nvcc": run_text([_build.nvcc_path(), "--version"]).splitlines()[-1],
          "triton": triton_version, "python": sys.version.split()[0]})
    check(cap == (9, 0), f"compute capability (9, 0), got {cap}")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "float32 matmuls run without TF32")

    # ---- 1: build
    t0 = time.time()
    _build.library()
    nvcc_s = time.time() - t0
    t0 = time.time()
    check(native.available(), f"native graph core builds: "
          f"{native.build_error()}")
    gxx_s = time.time() - t0
    ptxas = ptxas_report(_build.build_log or "")
    emit({"phase": 1, "nvcc_build_s": nvcc_s, "gxx_build_s": gxx_s,
          "ptxas": ptxas})
    check(sum(k["slab"] for k in ptxas) == 4,
          "four slab instantiations built (plain f32, f64; compensated; "
          "df)")
    for kernel in (*LEVEL_KERNELS, "cpg_level_comp_kernel",
                   "cst_level_kernel", "gpg_level_kernel", "probe_kernel",
                   "probe_reduce_kernel", *STEP_KERNELS,
                   "lanczos_step_df_kernel", "step_dot_kernel",
                   "step_update_kernel", "step_sub_norm_kernel",
                   "step_normalize_kernel", "df_dot_kernel",
                   "shard_dot_kernel", "shard_update_kernel",
                   "shard_sub_norm_kernel", "shard_normalize_kernel",
                   "df_update_kernel", "df_normalize_kernel",
                   "cpg_shard_level_df_kernel", "cpg_level_df_kernel",
                   "cpg_slab_level_df_kernel"):
        check(any(kernel in k["kernel"] for k in ptxas), f"{kernel} built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    cst_path = os.path.join(BUILD_DIR, f"cst_bn1M.{os.getpid()}.npz")
    cst_job = start_cst_pack(cst_path)

    # ---- 2: kernel == plain version on the card, small packs
    rng = np.random.default_rng(0)
    g40k = generators.barabasi_albert(40000, 6, seed=3)
    # several source slabs per chunk: the slab layout differs from classic
    g40k_m4 = generators.barabasi_albert(40000, 4, seed=1)
    g2000 = generators.barabasi_albert(2000, 8, seed=2)
    star = star_graph(CSRGraph)
    cases = [
        ("ba2000_m8_sub128", g2000, None, "classic"),
        ("star3000", star, None, "classic"),
        ("ba40000_m6_sub256", g40k, 256, "classic"),
        ("ba40000_m6_sub512", g40k, 512, "classic"),
        ("ba2000_m8_sub128_slab", g2000, None, "slab"),
        ("star3000_sub512_slab", star, 512, "slab"),
        ("ba40000_m6_sub512_slab", g40k, 512, "slab"),
        ("ba40000_m4_sub256_slab", g40k_m4, 256, "slab"),
        ("ba40000_m4_sub512_slab", g40k_m4, 512, "slab"),
    ]
    max_err = {"classic": 0.0, "slab": 0.0}
    comp_err = {"classic": 0.0, "slab": 0.0}
    df_err = {"classic": 0.0, "slab": 0.0}
    # rows 5 and 5c: the largest |kernel - plain| and relative alpha/beta
    # difference
    step_err = {"5": 0.0, "5c": 0.0}
    step_rel = {"5": 0.0, "5c": 0.0}
    rows = []
    for name, g, sub, layout in cases:
        cg = pack_cpg(g, sub=sub, layout=layout, device=dev)
        check(cg.layout == layout, f"{name}: pack layout {cg.layout}")
        slab = layout == "slab"
        plain_c = "launches_slab" if slab else "launches"
        comp_c = "launches_comp_slab" if slab else "launches_comp"
        df_c = "launches_df_slab" if slab else "launches_df"
        L, nb = len(cg.levels), cg.n_bcast
        reset_counts()
        xr = rng.standard_normal(cg.n)
        x32 = torch.from_numpy(cg.permute_in(xr, np.float32)).to(dev)
        max_err[layout] = max(max_err[layout],
                              level_chain(torch, spmv_cpg, cg, x32))
        y = spmv_cpg.spmv_cpg(cg, x32)
        y_ref = spmv_cpg.spmv_cpg_ref(cg, x32)
        check(torch.equal(y, y_ref), f"{name}: spmv_cpg == plain (f32)")
        # the float64 instance: every level == plain, and the SpMV
        # against scipy (the reference's 1e-11 bar)
        x64 = torch.from_numpy(cg.permute_in(xr, np.float64)).to(dev)
        max_err[layout] = max(max_err[layout],
                              level_chain(torch, spmv_cpg, cg, x64))
        y64 = cg.permute_out(spmv_cpg.spmv_cpg(cg, x64))
        err64 = float(np.abs(y64 - g.to_scipy() @ xr).max())
        check(err64 < 1e-11 * max(1.0, float(np.abs(y64).max())),
              f"{name}: f64 kernel matches scipy ({err64})")
        check_counts(read_counts(torch), {plain_c: 4 * L},
                     f"{name}: f32 and f64 levels and SpMVs")
        # df64: the df level kernel and the compensated kernel == plain
        # on every level, the df SpMV == its plain version and, in
        # float64, scipy's
        reset_counts()
        hi, lo = split_dev(torch, cg, xr, dev)
        err_d, err_c, (yh, yl) = df_level_chain(torch, spmv_cpg, cg, hi, lo)
        df_err[layout] = max(df_err[layout], err_d)
        comp_err[layout] = max(comp_err[layout], err_c)
        yh2, yl2 = spmv_cpg.spmv_cpg_df(cg, hi, lo)
        rh, rl = spmv_cpg.spmv_cpg_df_ref(cg, hi, lo)
        check(torch.equal(yh2, rh) and torch.equal(yl2, rl)
              and torch.equal(yh, rh) and torch.equal(yl, rl),
              f"{name}: spmv_cpg_df == plain")
        x_df = cg.permute_out(df_to_f64((hi, lo)))
        y_df = cg.permute_out(df_to_f64((yh, yl)))
        want_df = g.to_scipy() @ x_df
        df_rel = float(np.linalg.norm(y_df - want_df)
                       / np.linalg.norm(want_df))
        check(df_rel < 1e-13, f"{name}: df64 SpMV matches scipy ({df_rel})")
        counts = read_counts(torch)
        check_counts(counts, {df_c: 2 * L, comp_c: L - nb,
                              plain_c: L + nb},
                     f"{name}: two df SpMVs, one composed of kernels 1 and "
                     f"1c")
        # rows 5 and 5c on this pack's f32, f64 and df SpMV outputs
        reset_counts()
        for v_s, q_s, qp_s in step_inputs(torch, cg, xr, dev):
            e, r = step_case(torch, v_s, q_s, qp_s, cg.realmask)
            step_err["5"], step_rel["5"] = (max(step_err["5"], e),
                                            max(step_rel["5"], r))
        e, r = step_df_case(torch, *step_inputs(torch, cg, xr, dev, df=True),
                            cg.realmask)
        step_err["5c"], step_rel["5c"] = (max(step_err["5c"], e),
                                          max(step_rel["5c"], r))
        check_counts(read_counts(torch), {
            plain_c: 2 * L, df_c: L, "launches_step": 4,
            "launches_step_df": 2}, f"{name}: rows 5 and 5c, twice each")
        rows.append({"pack": name, "layout": layout, "sub": cg.sub,
                     "levels": L, "n_bcast": nb, "tiles": list(cg.t_reals),
                     "l2": str(cg.levels[0]["l2"].dtype), "f64_err": err64,
                     "df64_rel_err": df_rel, "df_launches": counts})
    emit({"phase": 2, "equal": True, "max_abs_err": max_err,
          "comp_max_abs_err": comp_err, "df_max_abs_err": df_err,
          "step_max_abs_err": step_err,
          "step_max_rel_alpha_beta": step_rel, "packs": rows})

    # ---- 3: main path at bench.py's size
    t0 = time.time()
    g = generators.barabasi_albert(N, M, seed=SEED, use_native=True)
    gen_s = time.time() - t0
    t0 = time.time()
    dg = pack_cpg(g, sub=SUB, device=dev)
    torch.cuda.synchronize()
    pack_s = time.time() - t0
    x1 = dg.realmask.clone()
    level_err = max(level_chain(torch, spmv_cpg, dg, x1),
                    level_chain(torch, spmv_cpg, dg, x1.double()))
    y = spmv_cpg.spmv_cpg(dg, x1)
    check(torch.equal(y, spmv_cpg.spmv_cpg_ref(dg, x1)),
          "bn1M: spmv_cpg == plain")
    max_err["classic"] = max(max_err["classic"], level_err)

    # the main path: expm_action, and the top-20 query with the host and
    # with the device eigensolve
    reset_counts()
    res = expm_action(g, k=K, log_scale=True, dg=dg)
    summ = expm_action_summary(g, k=K, topk=TOPK, dg=dg)
    summ_dev = expm_action_summary(g, k=K, topk=TOPK, dg=dg,
                                   eig_impl="device")
    counts = read_counts(torch)
    main_launches = counts["launches"]
    main_steps = counts["launches_step"]
    check_counts(counts, {"launches": 3 * K * len(dg.levels),
                          "launches_step": 3 * K},
                 "main path: k*levels and k steps per Lanczos run, three "
                 "runs")
    check(res.ans.shape == (N,) and bool(np.all(np.isfinite(res.ans))),
          "expm_action answer finite, shape (n,)")
    check(np.isfinite(res.log_scale), "log_scale finite")
    for sr in (summ, summ_dev):
        check(sr.top_values.shape == (TOPK,)
              and bool(np.all(np.isfinite(sr.top_values)))
              and np.isfinite(sr.ans_norm), "summary finite")
    check(set(summ_dev.top_nodes.tolist()) == set(summ.top_nodes.tolist()),
          "device-eig summary gives the host-eig summary's top-20")
    # the float32 device eigh resolves T's top cluster of ghost Ritz
    # copies (eigenvalues ~1e-5 apart) less well than float64 LAPACK: its
    # values are recorded, held only to a 1e-2 sanity bound
    dev_vs_host = float(np.max(np.abs(
        summ_dev.top_values * np.exp(summ_dev.log_scale - summ.log_scale)
        / summ.top_values - 1)))
    check(dev_vs_host < 1e-2, f"device-eig top-20 values within 1e-2 of "
          f"the host path's ({dev_vs_host})")

    sync_host = syncs(torch, lambda: expm_action_summary(
        g, k=K, topk=TOPK, dg=dg))
    sync_dev = syncs(torch, lambda: expm_action_summary(
        g, k=K, topk=TOPK, dg=dg, eig_impl="device"))
    sync_eigh = syncs(torch, lambda: torch.linalg.eigh(torch.eye(
        K, device=dev)))

    spmv_ms, spmv_samples = cuda_ms(torch, lambda: spmv_cpg.spmv_cpg(dg, x1))
    plain_ms, plain_samples = cuda_ms(
        torch, lambda: spmv_cpg.spmv_cpg_ref(dg, x1))
    level_ms = []
    for i, level in enumerate(dg.levels):
        base = None if i == dg.n_bcast else x1.reshape(dg.n_sub, 128)
        level_ms.append(cuda_ms(torch, lambda: spmv_cpg.run_level(
            x1.reshape(dg.n_sub, 128), level, dg.n_chunks, SUB,
            base=base))[0])
    torch.cuda.reset_peak_memory_stats()
    lanczos_ms, lanczos_samples = cuda_ms(torch, lambda: lanczos(dg, x1, K))
    peak_lanczos = torch.cuda.max_memory_allocated()

    query_med, query_s = wall_s(torch, lambda: expm_action_summary(
        g, k=K, topk=TOPK, dg=dg))
    query_dev_med, query_dev_s = wall_s(torch, lambda: expm_action_summary(
        g, k=K, topk=TOPK, dg=dg, eig_impl="device"))
    index_bytes = dg.index_bytes()

    # the library yardstick: cuSPARSE CSR SpMV (torch.sparse) of the same
    # graph in float32, never used by the port
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(g.indptr.astype(np.int64)),
        torch.from_numpy(g.indices.astype(np.int64)),
        torch.ones(g.nnz, dtype=torch.float32), size=(N, N)).to(dev)
    x_nat = torch.from_numpy(dg.permute_out(x1)).to(dev)
    lib_y = dg.permute_out(spmv_cpg.spmv_cpg(dg, x1))
    lib_rel = float(np.linalg.norm((csr @ x_nat).cpu().numpy() - lib_y)
                    / np.linalg.norm(lib_y))
    check(lib_rel < 1e-5, f"cuSPARSE SpMV agrees with the kernel ({lib_rel})")
    csr_ms, csr_samples = cuda_ms(torch, lambda: csr @ x_nat)
    spmv_bound_ms, spmv_bound_by = bound(*spmv_cost(dg))
    level_bound_ms = [bound(*level_cost(dg, i, 4, 1, i != dg.n_bcast))[0]
                      for i in range(len(dg.levels))]

    # row 5 at full size: the kernel against its plain version (f32, f64)
    # on bn1M's SpMV output, then its device time per step beside the
    # eager step's (queued, in turns), and Lanczos k=50 through the kernel
    # and through the eager step, in turns
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    ins = step_inputs(torch, dg, rng.standard_normal(N), dev)
    for v_s, q_s, qp_s in ins:
        e, r = step_case(torch, v_s, q_s, qp_s, dg.realmask)
        step_err["5"], step_rel["5"] = (max(step_err["5"], e),
                                        max(step_rel["5"], r))
    v_s, q_s, qp_s = ins[0]
    work = ls.workspace(dev)
    ab_k = [torch.zeros(8, device=dev) for _ in range(2)]
    ab_e = [torch.zeros(8, device=dev) for _ in range(2)]
    ab_k[1][2] = ab_e[1][2] = 0.75
    v_k = v_s.clone()
    # the step as the loops run it on a CPG pack: v before its realmask
    # multiply, the mask folded into the step (the eager step multiplies)
    rm = dg.realmask
    step_fns = {
        "kernel": (lambda: ls.lanczos_step(v_k, q_s, qp_s, *ab_k, 3,
                                           work=work, mask=rm), 100),
        "eager": (lambda: ls.lanczos_step_ref(v_s, q_s, qp_s, *ab_e, 3,
                                              mask=rm), 20),
    }
    step_turns, lanczos_turns = {}, {}
    for tag in ("eager_1", "kernel_1", "kernel_2", "eager_2"):
        fn, calls = step_fns[tag.split("_")[0]]
        ms, samples, host_ms = queued_ms(torch, fn, calls)
        step_turns[tag] = {"device_ms": ms, "samples": samples,
                           "host_enqueue_ms": host_ms, "calls": calls}
        with (eager_steps() if tag.startswith("eager")
              else contextlib.nullcontext()):
            lanczos_turns[tag] = cuda_ms(torch, lambda: lanczos(dg, x1, K))
    step_ms = float(np.median([step_turns[t]["device_ms"]
                               for t in ("kernel_1", "kernel_2")]))
    eager_step_ms = float(np.median([step_turns[t]["device_ms"]
                                     for t in ("eager_1", "eager_2")]))
    step_bound_ms, step_bound_by = step_bound(dg.n_pad, False)
    step_plan = ls.plan_for(dev, dg.n_pad, 4)
    del ins, v_s, q_s, qp_s, v_k
    emit({"phase": 3, "graph": f"ba_{N}_{M}_{SEED}_native", "nnz": g.nnz,
          "gen_s": gen_s, "pack_s": pack_s, "sub": SUB,
          "n_chunks": dg.n_chunks, "levels": len(dg.levels),
          "n_bcast": dg.n_bcast, "tiles": list(dg.t_reals),
          "index_bytes": index_bytes, "k": K,
          "main_launches": main_launches,
          "spmv_kernel_ms": spmv_ms, "spmv_kernel_samples": spmv_samples,
          "spmv_plain_ms": plain_ms, "spmv_plain_samples": plain_samples,
          "level_kernel_ms": level_ms,
          "level_tile_counts": chunk_counts(dg),
          "level_bound_ms": level_bound_ms,
          "main_level_bound_share": (level_bound_ms[dg.n_bcast]
                                     / level_ms[dg.n_bcast]),
          "index_GBps": index_bytes / (spmv_ms * 1e-3) / 1e9,
          "spmv_bound_ms": spmv_bound_ms, "spmv_bound_by": spmv_bound_by,
          "index_bound_ms": index_bytes / HBM_BYTES_PER_S * 1e3,
          "cusparse_spmv_ms": csr_ms, "cusparse_samples": csr_samples,
          "cusparse_rel_diff": lib_rel,
          "lanczos_k50_ms": lanczos_ms, "lanczos_samples": lanczos_samples,
          "lanczos_peak_bytes": peak_lanczos,
          "summary_query_s": query_med, "summary_query_samples": query_s,
          "summary_device_eig_query_s": query_dev_med,
          "summary_device_eig_query_samples": query_dev_s,
          "device_vs_host_eig_top20_max_rel": dev_vs_host,
          "syncs_summary_host_eig": sync_host,
          "syncs_summary_device_eig": sync_dev,
          "syncs_eigh_alone": sync_eigh,
          "log_scale": res.log_scale, "top_nodes": summ.top_nodes.tolist(),
          "main_steps": main_steps,
          "step_f32": {"max_abs_err": step_err["5"],
                       "max_rel_alpha_beta": step_rel["5"],
                       "device_ms": step_ms, "eager_device_ms": eager_step_ms,
                       "bound_ms": step_bound_ms, "bound_by": step_bound_by,
                       "bound_share": step_bound_ms / step_ms,
                       "plan": {"grid": step_plan.grid,
                                "smem_chunks": step_plan.smem_chunks,
                                "tier": step_plan.tier(dg.n_pad, 4)},
                       "turns": step_turns},
          "lanczos_k50_turns_ms": {t: v[0] for t, v in lanczos_turns.items()},
          "lanczos_k50_turn_samples": {t: v[1]
                                       for t, v in lanczos_turns.items()}})

    # ---- 3b: the same graph in the main path's pack (sub 256)
    p3b = main_pack_phase(torch, g, spmv_cpg)
    max_err["classic"] = max(max_err["classic"], p3b["max_abs_err"])
    emit(dict(p3b, total_s=time.time() - t_all))

    # ---- 4: accuracy against the float64 oracle, same graph
    t0 = time.time()
    ref, ref_shift = oracle.expm_action_shifted(g, np.ones(g.n), K)
    oracle_s = time.time() - t0
    rel = oracle.rel_error(res.ans * np.exp(res.log_scale - ref_shift), ref)
    top_ref = set(np.argsort(ref)[-TOPK:].tolist())
    top_ans = set(np.argsort(res.ans)[-TOPK:].tolist())
    top_sum = set(summ.top_nodes.tolist())
    emit({"phase": 4, "n": g.n, "k": K, "oracle_s": oracle_s,
          "rel_error": rel, "shift": res.log_scale, "oracle_shift": ref_shift,
          "top20_equal_expm": top_ans == top_ref,
          "top20_equal_summary": top_sum == top_ref,
          "total_s": time.time() - t_all})
    check(rel < 1e-4, f"f32 rel_error {rel} < 1e-4 against the f64 oracle")
    check(top_ans == top_ref and top_sum == top_ref,
          "top-20 nodes equal the oracle's")

    # ---- 5: the two-pass paths, same graph, pack and oracle answer
    L, nb = len(dg.levels), dg.n_bcast
    C = dg.n_chunks
    hi_r, lo_r = split_dev(torch, dg, rng.standard_normal(N), dev)
    err_d, err_c, _ = df_level_chain(torch, spmv_cpg, dg, hi_r, lo_r)
    df_err["classic"] = max(df_err["classic"], err_d)
    comp_err["classic"] = max(comp_err["classic"], err_c)

    def rel_to_oracle(r):
        return oracle.rel_error(r.ans * np.exp(r.log_scale - ref_shift), ref)

    # f32 two-pass: pass 1 regenerates stored-Q Lanczos bit for bit
    st = lanczos(dg, x1, K)
    a_lm, b_lm, xn_lm = lanczos_alphabeta(dg, x1, K)
    check(torch.equal(a_lm, st.alpha) and torch.equal(b_lm[:K - 1], st.beta)
          and torch.equal(xn_lm, st.x_norm),
          "lanczos_alphabeta == stored-Q lanczos (alpha, beta, x_norm)")
    del st, a_lm, b_lm, xn_lm
    reset_counts()
    res_lm = expm_action(g, k=K, log_scale=True, dg=dg, low_mem=True)
    counts = read_counts(torch)
    lm_launches = counts["launches"]
    check_counts(counts, {"launches": (2 * K - 1) * L,
                          "launches_step": 2 * K - 1},
                 "low_mem expm_action: (2k-1)*levels, 2k-1 steps")
    reset_counts()
    summ_lm = expm_action_summary(g, k=K, topk=TOPK, dg=dg, low_mem=True)
    counts = read_counts(torch)
    lm_summary_launches = counts["launches"]
    check_counts(counts, {"launches": (2 * K - 1) * L,
                          "launches_step": 2 * K - 1},
                 "low_mem expm_action_summary: (2k-1)*levels, 2k-1 steps")
    rel_lm = rel_to_oracle(res_lm)
    top_lm = set(np.argsort(res_lm.ans)[-TOPK:].tolist())
    top_lm_sum = set(summ_lm.top_nodes.tolist())
    check(rel_lm < 1e-4, f"low_mem f32 rel_error {rel_lm} < 1e-4")
    check(top_lm == top_ref and top_lm_sum == top_ref,
          "low_mem top-20 nodes equal the oracle's")

    def peak_bytes(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    q_bytes = 0.8 * K * dg.n_pad * 4
    peaks = {
        "summary_stored_q": peak_bytes(lambda: expm_action_summary(
            g, k=K, topk=TOPK, dg=dg)),
        "summary_low_mem": peak_bytes(lambda: expm_action_summary(
            g, k=K, topk=TOPK, dg=dg, low_mem=True)),
        "expm_stored_q": peak_bytes(lambda: expm_action(
            g, k=K, log_scale=True, dg=dg)),
        "expm_low_mem": peak_bytes(lambda: expm_action(
            g, k=K, log_scale=True, dg=dg, low_mem=True)),
    }
    for what in ("summary", "expm"):
        saved = peaks[f"{what}_stored_q"] - peaks[f"{what}_low_mem"]
        check(saved >= q_bytes, f"low_mem {what} peak is lower by "
              f"{saved} >= 0.8*k*n_pad*4 = {q_bytes} bytes")

    lm_query_s, lm_query_samples = wall_s(torch, lambda: expm_action_summary(
        g, k=K, topk=TOPK, dg=dg, low_mem=True))
    emit({"phase": 5, "part": "f32_two_pass", "k": K,
          "launches_expm": lm_launches,
          "launches_summary": lm_summary_launches, "rel_error": rel_lm,
          "top20_equal_expm": top_lm == top_ref,
          "top20_equal_summary": top_lm_sum == top_ref,
          "peak_bytes": peaks, "q_basis_bytes_0.8": q_bytes,
          "summary_query_s": lm_query_s,
          "summary_query_samples": lm_query_samples})

    # df64: one expm_action_df run is the counted main path
    reset_counts()
    t0 = time.time()
    res_df = expm_action_df(g, k=K, dg=dg, log_scale=True)
    torch.cuda.synchronize()
    df_first_s = time.time() - t0
    counts = read_counts(torch)
    df_launches = counts["launches_df"]
    df_comp_launches = counts["launches_comp"]
    df_steps = counts["launches_step_df"]
    check_counts(counts, {"launches_df": (2 * K - 1) * L,
                          "launches_step_df": 2 * K - 1},
                 "expm_action_df: (2k-1)L df level launches (one a level), "
                 "none of kernels 1 and 1c, 2k-1 df steps")
    rel_df = rel_to_oracle(res_df)
    top_df = set(np.argsort(res_df.ans)[-TOPK:].tolist())
    check(rel_df < 1e-10, f"df64 rel_error {rel_df} < 1e-10 against the "
          "f64 oracle")
    check(top_df == top_ref, "df64 top-20 nodes equal the oracle's")
    results, diffs = expm_action_ks_df(g, KS, dg=dg, log_scale=True)
    ks_rel = oracle.rel_error(results[K].ans, res_df.ans)
    check(diffs[K] == 0.0 and diffs[KS[0]] > diffs[KS[1]],
          f"expm_action_ks_df diffs vanish at k_max and decrease ({diffs})")
    check(ks_rel < 1e-12, f"ks_df results[{K}] matches expm_action_df "
          f"({ks_rel})")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        res_ck = expm_action_df(g, k=K, dg=dg, log_scale=True,
                                checkpoint_path=os.path.join(tmp, "df.npz"),
                                checkpoint_chunk=CKPT_CHUNK)
    check(np.array_equal(res_ck.alpha, res_df.alpha)
          and np.array_equal(res_ck.beta, res_df.beta),
          "checkpointed pass 1 == plain pass 1 (alpha, beta bit for bit)")

    x2d_r = hi_r.reshape(dg.n_sub, 128)
    main = dg.levels[nb]
    # the df SpMV through the df level kernel and composed of kernels 1c
    # and 1 with the eager folds (the reference's structure), in turns
    df_turns = df_spmv_turns(torch, spmv_cpg, dg, hi_r, lo_r)
    df_spmv_ms = float(np.median(df_turns["fused"]))
    df_spmv_samples = df_turns["fused"]
    df_spmv_plain_ms, df_spmv_plain_samples = cuda_ms(
        torch, lambda: spmv_cpg.spmv_cpg_df_ref(dg, hi_r, lo_r))
    df_bound = bound(*df_spmv_cost(dg))
    df_level_ms, df_level_bound_ms = df_levels_ms(torch, spmv_cpg, dg, hi_r,
                                                  lo_r)
    comp_ms, comp_samples = cuda_ms(
        torch, lambda: spmv_cpg.run_level_comp(x2d_r, main, C, SUB))
    comp_plain_ms, comp_plain_samples = cuda_ms(
        torch, lambda: spmv_cpg.run_level_comp_ref(x2d_r, main, C, SUB))
    level_main_ms = cuda_ms(
        torch, lambda: spmv_cpg.run_level(x2d_r, main, C, SUB))[0]
    comp_bound = bound(*level_cost(dg, nb, 4, 2, False, adds_per_entry=7))
    x1_lo = torch.zeros_like(x1)
    ab_df_ms, ab_df_samples = cuda_ms(
        torch, lambda: lanczos_alphabeta_df(dg, x1, x1_lo, K), reps=3)
    df_query_s, df_query_samples = wall_s(torch, lambda: expm_action_df(
        g, k=K, dg=dg, log_scale=True), reps=3)

    # row 5c at full size, as row 5 in phase 3: against its plain version
    # on bn1M's df SpMV output, its device time per step beside the eager
    # step's (queued, in turns), and pass 1 and the df64 query through
    # the kernel and through the eager step, in turns
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    v_d, q_d, qp_d = step_inputs(torch, dg, rng.standard_normal(N), dev,
                                 df=True)
    e, r = step_df_case(torch, v_d, q_d, qp_d, dg.realmask)
    step_err["5c"], step_rel["5c"] = (max(step_err["5c"], e),
                                      max(step_rel["5c"], r))
    work = ls.workspace(dev)
    z8 = torch.zeros(8, device=dev)
    ab_k = [z8.clone() for _ in range(4)]
    ab_e = [z8.clone() for _ in range(4)]
    ab_k[2][2] = ab_e[2][2] = 0.75
    v_k = (v_d[0].clone(), v_d[1].clone())
    rm = dg.realmask
    df_fns = {
        "kernel": (lambda: ls.lanczos_step_df(v_k, q_d, qp_d, ab_k[:2],
                                              ab_k[2:], 3, work=work,
                                              mask=rm), 50),
        "eager": (lambda: ls.lanczos_step_df_ref(v_d, q_d, qp_d, ab_e[:2],
                                                 ab_e[2:], 3, mask=rm), 1),
    }
    df_step_turns, ab_turns, df_query_turns = {}, {}, {}
    for tag in ("eager_1", "kernel_1", "kernel_2", "eager_2"):
        fn, calls = df_fns[tag.split("_")[0]]
        ms, samples, host_ms = queued_ms(torch, fn, calls)
        df_step_turns[tag] = {"device_ms": ms, "samples": samples,
                              "host_enqueue_ms": host_ms, "calls": calls}
        with (eager_steps() if tag.startswith("eager")
              else contextlib.nullcontext()):
            ab_turns[tag] = cuda_ms(torch, lambda: lanczos_alphabeta_df(
                dg, x1, x1_lo, K), reps=3)[0]
            df_query_turns[tag] = wall_s(torch, lambda: expm_action_df(
                g, k=K, dg=dg, log_scale=True), reps=2)[0]
    df_step_ms = float(np.median([df_step_turns[t]["device_ms"]
                                  for t in ("kernel_1", "kernel_2")]))
    eager_df_step_ms = float(np.median([df_step_turns[t]["device_ms"]
                                        for t in ("eager_1", "eager_2")]))
    df_step_bound_ms, df_step_bound_by = step_bound(dg.n_pad, True)
    df_plan = ls.df_plan_for(dev, dg.n_pad)
    del v_d, q_d, qp_d, v_k
    emit({"phase": 5, "part": "df64", "k": K, "levels": L, "n_bcast": nb,
          "launches_df": df_launches, "launches_comp": df_comp_launches,
          "rel_error": rel_df,
          "shift": res_df.log_scale, "oracle_shift": ref_shift,
          "top20_equal": top_df == top_ref, "ks": list(KS),
          "ks_diffs": {str(k): v for k, v in diffs.items()},
          "ks_vs_single": ks_rel, "checkpoint_equal": True,
          "comp_max_abs_err": comp_err["classic"],
          "df_max_abs_err": df_err["classic"],
          "df_spmv_ms": df_spmv_ms, "df_spmv_samples": df_spmv_samples,
          "df_spmv_turns": df_turns,
          "df_spmv_composed_ms": float(np.median(df_turns["composed"])),
          "df_spmv_bound_ms": df_bound[0], "df_spmv_bound_by": df_bound[1],
          "df_spmv_bound_share": df_bound[0] / df_spmv_ms,
          "df_level_ms": df_level_ms, "df_level_bound_ms": df_level_bound_ms,
          "df_spmv_plain_ms": df_spmv_plain_ms,
          "df_spmv_plain_samples": df_spmv_plain_samples,
          "comp_level_ms": comp_ms, "comp_level_samples": comp_samples,
          "comp_level_plain_ms": comp_plain_ms,
          "comp_level_bound_ms": comp_bound[0],
          "comp_level_bound_share": comp_bound[0] / comp_ms,
          "comp_level_plain_samples": comp_plain_samples,
          "plain_main_level_ms": level_main_ms,
          "alphabeta_df_k50_ms": ab_df_ms,
          "alphabeta_df_samples": ab_df_samples,
          "expm_action_df_first_s": df_first_s,
          "expm_action_df_s": df_query_s,
          "expm_action_df_samples": df_query_samples,
          "df_steps": df_steps,
          "step_df": {"max_abs_err": step_err["5c"],
                      "max_rel_alpha_beta": step_rel["5c"],
                      "device_ms": df_step_ms,
                      "eager_device_ms": eager_df_step_ms,
                      "bound_ms": df_step_bound_ms,
                      "bound_by": df_step_bound_by,
                      "bound_share": df_step_bound_ms / df_step_ms,
                      "plan": {"grid": df_plan.grid,
                               "rows_log": df_plan.rows_log,
                               "hold": df_plan.hold},
                      "turns": df_step_turns},
          "alphabeta_df_k50_turns_ms": ab_turns,
          "expm_action_df_turns_s": df_query_turns,
          "total_s": time.time() - t_all})

    # ---- 6: the slab layout, same graph, oracle answer and k
    t0 = time.time()
    ds = pack_cpg(g, sub=SUB, layout="slab", device=dev)
    torch.cuda.synchronize()
    slab_pack_s = time.time() - t0
    check(ds.layout == "slab", "bn1M slab pack")
    Ls, nbs = len(ds.levels), ds.n_bcast
    x1s = ds.realmask.clone()
    max_err["slab"] = max(max_err["slab"],
                          level_chain(torch, spmv_cpg, ds, x1s))
    ys = spmv_cpg.spmv_cpg(ds, x1s)
    check(torch.equal(ys, spmv_cpg.spmv_cpg_ref(ds, x1s)),
          "bn1M: slab spmv_cpg == plain")
    slab_vs_classic = float(np.abs(ds.permute_out(ys) - lib_y).max())
    check(slab_vs_classic == 0.0, f"bn1M: slab A.1 == classic A.1 (integer "
          f"sums are exact in f32; max diff {slab_vs_classic})")
    hi_s, lo_s = split_dev(torch, ds, rng.standard_normal(N), dev)
    err_ds, err_cs, _ = df_level_chain(torch, spmv_cpg, ds, hi_s, lo_s)
    df_err["slab"] = max(df_err["slab"], err_ds)
    comp_err["slab"] = max(comp_err["slab"], err_cs)

    reset_counts()
    res_s = expm_action(g, k=K, log_scale=True, dg=ds)
    counts = read_counts(torch)
    slab_launches = counts["launches_slab"]
    check_counts(counts, {"launches_slab": K * Ls, "launches_step": K},
                 "expm_action on the slab pack: k*levels slab launches, "
                 "k steps")
    rel_s = rel_to_oracle(res_s)
    top_s = set(np.argsort(res_s.ans)[-TOPK:].tolist())
    check(rel_s < 1e-4, f"slab f32 rel_error {rel_s} < 1e-4")
    check(top_s == top_ref, "slab top-20 nodes equal the oracle's")
    reset_counts()
    res_sdf = expm_action_df(g, k=K, dg=ds, log_scale=True)
    counts = read_counts(torch)
    comp_slab_launches = counts["launches_comp_slab"]
    df_slab_launches = counts["launches_df_slab"]
    check_counts(counts, {"launches_df_slab": (2 * K - 1) * Ls,
                          "launches_step_df": 2 * K - 1},
                 "expm_action_df on the slab pack: (2k-1)L slab df level "
                 "launches, none of the slab kernels 1 and 1c")
    rel_sdf = rel_to_oracle(res_sdf)
    top_sdf = set(np.argsort(res_sdf.ans)[-TOPK:].tolist())
    check(rel_sdf < 1e-10, f"slab df64 rel_error {rel_sdf} < 1e-10")
    check(top_sdf == top_ref, "slab df64 top-20 nodes equal the oracle's")

    # timings, classic and slab in turns: classic, slab, slab, classic
    x2d_c, x2d_s = x1.reshape(dg.n_sub, 128), x1s.reshape(ds.n_sub, 128)
    main_c, main_s = dg.levels[nb], ds.levels[nbs]
    turns = {}
    for tag in ("classic_1", "slab_1", "slab_2", "classic_2"):
        cg_t, x_t = (ds, x1s) if tag.startswith("slab") else (dg, x1)
        turns[f"spmv_{tag}_ms"] = cuda_ms(
            torch, lambda: spmv_cpg.spmv_cpg(cg_t, x_t))[0]
    slab_spmv_ms = float(np.median([turns["spmv_slab_1_ms"],
                                    turns["spmv_slab_2_ms"]]))
    slab_plain_ms = cuda_ms(torch, lambda: spmv_cpg.spmv_cpg_ref(ds, x1s))[0]
    main_level_ms = {
        "classic": cuda_ms(torch, lambda: spmv_cpg.run_level(
            x2d_c, main_c, C, SUB))[0],
        "slab": cuda_ms(torch, lambda: spmv_cpg.run_level(
            x2d_s, main_s, ds.n_chunks, SUB, slab=True))[0],
    }
    main_level_plain_ms = cuda_ms(torch, lambda: spmv_cpg.run_level_ref(
        x2d_s, main_s, ds.n_chunks, SUB, slab=True), reps=3)[0]
    # every slab level as spmv_cpg runs it (x = realmask), and its bound
    slab_level_ms, slab_level_bound_ms, x_l = [], [], x2d_s
    for i, level in enumerate(ds.levels):
        base = None if i == nbs else x_l
        slab_level_ms.append(cuda_ms(torch, lambda: spmv_cpg.run_level(
            x_l, level, ds.n_chunks, SUB, base=base, slab=True))[0])
        slab_level_bound_ms.append(bound(*level_cost(
            ds, i, 4, 1, base is not None))[0])
        x_l = spmv_cpg.run_level(x_l, level, ds.n_chunks, SUB, base=base,
                                 slab=True)
    hs2d = hi_s.reshape(ds.n_sub, 128)
    comp_slab_ms = cuda_ms(torch, lambda: spmv_cpg.run_level_comp(
        hs2d, main_s, ds.n_chunks, SUB, slab=True))[0]
    comp_slab_plain_ms = cuda_ms(torch, lambda: spmv_cpg.run_level_comp_ref(
        hs2d, main_s, ds.n_chunks, SUB, slab=True), reps=3)[0]
    df_slab_turns = df_spmv_turns(torch, spmv_cpg, ds, hi_s, lo_s)
    df_slab_ms = float(np.median(df_slab_turns["fused"]))
    df_slab_plain_ms = cuda_ms(
        torch, lambda: spmv_cpg.spmv_cpg_df_ref(ds, hi_s, lo_s), reps=3)[0]
    df_slab_bound = bound(*df_spmv_cost(ds))
    df_slab_level_ms, df_slab_level_bound_ms = df_levels_ms(
        torch, spmv_cpg, ds, hi_s, lo_s)
    lanczos_slab_ms, lanczos_slab_samples = cuda_ms(
        torch, lambda: lanczos(ds, x1s, K))
    lanczos_classic_ms = cuda_ms(torch, lambda: lanczos(dg, x1, K))[0]
    # the library yardstick again, in the same phase as the slab times
    slab_csr_ms = cuda_ms(torch, lambda: csr @ x_nat)[0]
    slab_bound_ms, slab_bound_by = bound(*spmv_cost(ds))
    comp_slab_bound = bound(*level_cost(ds, nbs, 4, 2, False,
                                        adds_per_entry=7))
    emit({"phase": 6, "graph": f"ba_{N}_{M}_{SEED}_native", "sub": SUB,
          "slab_pack_s": slab_pack_s, "classic_pack_s": pack_s,
          "levels": Ls, "n_bcast": nbs,
          "tiles": {"slab": list(ds.t_reals), "classic": list(dg.t_reals)},
          "index_bytes": {"slab": ds.index_bytes(),
                          "classic": dg.index_bytes()},
          "launches_expm": slab_launches,
          "launches_df": {"df_slab": df_slab_launches,
                          "comp_slab": comp_slab_launches},
          "rel_error": rel_s, "df64_rel_error": rel_sdf,
          "top20_equal": top_s == top_ref, "df64_top20_equal":
          top_sdf == top_ref, "max_abs_err": max_err["slab"],
          "comp_max_abs_err": comp_err["slab"], **turns,
          "spmv_slab_ms": slab_spmv_ms, "spmv_slab_plain_ms": slab_plain_ms,
          "cusparse_spmv_ms": slab_csr_ms,
          "level_tile_counts": chunk_counts(ds),
          "slab_level_ms": slab_level_ms,
          "slab_level_bound_ms": slab_level_bound_ms,
          "main_level_ms": main_level_ms,
          "main_level_plain_ms": main_level_plain_ms,
          "main_level_bound_ms": {"slab": slab_level_bound_ms[nbs],
                                  "classic": level_bound_ms[nb]},
          "comp_slab_main_level_ms": comp_slab_ms,
          "comp_slab_main_level_plain_ms": comp_slab_plain_ms,
          "comp_slab_main_level_bound_ms": comp_slab_bound[0],
          "comp_slab_bound_share": comp_slab_bound[0] / comp_slab_ms,
          "df_max_abs_err": df_err["slab"],
          "df_spmv_slab_ms": df_slab_ms, "df_spmv_slab_turns": df_slab_turns,
          "df_spmv_slab_composed_ms": float(np.median(
              df_slab_turns["composed"])),
          "df_spmv_slab_plain_ms": df_slab_plain_ms,
          "df_spmv_slab_bound_ms": df_slab_bound[0],
          "df_spmv_slab_bound_share": df_slab_bound[0] / df_slab_ms,
          "df_slab_level_ms": df_slab_level_ms,
          "df_slab_level_bound_ms": df_slab_level_bound_ms,
          "lanczos_k50_ms": {"slab": lanczos_slab_ms,
                             "classic": lanczos_classic_ms},
          "lanczos_slab_samples": lanczos_slab_samples,
          "index_GBps": {
              "slab": ds.index_bytes() / (slab_spmv_ms * 1e-3) / 1e9,
              "classic": dg.index_bytes() / (spmv_ms * 1e-3) / 1e9},
          "bound_ms": {"slab": slab_bound_ms, "classic": spmv_bound_ms},
          "bound_share": {"slab": slab_bound_ms / slab_spmv_ms,
                          "classic": spmv_bound_ms / spmv_ms},
          "total_s": time.time() - t_all})
    del ds, x1s, hi_s, lo_s, x2d_s, hs2d, main_s, x_l

    # ---- 7: the CLI, in process, its output parsed
    from tpu_lanczos_torch.kernels import cpg as cpg_mod

    # the full-width slab query; the packs the CLI builds are recorded
    # to read their level count
    packs = []

    def recording_pack(*a, **kw):
        packs.append(real_pack(*a, **kw))
        return packs[-1]

    real_pack = cpg_mod.pack_cpg
    full = ["-b", str(M), "-n", str(N), "-k", str(K), "--fmt", "cpg",
            "--cpg-sub", str(SUB), "--cpg-layout", "slab", "--topk",
            str(TOPK), "--no-serial"]
    cli_full = {}
    cpg_mod.pack_cpg = recording_pack
    try:
        for eig in ("device", "host"):
            packs.clear()
            reset_counts()
            rc, out, err, secs = run_cli(full + ["--eig", eig])
            counts = read_counts(torch)
            check(rc == 0, f"CLI --eig {eig}: rc {rc}: {err[-2000:]}")
            check(len(packs) == 1 and packs[0].layout == "slab",
                  f"CLI --eig {eig} built one slab pack")
            n_lv = len(packs[0].levels)
            check_counts(counts, {"launches_slab": K * n_lv,
                                  "launches_step": K},
                         f"CLI --eig {eig}: k*levels slab launches, k steps")
            nodes = json.loads(out.split(f"top-{TOPK} nodes: ")[1]
                               .split("\n")[0])
            query_s = float(out.split("device summary pipeline: ")[1]
                            .split("s")[0])
            cli_full[eig] = {"rc": rc, "wall_s": secs, "query_s": query_s,
                             "levels": n_lv, "launches": counts,
                             "top_nodes": nodes}
    finally:
        cpg_mod.pack_cpg = real_pack
        packs.clear()
    check(set(cli_full["device"]["top_nodes"])
          == set(cli_full["host"]["top_nodes"]),
          "CLI --eig device and --eig host give the same top-20")

    small_modes = [
        ("f32", [], 1e-4),
        ("float64", ["--dtype", "float64"], 1e-10),
        ("ks", ["--ks", "10,20,30"], None),
        ("func_heat", ["--func", "heat:0.5"], 1e-4),
        ("pipeline3", ["--pipeline", "3"], 1e-4),
        ("reorthogonalize", ["--reorthogonalize"], 1e-4),
        ("fmt_auto", ["--fmt", "auto"], 1e-4),
        ("fmt_coo", ["--fmt", "coo"], 1e-4),
        ("df64_slab", ["--dtype", "df64", "--fmt", "cpg", "--cpg-layout",
                       "slab"], 1e-12),
    ]
    cli_small = {}
    for name, extra, bar in small_modes:
        reset_counts()
        rc, out, err, secs = run_cli(CLI_SMALL + extra)
        counts = read_counts(torch)
        check(rc == 0, f"CLI {name}: rc {rc}: {err[-2000:]}")
        row = {"argv": extra, "wall_s": secs, "launches": counts}
        if bar is None:  # --ks: the diff vanishes at k_max
            last = [ln.split() for ln in out.splitlines()
                    if ln.strip().startswith("30 ")]
            check(len(last) == 1 and float(last[0][1]) == 0.0,
                  f"CLI --ks: diff at k_max is 0 ({last})")
        else:
            rel_c = float(out.split("relative ")[1].split(")")[0])
            check(rel_c < bar, f"CLI {name}: device vs serial {rel_c} < {bar}")
            row["rel_vs_serial"] = rel_c
        cli_small[name] = row
    check(cli_small["df64_slab"]["launches"]["launches_df_slab"] > 0
          and cli_small["df64_slab"]["launches"]["launches_comp_slab"] == 0,
          "CLI df64 slab ran the slab df level kernel, not kernel 1c")
    # a mesh of 2 GPUs on a machine with one fails as the reference's
    # does on one TPU chip
    try:
        run_cli(CLI_SMALL + ["--shards", "2"])
        shards_2 = None
    except ValueError as exc:
        shards_2 = str(exc)
    check(shards_2 == "need 2 devices, have 1",
          f"CLI --shards 2 on one GPU fails: {shards_2}")
    emit({"phase": 7, "full_width": cli_full, "small": cli_small,
          "shards_2": shards_2, "total_s": time.time() - t_all})

    # ---- 10 and 11 run here, while the CST pack child (phase 8) is
    # still packing on the host
    # ---- 10: the stochastic estimators and the stored-Q checkpoint
    p10 = estimators_phase(torch, g, dg, res.log_scale)
    emit({**p10, "total_s": time.time() - t_all})

    # ---- 11: the row-sharded path, 4 shards of this card
    shard_entries = sharded_phase(torch, g, dev, ref, ref_shift, top_ref,
                                  p10, spmv_ms,
                                  cli_full["host"]["top_nodes"])
    emit({"phase": 11, "part": "done", "total_s": time.time() - t_all})

    # ---- 12: the eval harness, still beside the CST pack child
    suite_cache = tempfile.mkdtemp(dir=BUILD_DIR)
    atexit.register(shutil.rmtree, suite_cache, True)
    eval_phase(torch, g, dg, ref, ref_shift, t_all, suite_cache, dev)

    # ---- 8: the lineage formats, GPG and CST, at full width
    from tpu_lanczos_torch.kernels import spmv_cst, spmv_gpg
    from tpu_lanczos_torch.kernels.gpg import pack_gpg
    from tpu_lanczos_torch.kernels.cst import pack_cst

    def cst_chain(cg, x):
        return lineage_chain(torch, spmv_cst, cg, x, spmv_cst.run_level_cst,
                             spmv_cst.run_level_cst_ref)

    def gpg_chain(gg, x):
        return lineage_chain(torch, spmv_gpg, gg, x, spmv_gpg.run_level_gpg,
                             spmv_gpg.run_level_gpg_ref)

    def f64_rel(pack, spmv_fn, gr, xr):
        """rel 2-norm error of the f64 kernel SpMV against scipy's."""
        x64 = torch.from_numpy(pack.permute_in(xr, np.float64)).to(dev)
        want = gr.to_scipy() @ xr
        got = pack.permute_out(spmv_fn(pack, x64))
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    # the small packs of tests/test_cst.py and tests/test_gpg.py
    hub = np.stack([np.zeros(1199, dtype=np.int64),
                    np.arange(1, 1200, dtype=np.int64)], axis=1)
    ba1500 = generators.barabasi_albert(1500, 6, seed=2)
    small_cst = [
        ("uniform2000", generators.uniform_random(2000, 8000, seed=1)),
        ("ba2000", g2000), ("stencil40", generators.stencil_2d(40)),
        ("tiny50", generators.uniform_random(50, 100, seed=0)),
        ("star3000", star)]
    small_gpg = [
        ("uniform1500", generators.uniform_random(1500, 5000, seed=1), {}),
        ("ba1500", ba1500, {}),
        ("rmat1500", generators.rmat(1500, 5000, seed=3), {}),
        ("stencil40", generators.stencil_2d(40), {}),
        ("hub1200", CSRGraph.from_edges(1200, hub), {}),
        ("ba1500_sub_d512", ba1500, dict(sub_d=512)),
        ("ba1500_g_s8", ba1500, dict(g_s=8)),
        ("ba1500_sub_s128", ba1500, dict(sub_s=128, g_s=16))]
    lin_err = {"cst": 0.0, "gpg": 0.0}
    small_rows = []
    for fmt, cases_f in (("cst", small_cst), ("gpg", small_gpg)):
        for case in cases_f:
            name, gs, kw = case if fmt == "gpg" else (*case, {})
            pk = (pack_cst(gs, device=dev) if fmt == "cst"
                  else pack_gpg(gs, device=dev, **kw))
            chain = cst_chain if fmt == "cst" else gpg_chain
            spmv_fn = spmv_cst.spmv_cst if fmt == "cst" else spmv_gpg.spmv_gpg
            L = len(pk.idx1) if fmt == "cst" else len(pk.levels)
            reset_counts()
            xr = rng.standard_normal(gs.n)
            for dt in (np.float32, np.float64):
                x_t = torch.from_numpy(pk.permute_in(xr, dt)).to(dev)
                lin_err[fmt] = max(lin_err[fmt], chain(pk, x_t))
            rel64 = f64_rel(pk, spmv_fn, gs, xr)
            check(rel64 < 1e-12, f"{fmt} {name}: f64 SpMV vs scipy {rel64}")
            check_counts(read_counts(torch), {f"launches_{fmt}": 3 * L},
                         f"{fmt} {name}: f32 and f64 levels, f64 SpMV")
            small_rows.append({"fmt": fmt, "pack": name, "levels": L,
                               "f64_rel_err": rel64})

    t0 = time.time()
    gg = pack_gpg(g, device=dev)
    torch.cuda.synchronize()
    gpg_pack_s = time.time() - t0
    cg, cst_pack_s, cst_load_s = finish_cst_pack(torch, cst_job, cst_path,
                                                 dev)
    Lg, Lc = len(gg.levels), len(cg.idx1)
    x1g, x1c = gg.realmask.clone(), cg.realmask.reshape(-1).clone()
    lin_err["gpg"] = max(lin_err["gpg"], gpg_chain(gg, x1g))
    lin_err["cst"] = max(lin_err["cst"], cst_chain(cg, x1c))
    check(lin_err == {"cst": 0.0, "gpg": 0.0},
          f"lineage kernels == plain versions ({lin_err})")
    xr = rng.standard_normal(N)
    rel64 = {"gpg": f64_rel(gg, spmv_gpg.spmv_gpg, g, xr),
             "cst": f64_rel(cg, spmv_cst.spmv_cst, g, xr)}
    check(max(rel64.values()) < 1e-12, f"bn1M f64 SpMV vs scipy {rel64}")
    lineage = {}
    for fmt, pk, L in (("gpg", gg, Lg), ("cst", cg, Lc)):
        reset_counts()
        res_f = expm_action(g, k=K, log_scale=True, dg=pk)
        counts = read_counts(torch)
        check_counts(counts, {f"launches_{fmt}": K * L, "launches_step": K},
                     f"expm_action through {fmt}: k*levels, no CPG launch, "
                     f"k steps")
        rel_f = rel_to_oracle(res_f)
        top_f = set(np.argsort(res_f.ans)[-TOPK:].tolist())
        check(rel_f < 1e-4, f"{fmt} f32 rel_error {rel_f} < 1e-4")
        check(top_f == top_ref, f"{fmt} top-20 nodes equal the oracle's")
        lineage[fmt] = {"levels": L, "launches_expm": counts[
            f"launches_{fmt}"], "rel_error": rel_f, "top20_equal": True}
    summ_g = expm_action_summary(g, k=K, topk=TOPK, dg=gg)
    check(set(summ_g.top_nodes.tolist()) == top_ref,
          "expm_action_summary through GPG: the oracle's top-20")

    spmv_ms_of = {"gpg": spmv_gpg.spmv_gpg, "cst": spmv_cst.spmv_cst}
    plain_of = {"gpg": spmv_gpg.spmv_gpg_ref, "cst": spmv_cst.spmv_cst_ref}
    for fmt, pk, x_t in (("gpg", gg, x1g), ("cst", cg, x1c)):
        row = lineage[fmt]
        row["spmv_ms"], row["spmv_samples"] = cuda_ms(
            torch, lambda: spmv_ms_of[fmt](pk, x_t))
        row["spmv_plain_ms"], row["spmv_plain_samples"] = cuda_ms(
            torch, lambda: plain_of[fmt](pk, x_t), reps=2)
        row["lanczos_k50_ms"], row["lanczos_samples"] = cuda_ms(
            torch, lambda: lanczos(pk, x_t, K))
        row["level_ms"] = lineage_level_ms(
            torch, spmv_cst if fmt == "cst" else spmv_gpg, pk, x_t,
            spmv_cst.run_level_cst if fmt == "cst"
            else spmv_gpg.run_level_gpg)
        nbytes, adds = (gpg_spmv_cost(pk) if fmt == "gpg"
                        else cst_spmv_cost(pk))
        row["bound_ms"], row["bound_by"] = bound(nbytes, adds)
        row["index_bytes"] = pk.index_bytes()
        row["index_GBps"] = pk.index_bytes() / (row["spmv_ms"] * 1e-3) / 1e9
        row["bound_share"] = row["bound_ms"] / row["spmv_ms"]
    # the library yardstick again, beside the lineage kernels
    cusparse_ms, _ = cuda_ms(torch, lambda: csr @ x_nat)
    # the bound of the TPU's int32 idx1 and idx3 (8 bytes a slot cell)
    cst_int32_bytes = sum(a.numel() * 8 for a in cg.idx1)
    cst32_ms, _ = bound(*cst_spmv_cost(cg, index_bytes=cst_int32_bytes))
    lineage["gpg"].update(pack_s=gpg_pack_s, tiles=list(gg.t_reals),
                          padded_tiles=[int(lv["d_ids"].shape[0])
                                        for lv in gg.levels],
                          chunk_tiles=[lv["counts"].tolist()
                                       for lv in gg.levels],
                          n_chunks=gg.n_chunks, sub_d=gg.sub_d,
                          fill=gg.fill,
                          real_step_share=gg.real_step_share)
    lineage["cst"].update(pack_s=cst_pack_s, load_h2d_s=cst_load_s,
                          slots=[int(a.shape[0]) for a in cg.idx1],
                          n_cols=cg.n_cols, theta=cg.theta, fill=cg.fill,
                          idx1_dtype=str(cg.idx1[0].dtype),
                          idx3_dtype=str(cg.idx3[0].dtype),
                          index_bytes_int32=cst_int32_bytes,
                          bound_int32_ms=cst32_ms,
                          bound_int32_share=cst32_ms / lineage["cst"][
                              "spmv_ms"])
    check(cg.idx1[0].dtype == torch.int16 and all(
        a.dtype == torch.uint8 for a in cg.idx3),
        "bn1M's CST indices are int16 and uint8 on the card")

    reset_counts()
    rc, out, err, secs = run_cli(CLI_SMALL + ["--fmt", "cst"])
    counts = read_counts(torch)
    check(rc == 0, f"CLI --fmt cst: rc {rc}: {err[-2000:]}")
    rel_cli = float(out.split("relative ")[1].split(")")[0])
    check(rel_cli < 1e-4, f"CLI --fmt cst: device vs serial {rel_cli}")
    # one expm_action of k=50 steps on the CLI's own CST pack
    cli_k = int(CLI_SMALL[CLI_SMALL.index("-k") + 1])
    check(counts["launches_cst"] > 0
          and counts["launches_cst"] % cli_k == 0
          and counts["launches_step"] == cli_k
          and sum(counts.values()) == counts["launches_cst"] + cli_k,
          f"CLI --fmt cst ran the CST kernel (k*levels) and k steps only "
          f"({counts})")
    rc_topk = run_cli(CLI_SMALL + ["--fmt", "cst", "--topk", "5"])[0]
    check(rc_topk == 2, f"CLI --fmt cst --topk 5 exits 2 (rc {rc_topk})")
    emit({"phase": 8, "graph": f"ba_{N}_{M}_{SEED}_native", "k": K,
          "small_packs": small_rows, "max_abs_err": lin_err,
          "bn1M_f64_rel_err": rel64, **lineage,
          "summary_gpg_top20_equal": True,
          "cpg_spmv_ms": spmv_ms, "cusparse_spmv_ms": cusparse_ms,
          "cusparse_spmv_ms_phase3": csr_ms,
          "cli_cst": {"rc": rc, "wall_s": secs, "rel_vs_serial": rel_cli,
                      "launches": counts}, "cli_cst_topk_rc": rc_topk,
          "total_s": time.time() - t_all})
    del gg, cg, x1g, x1c

    # ---- 9: the dense-block probe on the tensor cores
    from tpu_lanczos_torch.eval import mxu_probe

    def run_probe(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = mxu_probe.main(argv)
        return rc, out.getvalue(), err.getvalue()

    rc, _, check_log = run_probe(["--check-only"])
    check(rc == 0, f"mxu_probe --check-only: rc {rc}")
    reset_counts()
    rc, out, probe_log = run_probe([])
    counts = read_counts(torch)
    check(rc == 0, f"mxu_probe: rc {rc}")
    probe_rows = {r["variant"]: r for r in map(json.loads,
                                               out.strip().splitlines())}
    check(sorted(probe_rows) == sorted(mxu_probe.VARIANTS),
          f"mxu_probe timed every variant ({sorted(probe_rows)})")
    reps = probe_rows["dma"]["wall_samples"]
    check_counts(counts, {"launches_mxu": len(mxu_probe.VARIANTS) * (
        len(reps) * mxu_probe.CALLS_PER_SAMPLE + 3)},
        "mxu_probe: the check, the warm, timed and profiled runs")
    # each variant's two launches, from its profiled call: the block
    # stream and the reduce of the partials
    probe_kernel_ms = {v: r["kernel_ms"] for v, r in probe_rows.items()}
    check(all(set(k) == set(mxu_probe.KERNELS)
              for k in probe_kernel_ms.values()),
          f"the profiler timed both probe kernels ({probe_kernel_ms})")
    probe_launches = counts["launches_mxu"]
    blocks = probe_rows["dma"]["blocks"]
    a_p, xh_p, xl_p = mxu_probe.make_data(blocks, 4, 8)
    probe_err, probe_rel = {}, {}
    for v in mxu_probe.VARIANTS:
        got = mxu_probe.probe(a_p, xh_p, xl_p, 8, v, u=4)
        want = mxu_probe.probe_ref(a_p, xh_p, xl_p, 8, v)
        probe_err[v] = float((got - want).abs().max())
        probe_rel[v] = mxu_probe.scaled_err(got, want, 8)
    check(probe_err["dma"] == 0.0, "probe dma == plain at full size")
    check(max(probe_rel.values()) < 1e-5,
          f"probe mxu within 1e-5 of the plain version's largest value "
          f"({probe_rel})")
    probe_plain_ms = cuda_ms(torch, lambda: mxu_probe.probe_ref(
        a_p, xh_p, xl_p, 8, "mxu1"), reps=3)[0]
    # the library yardstick: one bf16 matmul of x_hi repeated B times by
    # the (B*128, 128) block stack (the same sum), never used by the port
    want = mxu_probe.probe_ref(a_p, xh_p, xl_p, 8, "mxu1")
    x_rep = xh_p.repeat(1, blocks)
    lib_out = torch.matmul(x_rep, a_p).float()  # bf16 output: ~2^-8
    lib_rel = float((lib_out - want).abs().max() / want.abs().max())
    check(lib_rel < 1e-2, f"bf16 matmul yardstick agrees ({lib_rel})")
    # timed as the probe is (mxu_probe.time_fn: samples of
    # CALLS_PER_SAMPLE calls back to back, as many samples), and its
    # device time in one profiled call beside the probe's two kernels'
    lib_samples = mxu_probe.time_fn(lambda: torch.matmul(x_rep, a_p),
                                    len(reps))
    probe_lib_ms = float(np.median(lib_samples)) * 1e3
    probe_lib_device_ms = sum(mxu_probe.device_ms(
        lambda: torch.matmul(x_rep, a_p)).values())
    probe_device_ms = {v: sum(k.values()) for v, k in probe_kernel_ms.items()}
    # the blocks, x_hi and x_lo (bf16) read once, the (8, 128) out written
    probe_bytes = (blocks * mxu_probe.BLOCK_BYTES + 2 * 8 * 128 * 2
                   + 8 * 128 * 4)
    probe_bound = bound(probe_bytes, 2 * 8 * 128 * 128 * blocks,
                        BF16_OPS_PER_S)
    emit({"phase": 9, "check_log": check_log.strip(),
          "probe_log": probe_log.strip(), "launches": probe_launches,
          "variants": probe_rows, "kernel_ms": probe_kernel_ms,
          "wall_ms": {v: r["wall_s"] * 1e3 for v, r in probe_rows.items()},
          "full_size_max_abs_err": probe_err,
          "full_size_rel_err": probe_rel, "plain_mxu1_ms": probe_plain_ms,
          "device_ms": probe_device_ms,
          "bf16_matmul_ms": probe_lib_ms,
          "bf16_matmul_samples_ms": [t * 1e3 for t in lib_samples],
          "bf16_matmul_device_ms": probe_lib_device_ms,
          "bf16_matmul_rel": lib_rel,
          "bound_ms": probe_bound[0], "bound_by": probe_bound[1],
          "total_s": time.time() - t_all})
    del a_p, xh_p, xl_p, x_rep, want, lib_out

    # ---- 12's traced Lanczos, after phase 9's profiled probe calls
    trace_part(suite_cache, t_all)
    shutil.rmtree(suite_cache, True)

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "spmv_cpg_level", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": main_launches,
        "max_abs_err": max_err["classic"], "ms": spmv_ms,
        "plain_ms": plain_ms, "bound_ms": spmv_bound_ms,
        "bound_by": spmv_bound_by, "library_ms": csr_ms,
    }, {
        "name": "spmv_cpg_level_staged", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": STAGED_REPLACES,
        "launches": p3b["launches_staged"],
        "max_abs_err": p3b["max_abs_err"],
        "ms": p3b["main_level_ms"]["staged_f32_f64"][0],
        "plain_ms": p3b["main_level_ms"]["plain_f32"],
        "bound_ms": p3b["main_level_bound_ms"][0],
        "bound_by": p3b["main_level_bound_by"][0], "library_ms": None,
    }, {
        "name": "spmv_cpg_level_comp", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": COMP_REPLACES,
        "launches": df_comp_launches, "max_abs_err": comp_err["classic"],
        "ms": comp_ms, "plain_ms": comp_plain_ms,
        "bound_ms": comp_bound[0], "bound_by": comp_bound[1],
        "library_ms": None,
    }, {
        "name": "spmv_cpg_level_slab", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": SLAB_REPLACES,
        "launches": slab_launches, "max_abs_err": max_err["slab"],
        "ms": slab_spmv_ms, "plain_ms": slab_plain_ms,
        "bound_ms": slab_bound_ms, "bound_by": slab_bound_by,
        "library_ms": slab_csr_ms,
    }, {
        "name": "spmv_cpg_level_comp_slab", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": COMP_SLAB_REPLACES,
        "launches": comp_slab_launches, "max_abs_err": comp_err["slab"],
        "ms": comp_slab_ms, "plain_ms": comp_slab_plain_ms,
        "bound_ms": comp_slab_bound[0], "bound_by": comp_slab_bound[1],
        "library_ms": None,
    }, {
        "name": "spmv_cpg_level_df", "route": "cuda", "source": DF_SOURCE,
        "replaces": DF_REPLACES, "launches": df_launches,
        "max_abs_err": df_err["classic"], "ms": df_spmv_ms,
        "plain_ms": df_spmv_plain_ms, "bound_ms": df_bound[0],
        "bound_by": df_bound[1], "library_ms": None,
    }, {
        "name": "spmv_cpg_level_df_slab", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": DF_SLAB_REPLACES,
        "launches": df_slab_launches, "max_abs_err": df_err["slab"],
        "ms": df_slab_ms, "plain_ms": df_slab_plain_ms,
        "bound_ms": df_slab_bound[0], "bound_by": df_slab_bound[1],
        "library_ms": None,
    }, {
        "name": "spmv_cst_level", "route": "cuda", "source": CST_SOURCE,
        "replaces": CST_REPLACES, "launches": lineage["cst"]["launches_expm"],
        "max_abs_err": lin_err["cst"], "ms": lineage["cst"]["spmv_ms"],
        "plain_ms": lineage["cst"]["spmv_plain_ms"],
        "bound_ms": lineage["cst"]["bound_ms"],
        "bound_by": lineage["cst"]["bound_by"], "library_ms": csr_ms,
    }, {
        "name": "spmv_gpg_level", "route": "cuda", "source": GPG_SOURCE,
        "replaces": GPG_REPLACES, "launches": lineage["gpg"]["launches_expm"],
        "max_abs_err": lin_err["gpg"], "ms": lineage["gpg"]["spmv_ms"],
        "plain_ms": lineage["gpg"]["spmv_plain_ms"],
        "bound_ms": lineage["gpg"]["bound_ms"],
        "bound_by": lineage["gpg"]["bound_by"], "library_ms": csr_ms,
    }, {
        "name": "mxu_block_probe", "route": "cuda", "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES, "launches": probe_launches,
        "max_abs_err": max(probe_err.values()),
        "ms": probe_rows["mxu1"]["wall_s"] * 1e3,
        "plain_ms": probe_plain_ms, "bound_ms": probe_bound[0],
        "bound_by": probe_bound[1], "library_ms": probe_lib_ms,
    }, {
        "name": "lanczos_step", "route": "cuda", "source": STEP_SOURCE,
        "replaces": STEP_REPLACES, "launches": main_steps,
        "max_abs_err": step_err["5"], "ms": step_ms,
        "plain_ms": eager_step_ms, "bound_ms": step_bound_ms,
        "bound_by": step_bound_by, "library_ms": None,
    }, {
        "name": "lanczos_step_df", "route": "cuda", "source": STEP_SOURCE,
        "replaces": STEP_DF_REPLACES, "launches": df_steps,
        "max_abs_err": step_err["5c"], "ms": df_step_ms,
        "plain_ms": eager_df_step_ms, "bound_ms": df_step_bound_ms,
        "bound_by": df_step_bound_by, "library_ms": None,
    }] + shard_entries})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
