"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (sm_90a), nvcc and g++; imports nothing of
jax or of the JAX package.  Each phase prints one JSON line:

  0  toolchain: torch/CUDA versions, card, capability, nvcc, triton;
  1  build: the CUDA kernels (nvcc) and the native graph core (g++),
     from this checkout's sources, with their build seconds;
  2  the SpMV kernel against its plain PyTorch version on the card, on
     every level of four small packs and on whole SpMVs: exact equality;
  3  the main path at bench.py's size (Barabasi-Albert n=1M, m=10,
     seed 0, native generator; pack sub=512; k=50) through
     ``expm_action`` and ``expm_action_summary``, with the kernel launch
     count of that run and CUDA-event timings;
  4  accuracy of the f32 answer against the float64 numpy oracle.

Then the card's name and power limit (nvidia-smi), one JSON line of
per-kernel results, and last ``{"ok": true, "device": {...}}``.  Any
failure raises: the script exits nonzero and prints no final line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N, M, K, SEED, SUB, TOPK = 1_000_000, 10, 50, 0, 512, 20
REPS = 5
KERNEL_SOURCE = "tpu_lanczos_torch/kernels/csrc/spmv_cpg.cu"
KERNEL_REPLACES = "tpu_lanczos/kernels/spmv_cpg.py:85"


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
    x2d = x.reshape(cg.n_sub, 128)
    err = 0.0

    def one(inp, level, base):
        nonlocal err
        got = spmv_cpg.run_level(inp, level, C, sub, base=base)
        want = spmv_cpg.run_level_ref(inp, level, C, sub, base=base)
        check(torch.equal(got, want), f"level kernel == plain (sub={sub})")
        err = max(err, float((got - want).abs().max()))
        return got

    for level in cg.levels[:nb]:
        x2d = one(x2d, level, x2d)
    y2d = one(x2d, cg.levels[nb], None)
    for level in cg.levels[nb + 1:]:
        y2d = one(y2d, level, y2d)
    return err


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_lanczos_torch import CSRGraph, generators
    from tpu_lanczos_torch import expm_action, expm_action_summary
    from tpu_lanczos_torch.core.lanczos import lanczos
    from tpu_lanczos_torch.eval import oracle
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
    ptxas = [ln.strip() for ln in (_build.build_log or "").splitlines()
             if "registers" in ln]
    emit({"phase": 1, "nvcc_build_s": nvcc_s, "gxx_build_s": gxx_s,
          "ptxas": ptxas})

    # ---- 2: kernel == plain version on the card, small packs
    rng = np.random.default_rng(0)
    g40k = generators.barabasi_albert(40000, 6, seed=3)
    cases = [
        ("ba2000_m8_sub128", generators.barabasi_albert(2000, 8, seed=2),
         None),
        ("star3000", star_graph(CSRGraph), None),
        ("ba40000_m6_sub256", g40k, 256),
        ("ba40000_m6_sub512", g40k, 512),
    ]
    max_err = 0.0
    rows = []
    for name, g, sub in cases:
        cg = pack_cpg(g, sub=sub, device=dev)
        before = spmv_cpg.launches
        xr = rng.standard_normal(cg.n)
        x32 = torch.from_numpy(cg.permute_in(xr, np.float32)).to(dev)
        max_err = max(max_err, level_chain(torch, spmv_cpg, cg, x32))
        y = spmv_cpg.spmv_cpg(cg, x32)
        y_ref = spmv_cpg.spmv_cpg_ref(cg, x32)
        check(torch.equal(y, y_ref), f"{name}: spmv_cpg == plain (f32)")
        # the float64 instance against scipy (the reference's 1e-11 bar)
        x64 = torch.from_numpy(cg.permute_in(xr, np.float64)).to(dev)
        y64 = cg.permute_out(spmv_cpg.spmv_cpg(cg, x64))
        err64 = float(np.abs(y64 - g.to_scipy() @ xr).max())
        check(err64 < 1e-11 * max(1.0, float(np.abs(y64).max())),
              f"{name}: f64 kernel matches scipy ({err64})")
        torch.cuda.synchronize()
        n_launch = spmv_cpg.launches - before
        check(n_launch == 3 * len(cg.levels),
              f"{name}: kernel launched per level ({n_launch})")
        rows.append({"pack": name, "levels": len(cg.levels),
                     "tiles": list(cg.t_reals), "l2": str(
                         cg.levels[0]["l2"].dtype), "f64_err": err64})
    emit({"phase": 2, "equal": True, "max_abs_err": max_err, "packs": rows})

    # ---- 3: main path at bench.py's size
    t0 = time.time()
    g = generators.barabasi_albert(N, M, seed=SEED, use_native=True)
    gen_s = time.time() - t0
    t0 = time.time()
    dg = pack_cpg(g, sub=SUB, device=dev)
    torch.cuda.synchronize()
    pack_s = time.time() - t0
    x1 = dg.realmask.clone()
    level_err = level_chain(torch, spmv_cpg, dg, x1)
    y = spmv_cpg.spmv_cpg(dg, x1)
    check(torch.equal(y, spmv_cpg.spmv_cpg_ref(dg, x1)),
          "bn1M: spmv_cpg == plain")
    max_err = max(max_err, level_err)

    torch.cuda.synchronize()
    spmv_cpg.launches = 0
    res = expm_action(g, k=K, log_scale=True, dg=dg)
    summ = expm_action_summary(g, k=K, topk=TOPK, dg=dg)
    torch.cuda.synchronize()
    main_launches = spmv_cpg.launches
    check(main_launches == 2 * K * len(dg.levels),
          f"main path ran the kernel k*levels per Lanczos run "
          f"({main_launches} != 2*{K}*{len(dg.levels)})")
    check(res.ans.shape == (N,) and bool(np.all(np.isfinite(res.ans))),
          "expm_action answer finite, shape (n,)")
    check(np.isfinite(res.log_scale), "log_scale finite")
    check(summ.top_values.shape == (TOPK,)
          and bool(np.all(np.isfinite(summ.top_values)))
          and np.isfinite(summ.ans_norm), "summary finite")

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

    def query():
        expm_action_summary(g, k=K, topk=TOPK, dg=dg)

    query()
    query_s = []
    for _ in range(REPS):
        t0 = time.time()
        query()
        query_s.append(time.time() - t0)
    index_bytes = dg.index_bytes()
    emit({"phase": 3, "graph": f"ba_{N}_{M}_{SEED}_native", "nnz": g.nnz,
          "gen_s": gen_s, "pack_s": pack_s, "sub": SUB,
          "n_chunks": dg.n_chunks, "levels": len(dg.levels),
          "n_bcast": dg.n_bcast, "tiles": list(dg.t_reals),
          "index_bytes": index_bytes, "k": K,
          "main_launches": main_launches,
          "spmv_kernel_ms": spmv_ms, "spmv_kernel_samples": spmv_samples,
          "spmv_plain_ms": plain_ms, "spmv_plain_samples": plain_samples,
          "level_kernel_ms": level_ms,
          "index_GBps": index_bytes / (spmv_ms * 1e-3) / 1e9,
          "lanczos_k50_ms": lanczos_ms, "lanczos_samples": lanczos_samples,
          "lanczos_peak_bytes": peak_lanczos,
          "summary_query_s": float(np.median(query_s)),
          "summary_query_samples": query_s,
          "log_scale": res.log_scale, "top_nodes": summ.top_nodes.tolist()})

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

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "spmv_cpg_level", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": main_launches,
        "max_abs_err": max_err, "ms": spmv_ms, "plain_ms": plain_ms,
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
