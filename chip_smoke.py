"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (sm_90a), nvcc and g++; imports nothing of
jax or of the JAX package.  Each phase prints one JSON line:

  0  toolchain: torch/CUDA versions, card, capability, nvcc, triton;
  1  build: the CUDA kernels (nvcc) and the native graph core (g++),
     from this checkout's sources, with their build seconds;
  2  both SpMV kernels (plain and compensated) against their plain
     PyTorch versions on the card, on every level of four small packs
     and on whole SpMVs and df SpMVs: exact equality; the f64 and df64
     SpMVs against scipy;
  3  the main path at bench.py's size (Barabasi-Albert n=1M, m=10,
     seed 0, native generator; pack sub=512; k=50) through
     ``expm_action`` and ``expm_action_summary``, with the kernel launch
     count of that run and CUDA-event timings;
  4  accuracy of the f32 answer against the float64 numpy oracle;
  5  the two-pass paths on the same graph, pack and oracle answer: the
     f32 ``low_mem=True`` queries (alpha/beta bit-equal to stored-Q
     Lanczos, launch count, accuracy, top-20, peak memory) and the df64
     pipeline (``expm_action_df``, ``expm_action_ks_df``, the pass-1
     checkpoint), each with its launch counts, accuracy and timings.

Then the card's name and power limit (nvidia-smi), one JSON line of
per-kernel results, and last ``{"ok": true, "device": {...}}``.  Any
failure raises: the script exits nonzero and prints no final line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N, M, K, SEED, SUB, TOPK = 1_000_000, 10, 50, 0, 512, 20
REPS = 5
KERNEL_SOURCE = "tpu_lanczos_torch/kernels/csrc/spmv_cpg.cu"
KERNEL_REPLACES = "tpu_lanczos/kernels/spmv_cpg.py:85"
COMP_REPLACES = "tpu_lanczos/kernels/spmv_cpg.py:85 (compensated=True)"
KS = (10, 30, 50)
CKPT_CHUNK = 16


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


def df_level_chain(torch, spmv_cpg, cg, hi, lo):
    """Run one df SpMV with every level through the kernels and their
    plain versions on the same inputs (the inputs spmv_cpg_df gives each
    level).  Returns the max |kernel - plain| of the compensated levels
    (acc and err) and the df SpMV's (hi, lo)."""
    err = 0.0

    def plain(inp, level, n_chunks, sub, base=None):
        got = spmv_cpg.run_level(inp, level, n_chunks, sub, base=base)
        want = spmv_cpg.run_level_ref(inp, level, n_chunks, sub, base=base)
        check(torch.equal(got, want), f"df level kernel == plain (sub={sub})")
        return got

    def comp(inp, level, n_chunks, sub):
        nonlocal err
        got = spmv_cpg.run_level_comp(inp, level, n_chunks, sub)
        want = spmv_cpg.run_level_comp_ref(inp, level, n_chunks, sub)
        for g_t, w_t in zip(got, want):
            check(torch.equal(g_t, w_t),
                  f"compensated level kernel == plain (sub={sub})")
            err = max(err, float((g_t - w_t).abs().max()))
        return got

    return err, spmv_cpg._spmv_df(cg, hi, lo, plain, comp)


def split_dev(torch, cg, x64, dev):
    """A float64 host vector as a permuted (hi, lo) float32 pair on dev."""
    from tpu_lanczos_torch.core.lanczos_df import split_f64

    hi, lo = split_f64(cg.permute_in(x64, np.float64))
    return torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)


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
    comp_err = 0.0
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
        # df64: the compensated kernel == plain on every level, the df
        # SpMV == its plain version and, in float64, scipy's
        n_comp_levels = len(cg.levels) - cg.n_bcast
        before_comp = spmv_cpg.launches_comp
        hi, lo = split_dev(torch, cg, xr, dev)
        err_c, (yh, yl) = df_level_chain(torch, spmv_cpg, cg, hi, lo)
        comp_err = max(comp_err, err_c)
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
        torch.cuda.synchronize()
        n_comp = spmv_cpg.launches_comp - before_comp
        check(n_comp == 2 * n_comp_levels,
              f"{name}: compensated kernel launched per non-broadcast "
              f"level ({n_comp} != 2*{n_comp_levels})")
        rows.append({"pack": name, "levels": len(cg.levels),
                     "n_bcast": cg.n_bcast,
                     "tiles": list(cg.t_reals), "l2": str(
                         cg.levels[0]["l2"].dtype), "f64_err": err64,
                     "df64_rel_err": df_rel, "comp_launches": n_comp})
    emit({"phase": 2, "equal": True, "max_abs_err": max_err,
          "comp_max_abs_err": comp_err, "packs": rows})

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

    # ---- 5: the two-pass paths, same graph, pack and oracle answer
    L, nb = len(dg.levels), dg.n_bcast
    C = dg.n_chunks
    hi_r, lo_r = split_dev(torch, dg, rng.standard_normal(N), dev)
    err_c, _ = df_level_chain(torch, spmv_cpg, dg, hi_r, lo_r)
    comp_err = max(comp_err, err_c)

    def rel_to_oracle(r):
        return oracle.rel_error(r.ans * np.exp(r.log_scale - ref_shift), ref)

    # f32 two-pass: pass 1 regenerates stored-Q Lanczos bit for bit
    st = lanczos(dg, x1, K)
    a_lm, b_lm, xn_lm = lanczos_alphabeta(dg, x1, K)
    check(torch.equal(a_lm, st.alpha) and torch.equal(b_lm[:K - 1], st.beta)
          and torch.equal(xn_lm, st.x_norm),
          "lanczos_alphabeta == stored-Q lanczos (alpha, beta, x_norm)")
    del st, a_lm, b_lm, xn_lm
    torch.cuda.synchronize()
    spmv_cpg.launches = 0
    res_lm = expm_action(g, k=K, log_scale=True, dg=dg, low_mem=True)
    torch.cuda.synchronize()
    lm_launches = spmv_cpg.launches
    spmv_cpg.launches = 0
    summ_lm = expm_action_summary(g, k=K, topk=TOPK, dg=dg, low_mem=True)
    torch.cuda.synchronize()
    lm_summary_launches = spmv_cpg.launches
    for n_l, what in ((lm_launches, "expm_action"),
                      (lm_summary_launches, "expm_action_summary")):
        check(n_l == (2 * K - 1) * L,
              f"low_mem {what} ran (2k-1)*levels kernels ({n_l} != "
              f"(2*{K}-1)*{L})")
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

    def wall_s(fn, reps=REPS):
        fn()
        samples = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            samples.append(time.time() - t0)
        return float(np.median(samples)), samples

    lm_query_s, lm_query_samples = wall_s(lambda: expm_action_summary(
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
    torch.cuda.synchronize()
    spmv_cpg.launches = 0
    spmv_cpg.launches_comp = 0
    t0 = time.time()
    res_df = expm_action_df(g, k=K, dg=dg, log_scale=True)
    torch.cuda.synchronize()
    df_first_s = time.time() - t0
    df_plain_launches = spmv_cpg.launches
    df_comp_launches = spmv_cpg.launches_comp
    check(df_comp_launches == (2 * K - 1) * (L - nb),
          f"expm_action_df ran (2k-1)(L-n_bcast) compensated kernels "
          f"({df_comp_launches} != {(2 * K - 1) * (L - nb)})")
    check(df_plain_launches == (2 * K - 1) * (L + nb),
          f"expm_action_df ran (2k-1)(L+n_bcast) plain kernels "
          f"({df_plain_launches} != {(2 * K - 1) * (L + nb)})")
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
    df_spmv_ms, df_spmv_samples = cuda_ms(
        torch, lambda: spmv_cpg.spmv_cpg_df(dg, hi_r, lo_r))
    df_spmv_plain_ms, df_spmv_plain_samples = cuda_ms(
        torch, lambda: spmv_cpg.spmv_cpg_df_ref(dg, hi_r, lo_r))
    comp_ms, comp_samples = cuda_ms(
        torch, lambda: spmv_cpg.run_level_comp(x2d_r, main, C, SUB))
    comp_plain_ms, comp_plain_samples = cuda_ms(
        torch, lambda: spmv_cpg.run_level_comp_ref(x2d_r, main, C, SUB))
    level_main_ms = cuda_ms(
        torch, lambda: spmv_cpg.run_level(x2d_r, main, C, SUB))[0]
    x1_lo = torch.zeros_like(x1)
    ab_df_ms, ab_df_samples = cuda_ms(
        torch, lambda: lanczos_alphabeta_df(dg, x1, x1_lo, K), reps=3)
    df_query_s, df_query_samples = wall_s(lambda: expm_action_df(
        g, k=K, dg=dg, log_scale=True), reps=3)
    emit({"phase": 5, "part": "df64", "k": K, "levels": L, "n_bcast": nb,
          "launches_comp": df_comp_launches,
          "launches_plain": df_plain_launches, "rel_error": rel_df,
          "shift": res_df.log_scale, "oracle_shift": ref_shift,
          "top20_equal": top_df == top_ref, "ks": list(KS),
          "ks_diffs": {str(k): v for k, v in diffs.items()},
          "ks_vs_single": ks_rel, "checkpoint_equal": True,
          "comp_max_abs_err": comp_err,
          "df_spmv_ms": df_spmv_ms, "df_spmv_samples": df_spmv_samples,
          "df_spmv_plain_ms": df_spmv_plain_ms,
          "df_spmv_plain_samples": df_spmv_plain_samples,
          "comp_level_ms": comp_ms, "comp_level_samples": comp_samples,
          "comp_level_plain_ms": comp_plain_ms,
          "comp_level_plain_samples": comp_plain_samples,
          "plain_main_level_ms": level_main_ms,
          "alphabeta_df_k50_ms": ab_df_ms,
          "alphabeta_df_samples": ab_df_samples,
          "expm_action_df_first_s": df_first_s,
          "expm_action_df_s": df_query_s,
          "expm_action_df_samples": df_query_samples,
          "total_s": time.time() - t_all})

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "spmv_cpg_level", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": main_launches,
        "max_abs_err": max_err, "ms": spmv_ms, "plain_ms": plain_ms,
    }, {
        "name": "spmv_cpg_level_comp", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": COMP_REPLACES,
        "launches": df_comp_launches, "max_abs_err": comp_err,
        "ms": comp_ms, "plain_ms": comp_plain_ms,
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
