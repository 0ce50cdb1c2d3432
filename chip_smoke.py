"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (sm_90a), nvcc and g++; imports nothing of
jax or of the JAX package.  Each phase prints one JSON line:

  0  toolchain: torch/CUDA versions, card, capability, nvcc, triton;
  1  build: the CUDA kernels (nvcc) and the native graph core (g++),
     from this checkout's sources, with their build seconds;
  2  the SpMV kernels (plain and compensated, classic and slab layout)
     against their plain PyTorch versions on the card, on every level of
     small classic and slab packs and on whole SpMVs and df SpMVs: exact
     equality; the f64 and df64 SpMVs against scipy;
  3  the main path at bench.py's size (Barabasi-Albert n=1M, m=10,
     seed 0, native generator; pack sub=512; k=50) through
     ``expm_action`` and ``expm_action_summary`` (host and device
     eigensolve), with the kernel launch count of that run, CUDA-event
     timings, the cuSPARSE SpMV time beside the kernel's, and the host
     syncs of each summary path;
  4  accuracy of the f32 answer against the float64 numpy oracle;
  5  the two-pass paths on the same graph, pack and oracle answer: the
     f32 ``low_mem=True`` queries (alpha/beta bit-equal to stored-Q
     Lanczos, launch count, accuracy, top-20, peak memory) and the df64
     pipeline (``expm_action_df``, ``expm_action_ks_df``, the pass-1
     checkpoint), each with its launch counts, accuracy and timings;
  6  the slab layout on the same graph: its pack beside the classic one,
     the slab kernels == plain on every level, ``expm_action`` and
     ``expm_action_df`` on the slab pack (launch counts, accuracy, top-20)
     and the slab SpMV, main level and Lanczos timed beside the classic;
  7  the CLI (``tpu_lanczos_torch.cli.main.main``) in process: the
     full-width slab --topk query with the device and the host
     eigensolve, and each single-device mode on a small graph against
     the serial oracle.

Then the card's name and power limit (nvidia-smi), one JSON line of
per-kernel results (with each kernel's bound: the larger of its bytes
over the HBM rate and its adds over the float32 rate), and last
``{"ok": true, "device": {...}}``.  Any
failure raises: the script exits nonzero and prints no final line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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
SLAB_REPLACES = "tpu_lanczos/kernels/spmv_cpg.py:85 (slab=True, :184-205)"
COMP_SLAB_REPLACES = ("tpu_lanczos/kernels/spmv_cpg.py:85 (compensated=True,"
                      " slab=True)")
KS = (10, 30, 50)
CKPT_CHUNK = 16
# the H100 SXM's published peaks (700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
COUNTERS = ("launches", "launches_slab", "launches_comp",
            "launches_comp_slab")
CLI_SMALL = ["-b", "4", "-n", "20000", "-k", "50"]


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


def reset_counts(spmv_cpg) -> None:
    for c in COUNTERS:
        setattr(spmv_cpg, c, 0)


def read_counts(torch, spmv_cpg) -> dict:
    torch.cuda.synchronize()
    return {c: getattr(spmv_cpg, c) for c in COUNTERS}


def check_counts(counts: dict, want: dict, what: str) -> None:
    """Exactly ``want`` launches of each named counter, none of the rest."""
    full = {c: want.get(c, 0) for c in COUNTERS}
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


def bound(nbytes: float, adds: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    adds over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = adds / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spmv_cost(cg, value_bytes: int = 4):
    """(bytes, adds) of one whole SpMV: every level, the realmask read
    and the masked y written."""
    nbytes, adds = 0, 0
    for i in range(len(cg.levels)):
        b, a = level_cost(cg, i, value_bytes, 1, i != cg.n_bcast)
        nbytes, adds = nbytes + b, adds + a
    return nbytes + cg.n_pad * (4 + value_bytes), adds + cg.n_pad


def ptxas_report(log: str) -> list:
    """One entry per compiled kernel: its mangled name, whether it is a
    slab-layout instantiation (template bool kSlab = true, mangled
    ``ILb1E``) and ptxas's register line."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "registers" in ln and name is not None:
            out.append({"kernel": name, "slab": "ILb1E" in name,
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
    """Run one df SpMV with every level through the kernels and their
    plain versions on the same inputs (the inputs spmv_cpg_df gives each
    level).  Returns the max |kernel - plain| of the compensated levels
    (acc and err) and the df SpMV's (hi, lo)."""
    err = 0.0

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
    ptxas = ptxas_report(_build.build_log or "")
    emit({"phase": 1, "nvcc_build_s": nvcc_s, "gxx_build_s": gxx_s,
          "ptxas": ptxas})
    check(sum(k["slab"] for k in ptxas) == 3,
          "three slab instantiations built (plain f32, f64; compensated)")

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
    rows = []
    for name, g, sub, layout in cases:
        cg = pack_cpg(g, sub=sub, layout=layout, device=dev)
        check(cg.layout == layout, f"{name}: pack layout {cg.layout}")
        slab = layout == "slab"
        plain_c = "launches_slab" if slab else "launches"
        comp_c = "launches_comp_slab" if slab else "launches_comp"
        L, nb = len(cg.levels), cg.n_bcast
        reset_counts(spmv_cpg)
        xr = rng.standard_normal(cg.n)
        x32 = torch.from_numpy(cg.permute_in(xr, np.float32)).to(dev)
        max_err[layout] = max(max_err[layout],
                              level_chain(torch, spmv_cpg, cg, x32))
        y = spmv_cpg.spmv_cpg(cg, x32)
        y_ref = spmv_cpg.spmv_cpg_ref(cg, x32)
        check(torch.equal(y, y_ref), f"{name}: spmv_cpg == plain (f32)")
        # the float64 instance against scipy (the reference's 1e-11 bar)
        x64 = torch.from_numpy(cg.permute_in(xr, np.float64)).to(dev)
        y64 = cg.permute_out(spmv_cpg.spmv_cpg(cg, x64))
        err64 = float(np.abs(y64 - g.to_scipy() @ xr).max())
        check(err64 < 1e-11 * max(1.0, float(np.abs(y64).max())),
              f"{name}: f64 kernel matches scipy ({err64})")
        check_counts(read_counts(torch, spmv_cpg), {plain_c: 3 * L},
                     f"{name}: f32 levels, f32 and f64 SpMV")
        # df64: the compensated kernel == plain on every level, the df
        # SpMV == its plain version and, in float64, scipy's
        reset_counts(spmv_cpg)
        hi, lo = split_dev(torch, cg, xr, dev)
        err_c, (yh, yl) = df_level_chain(torch, spmv_cpg, cg, hi, lo)
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
        counts = read_counts(torch, spmv_cpg)
        check_counts(counts, {comp_c: 2 * (L - nb),
                              plain_c: 2 * (L + nb)},
                     f"{name}: two df SpMVs")
        rows.append({"pack": name, "layout": layout, "sub": cg.sub,
                     "levels": L, "n_bcast": nb, "tiles": list(cg.t_reals),
                     "l2": str(cg.levels[0]["l2"].dtype), "f64_err": err64,
                     "df64_rel_err": df_rel, "df_launches": counts})
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
    max_err["classic"] = max(max_err["classic"], level_err)

    # the main path: expm_action, and the top-20 query with the host and
    # with the device eigensolve
    reset_counts(spmv_cpg)
    res = expm_action(g, k=K, log_scale=True, dg=dg)
    summ = expm_action_summary(g, k=K, topk=TOPK, dg=dg)
    summ_dev = expm_action_summary(g, k=K, topk=TOPK, dg=dg,
                                   eig_impl="device")
    counts = read_counts(torch, spmv_cpg)
    main_launches = counts["launches"]
    check_counts(counts, {"launches": 3 * K * len(dg.levels)},
                 "main path: k*levels per Lanczos run, three runs")
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

    def syncs(fn) -> int:
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

    sync_host = syncs(lambda: expm_action_summary(g, k=K, topk=TOPK, dg=dg))
    sync_dev = syncs(lambda: expm_action_summary(
        g, k=K, topk=TOPK, dg=dg, eig_impl="device"))
    sync_eigh = syncs(lambda: torch.linalg.eigh(torch.eye(
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

    query_med, query_s = wall_s(lambda: expm_action_summary(
        g, k=K, topk=TOPK, dg=dg))
    query_dev_med, query_dev_s = wall_s(lambda: expm_action_summary(
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
    reset_counts(spmv_cpg)
    res_lm = expm_action(g, k=K, log_scale=True, dg=dg, low_mem=True)
    counts = read_counts(torch, spmv_cpg)
    lm_launches = counts["launches"]
    check_counts(counts, {"launches": (2 * K - 1) * L},
                 "low_mem expm_action: (2k-1)*levels")
    reset_counts(spmv_cpg)
    summ_lm = expm_action_summary(g, k=K, topk=TOPK, dg=dg, low_mem=True)
    counts = read_counts(torch, spmv_cpg)
    lm_summary_launches = counts["launches"]
    check_counts(counts, {"launches": (2 * K - 1) * L},
                 "low_mem expm_action_summary: (2k-1)*levels")
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
    reset_counts(spmv_cpg)
    t0 = time.time()
    res_df = expm_action_df(g, k=K, dg=dg, log_scale=True)
    torch.cuda.synchronize()
    df_first_s = time.time() - t0
    counts = read_counts(torch, spmv_cpg)
    df_plain_launches = counts["launches"]
    df_comp_launches = counts["launches_comp"]
    check_counts(counts, {"launches_comp": (2 * K - 1) * (L - nb),
                          "launches": (2 * K - 1) * (L + nb)},
                 "expm_action_df: (2k-1)(L-n_bcast) compensated and "
                 "(2k-1)(L+n_bcast) plain")
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
          "comp_max_abs_err": comp_err["classic"],
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
    err_cs, _ = df_level_chain(torch, spmv_cpg, ds, hi_s, lo_s)
    comp_err["slab"] = max(comp_err["slab"], err_cs)

    reset_counts(spmv_cpg)
    res_s = expm_action(g, k=K, log_scale=True, dg=ds)
    counts = read_counts(torch, spmv_cpg)
    slab_launches = counts["launches_slab"]
    check_counts(counts, {"launches_slab": K * Ls},
                 "expm_action on the slab pack: k*levels slab launches")
    rel_s = rel_to_oracle(res_s)
    top_s = set(np.argsort(res_s.ans)[-TOPK:].tolist())
    check(rel_s < 1e-4, f"slab f32 rel_error {rel_s} < 1e-4")
    check(top_s == top_ref, "slab top-20 nodes equal the oracle's")
    reset_counts(spmv_cpg)
    res_sdf = expm_action_df(g, k=K, dg=ds, log_scale=True)
    counts = read_counts(torch, spmv_cpg)
    comp_slab_launches = counts["launches_comp_slab"]
    check_counts(counts, {"launches_comp_slab": (2 * K - 1) * (Ls - nbs),
                          "launches_slab": (2 * K - 1) * (Ls + nbs)},
                 "expm_action_df on the slab pack")
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
    hs2d = hi_s.reshape(ds.n_sub, 128)
    comp_slab_ms = cuda_ms(torch, lambda: spmv_cpg.run_level_comp(
        hs2d, main_s, ds.n_chunks, SUB, slab=True))[0]
    comp_slab_plain_ms = cuda_ms(torch, lambda: spmv_cpg.run_level_comp_ref(
        hs2d, main_s, ds.n_chunks, SUB, slab=True))[0]
    lanczos_slab_ms, lanczos_slab_samples = cuda_ms(
        torch, lambda: lanczos(ds, x1s, K))
    lanczos_classic_ms = cuda_ms(torch, lambda: lanczos(dg, x1, K))[0]
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
          "launches_df": {"comp_slab": comp_slab_launches,
                          "slab": (2 * K - 1) * (Ls + nbs)},
          "rel_error": rel_s, "df64_rel_error": rel_sdf,
          "top20_equal": top_s == top_ref, "df64_top20_equal":
          top_sdf == top_ref, "max_abs_err": max_err["slab"],
          "comp_max_abs_err": comp_err["slab"], **turns,
          "spmv_slab_ms": slab_spmv_ms, "spmv_slab_plain_ms": slab_plain_ms,
          "main_level_ms": main_level_ms,
          "comp_slab_main_level_ms": comp_slab_ms,
          "comp_slab_main_level_plain_ms": comp_slab_plain_ms,
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
    del ds, x1s, hi_s, lo_s, x2d_s, hs2d, main_s

    # ---- 7: the CLI, in process, its output parsed
    from tpu_lanczos_torch.cli import main as cli
    from tpu_lanczos_torch.kernels import cpg as cpg_mod

    def run_cli(argv):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        return rc, out.getvalue(), err.getvalue(), time.time() - t0

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
            reset_counts(spmv_cpg)
            rc, out, err, secs = run_cli(full + ["--eig", eig])
            counts = read_counts(torch, spmv_cpg)
            check(rc == 0, f"CLI --eig {eig}: rc {rc}: {err[-2000:]}")
            check(len(packs) == 1 and packs[0].layout == "slab",
                  f"CLI --eig {eig} built one slab pack")
            n_lv = len(packs[0].levels)
            check_counts(counts, {"launches_slab": K * n_lv},
                         f"CLI --eig {eig}: k*levels slab launches")
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
        reset_counts(spmv_cpg)
        rc, out, err, secs = run_cli(CLI_SMALL + extra)
        counts = read_counts(torch, spmv_cpg)
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
    check(cli_small["df64_slab"]["launches"]["launches_comp_slab"] > 0,
          "CLI df64 slab ran the compensated slab kernel")
    rc_shards = run_cli(CLI_SMALL + ["--shards", "2"])[0]
    check(rc_shards == 2, f"CLI --shards 2 exits 2 (rc {rc_shards})")
    emit({"phase": 7, "full_width": cli_full, "small": cli_small,
          "shards_rc": rc_shards, "total_s": time.time() - t_all})

    comp_bound = bound(*level_cost(dg, nb, 4, 2, False, adds_per_entry=7))
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "spmv_cpg_level", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": main_launches,
        "max_abs_err": max_err["classic"], "ms": spmv_ms,
        "plain_ms": plain_ms, "bound_ms": spmv_bound_ms,
        "bound_by": spmv_bound_by, "library_ms": csr_ms,
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
        "library_ms": csr_ms,
    }, {
        "name": "spmv_cpg_level_comp_slab", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": COMP_SLAB_REPLACES,
        "launches": comp_slab_launches, "max_abs_err": comp_err["slab"],
        "ms": comp_slab_ms, "plain_ms": comp_slab_plain_ms,
        "bound_ms": comp_slab_bound[0], "bound_by": comp_slab_bound[1],
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
