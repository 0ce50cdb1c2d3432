"""Time other versions of the CPG level kernel beside the package's own
on one CUDA GPU.

    python -m tpu_lanczos_torch.eval.cpg_variants \\
        [--n 1000000] [--m 10] [--seed 0] \\
        [--stencil SIDE | --suite NAME | --graph500 SCALE] \\
        [--sub 512] [--layout classic|slab] \\
        [--source NAME=PATH[,PATH...] ...]

Builds ``kernels/csrc/spmv_cpg.cu`` and ``spmv_cpg_shard.cu`` (as
"package") and each ``--source`` (one or more files with the same C
interfaces, built together: an earlier version of the kernels, for
example the parent commit's, from ``git archive``), each into its own
library.  On the graph (Barabasi-Albert, native generator; with
``--stencil`` the 5-point SIDE x SIDE mesh in its own order; with
``--suite`` a ``bench_suite`` config's graph and pack options; with
``--graph500`` the Graph500 Kronecker graph of 2^SCALE vertices,
edgefactor 16, from ``--seed``) packed at
``--sub`` (the suite config's own where not given, else 512) in
``--layout``, it prints one JSON line with each level's
per-chunk tile counts, then one line per build: its ptxas report, and
for each kernel the build has, equality with the package's kernel on
every level (plain in f32 and f64, and compensated; the df64 level of
the layout, ``run_level_df``'s C entry, on every level of one df SpMV),
CUDA-event medians of each level (``level_ms`` in f32, ``level_ms_f64``),
the whole SpMV and the compensated main level, the host's time to launch the main level (``host_us``), and
the df SpMV and its main level, the builds timed in turns (forward,
then backward).  A build with the staged classic walk
(``tlt_spmv_cpg_level_staged``, sub 256) also has it held against
the package's kernel and timed on every level (``staged_level_ms``,
``staged_level_ms_f64``), its
main level's launch (``staged_host_us``), and the SpMV as ``spmv_cpg``
routes it (``routed_spmv_ms``: ``spmv_cpg.staged_walk`` picks the walk of
each level).  Last, one line with
the device time by kernel of one ``lanczos`` run of ``--k`` steps
through the package's kernel (torch.profiler), its wall time and the
device's idle share.  Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tpu_lanczos_torch.kernels import _build

HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published HBM rate


def lib_path(name: str, prefix: str = "cpg") -> str:
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    return os.path.join(_build.BUILD_DIR, "variants",
                        f"lib{prefix}_{tag}.so")


def build(builds: dict, prefix: str = "cpg") -> dict:
    """``builds``: name -> source, or list of sources built into one
    library (which may include the package's csrc/ headers).  One nvcc per
    build, all at once, into ``lib_path(name, prefix)``; returns name ->
    ptxas report lines."""
    nvcc = _build.nvcc_path()
    os.makedirs(os.path.dirname(lib_path("x")), exist_ok=True)
    procs = {name: subprocess.Popen(
        [nvcc] + _build.NVCC_FLAGS + [
            "-I", _build.CSRC_DIR, "-shared", "-o", lib_path(name, prefix)]
        + ([src] if isinstance(src, str) else list(src)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for name, src in builds.items()}
    logs = {name: p.communicate(timeout=600)[1] for name, p in procs.items()}
    for name, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name][-4000:]}")
    return {name: [ln.split(":")[-1].strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in logs.items()}


def level_fns(name: str, slab: bool = False):
    """(plain level, compensated level, df64 level of the layout, staged
    classic level) of one build, with ``spmv_cpg.run_level``'s,
    ``run_level_comp``'s and ``run_level_df``'s signatures; None for a
    kernel the build lacks."""
    lib = _build.bind_cpg(ctypes.CDLL(lib_path(name)))
    staged_entry = getattr(lib, "tlt_spmv_cpg_level_staged", None)

    def staged(x2d, level, n_chunks, sub, base=None, slab=False):
        out = torch.empty_like(x2d)
        err = staged_entry(
            x2d.data_ptr(), level["l1"].data_ptr(), level["l2"].data_ptr(),
            level["s_ids"].data_ptr(), level["starts"].data_ptr(),
            level["counts"].data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(),
            n_chunks, sub, x2d.element_size(),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: staged launch failed: CUDA error "
                               f"{err}")
        return out

    def plain(x2d, level, n_chunks, sub, base=None, slab=False):
        out = torch.empty_like(x2d)
        err = lib.tlt_spmv_cpg_level(
            x2d.data_ptr(), level["l1"].data_ptr(), level["l2"].data_ptr(),
            level["s_ids"].data_ptr(), level["starts"].data_ptr(),
            level["counts"].data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(),
            n_chunks, sub, level["l2"].element_size(), x2d.element_size(),
            int(slab), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed: CUDA error {err}")
        return out

    def comp(x2d, level, n_chunks, sub, slab=False):
        out, e = torch.empty_like(x2d), torch.empty_like(x2d)
        err = lib.tlt_spmv_cpg_level_comp(
            x2d.data_ptr(), level["l1"].data_ptr(), level["l2"].data_ptr(),
            level["s_ids"].data_ptr(), level["starts"].data_ptr(),
            level["counts"].data_ptr(), out.data_ptr(), e.data_ptr(),
            n_chunks, sub, level["l2"].element_size(), int(slab),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: comp launch failed: CUDA error {err}")
        return out, e

    df_entry = getattr(lib, "tlt_spmv_cpg_slab_level_df" if slab
                       else "tlt_spmv_cpg_level_df", None)

    def df(x_hi, x_lo, level, n_chunks, sub, mode="main", finish=False,
           mask=None, slab=False):
        from tpu_lanczos_torch.kernels.spmv_cpg import _DF_MODES

        a, b = torch.empty_like(x_hi), torch.empty_like(x_hi)
        err = df_entry(
            x_hi.data_ptr(), x_lo.data_ptr(), level["l1"].data_ptr(),
            level["l2"].data_ptr(), level["s_ids"].data_ptr(),
            level["starts"].data_ptr(), level["counts"].data_ptr(),
            None if mask is None else mask.data_ptr(), a.data_ptr(),
            b.data_ptr(), n_chunks, sub, level["l2"].element_size(),
            _DF_MODES[mode], int(finish),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: df launch failed: CUDA error {err}")
        return a, b

    has = hasattr(lib, "tlt_spmv_cpg_level")
    return (plain if has else None, comp if has else None,
            df if df_entry is not None else None,
            staged if staged_entry is not None and not slab else None)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn in ms, after one warm run."""
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
    return float(np.median(samples))


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of fn takes to return, over ``calls``
    calls enqueued back to back with no sync between them (the card
    works behind them; its queue holds far more launches)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def chunk_counts(cg) -> list:
    """Per level: real tiles and the min / median / max of the per-chunk
    tile counts, with the number of chunks that have any."""
    rows = []
    for i, level in enumerate(cg.levels):
        c = level["counts"].cpu().numpy()
        rows.append({"level": i, "tiles": int(cg.t_reals[i]),
                     "min": int(c.min()), "median": float(np.median(c)),
                     "max": int(c.max()), "chunks_nonzero": int((c > 0).sum()),
                     "chunks": int(c.size)})
    return rows


def lanczos_profile(cg, k: int) -> dict:
    """Device time by kernel (name up to its template arguments) of one
    ``lanczos(cg, realmask, k)`` after a warm run, the wall time of the
    profiled run, the union of kernel intervals and the idle share."""
    from torch.autograd import DeviceType

    from tpu_lanczos_torch.core.lanczos import lanczos

    x1 = cg.realmask.clone()
    lanczos(cg, x1, k)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        lanczos(cg, x1, k)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    by_name, busy_us, reach = {}, 0.0, float("-inf")
    for start, end, name in spans:
        name = name.replace("(anonymous namespace)::", "")
        name = name[5:] if name.startswith("void ") else name
        key = name.split("<")[0].split("(")[0].split("::")[-1][:60]
        row = by_name.setdefault(key, {"ms": 0.0, "count": 0})
        row["ms"] += (end - start) / 1e3
        row["count"] += 1
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return {"lanczos_k": k, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / wall_ms,
            "kernels": dict(sorted(by_name.items(),
                                   key=lambda kv: -kv[1]["ms"]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stencil", type=int, default=0)
    ap.add_argument("--suite", default="")
    ap.add_argument("--graph500", type=int, default=0, metavar="SCALE")
    ap.add_argument("--sub", type=int, default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--layout", choices=("classic", "slab"),
                    default="classic")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cpg_variants needs a CUDA GPU")
    from tpu_lanczos_torch import generators
    from tpu_lanczos_torch.kernels import spmv_cpg
    from tpu_lanczos_torch.kernels.cpg import LANE, pack_cpg

    builds = {"package": _build.SOURCES[:2]}  # spmv_cpg.cu, _shard.cu
    for item in args.source:
        name, paths = item.split("=", 1)
        builds[name] = [os.path.abspath(p) for p in paths.split(",")]
    ptxas = build(builds)
    slab = args.layout == "slab"
    fns = {name: level_fns(name, slab) for name in builds}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    pack_kw = {"sub": 512}
    if args.suite:
        from tpu_lanczos_torch.eval import bench_suite

        cfg = next(c for c in bench_suite.CONFIGS if c["name"] == args.suite)
        graph = f"bench_suite {args.suite}"
        g = bench_suite._generate(cfg)
        pack_kw = dict(cfg.get("pack") or {})
    elif args.graph500:
        graph = f"graph500({args.graph500}, 16, seed={args.seed})"
        g = generators.graph500(args.graph500, seed=args.seed)
    elif args.stencil:
        graph = f"stencil_2d({args.stencil})"
        g = generators.stencil_2d(args.stencil)
    else:
        graph = f"ba({args.n}, {args.m}, seed={args.seed}, native)"
        g = generators.barabasi_albert(args.n, args.m, seed=args.seed,
                                       use_native=True)
    if args.sub is not None:
        pack_kw["sub"] = args.sub
    cg = pack_cpg(g, layout=args.layout, device="cuda", **pack_kw)
    C, sub, nb = cg.n_chunks, cg.sub, cg.n_bcast
    print(json.dumps({"nvidia_smi": smi, "graph": graph, "n": g.n,
                      "sub": sub, "layout": cg.layout, "n_chunks": C,
                      "n_bcast": nb, "index_bytes": cg.index_bytes(),
                      "counts": chunk_counts(cg)}), flush=True)

    # each level's input and base as spmv_cpg gives them, x = realmask,
    # in float32 and float64
    inputs = []
    for dtype in (torch.float32, torch.float64):
        x2d = cg.realmask.to(dtype).reshape(cg.n_sub, LANE)
        for i, level in enumerate(cg.levels):
            base = None if i == nb else x2d
            inputs.append((x2d, level, base))
            x2d = spmv_cpg.run_level(x2d, level, C, sub, base=base,
                                     slab=slab)
    rng = np.random.default_rng(1)
    xr = torch.from_numpy(cg.permute_in(rng.standard_normal(cg.n),
                                        np.float32)).cuda()
    main_in = xr.reshape(cg.n_sub, LANE)
    want = [spmv_cpg.run_level(xi, lv, C, sub, base=b, slab=slab)
            for xi, lv, b in inputs]
    # the compensated level on every level, fed the random f32 vector
    want_comp = [spmv_cpg.run_level_comp(main_in, lv, C, sub, slab=slab)
                 for lv in cg.levels]
    plain_equal = all(torch.equal(spmv_cpg.run_level_ref(
        xi, lv, C, sub, base=b, slab=slab), w)
        for (xi, lv, b), w in zip(inputs, want))
    plain_equal = plain_equal and all(
        torch.equal(a, b) for lv, wc in zip(cg.levels, want_comp)
        for a, b in zip(spmv_cpg.run_level_comp_ref(main_in, lv, C, sub,
                                                    slab=slab), wc))
    print(json.dumps({"package_kernel_equals_plain_version": plain_equal}),
          flush=True)
    # every df64 level's inputs as spmv_cpg_df gives them (hi, lo: the
    # random vector split), and the package kernel's outputs
    from tpu_lanczos_torch.core.lanczos_df import split_f64

    hi, lo = (torch.from_numpy(t).cuda() for t in split_f64(
        cg.permute_in(rng.standard_normal(cg.n), np.float64)))
    df_calls = []

    def record(*a, **kw):
        df_calls.append((a, kw, spmv_cpg.run_level_df(*a, **kw)))
        return df_calls[-1][2]

    spmv_cpg._spmv_df_levels(cg, hi, lo, record)

    rows = {}
    for name, (plain, comp, df, staged) in fns.items():
        row = rows[name] = {"build": name, "source": builds[name],
                            "ptxas": ptxas[name]}
        if plain is not None:
            row["equal"] = all(
                torch.equal(plain(xi, lv, C, sub, base=b, slab=slab), w)
                for (xi, lv, b), w in zip(inputs, want))
            row["equal_comp"] = all(
                torch.equal(a, b) for lv, wc in zip(cg.levels, want_comp)
                for a, b in zip(comp(main_in, lv, C, sub, slab=slab), wc))
            row.update(level_ms=[], level_ms_f64=[], spmv_ms=[],
                       comp_main_ms=[], host_us=[])
        if df is not None:
            row["equal_df"] = all(
                torch.equal(g.view(torch.int32), w.view(torch.int32))
                for a, kw, out in df_calls for g, w in zip(df(*a, **kw),
                                                           out))
            row.update(df_spmv_ms=[], df_main_ms=[])
        if staged is not None and sub == spmv_cpg.STAGED_SUB:
            row["equal_staged"] = all(
                torch.equal(staged(xi, lv, C, sub, base=b), w)
                for (xi, lv, b), w in zip(inputs, want))
            row["staged_route"] = [spmv_cpg.staged_walk(lv, sub)
                                   for lv in cg.levels]
            row.update(staged_level_ms=[], staged_level_ms_f64=[],
                       routed_spmv_ms=[], staged_host_us=[])
    x1 = cg.realmask.clone()
    f32_inputs = inputs[:len(cg.levels)]

    def time_levels(row, fn, key):
        # each level's median, f32 under ``key``, f64 under key + "_f64"
        ms = [cuda_ms(lambda: fn(xi, lv, b), args.reps)
              for xi, lv, b in inputs]
        row[key].append(ms[:len(cg.levels)])
        row[key + "_f64"].append(ms[len(cg.levels):])

    order = list(fns) + list(fns)[::-1]
    for name in order:
        plain, comp, df, staged = fns[name]
        row = rows[name]
        if plain is not None:
            time_levels(row, lambda xi, lv, b: plain(
                xi, lv, C, sub, base=b, slab=slab), "level_ms")
            row["spmv_ms"].append(cuda_ms(
                lambda: spmv_cpg._spmv(cg, x1, plain), args.reps))
            row["comp_main_ms"].append(cuda_ms(
                lambda: comp(main_in, cg.levels[nb], C, sub, slab=slab),
                args.reps))
            xi, lv, b = f32_inputs[nb]
            row["host_us"].append(host_us(
                lambda: plain(xi, lv, C, sub, base=b, slab=slab)))
        if "staged_level_ms" in row:
            time_levels(row, lambda xi, lv, b: staged(
                xi, lv, C, sub, base=b), "staged_level_ms")

            def routed(xi, lv, n_chunks, sub, base=None, slab=False):
                walk = staged if spmv_cpg.staged_walk(lv, sub) else plain
                return walk(xi, lv, n_chunks, sub, base=base)

            row["routed_spmv_ms"].append(cuda_ms(
                lambda: spmv_cpg._spmv(cg, x1, routed), args.reps))
            xi, lv, b = f32_inputs[nb]
            row["staged_host_us"].append(host_us(
                lambda: staged(xi, lv, C, sub, base=b)))
        if df is not None:
            row["df_spmv_ms"].append(cuda_ms(
                lambda: spmv_cpg._spmv_df_levels(cg, hi, lo, df), args.reps))
            a, kw, _ = df_calls[nb]
            row["df_main_ms"].append(cuda_ms(lambda: df(*a, **kw),
                                             args.reps))
    for row in rows.values():
        if "level_ms" in row:
            for key in ("level_ms", "level_ms_f64"):
                row[key + "_median"] = np.median(row[key], axis=0).tolist()
            row["spmv_ms_median"] = float(np.median(row["spmv_ms"]))
            row["comp_main_ms_median"] = float(np.median(
                row["comp_main_ms"]))
            row["host_us_median"] = float(np.median(row["host_us"]))
            row["index_GBps"] = (cg.index_bytes() / row["spmv_ms_median"]
                                 / 1e6)
        if "staged_level_ms" in row:
            for key in ("staged_level_ms", "staged_level_ms_f64"):
                row[key + "_median"] = np.median(row[key], axis=0).tolist()
            row["routed_spmv_ms_median"] = float(np.median(
                row["routed_spmv_ms"]))
            row["staged_host_us_median"] = float(np.median(
                row["staged_host_us"]))
        if "df_spmv_ms" in row:
            row["df_spmv_ms_median"] = float(np.median(row["df_spmv_ms"]))
            row["df_main_ms_median"] = float(np.median(row["df_main_ms"]))
        print(json.dumps(row), flush=True)
    print(json.dumps(lanczos_profile(cg, args.k)), flush=True)
    return 0 if plain_equal and all(
        row.get(k, True) for row in rows.values()
        for k in ("equal", "equal_comp", "equal_df", "equal_staged")) else 1


if __name__ == "__main__":
    sys.exit(main())
