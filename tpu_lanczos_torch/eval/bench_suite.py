"""Benchmark suite mirroring the reference's graph classes, on the GPU.

The port of ``tpu_lanczos/eval/bench_suite.py``.  The reference CUDA code
benchmarked nine graphs (BASELINE.md): power-law (Barabasi), social
(coPapers/LiveJournal), and mesh/road-class (adaptive, channel,
hugetrace, road_central, europe_osm).  Their data files are not
redistributable, so this suite *generates* class-matched stand-ins at
matched n/nnz scales and reports the same headline quantity: Lanczos
decomposition time at k=50, plus effective nnz/s and the share of the
H100's HBM rate that the SpMV's index traffic would need.

Every config is packed CPG with its own ``pack`` kwargs on every device
(the reference did so only on a TPU), so every row runs the CPG level
kernels (``kernels/csrc/spmv_cpg.cu``); before a row is timed, every
level of its pack is held against the plain version on the pack's device
(``check_levels``).  Lanczos is timed by CUDA events on a GPU (median of
``reps`` after one warm run), by the host clock on the CPU.

Run: ``python -m tpu_lanczos_torch.eval.bench_suite [--quick]
[--only NAME,...] [--k 50] [--no-acc] [--device cuda]``; each result is
one JSON line, a table at the end on stderr.  Graphs, packs and oracle
answers are cached under ``--cache`` (``.bench_cache`` in the working
directory).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import zipfile

import numpy as np
import torch

# (name, builder kwargs, reference analog + the reference CUDA code's
#  seconds on its RTX 2080 Super at k=50 and k=100 where it recorded
#  them: final_output1.txt:16-272 (k=50) and :289-480 (k=100))
CONFIGS = [
    dict(name="ba_1M_m10", kind="barabasi", n=1_000_000, m=10,
         analog="bn1000000e9999944", ref_s=0.4166, ref_s_k100=0.8096,
         pack=dict(sub=512, theta=150)),
    dict(name="uniform_1M_e10M", kind="uniform", n=1_000_000, e=10_000_000,
         analog=None, ref_s=None, pack=dict(sub=512, order="degree")),
    dict(name="stencil_1400", kind="stencil", side=1400,
         analog="mesh-class (California-adaptive scale)", ref_s=None),
    dict(name="stencil_2600", kind="stencil", side=2600,
         analog="adaptive n=6.8M nnz=27M", ref_s=1.2654, ref_s_k100=2.4555),
    dict(name="stencil_4000", kind="stencil", side=4000,
         analog="road_central n=14M nnz=34M / hugetrace n=16M nnz=48M",
         ref_s=2.9778),  # mean of road_central 2.7427 and hugetrace 3.2129
    dict(name="channel_3d", kind="stencil3d", nx=500, ny=100, nz=100,
         analog="channel-500x100x100-b050 n=4.8M nnz=85M (CFD mesh, "
                "uniform degree ~18)",
         ref_s=0.4809, ref_s_k100=1.8055),
    dict(name="copapers_540k", kind="clique", n=540_000, papers=1_240_000,
         analog="coPapersDBLP n=540K nnz=30M deg~56 — clique-union "
                "co-authorship with community locality, the graph class "
                "the reference actually benchmarked (its best GPU case)",
         ref_s=0.1200, ref_s_k100=0.3276, pack=dict(sub=128)),
    dict(name="rmat_540k_e15M", kind="rmat", n=540_000, e=15_250_000,
         analog="coPapersDBLP scale with R-MAT social-graph skew instead "
                "of clique locality (strictly harder layout stress case)",
         ref_s=0.1200, ref_s_k100=0.3276, pack=dict(sub=256, theta=300)),
    dict(name="rmat_4M_e35M", kind="rmat", n=4_000_000, e=34_700_000,
         analog="com-LiveJournal n=4.0M nnz=69M (social; R-MAT carries "
                "the real graph's skew + community structure)",
         ref_s=1.3245, ref_s_k100=2.5756, pack=dict(sub=512, theta=300)),
    dict(name="ba_4M_m9", kind="barabasi", n=4_000_000, m=9,
         analog="com-LiveJournal scale, pure preferential-attachment "
                "expander (no community structure: adversarial stress "
                "case, strictly harder than the real graph)",
         ref_s=1.3245, ref_s_k100=2.5756, pack=dict(sub=512, theta=200)),
]

# the H100 SXM's published HBM rate (700 W), as chip_smoke.py uses
HBM_BYTES_PER_S = 3.35e12

# per-row accuracy: up to this many nodes the f64 numpy oracle (cached per
# (config, k)) is the truth; beyond it the f32 answer is compared with
# the df64 pipeline on the same device, itself held to the oracle at 1M
# nodes (eval/accuracy_gpu.py, chip_smoke phases 4-5)
ORACLE_N_MAX = 2_000_000

_GEN_KEYS = ("kind", "n", "m", "e", "side", "nx", "ny", "nz", "papers")
# what a truncated or corrupt .npz raises on load
_BAD_CACHE = (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile)


def _gen_tag(cfg) -> str:
    return "_".join(f"{key}{cfg[key]}" for key in _GEN_KEYS if key in cfg)


def graph_cache_path(cfg, cache_dir: str = ".bench_cache") -> str:
    """Graph cache file: the key carries every generator parameter, so
    retuning a config's size under the same name cannot serve a stale
    graph."""
    return os.path.join(cache_dir, f"graph_{cfg['name']}_{_gen_tag(cfg)}.npz")


def oracle_cache_path(cfg, k: int, cache_dir: str) -> str:
    """Oracle-answer cache key: carries every generator parameter like
    the graph cache does."""
    return os.path.join(cache_dir,
                        f"oracle_{cfg['name']}_{_gen_tag(cfg)}_k{k}_s.npz")


def pack_cache_path(cfg, cache_dir: str = ".bench_cache") -> str:
    """Canonical pack-cache file for a suite config (the port's
    PACK_VERSION, equal to the reference's, so either package's packs
    load in the other)."""
    from tpu_lanczos_torch.kernels.cpg import PACK_VERSION

    pack_kw = cfg.get("pack") or {}
    tag = "".join(f"_{key}{val}" for key, val in sorted(pack_kw.items()))
    return os.path.join(
        cache_dir, f"suite_{cfg['name']}_cpg_v{PACK_VERSION}{tag}.npz")


def _save_atomic(path: str, save) -> None:
    """``save(tmp)`` then an atomic replace: an interrupted save must not
    leave a truncated .npz that poisons every later run."""
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    save(tmp)
    os.replace(tmp, path)


def save_pack_cache(dg, path: str, pack_s: float) -> None:
    """save_cpg with the uncached pack wall time stored beside it."""
    from tpu_lanczos_torch.kernels.cpg import save_cpg

    _save_atomic(path, lambda tmp: save_cpg(dg, tmp, pack_s=pack_s))


def _load_csr(path: str):
    from tpu_lanczos_torch.graphs.csr import CSRGraph

    with np.load(path) as z:
        return CSRGraph(indptr=z["indptr"], indices=z["indices"],
                        n=int(z["n"]))


def _save_csr(g, path: str) -> None:
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _save_atomic(path, lambda tmp: np.savez(
            tmp, indptr=g.indptr, indices=g.indices, n=g.n))
    except OSError as e:  # a read-only cache costs a regeneration only
        print(f"bench_suite: graph cache not written: {e}", file=sys.stderr)


def build(cfg, cache_dir: str = ".bench_cache"):
    """Generate the config's graph, cached as raw CSR: generation is
    deterministic per config (seed=0 throughout) and the 4M-node
    power-law graphs cost minutes to regenerate.  A truncated or corrupt
    cache file is regenerated and overwritten."""
    path = graph_cache_path(cfg, cache_dir)
    if os.path.exists(path):
        try:
            return _load_csr(path)
        except _BAD_CACHE:
            pass
    g = _generate(cfg)
    _save_csr(g, path)
    return g


def _generate(cfg):
    from tpu_lanczos_torch.graphs import generators

    if cfg["kind"] == "barabasi":
        return generators.barabasi_albert(cfg["n"], cfg["m"], seed=0)
    if cfg["kind"] == "uniform":
        return generators.uniform_random(cfg["n"], cfg["e"], seed=0,
                                         use_native=True)
    if cfg["kind"] == "stencil":
        return generators.stencil_2d(cfg["side"])
    if cfg["kind"] == "stencil3d":
        return generators.stencil_3d(cfg["nx"], cfg["ny"], cfg["nz"])
    if cfg["kind"] == "rmat":
        return generators.rmat(cfg["n"], cfg["e"], seed=0)
    if cfg["kind"] == "clique":
        return generators.clique_union(cfg["n"], cfg["papers"], seed=0)
    raise ValueError(cfg["kind"])


def load_graph(n: int = 1_000_000, m: int = 10, seed: int = 0,
               cache_dir: str = ".bench_cache"):
    """bench.py's flagship graph (Barabasi-Albert, native generator),
    cached under bench.py's file name ``ba_{n}_{m}_{seed}_native.npz``:
    the native RNG stream differs from numpy's, so the two are distinct
    graphs."""
    from tpu_lanczos_torch.graphs import generators

    path = os.path.join(cache_dir, f"ba_{n}_{m}_{seed}_native.npz")
    if os.path.exists(path):
        try:
            return _load_csr(path)
        except _BAD_CACHE:
            pass
    g = generators.barabasi_albert(n, m, seed=seed, use_native=True)
    _save_csr(g, path)
    return g


def _load_pack(path: str, device):
    """(pack, recorded pack seconds) from a cache file, or None."""
    from tpu_lanczos_torch.kernels.cpg import load_cpg

    if not os.path.exists(path):
        return None
    try:
        dg = load_cpg(path, device=device)
        with np.load(path) as z:
            pack_s = float(z["pack_s"]) if "pack_s" in z else -1.0
    except _BAD_CACHE:
        return None
    return dg, pack_s


def _pack_and_save(g, path: str, device, pack_kw: dict):
    from tpu_lanczos_torch.eval.profiling import wait
    from tpu_lanczos_torch.kernels.cpg import pack_cpg

    t0 = time.perf_counter()
    dg = pack_cpg(g, device=device, **pack_kw)
    wait(dg.realmask)
    pack_s = time.perf_counter() - t0
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_pack_cache(dg, path, pack_s)
    except OSError as e:
        print(f"bench_suite: pack cache not written: {e}", file=sys.stderr)
    return dg, pack_s


def load_or_pack(cfg, g, cache_dir: str = ".bench_cache", device="cuda"):
    """The config's CPG pack on ``device``, packed with its own ``pack``
    kwargs, from the pack cache when a readable one exists.  Returns
    (pack, pack seconds of the original uncached pack)."""
    path = pack_cache_path(cfg, cache_dir)
    got = _load_pack(path, device)
    if got is not None:
        return got
    return _pack_and_save(g, path, device, cfg.get("pack") or {})


def flagship_pack(g, n: int, m: int, seed: int,
                  cache_dir: str = ".bench_cache", device="cuda"):
    """bench.py's sub=512 pack of ``load_graph(n, m, seed)``, cached as
    ``cpg_{n}_{m}_{seed}_v{PACK_VERSION}_sub512.npz``.  Returns (pack,
    pack seconds)."""
    from tpu_lanczos_torch.kernels.cpg import PACK_VERSION

    path = os.path.join(
        cache_dir, f"cpg_{n}_{m}_{seed}_v{PACK_VERSION}_sub512.npz")
    got = _load_pack(path, device)
    if got is not None:
        return got
    return _pack_and_save(g, path, device, dict(sub=512))


def check_levels(dg, seed: int = 0) -> dict:
    """Hold every level of ``dg`` against its plain version on the pack's
    device, on the inputs one float32 SpMV and one df SpMV of a seeded
    random vector give each level: ``run_level`` must equal
    ``run_level_ref`` and ``run_level_comp`` ``run_level_comp_ref`` bit
    for bit (the df SpMV composed as the reference composes it), and
    ``run_level_df`` ``run_level_df_ref`` (the df SpMV as ``spmv_cpg_df``
    runs it, a level a call).  Raises RuntimeError at the first
    difference.  Returns the number of level calls checked, plain,
    compensated and df."""
    from tpu_lanczos_torch.core.lanczos_df import split_f64
    from tpu_lanczos_torch.kernels import spmv_cpg

    xr = np.random.default_rng(seed).standard_normal(dg.n)
    counts = {"plain": 0, "comp": 0, "df": 0}

    def plain(inp, level, n_chunks, sub, base=None, slab=False):
        got = spmv_cpg.run_level(inp, level, n_chunks, sub, base, slab)
        want = spmv_cpg.run_level_ref(inp, level, n_chunks, sub, base, slab)
        if not torch.equal(got, want):
            raise RuntimeError(
                f"level kernel != plain version (sub={sub}, "
                f"{dg.n_chunks} chunks, {inp.dtype})")
        counts["plain"] += 1
        return got

    def comp(inp, level, n_chunks, sub, slab=False):
        got = spmv_cpg.run_level_comp(inp, level, n_chunks, sub, slab)
        want = spmv_cpg.run_level_comp_ref(inp, level, n_chunks, sub, slab)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(
                f"compensated level kernel != plain version (sub={sub}, "
                f"{dg.n_chunks} chunks)")
        counts["comp"] += 1
        return got

    def df_level(x_hi, x_lo, level, n_chunks, sub, **kw):
        got = spmv_cpg.run_level_df(x_hi, x_lo, level, n_chunks, sub, **kw)
        want = spmv_cpg.run_level_df_ref(x_hi, x_lo, level, n_chunks, sub,
                                         **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(
                f"df level kernel != plain version (sub={sub}, "
                f"{dg.n_chunks} chunks, {kw['mode']})")
        counts["df"] += 1
        return got

    x = torch.from_numpy(dg.permute_in(xr, np.float32)).to(dg.device)
    spmv_cpg._spmv(dg, x, plain)
    hi, lo = (torch.from_numpy(t).to(dg.device)
              for t in split_f64(dg.permute_in(xr, np.float64)))
    spmv_cpg._spmv_df(dg, hi, lo, plain, comp)
    spmv_cpg._spmv_df_levels(dg, hi, lo, df_level)
    return counts


def oracle_answer(cfg, g, k: int, cache_dir: str):
    """The shifted f64 oracle answer (ans, shift), cached per (config,
    k): ref = e^{A-sI}.x with s returned apart, so a compare stays finite
    even where lambda_max > 709 and e^A.x itself overflows f64 (R-MAT
    hubs; the reference CUDA code's own double pipeline printed inf/nan
    in this regime, final_output1.txt:154-159)."""
    from tpu_lanczos_torch.eval import oracle

    path = oracle_cache_path(cfg, k, cache_dir)
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return z["ans"], float(z["shift"])
        except _BAD_CACHE:
            pass
    ref, shift = oracle.expm_action_shifted(g, np.ones(g.n), k)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        _save_atomic(path, lambda tmp: np.savez(tmp, ans=ref, shift=shift))
    except OSError as e:
        print(f"bench_suite: oracle cache not written: {e}", file=sys.stderr)
    return ref, shift


def _accuracy(cfg, g, dg, k, cache_dir):
    """Rel-norm-of-diff of the f32 answer for this row: the reference
    CUDA code committed one for every graph it benchmarked
    (final_output1.txt:31,63,95,127,223,255,287).  Returns (rel_err,
    err_ref, err_s).

    n <= ORACLE_N_MAX: the f32 two-pass answer against the f64 oracle
    (cached) on the oracle's shifted scale.  Larger: against the df64
    pipeline on the same device (a self-check)."""
    from tpu_lanczos_torch.core.lanczos_df import expm_action_df
    from tpu_lanczos_torch.core.pipeline import expm_action

    t0 = time.perf_counter()
    r32 = expm_action(g, None, k, dg=dg, low_mem=True, log_scale=True)
    a32 = r32.ans.astype(np.float64)
    s32 = float(r32.log_scale)
    if g.n <= ORACLE_N_MAX:
        ref, s_ref = oracle_answer(cfg, g, k, cache_dir)
        # rescale the f32 answer onto the oracle's shifted scale: the
        # exponent difference s32 - s_ref is O(roundoff in lambda_max),
        # so the factor is O(1) and finite by construction
        a = a32 * np.exp(s32 - s_ref)
        err = float(np.linalg.norm(a - ref) / np.linalg.norm(ref))
        return err, "oracle_f64", time.perf_counter() - t0
    rdf = expm_action_df(g, None, k, dg=dg, log_scale=True)
    a = a32 * np.exp(s32 - float(rdf.log_scale))  # common log-scale
    err = float(np.linalg.norm(a - rdf.ans) / np.linalg.norm(rdf.ans))
    return err, "df64_selfcheck", time.perf_counter() - t0


def run_one(cfg, k: int = 50, reps: int = 3, cache_dir: str = ".bench_cache",
            accuracy: bool = True, device="cuda") -> dict:
    """One suite row: build (cached), pack (cached), check every level
    against its plain version, time ``lanczos(dg, ones, k)``, then the
    accuracy column.  Prints the row as one JSON line and returns it."""
    from tpu_lanczos_torch.core.lanczos import lanczos
    from tpu_lanczos_torch.eval.cpg_variants import cuda_ms
    from tpu_lanczos_torch.eval.profiling import timed, wait

    os.makedirs(cache_dir, exist_ok=True)
    t0 = time.perf_counter()
    g = build(cfg, cache_dir)
    t_build = time.perf_counter() - t0
    dg, t_pack = load_or_pack(cfg, g, cache_dir, device)
    checked = check_levels(dg)
    x = dg.realmask.reshape(-1).to(torch.float32)  # the permuted ones

    def run():
        return lanczos(dg, x, k)

    t0 = time.perf_counter()
    alpha = run().alpha.cpu().numpy()
    t_first = time.perf_counter() - t0
    if not np.all(np.isfinite(alpha)):
        raise RuntimeError(f"{cfg['name']}: non-finite alpha")
    if dg.device.type == "cuda":
        t = cuda_ms(run, reps) / 1e3
        protocol = dict(timing="cuda_events", reps=reps)
    else:
        _, t = timed(run, reps=reps)
        protocol = dict(timing="host_wall", reps=reps)
    # one synchronized call, host wall (the reference's single-dispatch
    # protocol): the launches' host time shows here, not in the events
    singles = []
    for _ in range(2):
        wait(x)
        t0 = time.perf_counter()
        wait(run())
        singles.append(time.perf_counter() - t0)
    t_single = float(np.median(singles))

    # index-traffic roofline: the l1 + l2 bytes one SpMV reads (l2 is
    # int16 past sub=256, 2 B an element), k SpMVs at the HBM rate
    idx_bytes = sum(lv[key].numel() * lv[key].element_size()
                    for lv in dg.levels for key in ("l1", "l2"))
    tiles = int(dg.total_tiles)
    roofline_s = k * idx_bytes / HBM_BYTES_PER_S
    ref_key = "ref_s" if k == 50 else ("ref_s_k100" if k == 100 else None)
    ref_s = cfg.get(ref_key) if ref_key else None
    rel_err = err_ref = err_s = None
    if accuracy:
        try:
            rel_err, err_ref, err_s = _accuracy(cfg, g, dg, k, cache_dir)
        except Exception as e:  # accuracy is additive: keep the row
            traceback.print_exc()
            err_ref = f"failed: {type(e).__name__}: {e}"
    out = dict(
        name=cfg["name"], n=g.n, nnz=g.nnz, fmt=type(dg).__name__, k=k,
        device=(torch.cuda.get_device_name(dg.device)
                if dg.device.type == "cuda" else "cpu"),
        sub=dg.sub, levels=len(dg.levels), n_bcast=dg.n_bcast,
        n_chunks=dg.n_chunks,
        levels_checked=checked,
        build_s=t_build, pack_s=t_pack,
        compile_s=t_first, lanczos_s=t,
        lanczos_s_single=t_single, protocol=protocol,
        gnnz_per_s=g.nnz * k / t / 1e9,
        roofline_pct=100 * roofline_s / t,
        tiles=tiles, ns_per_tile=t * 1e9 / max(k * tiles, 1),
        rel_err=rel_err, err_ref=err_ref, err_s=err_s,
        analog=cfg.get("analog"), ref_s=ref_s,
        vs_ref=ref_s / t if ref_s else None,
    )
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="only the two smallest configs")
    ap.add_argument("--only", help="comma-separated config names")
    ap.add_argument("--k", type=int, default=50,
                    help="krylov dim (the reference recorded 50 and 100)")
    ap.add_argument("--no-acc", action="store_true",
                    help="skip the per-row accuracy column")
    ap.add_argument("--cache", default=".bench_cache")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from tpu_lanczos_torch.utils import enable_heap_reuse

    enable_heap_reuse()  # multi-GB pack temporaries fault their pages once
    configs = CONFIGS[:1] + CONFIGS[2:3] if args.quick else CONFIGS
    if args.only:
        names = set(args.only.split(","))
        configs = [c for c in CONFIGS if c["name"] in names]
    results = [run_one(c, k=args.k, cache_dir=args.cache,
                       accuracy=not args.no_acc, device=args.device)
               for c in configs]
    print(f"\n{'name':22} {'n':>10} {'nnz':>11} {'fmt':9} "
          f"{'lanczos_s':>9} {'Gnnz/s':>7} {'vs_ref':>7} {'rel_err':>9}",
          file=sys.stderr)
    for r in results:
        err = f"{r['rel_err']:.1e}" if r.get("rel_err") is not None else "-"
        vs = f"{r['vs_ref']:.2f}" if r["vs_ref"] else "-"
        print(f"{r['name']:22} {r['n']:>10} {r['nnz']:>11} {r['fmt']:9} "
              f"{r['lanczos_s']:>9.4f} {r['gnnz_per_s']:>7.2f} "
              f"{vs:>7} {err:>9}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
