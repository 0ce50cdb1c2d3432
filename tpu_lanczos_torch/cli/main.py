"""CLI driver of the PyTorch port, with the reference's flag surface and
output shape.

    python -m tpu_lanczos_torch.cli.main -b 10 -n 1000000 -k 50 --topk 20
    python -m tpu_lanczos_torch.cli.main -n 2000 -e 6000 --device cpu -v

The port of ``tpu_lanczos/cli/main.py``: the same parser, flag for flag,
and every single-device branch.  The "serial" pipeline is the numpy/scipy
oracle and the "device" pipeline is the port's, on the CUDA GPU by
default (``--device cuda``; the hand-written CUDA kernels) or, on
request, on the CPU (``--device cpu``; their plain PyTorch versions).
Without a GPU and without ``--device cpu`` the CLI exits with an error;
it never falls back to the CPU by itself.  ``--device`` takes the place
of the reference's ``--platform``.

``--shards N`` row-shards the query over a mesh of N devices
(``tpu_lanczos_torch.dist``): N GPUs with ``--device cuda`` (short of
them it fails with the reference's "need N devices, have M"), N CPU
shards with ``--device cpu``; e^A.x in f32/f64 or df64, and the
stochastic estimators.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_lanczos_torch",
        description="e^A.x graph centrality via Lanczos on a CUDA GPU "
                    "(PyTorch port of tpu_lanczos)",
    )
    p.add_argument("-f", "--file", help=".mtx adjacency file")
    p.add_argument("-k", "--krylov", type=int, default=50, help="Krylov dim")
    p.add_argument("-n", type=int, default=10000, help="nodes (generated)")
    p.add_argument("-e", "--edges", type=int, default=30000,
                   help="edges for uniform-random generation")
    p.add_argument("-b", "--barabasi", type=int, default=None, metavar="DEG",
                   help="generate Barabasi-Albert with this degree instead")
    p.add_argument("--graph500", type=int, default=None, metavar="SCALE",
                   help="generate the Graph500 Kronecker graph of 2^SCALE "
                        "vertices, edgefactor 16, instead")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "df64"],
                   help="df64: two-float32 double-word pipeline, f64-grade "
                        "accuracy from float32 pairs")
    p.add_argument("--fmt", default="best",
                   choices=["best", "auto", "ell", "coo", "hyb", "cpg", "cst"],
                   help="best/cpg: the CPG format and its CUDA kernel; "
                        "cst: the CST format and its CUDA kernel (one "
                        "device, no --topk); auto/ell/coo/hyb: the "
                        "fallback formats (torch ops)")
    p.add_argument("--seed", type=int, default=0)
    # CPG pack knobs (kernels/cpg.py pack_cpg; None/auto = heuristic)
    p.add_argument("--cpg-theta", type=int, default=None, metavar="T",
                   help="CPG virtual-row split threshold (default: auto)")
    p.add_argument("--cpg-sub", type=int, default=None, metavar="S",
                   help="CPG chunk height in sublanes, multiple of 128")
    p.add_argument("--cpg-order", default="auto",
                   choices=["auto", "locality", "degree"],
                   help="CPG vertex ordering")
    p.add_argument("--cpg-theta-s", default="auto", metavar="TS",
                   help="CPG source-split cap: auto | off | <int>")
    p.add_argument("--cpg-layout", default="auto",
                   choices=["auto", "classic", "slab"],
                   help="CPG tile layout (slab: source-slab-pure tiles)")
    p.add_argument("--cpg-redeal", default="auto",
                   choices=["auto", "on", "off"],
                   help="CPG block-aware entry dealing")
    p.add_argument("--ell-pct", type=float, default=98.0,
                   help="hybrid format: ELL width percentile (rest -> COO)")
    p.add_argument("--shards", type=int, default=0,
                   help="row-shard over this many devices (0 = single "
                        "device): GPUs with --device cuda, CPU shards "
                        "with --device cpu")
    p.add_argument("--pipeline", type=int, default=0, metavar="N",
                   help="serve the query N times through the pipelined "
                        "path (query i's answer D2H rides behind query "
                        "i+1's Lanczos) and report per-query wall")
    p.add_argument("--reorthogonalize", action="store_true")
    p.add_argument("--ks", default=None, metavar="K1,K2,...",
                   help="convergence study: answers for every listed "
                        "Krylov dim from ONE decomposition, with "
                        "||ans_k - ans_kmax||/||ans_kmax|| diffs")
    p.add_argument("--func", default="exp", metavar="F",
                   help="spectral function applied to A: exp (default), "
                        "heat:<t> (e^{-t*lambda}), resolvent:<sigma> "
                        "(1/(sigma-lambda), Katz-style; sigma > lambda_max),"
                        " or cos.  Non-exp functions run the host-eig "
                        "pipeline (fa_action)")
    p.add_argument("--estrada", type=int, default=0, metavar="PROBES",
                   help="estimate the Estrada index tr(e^A) with PROBES "
                        "Hutchinson probes (one Q-free Lanczos quadrature "
                        "each; core/stochastic.py); with --func, tr(f(A))")
    p.add_argument("--subgraph", type=int, default=0, metavar="PROBES",
                   help="estimate subgraph centrality diag(e^A) for every "
                        "node with PROBES Hutchinson probes; prints the "
                        "top-10 nodes")
    p.add_argument("--dos", type=int, default=0, metavar="PROBES",
                   help="estimate the spectral density (DOS) of A by "
                        "stochastic Lanczos quadrature with PROBES "
                        "probes; prints the spectral interval and "
                        "density peaks (use --write-ans to dump the "
                        "grid/density table)")
    p.add_argument("--deflate", type=int, default=8, metavar="M",
                   help="rank of the top-Ritz deflation basis for "
                        "--estrada/--subgraph variance reduction (0 = "
                        "plain Hutchinson)")
    p.add_argument("--log-scale", action="store_true",
                   help="return e^(A - lambda_max I).x plus the shift "
                        "(avoids f32 overflow)")
    p.add_argument("--no-serial", action="store_true",
                   help="skip the numpy oracle pass (large graphs)")
    p.add_argument("--topk", type=int, default=0, metavar="K",
                   help="summary mode: reduce the answer ON DEVICE to its "
                        "top-K entries + norm (O(K) transfer) instead of "
                        "pulling the full vector")
    p.add_argument("--eig", default="device", choices=["device", "host"],
                   help="--topk eigensolver: 'device' (default) runs the "
                        "whole query on the device with no host read "
                        "before the O(K) fetch (f32 eigh: values within "
                        "~1e-5 of the host path); 'host' keeps f64 LAPACK "
                        "coefficients at one extra sync")
    p.add_argument("--low-mem", action="store_true",
                   help="two-pass Q-free Lanczos: O(n) device memory "
                        "instead of O(k*n) (large graphs)")
    p.add_argument("--write-ans", metavar="PATH",
                   help="write the answer vector (20 digits) to PATH")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the pipeline runs: cuda (default; the CUDA "
                        "kernels, needs a GPU) or cpu (their plain "
                        "PyTorch versions)")
    return p


def load_graph(args):
    from tpu_lanczos_torch.graphs import generators, io as gio

    if args.file:
        g = gio.read_mtx(args.file)
        src = args.file
    elif args.barabasi is not None:
        g = generators.barabasi_albert(args.n, args.barabasi, seed=args.seed)
        src = f"barabasi(n={args.n}, m={args.barabasi}, seed={args.seed})"
    elif args.graph500 is not None:
        g = generators.graph500(args.graph500, seed=args.seed)
        src = f"graph500(scale={args.graph500}, edgefactor=16, seed={args.seed})"
    else:
        g = generators.uniform_random(args.n, args.edges, seed=args.seed)
        src = f"uniform(n={args.n}, E={args.edges}, seed={args.seed})"
    return g, src


def _parse_func(spec: str):
    """--func spec -> (callable on eigenvalues, label), or None for exp."""
    if spec == "exp":
        return None
    if spec == "cos":
        return np.cos, "cos(A)"
    if spec.startswith("heat:"):
        t = float(spec.split(":", 1)[1])
        return (lambda ev, t=t: np.exp(-t * ev)), f"exp(-{t}A)"
    if spec.startswith("resolvent:"):
        sigma = float(spec.split(":", 1)[1])
        return (lambda ev, s=sigma: 1.0 / (s - ev)), f"(({sigma})I - A)^-1"
    raise SystemExit(f"unknown --func {spec!r} (exp | cos | heat:<t> | "
                     f"resolvent:<sigma>)")


def _custom_cpg_dg(args, g):
    """Build the CPG pack from the --cpg-* tuning flags, or None when
    every knob is at its default (let the pipeline pick)."""
    if args.fmt != "cpg" or not (
        args.cpg_theta is not None or args.cpg_sub is not None
        or args.cpg_order != "auto" or args.cpg_theta_s != "auto"
        or args.cpg_redeal != "auto" or args.cpg_layout != "auto"
    ):
        return None
    from tpu_lanczos_torch.kernels.cpg import pack_cpg

    theta_s = ("auto" if args.cpg_theta_s == "auto"
               else None if args.cpg_theta_s == "off"
               else int(args.cpg_theta_s))
    redeal = (None if args.cpg_redeal == "auto"
              else args.cpg_redeal == "on")
    return pack_cpg(g, theta=args.cpg_theta, sub=args.cpg_sub,
                    order=args.cpg_order, theta_s=theta_s,
                    redeal=redeal, layout=args.cpg_layout,
                    device=args.device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda (the default) needs a CUDA GPU and "
              "torch.cuda.is_available() is False; pass --device cpu to "
              "run the kernels' plain PyTorch versions on the CPU",
              file=sys.stderr)
        return 1
    return _main(args)


def _print_summary(label: str, t_device: float, topk: int, norm: float,
                   shift: float, nodes, values) -> None:
    print(f"device summary pipeline{label}: {t_device:.4f}s "
          f"(includes kernel build on first run)")
    print(f"  ||ans|| = {norm:.6e}  log-scale shift = {shift:.6f}")
    print(f"  top-{topk} nodes: {list(nodes)}")
    print(f"  top-{topk} values (scaled): "
          + " ".join(f"{v:.6e}" for v in values))


def _estimators(args, g, k: int) -> int:
    """--estrada/--subgraph/--dos on one device or, with --shards, on a
    row mesh, with the dense oracle beside each estimate for graphs of
    at most 4,000 nodes."""
    if (args.topk or args.low_mem
            or args.dtype == "df64" or args.reorthogonalize
            or args.ks or args.pipeline):
        print("error: --estrada/--subgraph/--dos run the f32/f64 "
              "pipeline (no --topk/--low-mem/df64/"
              "--reorthogonalize/--ks/--pipeline)", file=sys.stderr)
        return 2
    fa_est = _parse_func(args.func)
    if fa_est is not None and args.subgraph:
        print("error: --func composes with --estrada only (the "
              "diagonal estimator's fused shifted-space program is "
              "exp-specific)", file=sys.stderr)
        return 2
    from tpu_lanczos_torch.core import stochastic
    from tpu_lanczos_torch.core.pipeline import _resolve_dg
    from tpu_lanczos_torch.eval import oracle
    from tpu_lanczos_torch.utils import torch_dtype

    if args.log_scale:
        print("note: --log-scale is implied by the estimators (they "
              "work in shifted space); flag ignored", file=sys.stderr)
    if args.write_ans and not (args.subgraph or args.dos):
        print("note: --write-ans applies to --subgraph/--dos only "
              "(--estrada yields a scalar); flag ignored",
              file=sys.stderr)
    mesh = sg = dgc = None
    if args.shards:
        from tpu_lanczos_torch.dist import make_mesh

        if args.fmt == "cst":
            print("error: --fmt cst is single-chip only (sharded "
                  "estimators support best/cpg/auto/ell/hyb/coo)",
                  file=sys.stderr)
            return 2
        if args.fmt == "coo":
            print("note: sharded --fmt coo runs the hybrid ELL+COO "
                  "format (pure COO has no sharded packer)",
                  file=sys.stderr)
        mesh = make_mesh(args.shards, device=args.device)
        # one pack for every estimator: fmt cpg/best rides the CUDA CPG
        # kernel on each shard, the ELL/COO torch ops otherwise
        sg, _ = stochastic._sharded_setup(
            g, mesh, args.fmt, torch_dtype(args.dtype), args.ell_pct)
        print(f"{args.shards}-shard mesh (stochastic estimators, "
              f"{type(sg).__name__})")
    else:
        dgc = _custom_cpg_dg(args, g)
        if dgc is None:
            dgc = _resolve_dg(g, args.fmt, args.ell_pct, args.device)
    dense = not args.no_serial and g.n <= 4000
    if args.estrada:
        t0 = time.time()
        if fa_est is not None:
            # general-f trace: tr(f(A)) by deflated Hutchinson with
            # |f(theta)|-ranked Ritz deflation (heat kernels deflate the
            # bottom of the spectrum, exp-like f the top)
            f, label = fa_est
            if mesh is not None:
                r = stochastic.trace_fa_sharded(
                    sg, f=f, k=k, probes=args.estrada, mesh=mesh,
                    deflate=args.deflate, seed=args.seed, dtype=args.dtype)
            else:
                r = stochastic.trace_fa(
                    g, f=f, k=k, probes=args.estrada, deflate=args.deflate,
                    seed=args.seed, dtype=args.dtype, dg=dgc)
            dt = time.time() - t0
            print(f"tr({label}) ~= {r.estimate:.6e}")
            print(f"  probes={r.probes} k={r.k} deflation rank="
                  f"{r.deflated}  rel stderr={r.rel_stderr:.2e}  "
                  f"[{dt:.4f}s incl. kernel build on first run]")
            if dense:
                tr_true = oracle.trace_fa_dense(g, f)
                print(f"  dense oracle: {tr_true:.6e}   rel err "
                      f"{abs(r.estimate - tr_true) / abs(tr_true):.3e}")
        else:
            if mesh is not None:
                r = stochastic.estrada_index_sharded(
                    sg, k=k, probes=args.estrada, mesh=mesh,
                    deflate=args.deflate, seed=args.seed, dtype=args.dtype)
            else:
                r = stochastic.estrada_index(
                    g, k=k, probes=args.estrada, deflate=args.deflate,
                    seed=args.seed, dtype=args.dtype, dg=dgc)
            dt = time.time() - t0
            print(f"Estrada index tr(e^A) ~= {r.estimate:.6e}   "
                  f"(log: {r.log_estimate:.6f})")
            print(f"  probes={r.probes} k={r.k} deflation rank="
                  f"{r.deflated}  rel stderr={r.rel_stderr:.2e}  "
                  f"[{dt:.4f}s incl. kernel build on first run]")
            if dense:
                tr_true = oracle.trace_expm_dense(g)
                print(f"  dense oracle: {tr_true:.6e}   rel err "
                      f"{abs(r.estimate - tr_true) / tr_true:.3e}")
    if args.subgraph:
        t0 = time.time()
        if mesh is not None:
            dr = stochastic.subgraph_centrality_sharded(
                sg, k=k, probes=args.subgraph, mesh=mesh,
                deflate=args.deflate, seed=args.seed, dtype=args.dtype)
        else:
            dr = stochastic.subgraph_centrality(
                g, k=k, probes=args.subgraph, deflate=args.deflate,
                seed=args.seed, dtype=args.dtype, dg=dgc)
        dt = time.time() - t0
        print(f"subgraph centrality diag(e^A), scaled by "
              f"e^{dr.log_scale:.4f}:")
        print(f"  probes={dr.probes} k={dr.k} deflation rank="
              f"{dr.deflated}  [{dt:.4f}s incl. kernel build on first run]")
        top = dr.top_nodes(10)
        print("  top-10 nodes: " + ", ".join(
            f"{i} ({dr.diag_scaled[i]:.4g})" for i in top))
        if dense:
            d_true = oracle.diag_expm_dense(g)
            d_est = dr.full_diag()
            if np.all(np.isfinite(d_est)):
                rel = (np.linalg.norm(d_est - d_true)
                       / np.linalg.norm(d_true))
                print(f"  dense oracle: rel l2 err {rel:.3e}, top-1 "
                      f"match: {int(top[0]) == int(np.argmax(d_true))}")
        if args.write_ans:
            from tpu_lanczos_torch.eval.check import write_ans

            write_ans(dr.diag_scaled, args.write_ans)
            print(f"scaled diagonal written to {args.write_ans} "
                  f"(true diag = value * e^{dr.log_scale:.4f})")
    if args.dos:
        t0 = time.time()
        if mesh is not None:
            d = stochastic.spectral_density_sharded(
                sg, k=k, probes=args.dos, mesh=mesh, seed=args.seed,
                dtype=args.dtype)
        else:
            d = stochastic.spectral_density(
                g, k=k, probes=args.dos, seed=args.seed, dtype=args.dtype,
                dg=dgc)
        dt = time.time() - t0
        mass = float(np.trapezoid(d.density, d.grid))
        print(f"spectral density (DOS): lambda in "
              f"[{d.lambda_min:.4f}, {d.lambda_max:.4f}], "
              f"sigma={d.sigma:.4f}")
        print(f"  probes={d.probes} k={d.k} mass={mass:.4f}  "
              f"[{dt:.4f}s incl. kernel build on first run]")
        idx = np.argsort(d.density)[::-1][:3]
        print("  density peaks near lambda ~ " + ", ".join(
            f"{d.grid[i]:.3f} ({d.density[i]:.4g})" for i in sorted(idx)))
        if args.write_ans:
            # two-column (lambda, density) table; suffixed when
            # --subgraph already claimed the path
            path = (args.write_ans + ".dos" if args.subgraph
                    else args.write_ans)
            np.savetxt(path, np.column_stack([d.grid, d.density]))
            print(f"DOS table (lambda, density) written to {path}")
    return 0


def _main(args) -> int:
    from tpu_lanczos_torch.utils import enable_heap_reuse

    enable_heap_reuse()  # CLI opt-in: big packs fault their pages once
    device = args.device

    t0 = time.time()
    g, src = load_graph(args)
    t_load = time.time() - t0
    k = min(args.krylov, g.n - 1)
    print(f"graph: {src}")
    print(f"  n = {g.n}, undirected edges = {g.edge_count} (nnz = {g.nnz}), "
          f"max degree = {g.max_degree}  [{t_load:.3f}s]")
    print(f"krylov dim: {k}")

    # ---------------- all-k convergence study (--ks)
    if args.ks:
        if (args.shards or args.topk or args.low_mem
                or args.func != "exp" or args.reorthogonalize
                or args.estrada or args.subgraph or args.pipeline):
            print("error: --ks runs the single-chip exp pipeline (no "
                  "--shards/--topk/--low-mem/--func/--reorthogonalize/"
                  "--estrada/--subgraph/--pipeline)", file=sys.stderr)
            return 2
        ks = [int(s) for s in args.ks.split(",")]
        t0 = time.time()
        if args.dtype == "df64":
            # one alpha/beta pass + one multi-answer recombine
            if args.fmt not in ("best", "cpg"):
                print("note: df64 always runs the two-pass CPG pipeline "
                      "(--fmt ignored)", file=sys.stderr)
            from tpu_lanczos_torch.core.lanczos_df import expm_action_ks_df

            results, diffs = expm_action_ks_df(
                g, ks, log_scale=args.log_scale,
                dg=_custom_cpg_dg(args, g), device=device)
        else:
            from tpu_lanczos_torch.core.pipeline import expm_action_ks

            results, diffs = expm_action_ks(
                g, ks, dtype=args.dtype, fmt=args.fmt,
                log_scale=args.log_scale, dg=_custom_cpg_dg(args, g),
                device=device)
        print(f"one k_max={max(results)} decomposition: "
              f"{time.time() - t0:.4f}s (includes kernel build on first "
              f"run)")
        print(f"{'k':>6} {'rel diff vs k_max':>18}")
        for kk in sorted(results):
            print(f"{kk:>6} {diffs[kk]:>18.3e}")
        if args.write_ans:
            from tpu_lanczos_torch.eval.check import write_ans

            for kk in sorted(results):
                write_ans(results[kk].ans, f"{args.write_ans}.k{kk}")
            print(f"answers written to {args.write_ans}.k<K>")
        return 0

    # -------- stochastic spectral estimators (--estrada/--subgraph/--dos)
    if args.estrada or args.subgraph or args.dos:
        return _estimators(args, g, k)

    # ---------------- general spectral function (--func != exp)
    fa = _parse_func(args.func)
    if fa is not None:
        f, label = fa
        if (args.shards or args.topk or args.low_mem
                or args.dtype == "df64" or args.log_scale
                or args.pipeline):
            print("error: --func runs the single-chip host-eig pipeline "
                  "(no --shards/--topk/--low-mem/df64/--log-scale/"
                  "--pipeline)", file=sys.stderr)
            return 2
        ans_serial_f = None
        if not args.no_serial:
            from tpu_lanczos_torch.eval import oracle

            t0 = time.time()
            ans_serial_f = oracle.fa_action(g, np.ones(g.n), k, f)
            print(f"serial (numpy f64) {label}·1 pipeline: "
                  f"{time.time() - t0:.4f}s")
        from tpu_lanczos_torch.core.pipeline import fa_action

        t0 = time.time()
        res = fa_action(g, f, k=k, dtype=args.dtype, fmt=args.fmt,
                        reorthogonalize=args.reorthogonalize,
                        dg=_custom_cpg_dg(args, g), device=device)
        print(f"device {label}·1 pipeline ({args.dtype}): "
              f"{time.time() - t0:.4f}s (includes kernel build on first "
              f"run)")
        if res.log_scale is not None:
            print(f"  scale shift: {res.log_scale:.6f} "
                  f"(true ans = ans * e^shift; |f| exceeded the dtype)")
        if ans_serial_f is not None:
            from tpu_lanczos_torch.eval.check import check_ans

            a = (res.ans if res.log_scale is None
                 else res.ans.astype(np.float64) * np.exp(res.log_scale))
            if np.all(np.isfinite(a)):
                print(f"device vs serial: {check_ans(a, ans_serial_f)}")
            else:
                an = res.ans / np.linalg.norm(res.ans)
                bs = ans_serial_f / np.linalg.norm(ans_serial_f)
                print(f"device vs serial (normalized; |f| overflow): "
                      f"rel diff {np.linalg.norm(an - bs):.3e}")
        if args.verbose:
            top = np.argsort(res.ans)[-10:][::-1]
            print("top-10 nodes:", ", ".join(map(str, top)))
        if args.write_ans:
            from tpu_lanczos_torch.eval.check import write_ans

            write_ans(res.ans, args.write_ans)
            print(f"answer written to {args.write_ans}")
        return 0

    # ---------------- serial oracle pass (reference: serial pipeline first,
    # parallel-final/main.cu:69-106)
    ans_serial = None
    t_serial = None
    if not args.no_serial:
        from tpu_lanczos_torch.eval import oracle

        t0 = time.time()
        ans_serial = oracle.expm_action(g, np.ones(g.n), k)
        t_serial = time.time() - t0
        print(f"serial (numpy f64) pipeline: {t_serial:.4f}s")

    # ---------------- device pass; -v records its spans and prints them
    if not args.verbose:
        return _device_pass(args, g, k, t_serial, ans_serial)
    from tpu_lanczos_torch import obs

    with obs.recording() as rec:
        rc = _device_pass(args, g, k, t_serial, ans_serial)
    print("device pass spans (ms; card ms read by CUDA events):")
    print(obs.table(rec.take()))
    return rc


def _device_pass(args, g, k: int, t_serial, ans_serial) -> int:
    """The device pass: e^A.x, or its top-k, on one device or a mesh."""
    from tpu_lanczos_torch.core.pipeline import expm_action

    device = args.device
    t0 = time.time()
    if args.shards:
        out = _sharded(args, g, k)
        if isinstance(out, int):
            return out
        return _report(args, *out, f"{args.shards}-shard mesh",
                       time.time() - t0, t_serial, ans_serial)
    dg = _custom_cpg_dg(args, g)
    if args.topk:
        from tpu_lanczos_torch.core.pipeline import expm_action_summary

        if args.pipeline:
            print("error: --topk and --pipeline are separate "
                  "serving modes (pick one)", file=sys.stderr)
            return 2
        if args.fmt == "cst":
            print("error: --topk supports fmt best/cpg/ell/coo/hyb",
                  file=sys.stderr)
            return 2
        if args.dtype == "df64":
            # df64 top-k: the two-pass pipeline materializes the full f64
            # answer on the host anyway (hi+lo pair D2H), so the summary
            # reduces there (no O(topk)-transfer claim for this dtype)
            if args.fmt not in ("best", "cpg"):
                print("note: df64 always runs the two-pass CPG "
                      "pipeline (--fmt ignored)", file=sys.stderr)
            from tpu_lanczos_torch.core.lanczos_df import expm_action_df

            res = expm_action_df(g, k=k, dg=dg, log_scale=True,
                                 device=device)
            idx = np.argsort(res.ans)[-args.topk:][::-1]
            _print_summary(" (df64)", time.time() - t0, args.topk,
                           np.linalg.norm(res.ans), res.log_scale,
                           idx.tolist(), res.ans[idx])
            return 0
        eig = args.eig
        if args.low_mem:
            # two-pass Q-free serving at O(n) device memory; its
            # eigensolve runs on the host between the two passes, so the
            # fused device query (which stores Q) does not apply
            if eig == "device":
                print("note: --low-mem summary runs the two-pass "
                      "host-eig path (--eig device needs stored Q)",
                      file=sys.stderr)
            eig = "host"
        srs = expm_action_summary(g, k=k, topk=args.topk, fmt=args.fmt,
                                  dtype=args.dtype, dg=dg,
                                  ell_pct=args.ell_pct, eig_impl=eig,
                                  low_mem=args.low_mem, device=device)
        mode = " (two-pass Q-free)" if args.low_mem else ""
        _print_summary(mode, time.time() - t0, args.topk, srs.ans_norm,
                       srs.log_scale, srs.top_nodes.tolist(),
                       srs.top_values)
        return 0
    if args.pipeline:
        if args.dtype == "df64" or args.low_mem or args.reorthogonalize:
            print("error: --pipeline supports the standard f32/f64 "
                  "stored-Q path (no df64/--low-mem/--reorthogonalize)",
                  file=sys.stderr)
            return 2
        from tpu_lanczos_torch.core.pipeline import expm_action_pipelined

        if dg is None:
            from tpu_lanczos_torch.core.pipeline import _resolve_dg

            dg = _resolve_dg(g, args.fmt, args.ell_pct, device)
        # a warm-up query builds the kernels, so the reported per-query
        # wall is steady-state throughput
        expm_action_pipelined(g, [None], k, dtype=args.dtype, dg=dg,
                              log_scale=args.log_scale)
        t0 = time.time()
        rs = expm_action_pipelined(g, [None] * args.pipeline, k,
                                   dtype=args.dtype, dg=dg,
                                   log_scale=args.log_scale)
        per_q = (time.time() - t0) / args.pipeline
        res = rs[-1]
        print(f"pipelined x{args.pipeline}: {per_q:.4f}s/query "
              "(answer D2H of query i overlapped with query i+1's "
              "Lanczos)")
    elif args.dtype == "df64":
        from tpu_lanczos_torch.core.lanczos_df import expm_action_df

        if args.fmt not in ("best", "cpg") or args.reorthogonalize:
            print("note: df64 always runs the two-pass CPG pipeline "
                  "(--fmt/--reorthogonalize ignored)", file=sys.stderr)
        res = expm_action_df(g, k=k, dg=dg, log_scale=args.log_scale,
                             device=device)
    else:
        res = expm_action(
            g, k=k, dtype=args.dtype, fmt=args.fmt, dg=dg,
            ell_pct=args.ell_pct, low_mem=args.low_mem,
            reorthogonalize=args.reorthogonalize,
            log_scale=args.log_scale, device=device,
        )
    return _report(args, res.ans, res.log_scale, "device", time.time() - t0,
                   t_serial, ans_serial)


def _sharded_pack_kw(args) -> dict:
    """The --cpg-* knobs a sharded CPG pack takes (pack_cpg_sharded)."""
    pack_kw = {}
    if args.cpg_theta is not None:
        pack_kw["theta"] = args.cpg_theta
    if args.cpg_sub is not None:
        pack_kw["sub"] = args.cpg_sub
    if args.cpg_order != "auto":
        pack_kw["order"] = args.cpg_order
    if args.cpg_redeal != "auto":
        pack_kw["redeal"] = args.cpg_redeal == "on"
    return pack_kw


def _sharded(args, g, k: int):
    """The device pass on a row mesh of --shards devices: e^A.x (f32/f64,
    the CPG or the ELL/COO formats) or df64.  Returns (ans, shift), or an
    exit code."""
    from tpu_lanczos_torch.dist import expm_action_sharded, make_mesh

    if args.topk or args.low_mem:
        print("error: --topk/--low-mem are single-chip modes",
              file=sys.stderr)
        return 2
    if args.pipeline:
        print("error: --pipeline is a single-chip serving mode "
              "(no --shards)", file=sys.stderr)
        return 2
    if args.dtype == "df64":
        # f64-grade e^A.x over the row mesh: the df64 two-pass Q-free
        # Lanczos (dist/lanczos_df.py)
        from tpu_lanczos_torch.dist.lanczos_df import expm_action_df_sharded

        if args.fmt not in ("best", "cpg") or args.reorthogonalize:
            print("note: sharded df64 always runs the two-pass CPG "
                  "pipeline (--fmt/--reorthogonalize ignored)",
                  file=sys.stderr)
        if args.cpg_layout == "slab":
            print("error: --cpg-layout slab is single-chip only "
                  "(the sharded CPG splitter needs the classic "
                  "layout)", file=sys.stderr)
            return 2
        res = expm_action_df_sharded(
            g, k=k, mesh=make_mesh(args.shards, device=args.device),
            log_scale=args.log_scale, **_sharded_pack_kw(args))
        return res.ans, res.log_scale
    if args.fmt == "cst":
        # the CST layout is single-device only; silently running the
        # hybrid format here would misattribute its numbers
        print("error: --fmt cst is single-chip only (the sharded "
              "path supports best/cpg/auto/ell/hyb; coo runs hyb)",
              file=sys.stderr)
        return 2
    if args.fmt == "coo":
        print("note: sharded --fmt coo runs the hybrid ELL+COO "
              "format (pure COO has no sharded packer)",
              file=sys.stderr)
    pack_kw = None
    if args.fmt in ("cpg", "best"):
        pack_kw = _sharded_pack_kw(args)
        if args.cpg_layout == "slab":
            print("error: --cpg-layout slab is single-chip only "
                  "(the sharded CPG splitter needs the classic "
                  "layout)", file=sys.stderr)
            return 2
    ans, shift, _, _ = expm_action_sharded(
        g, k=k, mesh=make_mesh(args.shards, device=args.device),
        dtype=args.dtype, fmt=args.fmt,
        reorthogonalize=args.reorthogonalize, log_scale=args.log_scale,
        pack_kw=pack_kw, ell_pct=args.ell_pct)
    return ans, shift


def _report(args, ans, shift, label: str, t_device: float, t_serial,
            ans_serial) -> int:
    """The device pass's lines: its time, the shift, the speedup and the
    cross-check against the serial oracle, then -v and --write-ans."""
    print(f"{label} pipeline ({args.dtype}): {t_device:.4f}s "
          f"(includes kernel build on first run)")
    if shift is not None:
        print(f"  log-scale shift: {shift:.6f} (true ans = ans * e^shift)")
    if t_serial is not None and t_device > 0:
        print(f"speedup vs serial: {t_serial / t_device:.2f}x")

    # ---------------- cross-check (reference: check_ans, main.cu:156)
    if ans_serial is not None:
        from tpu_lanczos_torch.eval.check import check_ans

        with np.errstate(over="ignore"):
            a = ans if shift is None else ans * np.exp(shift)
        if np.all(np.isfinite(a)) and np.all(np.isfinite(ans_serial)):
            print(f"device vs serial: {check_ans(a, ans_serial)}")
        elif np.all(np.isfinite(ans)) and np.all(np.isfinite(ans_serial)):
            # overflow regime: compare direction only; the unscaled
            # device vector is finite under --log-scale
            an = ans / np.linalg.norm(ans)
            bs = ans_serial / np.linalg.norm(ans_serial)
            print(f"device vs serial (normalized; e^lambda overflow): "
                  f"rel diff {np.linalg.norm(an - bs):.3e}")
        else:
            print("device vs serial: serial oracle overflowed (non-finite); "
                  "no comparison possible — rerun the oracle log-scaled")

    if args.verbose:
        # ans is argsort-equivalent to the true answer under --log-scale
        # (scaling by e^shift > 0 preserves order)
        top = np.argsort(ans)[-10:][::-1]
        print("top-10 central nodes:", ", ".join(map(str, top)))

    if args.write_ans:
        from tpu_lanczos_torch.eval.check import write_ans

        write_ans(ans, args.write_ans)
        print(f"answer written to {args.write_ans}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
