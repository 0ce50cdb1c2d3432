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

Flags whose code is not ported yet keep their parser entry and exit 2,
naming their ROADMAP item: ``--estrada``, ``--subgraph`` and ``--dos``
(queue 1 item 13), ``--shards`` (queue 1 item 14), ``--fmt cst`` (queue 2
item 6).
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
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "df64"],
                   help="df64: two-float32 double-word pipeline, f64-grade "
                        "accuracy from float32 pairs")
    p.add_argument("--fmt", default="best",
                   choices=["best", "auto", "ell", "coo", "hyb", "cpg", "cst"],
                   help="best/cpg: the CPG format and its CUDA kernel; "
                        "auto/ell/coo/hyb: the fallback formats (torch "
                        "ops); cst: not ported")
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
                        "device; not ported, ROADMAP queue 1 item 14)")
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
                   help="Estrada index tr(e^A) by Hutchinson probes (not "
                        "ported, ROADMAP queue 1 item 13)")
    p.add_argument("--subgraph", type=int, default=0, metavar="PROBES",
                   help="subgraph centrality diag(e^A) by Hutchinson "
                        "probes (not ported, ROADMAP queue 1 item 13)")
    p.add_argument("--dos", type=int, default=0, metavar="PROBES",
                   help="spectral density by stochastic Lanczos "
                        "quadrature (not ported, ROADMAP queue 1 item 13)")
    p.add_argument("--deflate", type=int, default=8, metavar="M",
                   help="rank of the deflation basis for --estrada/"
                        "--subgraph (not ported, ROADMAP queue 1 item 13)")
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


def _unported(args) -> str | None:
    """The message for a flag whose code is not ported yet, or None."""
    if args.estrada or args.subgraph or args.dos:
        return ("--estrada/--subgraph/--dos: the stochastic estimators are "
                "not ported yet (ROADMAP queue 1 item 13)")
    if args.shards:
        return ("--shards: the row-sharded multi-device path is not ported "
                "yet (ROADMAP queue 1 item 14)")
    if args.fmt == "cst":
        return ("--fmt cst: the CST format and its kernel are not ported "
                "yet (ROADMAP queue 2 item 6)")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    msg = _unported(args)
    if msg is not None:
        print(f"error: {msg}", file=sys.stderr)
        return 2
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
        if (args.topk or args.low_mem or args.func != "exp"
                or args.reorthogonalize or args.pipeline):
            print("error: --ks runs the single-device exp pipeline (no "
                  "--topk/--low-mem/--func/--reorthogonalize/--pipeline)",
                  file=sys.stderr)
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

    # ---------------- general spectral function (--func != exp)
    fa = _parse_func(args.func)
    if fa is not None:
        f, label = fa
        if (args.topk or args.low_mem or args.dtype == "df64"
                or args.log_scale or args.pipeline):
            print("error: --func runs the single-device host-eig pipeline "
                  "(no --topk/--low-mem/df64/--log-scale/--pipeline)",
                  file=sys.stderr)
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

    # ---------------- device pass
    from tpu_lanczos_torch.core.pipeline import expm_action

    t0 = time.time()
    dg = _custom_cpg_dg(args, g)
    if args.topk:
        from tpu_lanczos_torch.core.pipeline import expm_action_summary

        if args.pipeline:
            print("error: --topk and --pipeline are separate "
                  "serving modes (pick one)", file=sys.stderr)
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
    ans, shift = res.ans, res.log_scale
    t_device = time.time() - t0
    print(f"device pipeline ({args.dtype}): {t_device:.4f}s "
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
