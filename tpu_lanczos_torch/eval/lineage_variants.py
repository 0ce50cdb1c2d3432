"""Time other versions of the GPG and CST level kernels beside the
package's own on one CUDA GPU.

    python -m tpu_lanczos_torch.eval.lineage_variants \\
        [--n 1000000] [--m 10] [--seed 0] [--reps 5] \\
        [--source NAME=PATH ...] [--variant NAME=PATH ...]

Builds the package's ``kernels/csrc/spmv_gpg.cu`` and ``spmv_cst.cu`` and
each extra file, each into its own library (``cpg_variants.build``):

- ``--source``: a file with the first port's C interface, whose kernels
  take int32 CST indices and no tensor maps (for example the parent
  commit's ``spmv_gpg.cu`` or ``spmv_cst.cu``, from ``git archive``); its
  CST levels read int32 copies of the pack's indices;
- ``--variant``: a file with the package's C interface (another design
  of the same kernel).

The package's CST kernel is also timed on an int32 copy of idx1 (its
int32 branch, 5 index bytes a slot cell instead of 3).

Whether a file is a GPG or a CST kernel follows from the entry point its
library exports.  On the graph (Barabasi-Albert, native generator), GPG
pack at its defaults and CST pack (packed on the host by a child process
while the GPG builds run), it prints JSON lines: the GPG pack's per-chunk
tile counts and real-step share, the CST pack's slots and index bytes
(narrowed and as int32), then one line per build: its ptxas report,
equality with the package's kernel on every level (f32 and f64), and
CUDA-event medians of each level and of the whole SpMV, the builds of a
format timed in turns (forward, then backward); and the cuSPARSE SpMV of
the same graph.  Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tpu_lanczos_torch.eval.cpg_variants import (build, chunk_counts,
                                                 cuda_ms, lib_path)
from tpu_lanczos_torch.kernels import _build

PACKAGE = {"gpg": os.path.join(_build.CSRC_DIR, "spmv_gpg.cu"),
           "cst": os.path.join(_build.CSRC_DIR, "spmv_cst.cu")}

# the CST pack of a large graph is minutes of host numpy: a child packs
# it while the GPG builds run, and hands it over in a file
CST_CHILD = """
import json, sys, time
import numpy as np
from tpu_lanczos_torch import generators
from tpu_lanczos_torch.kernels.cst import pack_cst
n, m, seed = (int(a) for a in sys.argv[1:4])
g = generators.barabasi_albert(n, m, seed=seed, use_native=True)
t0 = time.time()
cg = pack_cst(g, device="cpu")
pack_s = time.time() - t0
arrays = {f"idx1_{i}": a.numpy() for i, a in enumerate(cg.idx1)}
arrays.update({f"idx3_{i}": a.numpy() for i, a in enumerate(cg.idx3)})
np.savez(sys.argv[4], n=cg.n, n_cols=cg.n_cols, nnz=cg.nnz, theta=cg.theta,
         n_levels=len(cg.idx1), realmask=cg.realmask.numpy(),
         new_of_old=cg.new_of_old, **arrays)
print(json.dumps({"pack_s": pack_s}))
"""


def gpg_level_fn(lib, new_interface: bool):
    """A function with ``spmv_gpg.run_level_gpg``'s signature that
    launches ``lib``'s GPG kernel (the package's interface or the first
    port's)."""

    def level(x2d, lv, n_chunks, g_s, sub_s, sub_d):
        out = x2d.new_empty((n_chunks * 128, sub_d))
        ptrs = [x2d.data_ptr()] + [lv[k].data_ptr() for k in (
            "l1", "l2", "g_ids", "starts", "counts")] + [out.data_ptr()]
        shape = ([n_chunks, lv["d_ids"].shape[0], g_s, sub_s, sub_d]
                 if new_interface else [n_chunks, g_s, sub_s, sub_d])
        err = lib.tlt_spmv_gpg_level(
            *ptrs, *shape, x2d.element_size(),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"GPG launch failed: CUDA error {err}")
        return out

    return level


def cst_level_fn(lib, new_interface: bool, wide: dict | None = None,
                 wide_idx1: bool = False):
    """A function with ``spmv_cst.run_level_cst``'s signature that
    launches ``lib``'s CST kernel.  The first port's interface reads the
    int32 copy ``wide[data_ptr]`` of each index tensor; the package's
    reads the int32 copy of idx1 with ``wide_idx1``."""

    def level(src, acc, i1, i3):
        out = torch.empty_like(src)
        if new_interface:
            if wide_idx1:
                i1 = wide[i1.data_ptr()]
            tail = [i3.stride(1), i1.element_size(), src.element_size()]
        else:
            i1, i3 = wide[i1.data_ptr()], wide[i3.data_ptr()]
            tail = [src.element_size()]
        err = lib.tlt_spmv_cst_level(
            src.data_ptr(), None if acc is None else acc.data_ptr(),
            i1.data_ptr(), i3.data_ptr(), out.data_ptr(), i1.shape[0],
            src.shape[1], *tail, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"CST launch failed: CUDA error {err}")
        return out

    return level


def load(name: str, new_interface: bool):
    """(format, library) of a build: the format is the entry point it
    exports; the first port's interface is bound here."""
    lib = ctypes.CDLL(lib_path(name))
    p, i = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "tlt_spmv_gpg_level"):
        fmt = "gpg"
        old = [p] * 7 + [i] * 5 + [p]
    elif hasattr(lib, "tlt_spmv_cst_level"):
        fmt = "cst"
        old = [p] * 5 + [i] * 3 + [p]
    else:
        raise ValueError(f"{name}: no GPG or CST entry point")
    if new_interface:
        _build.bind_lineage(lib)
    else:
        fn = getattr(lib, f"tlt_spmv_{fmt}_level")
        fn.restype, fn.argtypes = i, old
    return fmt, lib


def level_inputs(pk, spmv_mod, x, plain):
    """Each level's arguments as ``spmv_mod._spmv`` gives them for x."""
    args = []

    def record(*a):
        args.append(a)
        return plain(*a)

    spmv_mod._spmv(pk, x, record)
    return args


def time_builds(rows, fns, pk, spmv_mod, args, x, reps):
    """Level and SpMV medians of every build, in turns."""
    order = list(fns) + list(fns)[::-1]
    for name in order:
        fn = fns[name]
        rows[name]["level_ms"].append([cuda_ms(lambda: fn(*a), reps)
                                       for a in args])
        rows[name]["spmv_ms"].append(cuda_ms(
            lambda: spmv_mod._spmv(pk, x, fn), reps))
    for row in rows.values():
        row["level_ms_median"] = np.median(row["level_ms"], axis=0).tolist()
        row["spmv_ms_median"] = float(np.median(row["spmv_ms"]))
        row["index_GBps"] = pk.index_bytes() / row["spmv_ms_median"] / 1e6


def compare(fns, want, args_of):
    """name -> whether the build equals the package kernel on every
    level, f32 and f64."""
    return {name: all(torch.equal(fn(*a), w)
                      for dt in want for a, w in zip(args_of[dt], want[dt]))
            for name, fn in fns.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lineage_variants needs a CUDA GPU")
    from tpu_lanczos_torch import generators
    from tpu_lanczos_torch.kernels import cst, spmv_cst, spmv_gpg
    from tpu_lanczos_torch.kernels.gpg import pack_gpg

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    cst_path = os.path.join(tmp, "cst.npz")
    child = subprocess.Popen(
        [sys.executable, "-c", CST_CHILD, str(args.n), str(args.m),
         str(args.seed), cst_path], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [os.getcwd()] + sys.path)})
    try:
        return _run(args, child, cst_path, generators, cst, spmv_cst,
                    spmv_gpg, pack_gpg)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        if os.path.exists(cst_path):
            os.remove(cst_path)
        os.rmdir(tmp)


def _run(args, child, cst_path, generators, cst, spmv_cst, spmv_gpg,
         pack_gpg) -> int:
    builds = {f"{fmt}_package": src for fmt, src in PACKAGE.items()}
    new_iface = dict.fromkeys(builds, True)
    for flag, items in (("source", args.source), ("variant", args.variant)):
        for item in items:
            name, path = item.split("=", 1)
            builds[name] = os.path.abspath(path)
            new_iface[name] = flag == "variant"
    t0 = time.time()
    ptxas = build(builds)
    build_s = time.time() - t0
    libs = {name: load(name, new_iface[name]) for name in builds}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "n": args.n, "m": args.m,
                      "build_s": build_s,
                      "builds": {n: libs[n][0] for n in builds}}),
          flush=True)
    g = generators.barabasi_albert(args.n, args.m, seed=args.seed,
                                   use_native=True)
    rng = np.random.default_rng(1)
    xr = rng.standard_normal(g.n)
    ok = True

    # ---- GPG
    gg = pack_gpg(g, device="cuda")
    print(json.dumps({"gpg": {"n_chunks": gg.n_chunks, "g_s": gg.g_s,
                              "sub_s": gg.sub_s, "sub_d": gg.sub_d,
                              "index_bytes": gg.index_bytes(),
                              "real_step_share": gg.real_step_share,
                              "counts": chunk_counts(gg),
                              "chunk_tiles": [lv["counts"].tolist()
                                              for lv in gg.levels]}}),
          flush=True)
    fns = {}
    for name, (fmt, lib) in libs.items():
        if fmt == "gpg":
            fns[name] = gpg_level_fn(lib, new_iface[name])
    ok &= _format_rows("gpg", gg, spmv_gpg, spmv_gpg.run_level_gpg_ref,
                       fns, ptxas, builds, xr, args.reps)

    # ---- CST
    out, err = child.communicate(timeout=1800)
    if child.returncode != 0:
        raise RuntimeError(f"CST pack child: rc {child.returncode}: "
                           f"{err[-2000:]}")
    with np.load(cst_path) as z:
        L = int(z["n_levels"])
        cg = cst.from_numpy(
            {k: int(z[k]) for k in ("n", "n_cols", "nnz", "theta")},
            [z[f"idx1_{i}"] for i in range(L)],
            [z[f"idx3_{i}"] for i in range(L)],
            z["realmask"], z["new_of_old"], "cuda")
    wide = {a.data_ptr(): a.int() for a in cg.idx1 + cg.idx3}
    print(json.dumps({"cst": {
        "pack_s": json.loads(out.strip().splitlines()[-1])["pack_s"],
        "n_cols": cg.n_cols, "slots": [int(a.shape[0]) for a in cg.idx1],
        "idx1_dtype": str(cg.idx1[0].dtype),
        "idx3_dtype": str(cg.idx3[0].dtype),
        "index_bytes": cg.index_bytes(),
        "index_bytes_int32": sum(a.numel() * 4 for a in wide.values())}}),
        flush=True)
    fns = {name: cst_level_fn(lib, new_iface[name], wide)
           for name, (fmt, lib) in libs.items() if fmt == "cst"}
    fns["cst_package_idx1_int32"] = cst_level_fn(
        libs["cst_package"][1], True, wide, wide_idx1=True)
    ok &= _format_rows("cst", cg, spmv_cst, spmv_cst.run_level_cst_ref,
                       fns, ptxas, builds, xr, args.reps)

    csr = g.to_scipy().tocsr()
    a = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int64)),
        torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(csr.data.astype(np.float32)), size=csr.shape,
        device="cuda")
    xc = torch.from_numpy(xr.astype(np.float32)).cuda()
    print(json.dumps({"cusparse_spmv_ms": cuda_ms(lambda: a @ xc,
                                                  args.reps)}), flush=True)
    return 0 if ok else 1


def _format_rows(fmt, pk, spmv_mod, plain, fns, ptxas, builds, xr,
                 reps) -> bool:
    """Equality of every build of one format with its package kernel,
    f32 and f64, on every level; then the timings in turns."""
    package = fns[f"{fmt}_package"]
    args_of, want = {}, {}
    for dt in (np.float32, np.float64):
        x = torch.from_numpy(pk.permute_in(xr, dt)).cuda()
        args_of[dt] = level_inputs(pk, spmv_mod, x, package)
        want[dt] = [package(*a) for a in args_of[dt]]
    plain_equal = all(torch.equal(plain(*a), w) for dt in want
                      for a, w in zip(args_of[dt], want[dt]))
    equal = compare(fns, want, args_of)
    rows = {name: {"fmt": fmt, "build": name,
                   "source": builds.get(name, builds[f"{fmt}_package"]),
                   "ptxas": ptxas.get(name, ptxas[f"{fmt}_package"]),
                   "equal": equal[name], "level_ms": [], "spmv_ms": []}
            for name in fns}
    x1 = pk.realmask.reshape(-1).clone()
    time_builds(rows, fns, pk, spmv_mod, args_of[np.float32], x1, reps)
    print(json.dumps({"fmt": fmt, "package_equals_plain": plain_equal}),
          flush=True)
    for row in rows.values():
        print(json.dumps(row), flush=True)
    return plain_equal and all(equal.values())


if __name__ == "__main__":
    sys.exit(main())
