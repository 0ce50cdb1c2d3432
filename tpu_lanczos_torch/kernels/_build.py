"""nvcc build and ctypes binding of the port's CUDA kernels.

The sources under ``kernels/csrc/`` have a plain C interface (no PyTorch
headers: seconds, not minutes).  At first use each is compiled by its own
nvcc process, all started together, and the objects are linked into one
shared library in ``build/tpu_lanczos_torch/``, loaded with ctypes.
Every pointer and the stream pass as ``ctypes.c_void_p``; each C entry
point returns ``cudaGetLastError()``.  Nothing here runs at import time,
and nothing falls back: a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

from tpu_lanczos_torch.utils import BUILD_DIR, build_shared

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = [os.path.join(CSRC_DIR, name) for name in (
    "spmv_cpg.cu", "spmv_cpg_shard.cu", "spmv_cst.cu", "spmv_gpg.cu",
    "mxu_probe.cu", "lanczos_step.cu")]
HEADERS = [os.path.join(CSRC_DIR, name) for name in (
    "tma.cuh", "heavy_first.cuh", "df_level.cuh")]
LIB_PATH = os.path.join(BUILD_DIR, "libtlt_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
build_log: str | None = None  # nvcc's stderr (ptxas register report)


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def bind_cpg(lib):
    """Argument types of the single-device CPG entry points on ``lib``
    (whichever it has): spmv_cpg.cu's levels (plain, staged classic,
    compensated, the slab df64 level) and spmv_cpg_shard.cu's classic
    df64 level."""
    p, i = ctypes.c_void_p, ctypes.c_int
    df = [p] * 10 + [i] * 5 + [p]
    for name, args in (
            ("tlt_spmv_cpg_level", [p] * 8 + [i] * 5 + [p]),
            ("tlt_spmv_cpg_level_staged", [p] * 8 + [i] * 3 + [p]),
            ("tlt_spmv_cpg_level_comp", [p] * 8 + [i] * 4 + [p]),
            ("tlt_spmv_cpg_level_df", df),
            ("tlt_spmv_cpg_slab_level_df", df)):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = args
    return lib


def bind_shard(lib):
    """Argument types of the row-sharded path's entry points on ``lib``:
    spmv_cpg.cu's two-source level and spmv_cpg_shard.cu's df64 level
    (its arguments' struct passes by its address)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tlt_spmv_cpg_level_halo.restype = i
    lib.tlt_spmv_cpg_level_halo.argtypes = [p, p, i, p, p, p, p, p, p, p,
                                            i, i, i, i, p]
    lib.tlt_spmv_cpg_shard_df.restype = i
    lib.tlt_spmv_cpg_shard_df.argtypes = [p, i, p]
    return lib


def bind_lineage(lib):
    """Argument types of spmv_cst.cu's and spmv_gpg.cu's entry points on
    ``lib`` (whichever it has)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "tlt_spmv_cst_level"):
        lib.tlt_spmv_cst_level.restype = i
        lib.tlt_spmv_cst_level.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    if hasattr(lib, "tlt_spmv_gpg_level"):
        lib.tlt_spmv_gpg_level.restype = i
        lib.tlt_spmv_gpg_level.argtypes = [p, p, p, p, p, p, p,
                                           i, i, i, i, i, i, p]
    return lib


def bind_step(lib):
    """Argument types of lanczos_step.cu's entry points on ``lib``."""
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tlt_lanczos_step_workspace_bytes.restype = i
    lib.tlt_lanczos_step_workspace_bytes.argtypes = []
    lib.tlt_lanczos_step_occupancy.restype = i
    lib.tlt_lanczos_step_occupancy.argtypes = [i, i, n]
    lib.tlt_lanczos_step.restype = i
    lib.tlt_lanczos_step.argtypes = [p, p, p, p, p, p, n, i, i, p, p, p, i,
                                     p, i, i, p]
    lib.tlt_lanczos_step_head.restype = i
    lib.tlt_lanczos_step_head.argtypes = [p, p, p, p, p, n, i, i, p, p]
    lib.tlt_lanczos_step_tail.restype = i
    lib.tlt_lanczos_step_tail.argtypes = [p, p, p, n, i, i, p, p, p, i, p,
                                          p]
    lib.tlt_lanczos_step_df.restype = i
    lib.tlt_lanczos_step_df.argtypes = [p, p, p, p, p, p, p, p, p, p, p, n,
                                        i, p, p, p, p, i, i, n, p, i, i, i,
                                        p]
    lib.tlt_df_norm.restype = i
    lib.tlt_df_norm.argtypes = [p, p, p, p, n, p, p]
    # rows 5d and 5cd, the per-shard passes
    for name, args in (
            ("tlt_shard_step_dot", [p, p, p, p, n, i, i, i, p, p]),
            ("tlt_shard_step_update", [p] * 6 + [i, p, i, p, n, i, i, i,
                                                 p, p]),
            ("tlt_shard_step_sub_norm", [p, p, p, n, i, i, p, p]),
            ("tlt_shard_step_normalize", [p, p, i, p, i, p, n, i, i, i, p]),
            ("tlt_shard_df_dot", [p] * 7 + [n, i, p, p]),
            ("tlt_shard_df_update", [p] * 9 + [i, p, p, i, p, p, n, i, p,
                                               p]),
            ("tlt_shard_df_normalize", [p, p, p, i, p, p, i, p, p, p, p, i,
                                        n, i, p])):
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = args
    return lib


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    bind_cpg(lib)
    bind_shard(lib)
    bind_lineage(lib)
    bind_step(lib)
    lib.tlt_mxu_probe.restype = i
    lib.tlt_mxu_probe.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    return lib


def _compile_all(nvcc: str, objs: list[str]) -> str:
    """One ``nvcc -c`` per source into ``objs``, all running at once.
    Returns the compilers' stderr; raises on a failure, with every
    compiler stopped."""
    procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(SOURCES, objs)]
    try:
        logs = [proc.communicate(timeout=600)[1] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for src, proc, log in zip(SOURCES, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log[-4000:]}")
    return "".join(logs)


def library():
    """The loaded kernel library, built by nvcc on first call."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            nvcc = nvcc_path()
            if not _up_to_date():
                os.makedirs(BUILD_DIR, exist_ok=True)
                # per-pid names: concurrent first builds must not share one
                objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}."
                                     f"{os.getpid()}.o") for src in SOURCES]
                try:
                    build_log = _compile_all(nvcc, objs)
                    build_shared([nvcc, "-shared"], objs, LIB_PATH)
                finally:
                    for obj in objs:
                        if os.path.exists(obj):
                            os.remove(obj)
            _lib = _bind(ctypes.CDLL(LIB_PATH))
        return _lib


def _up_to_date() -> bool:
    return os.path.exists(LIB_PATH) and all(
        os.path.getmtime(LIB_PATH) >= os.path.getmtime(s)
        for s in SOURCES + HEADERS)
