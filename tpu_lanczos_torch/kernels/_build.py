"""nvcc build and ctypes binding of the port's CUDA kernels.

The sources under ``kernels/csrc/`` have a plain C interface, so they are
compiled by nvcc straight into one shared library (no PyTorch headers:
seconds, not minutes) in ``build/tpu_lanczos_torch/`` at first use, and
loaded with ctypes.  Every pointer and the stream pass as
``ctypes.c_void_p``; each C entry point returns ``cudaGetLastError()``.
Nothing here runs at import time, and nothing falls back: a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

from tpu_lanczos_torch.utils import BUILD_DIR, build_shared

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = [os.path.join(CSRC_DIR, "spmv_cpg.cu")]
LIB_PATH = os.path.join(BUILD_DIR, "libtlt_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tlt_spmv_cpg_level.restype = i
    lib.tlt_spmv_cpg_level.argtypes = [p, p, p, p, p, p, p, p,
                                       i, i, i, i, i, p]
    lib.tlt_spmv_cpg_level_comp.restype = i
    lib.tlt_spmv_cpg_level_comp.argtypes = [p, p, p, p, p, p, p, p,
                                            i, i, i, i, p]
    return lib


def library():
    """The loaded kernel library, built by nvcc on first call."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            log = build_shared([nvcc_path()] + NVCC_FLAGS, SOURCES, LIB_PATH)
            if log is not None:
                build_log = log
            _lib = _bind(ctypes.CDLL(LIB_PATH))
        return _lib
