"""Build-directory and shared-library helpers for the port's native code.

Both native builds of the port go through :func:`build_shared`: the graph
core (``graphs/native/graphcore.cc``, compiled with g++) and the CUDA
kernels (``kernels/csrc/*.cu``, compiled with nvcc).  Outputs land in
``build/tpu_lanczos_torch/`` beside the package, a directory git ignores.
Also the CLI's opt-in allocator setting, ``enable_heap_reuse``.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(ROOT_DIR, "build", "tpu_lanczos_torch")


def build_shared(cmd: list[str], sources: list[str], out: str,
                 timeout: float = 600) -> str | None:
    """Run ``cmd + ["-o", tmp] + sources`` unless ``out`` is newer than
    every source, then install the result atomically.  Returns the
    compiler's stderr (None when ``out`` was up to date); raises
    RuntimeError with it on failure."""
    if os.path.exists(out) and all(
            os.path.getmtime(out) >= os.path.getmtime(s) for s in sources):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # per-pid tmp: concurrent first builds (test workers) must not write
    # the same file; os.replace keeps the install atomic
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(cmd + ["-o", tmp] + sources, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{cmd[0]} failed for {out}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return proc.stderr


def torch_dtype(dtype) -> torch.dtype:
    """"float32" / np.float32 / torch.float32 -> torch.float32."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


_HEAP_REUSE_DONE = False


def enable_heap_reuse() -> bool:
    """Keep freed large allocations on the glibc heap for reuse.

    By default glibc serves numpy's big temporaries via mmap and returns
    them to the OS on free, so every pass over a multi-GB working set
    re-faults fresh pages; on hosts with lazy memory provisioning that
    dominates pack time.  Raising M_MMAP_THRESHOLD / M_TRIM_THRESHOLD
    keeps the pages in the process after free, so the pack's temporaries
    fault once.  Trade-off: peak RSS stays at the high-water mark for the
    process lifetime, so only the CLI opts in (the library never calls
    it).  ``TPU_LANCZOS_NO_HEAP_REUSE`` set in the environment disables
    it.  Returns True when mallopt was reachable and accepted the
    settings.
    """
    global _HEAP_REUSE_DONE
    if _HEAP_REUSE_DONE:
        return True
    if os.environ.get("TPU_LANCZOS_NO_HEAP_REUSE"):
        return False
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        giant = 2**31 - 1  # mallopt takes int
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, giant))
        ok = bool(libc.mallopt(M_TRIM_THRESHOLD, giant)) and ok
        _HEAP_REUSE_DONE = ok
        return ok
    except Exception:
        return False
