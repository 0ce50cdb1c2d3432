"""Barabasi-Albert graphs from the frozen C++ generator ``ba_csr.cc``.

Configuration keys: ``n`` (nodes) and ``m`` (edges each new node
attaches).  The graph seed is the run's ``--seed``.  The library is built
by g++ at first use into ``lanczos_bench/build/`` (a fixed path inside
the checkout, so later runs find it) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "ba_csr.cc")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libba_csr.so")


def _library():
    if not (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp,
             SOURCE], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    lib = ctypes.CDLL(LIB_PATH)
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.lb_barabasi_csr.restype = ptr
    lib.lb_barabasi_csr.argtypes = [i64, i64, ctypes.c_uint64]
    lib.lb_csr_nnz.restype = i64
    lib.lb_csr_nnz.argtypes = [ptr]
    lib.lb_csr_fill.restype = None
    lib.lb_csr_fill.argtypes = [ptr, ptr, ptr]
    lib.lb_csr_free.restype = None
    lib.lb_csr_free.argtypes = [ptr]
    return lib


def barabasi_albert(n: int, m: int, seed: int):
    """(indptr int64 (n+1,), indices int32 (nnz,)) of the BA graph."""
    if seed < 0 or seed >= 2**64:
        raise ValueError(f"seed {seed} does not fit 64 unsigned bits")
    lib = _library()
    handle = lib.lb_barabasi_csr(n, m, seed)
    if not handle:
        raise ValueError(f"no BA graph for n={n}, m={m}")
    try:
        indptr = np.empty(n + 1, dtype=np.int64)
        indices = np.empty(lib.lb_csr_nnz(handle), dtype=np.int32)
        lib.lb_csr_fill(handle, indptr.ctypes.data_as(ctypes.c_void_p),
                        indices.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.lb_csr_free(handle)
    return indptr, indices


def generate(config: dict, seed: int):
    return barabasi_albert(int(config["n"]), int(config["m"]), seed)
