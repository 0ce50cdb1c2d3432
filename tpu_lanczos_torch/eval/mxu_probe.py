"""The dense-block probe on the tensor cores: does a stream of (128, 128)
bf16 0/1 adjacency blocks through the tensor cores run at the HBM rate?

The port of ``tpu_lanczos/eval/mxu_probe.py``, which asked the same of
the TPU's MXU.  The same data (``default_rng(7)``, 0/1 blocks at 5% fill,
x split into hi and lo bf16 parts; ``torch.bfloat16`` in place of
``ml_dtypes``) and the same three variants:

- ``dma``: copy each block and add rows :m_rows in float (the copy
  baseline);
- ``mxu1``: ``acc += x_hi @ A_b`` on the tensor cores;
- ``mxu2``: ``acc += x_hi @ A_b + x_lo @ A_b`` (the hi/lo split, exact
  products for a 0/1 A).

``probe`` launches ``kernels/csrc/mxu_probe.cu`` on CUDA tensors and
takes the plain version ``probe_ref`` only for CPU tensors.

    python -m tpu_lanczos_torch.eval.mxu_probe [--blocks 16384]
    python -m tpu_lanczos_torch.eval.mxu_probe --check-only
    python -m tpu_lanczos_torch.eval.mxu_probe --source NAME=PATH[@K]

runs on the CUDA GPU (and raises without one): first the kernel against
the plain version on 8 blocks for every variant (``--check-only`` stops
there), then each variant timed with CUDA events at ``--blocks`` (the
time a call takes, both launches, over CALLS_PER_SAMPLE calls back to
back), printed as one JSON line with its wall time, ns per block, block
GB/s, share of the 3.35 TB/s bound, and the device time of each of its
two kernels in one profiled call (torch.profiler): the block stream and
the reduce of the partials.

``--source NAME=PATH`` builds another ``mxu_probe.cu`` with the same C
interface (for example the parent commit's, from ``git archive``) into
its own library and times it beside the package's build: every variant
of every build, in turns (forward, then backward), each checked against
the plain version at the timed size first (element-wise, ``rel_err``,
and against the plain version's largest value, ``scaled_err``).  A
build whose own wrapper ran K CTAs an SM, not CTAS_PER_SM, is named
``NAME=PATH@K`` and runs with that partition.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

LANE = 128
VARIANTS = ("dma", "mxu1", "mxu2")
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published HBM rate
BLOCK_BYTES = LANE * LANE * 2
CHECK_BLOCKS, CHECK_U = 8, 2  # the reference's self-check slice
CTAS_PER_SM = 1  # one persistent CTA an SM: its ring takes ~193 KB
KERNELS = ("probe_reduce_kernel", "probe_kernel")  # device kernel names
CALLS_PER_SAMPLE = 10  # probe calls between a timing sample's two events

# CUDA launches of the probe kernel; only probe adds to it
launches_mxu = 0


def make_data(blocks: int, u: int, m_rows: int, device="cuda"):
    """The reference's inputs: B = (blocks // u) * u blocks of 0/1 at 5%
    fill drawn first, then x; x_hi = bf16(x), x_lo = bf16(x - x_hi), each
    broadcast to max(8, m_rows) rows.  Returns (a (B*128, 128) bf16, xh,
    xl) on ``device``."""
    rng = np.random.default_rng(7)
    B = (blocks // u) * u
    a_np = (rng.random((B * LANE, LANE)) < 0.05).astype(np.float32)
    x_np = rng.standard_normal(LANE).astype(np.float32)
    a = torch.from_numpy(a_np).to(device).to(torch.bfloat16)
    del a_np
    x = torch.from_numpy(x_np)
    xh = x.to(torch.bfloat16)
    xl = (x - xh.float()).to(torch.bfloat16)
    mr = max(8, m_rows)
    return (a, xh.expand(mr, LANE).contiguous().to(device),
            xl.expand(mr, LANE).contiguous().to(device))


def probe_ref(a: torch.Tensor, xh: torch.Tensor, xl: torch.Tensor,
              m_rows: int, variant: str) -> torch.Tensor:
    """Plain PyTorch version: every block's term in float32 (exact
    products of bf16 values by 0/1), summed over blocks.  Returns
    (max(8, m_rows), 128) float32, rows m_rows.. zero."""
    blocks = a.view(-1, LANE, LANE)
    if variant == "dma":
        parts = blocks[:, :m_rows, :].float()
    elif variant in ("mxu1", "mxu2"):
        af = blocks.float()
        parts = xh[:m_rows].float() @ af
        if variant == "mxu2":
            parts = parts + xl[:m_rows].float() @ af
    else:
        raise ValueError(f"unknown variant {variant!r}")
    out = torch.zeros((max(8, m_rows), LANE), dtype=torch.float32,
                      device=a.device)
    out[:m_rows] = parts.sum(dim=0)
    return out


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ctas(n_blocks: int, u: int, max_ctas: int) -> tuple[int, int]:
    """(per_cta, n_cta): CTA i takes blocks [i*per_cta, (i+1)*per_cta),
    a contiguous run of whole groups of u blocks, with at most
    ``max_ctas`` CTAs (the probe's: CTAS_PER_SM an SM); every CTA has at
    least one group."""
    n_groups = n_blocks // u
    per_cta = -(-n_groups // max_ctas) * u
    return per_cta, -(-n_blocks // per_cta)


def _check_args(a, xh, xl, m_rows: int, variant: str, u: int) -> int:
    """The checks of the CUDA path; returns the block count."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    mr = max(8, m_rows)
    n_blocks = a.shape[0] // LANE
    if not 1 <= m_rows <= 16:
        raise ValueError(f"m_rows must be in 1..16, got {m_rows}")
    if (a.dtype != torch.bfloat16 or a.dim() != 2 or a.shape[1] != LANE
            or a.shape[0] % LANE or n_blocks == 0 or n_blocks % u
            or not a.is_contiguous()):
        raise ValueError(f"a must be contiguous bf16 (B*128, 128) with B "
                         f"a multiple of u={u}, got {a.dtype} "
                         f"{tuple(a.shape)}")
    if a.data_ptr() % 16 or n_blocks * LANE >= 2**31:
        raise ValueError("a must be 16-byte aligned (TMA) with fewer than "
                         "2^24 blocks")
    for name, x in (("xh", xh), ("xl", xl)):
        if (x.dtype != torch.bfloat16 or x.shape != (mr, LANE)
                or x.device != a.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous bf16 ({mr}, {LANE}) "
                             f"on {a.device}")
    return n_blocks


def _launch(lib, a, xh, xl, m_rows: int, variant: str, u: int,
            ctas_per_sm: int) -> torch.Tensor:
    """One probe through ``lib``'s ``tlt_mxu_probe`` (checked args), at
    most ``ctas_per_sm`` CTAs an SM."""
    n_blocks = _check_args(a, xh, xl, m_rows, variant, u)
    per_cta, n_cta = _ctas(n_blocks, u, ctas_per_sm * _sm_count(a.device))
    partial = torch.empty((n_cta, 16, LANE), dtype=torch.float32,
                          device=a.device)
    out = torch.empty((max(8, m_rows), LANE), dtype=torch.float32,
                      device=a.device)
    err = lib.tlt_mxu_probe(
        a.data_ptr(), xh.data_ptr(), xl.data_ptr(), partial.data_ptr(),
        out.data_ptr(), n_blocks, per_cta, n_cta, m_rows, out.shape[0],
        VARIANTS.index(variant),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mxu probe kernel launch failed: CUDA error {err}")
    return out


def probe(a: torch.Tensor, xh: torch.Tensor, xl: torch.Tensor, m_rows: int,
          variant: str, u: int = 1) -> torch.Tensor:
    """The probe over every block of ``a``: the CUDA kernel on CUDA
    tensors (each CTA a contiguous run of whole groups of ``u`` blocks,
    its partial summed in a fixed order by a second launch), the plain
    version on CPU tensors.  m_rows <= 16 (one mma tile of rows).
    Launches on the current stream without syncing."""
    global launches_mxu
    if a.device.type == "cpu":
        return probe_ref(a, xh, xl, m_rows, variant)
    if a.device.type != "cuda":
        raise ValueError(f"no probe for device {a.device}")
    from tpu_lanczos_torch.kernels import _build

    out = _launch(_build.library(), a, xh, xl, m_rows, variant, u,
                  CTAS_PER_SM)
    launches_mxu += 1
    return out


def rel_err(got: torch.Tensor, want: torch.Tensor, m_rows: int) -> float:
    """The reference's bar (mxu_probe.py:160-163): max over rows :m_rows
    of |got - want| / (|want| + 1e-30)."""
    g = got[:m_rows].double().cpu()
    w = want[:m_rows].double().cpu()
    return float(((g - w).abs() / (w.abs() + 1e-30)).max())


def scaled_err(got: torch.Tensor, want: torch.Tensor, m_rows: int) -> float:
    """max over rows :m_rows of |got - want|, over max |want|."""
    g = got[:m_rows].double().cpu()
    w = want[:m_rows].double().cpu()
    return float((g - w).abs().max() / w.abs().max())


def check(a: torch.Tensor, xh: torch.Tensor, xl: torch.Tensor,
          m_rows: int) -> dict:
    """The kernel against the plain version on the first 8 blocks, every
    variant: dma exactly equal (integer sums), mxu1 and mxu2 within rel
    1e-5.  Raises on a miss; returns each variant's rel error."""
    a_s = a[: CHECK_BLOCKS * LANE]
    errs = {}
    for variant in VARIANTS:
        got = probe(a_s, xh, xl, m_rows, variant, u=CHECK_U)
        want = probe_ref(a_s, xh, xl, m_rows, variant)
        errs[variant] = rel_err(got, want, m_rows)
        ok = (torch.equal(got[:m_rows], want[:m_rows]) if variant == "dma"
              else errs[variant] < 1e-5)
        if not ok:
            raise RuntimeError(f"mxu probe {variant}: kernel vs plain rel "
                               f"err {errs[variant]:.3e}")
    return errs


def time_fn(fn, reps: int, calls: int = CALLS_PER_SAMPLE) -> list[float]:
    """Seconds per call of fn, CUDA events: ``reps`` samples after one
    warm run, each over ``calls`` calls back to back, so that the host's
    time to enqueue a call overlaps the card's work on the one before."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) * 1e-3 / calls)
    return samples


def time_variant(a, xh, xl, m_rows: int, variant: str, u: int,
                 reps: int) -> list[float]:
    """Seconds per probe call (``time_fn``)."""
    return time_fn(lambda: probe(a, xh, xl, m_rows, variant, u), reps)


def device_ms(fn) -> dict:
    """Device ms of each CUDA kernel launched by one profiled call of fn
    (torch.profiler), by the kernel's name."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    return out


def kernel_ms(fn) -> dict:
    """Device ms of each of the probe's two kernels in one profiled call
    of fn, by their short names (KERNELS)."""
    out = {}
    for full, ms in device_ms(fn).items():
        for name in KERNELS:
            if name in full:
                out[name] = out.get(name, 0.0) + ms
                break
    return out


def result_line(variant: str, blocks: int, u: int, m_rows: int,
                samples: list[float], kernels: dict | None = None,
                build: str = "package") -> dict:
    wall = float(np.median(samples))
    nbytes = blocks * BLOCK_BYTES
    return dict(
        study="mxu_block_probe", build=build, variant=variant,
        blocks=blocks, u=u, m_rows=m_rows,
        device=torch.cuda.get_device_name(0),
        wall_s=wall, wall_samples=samples, ns_per_block=wall * 1e9 / blocks,
        block_GBps=nbytes / wall / 1e9,
        bound_share=nbytes / HBM_BYTES_PER_S / wall,
        kernel_ms=kernels or {},
        note="streamed bf16 (128,128) blocks, x_row @ A_b on the tensor "
             "cores; dma = copy-only baseline; mxu2 = hi/lo split; "
             "kernel_ms: device time of each launch in one profiled call")


def compare_builds(sources: dict, a, xh, xl, m_rows: int, u: int,
                   reps: int) -> int:
    """Every variant of the package's build and of each other source
    (name -> (path, CTAs an SM)), checked against the plain version and
    timed in turns; one JSON line a build and variant.  Returns 0 if
    every build agreed with the plain version (rel_err)."""
    import ctypes

    from tpu_lanczos_torch.eval.cpg_variants import build, lib_path
    from tpu_lanczos_torch.kernels import _build

    builds = dict(package=(os.path.join(_build.CSRC_DIR, "mxu_probe.cu"),
                           CTAS_PER_SM), **sources)
    ptxas = build({name: path for name, (path, _) in builds.items()},
                  prefix="probe")
    ctas = {name: k for name, (_, k) in builds.items()}
    libs = {}
    for name in builds:
        lib = ctypes.CDLL(lib_path(name, "probe"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tlt_mxu_probe.restype = i
        lib.tlt_mxu_probe.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        libs[name] = lib
    blocks = a.shape[0] // LANE
    rows, ok = {}, True
    for name, lib in libs.items():
        k = ctas[name]
        for v in VARIANTS:
            got = _launch(lib, a, xh, xl, m_rows, v, u, k)
            want = probe_ref(a, xh, xl, m_rows, v)
            err = rel_err(got, want, m_rows)
            equal = (torch.equal(got[:m_rows], want[:m_rows]) if v == "dma"
                     else err < 1e-5)
            ok = ok and equal
            rows[name, v] = dict(ctas_per_sm=k, ptxas=ptxas[name],
                                 rel_err=err,
                                 scaled_err=scaled_err(got, want, m_rows),
                                 agrees=equal, samples=[])
    order = list(libs) + list(libs)[::-1]
    for name in order:
        k = ctas[name]
        for v in VARIANTS:
            fn = (lambda lib=libs[name], v=v:
                  _launch(lib, a, xh, xl, m_rows, v, u, k))
            rows[name, v]["samples"] += time_fn(fn, reps)
    for name, lib in libs.items():
        k = ctas[name]
        for v in VARIANTS:
            row = rows[name, v]
            kern = kernel_ms(lambda: _launch(lib, a, xh, xl, m_rows, v, u, k))
            line = result_line(v, blocks, u, m_rows, row.pop("samples"),
                               kern, build=name)
            print(json.dumps({**line, **row}), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="tensor-core dense-block probe (CUDA GPU)")
    ap.add_argument("--blocks", type=int, default=16384)
    ap.add_argument("--u", type=int, default=4)
    ap.add_argument("--m-rows", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check-only", action="store_true",
                    help="check the kernel against the plain version on "
                         "8 blocks, then stop")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH[@K] of another mxu_probe.cu to time "
                         "beside the package's build (K: the CTAs an SM "
                         "its own wrapper ran)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the mxu probe runs on a CUDA GPU and "
                           "torch.cuda.is_available() is False")
    blocks = (args.blocks // args.u) * args.u
    if blocks < CHECK_BLOCKS:
        raise ValueError(f"--blocks must give at least {CHECK_BLOCKS} blocks")
    a, xh, xl = make_data(args.blocks, args.u, args.m_rows)
    if args.source:
        sources = {}
        for item in args.source:
            name, spec = item.split("=", 1)
            path, _, k = spec.partition("@")
            sources[name] = (os.path.abspath(path), int(k or CTAS_PER_SM))
        return compare_builds(sources, a, xh, xl, args.m_rows, args.u,
                              args.reps)
    errs = check(a, xh, xl, args.m_rows)
    print(f"kernel vs plain on {CHECK_BLOCKS} blocks: "
          + ", ".join(f"{v} rel err {e:.2e}" for v, e in errs.items()),
          file=sys.stderr)
    if args.check_only:
        return 0
    for variant in VARIANTS:
        samples = time_variant(a, xh, xl, args.m_rows, variant, args.u,
                               args.reps)
        kern = kernel_ms(lambda: probe(a, xh, xl, args.m_rows, variant,
                                       args.u))
        print(json.dumps(result_line(variant, blocks, args.u, args.m_rows,
                                     samples, kern)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
