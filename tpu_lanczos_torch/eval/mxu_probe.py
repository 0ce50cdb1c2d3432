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

runs on the CUDA GPU (and raises without one): first the kernel against
the plain version on 8 blocks for every variant (``--check-only`` stops
there), then each variant timed with CUDA events at ``--blocks``,
printed as one JSON line with its wall time, ns per block, block GB/s and
share of the 3.35 TB/s bound.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

LANE = 128
VARIANTS = ("dma", "mxu1", "mxu2")
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published HBM rate
BLOCK_BYTES = LANE * LANE * 2
CHECK_BLOCKS, CHECK_U = 8, 2  # the reference's self-check slice
CTAS_PER_SM = 3  # 72 KB of shared memory per CTA: three fit on one SM

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


def _ctas(a: torch.Tensor, n_blocks: int, u: int) -> tuple[int, int]:
    """(per_cta, n_cta): each CTA takes a contiguous run of whole groups
    of u blocks, about CTAS_PER_SM CTAs per SM."""
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    n_groups = n_blocks // u
    groups = -(-n_groups // (CTAS_PER_SM * sms))
    per_cta = groups * u
    return per_cta, -(-n_blocks // per_cta)


def probe(a: torch.Tensor, xh: torch.Tensor, xl: torch.Tensor, m_rows: int,
          variant: str, u: int = 1) -> torch.Tensor:
    """The probe over every block of ``a``: the CUDA kernel on CUDA
    tensors (each CTA a contiguous run of whole groups of ``u`` blocks,
    its partial summed in CTA order by a second launch), the plain
    version on CPU tensors.  m_rows <= 16 (one wmma tile of rows).
    Launches on the current stream without syncing."""
    global launches_mxu
    if a.device.type == "cpu":
        return probe_ref(a, xh, xl, m_rows, variant)
    if a.device.type != "cuda":
        raise ValueError(f"no probe for device {a.device}")
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
    for name, x in (("xh", xh), ("xl", xl)):
        if (x.dtype != torch.bfloat16 or x.shape != (mr, LANE)
                or x.device != a.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous bf16 ({mr}, {LANE}) "
                             f"on {a.device}")
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    per_cta, n_cta = _ctas(a, n_blocks, u)
    partial = torch.empty((n_cta, 16, LANE), dtype=torch.float32,
                          device=a.device)
    out = torch.empty((mr, LANE), dtype=torch.float32, device=a.device)
    err = lib.tlt_mxu_probe(
        a.data_ptr(), xh.data_ptr(), xl.data_ptr(), partial.data_ptr(),
        out.data_ptr(), n_blocks, per_cta, n_cta, m_rows, mr,
        VARIANTS.index(variant),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mxu probe kernel launch failed: CUDA error {err}")
    launches_mxu += 1
    return out


def rel_err(got: torch.Tensor, want: torch.Tensor, m_rows: int) -> float:
    """The reference's bar (mxu_probe.py:160-163): max over rows :m_rows
    of |got - want| / (|want| + 1e-30)."""
    g = got[:m_rows].double().cpu()
    w = want[:m_rows].double().cpu()
    return float(((g - w).abs() / (w.abs() + 1e-30)).max())


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


def time_variant(a, xh, xl, m_rows: int, variant: str, u: int,
                 reps: int) -> list[float]:
    """Seconds per probe call, CUDA events, ``reps`` runs after one warm
    run."""
    probe(a, xh, xl, m_rows, variant, u)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        probe(a, xh, xl, m_rows, variant, u)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) * 1e-3)
    return samples


def result_line(variant: str, blocks: int, u: int, m_rows: int,
                samples: list[float]) -> dict:
    wall = float(np.median(samples))
    nbytes = blocks * BLOCK_BYTES
    return dict(
        study="mxu_block_probe", variant=variant, blocks=blocks, u=u,
        m_rows=m_rows, device=torch.cuda.get_device_name(0),
        wall_s=wall, wall_samples=samples, ns_per_block=wall * 1e9 / blocks,
        block_GBps=nbytes / wall / 1e9,
        bound_share=nbytes / HBM_BYTES_PER_S / wall,
        note="streamed bf16 (128,128) blocks, x_row @ A_b on the tensor "
             "cores; dma = copy-only baseline; mxu2 = hi/lo split")


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the mxu probe runs on a CUDA GPU and "
                           "torch.cuda.is_available() is False")
    blocks = (args.blocks // args.u) * args.u
    if blocks < CHECK_BLOCKS:
        raise ValueError(f"--blocks must give at least {CHECK_BLOCKS} blocks")
    a, xh, xl = make_data(args.blocks, args.u, args.m_rows)
    errs = check(a, xh, xl, args.m_rows)
    print(f"kernel vs plain on {CHECK_BLOCKS} blocks: "
          + ", ".join(f"{v} rel err {e:.2e}" for v, e in errs.items()),
          file=sys.stderr)
    if args.check_only:
        return 0
    for variant in VARIANTS:
        samples = time_variant(a, xh, xl, args.m_rows, variant, args.u,
                               args.reps)
        print(json.dumps(result_line(variant, blocks, args.u, args.m_rows,
                                     samples)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
