"""Single runtime configuration object.

A copy of ``tpu_lanczos/config.py`` (a plain dataclass; importing the
JAX package's module would import jax): the one flag surface consumed by
the port's CLI and by ``core.pipeline.run_config``.  The reference
scattered configuration over getopt flags, compile-time headers and
edit-the-source toggles (SURVEY.md section 5; parallel-final/lib/
helpers.cu:31-63, blocks.h:1, main.cu:111-115).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # algorithm
    krylov_dim: int = 50
    reorthogonalize: bool = False  # full-reorthog variant (ref: decompose_with_arnoldi)
    dtype: str = "float32"  # "float32" | "float64" (f64 = parity/accuracy runs)
    # overflow guard: return (vector, log_scale) instead of risking e^lambda
    # overflow in f32 (the reference's documented NaN hazard,
    # output/single_double.txt:27-31, writeup §9.3.1)
    log_scale_output: bool = False

    # device format selection for the sparse matrix; "best" is the CPG
    # format, "cst" the CST format (each its CUDA kernel on the GPU)
    fmt: str = "best"  # "best" | "auto" | "ell" | "coo" | "hyb" | "cpg" | "cst"
    # CPG pack parameters (kernels/cpg.py; None = auto)
    cpg_theta: int | None = None   # virtual-row split threshold
    cpg_sub: int | None = None     # chunk height in sublanes
    cpg_order: str = "auto"        # "auto" | "locality" | "degree"
    # source-split cap ("auto": = theta on power-law graphs, off on meshes)
    cpg_theta_s: int | str | None = "auto"
    # block-aware dealing (None = auto: on for power-law / "degree" order)
    cpg_redeal: bool | None = None
    # tile layout: "auto"/"classic" (chunk-pair tiles) | "slab"
    # (source-slab-pure tiles)
    cpg_layout: str = "auto"
    # ELL/COO/HYB parameters (kernels/formats.py)
    ell_pct: float = 98.0  # hybrid: ELL width percentile; rest spills to COO
    lane_tile: int = 128

    # distribution: row-shard over this many devices (0 = single device)
    shards: int = 0

    # graph source (CLI parity with reference getopt flags -f -k -n -e -b -v,
    # parallel-final/lib/helpers.cu:31-63)
    filename: str | None = None
    n: int = 10000
    edges: int = 30000
    barabasi_deg: int | None = None
    seed: int = 0
    verbose: bool = False

    @staticmethod
    def _norm_theta_s(v):
        if v in ("auto", None):
            return "auto" if v == "auto" else None
        if v == "off":
            return None
        return int(v)

    @staticmethod
    def _norm_redeal(v):
        if isinstance(v, bool) or v is None:
            return v
        return None if v == "auto" else v == "on"

    @classmethod
    def from_args(cls, args) -> "Config":
        """Build from the CLI's parsed argparse namespace."""
        return cls(
            krylov_dim=args.krylov,
            reorthogonalize=args.reorthogonalize,
            dtype=args.dtype,
            log_scale_output=args.log_scale,
            fmt=args.fmt,
            cpg_theta=getattr(args, "cpg_theta", None),
            cpg_sub=getattr(args, "cpg_sub", None),
            cpg_order=getattr(args, "cpg_order", "auto"),
            cpg_theta_s=cls._norm_theta_s(getattr(args, "cpg_theta_s", "auto")),
            cpg_redeal=cls._norm_redeal(getattr(args, "cpg_redeal", "auto")),
            cpg_layout=getattr(args, "cpg_layout", "auto"),
            ell_pct=getattr(args, "ell_pct", 98.0),
            shards=args.shards,
            filename=args.file,
            n=args.n,
            edges=args.edges,
            barabasi_deg=args.barabasi,
            seed=args.seed,
            verbose=args.verbose,
        )
