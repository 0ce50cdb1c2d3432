"""spmv_df_roofline_pct: as ``spmv_roofline_pct`` for the df64 SpMV,
``spmv_cpg_df(dg, x_hi, x_lo)``: two value streams in and two out."""

from lanczos_bench.harness import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "SpMV kernels", "query_ms.df64"


def read(run):
    if run.traffic["precision"] != "df64":
        return None
    import torch
    from tpu_lanczos_torch.kernels.spmv_cpg import spmv_cpg_df

    dg = run.dg
    hi = dg.realmask.reshape(-1).to(torch.float32)
    lo = torch.full_like(hi, 2.0 ** -30) * hi
    ms = run.device_ms(lambda: spmv_cpg_df(dg, hi, lo))
    if ms is None:
        return None
    nbytes = roofline.csr_spmv_bytes(run.n, run.nnz, vectors=2)
    return roofline.roofline_pct(nbytes, ms * 1e-3, run.device_name)
