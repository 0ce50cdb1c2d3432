"""spmv_roofline_pct: the bytes a float32 SpMV of the graph needs,
counted from its CSR (``harness/roofline.py``), over the card's peak
bandwidth, over the device time of the program's public SpMV,
``kernels/spmv.py::spmv(dg, x)``, on the cell's pack."""

from lanczos_bench.harness import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "SpMV kernels", "query_ms"


def read(run):
    if run.traffic["precision"] != "float32":
        return None
    from tpu_lanczos_torch.kernels.spmv import spmv

    dg = run.dg
    x = dg.realmask.reshape(-1).clone()
    ms = run.device_ms(lambda: spmv(dg, x))
    if ms is None:
        return None
    nbytes = roofline.csr_spmv_bytes(run.n, run.nnz, vectors=1)
    return roofline.roofline_pct(nbytes, ms * 1e-3, run.device_name)
