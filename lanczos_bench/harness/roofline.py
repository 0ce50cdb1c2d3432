"""The yardstick of the SpMV rooflines: the bytes an SpMV of the graph
needs, counted from its value-free CSR (not from any pack of the
program, so a change of format cannot move it), and the cards' peaks.

Bytes of one y = A x with ``vectors`` value streams (1 for float32, 2 for
a (hi, lo) df64 pair): ``nnz`` int32 column indices, ``n + 1`` int32 row
offsets, each of x's streams read once and each of y's written once.
"""

from __future__ import annotations

INDEX_BYTES = 4

# HBM bandwidth of each card (NVIDIA's data sheets), by
# torch.cuda.get_device_name(); a card not listed has no roofline
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # SXM5
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def csr_spmv_bytes(n: int, nnz: int, vectors: int = 1,
                   value_bytes: int = 4) -> int:
    return (nnz + n + 1) * INDEX_BYTES + 2 * vectors * n * value_bytes


def roofline_pct(nbytes: int, seconds: float, device_name: str):
    """The share of the card's bandwidth bound, in %, or None where the
    card's peak is unknown or nothing was timed."""
    peak = PEAK_BYTES_PER_S.get(device_name)
    if peak is None or not seconds or seconds <= 0:
        return None
    return 100.0 * nbytes / peak / seconds
