"""The CSR-byte count, the rooflines and the trace's interval
arithmetic, on hand-made cases."""

import pytest

from lanczos_bench.harness import roofline, trace


def test_csr_bytes():
    # 3 nodes, 4 nonzeros: 4 + 4 int32 indices and offsets, x and y once
    assert roofline.csr_spmv_bytes(3, 4) == 4 * 4 + 4 * 4 + 2 * 3 * 4
    assert roofline.csr_spmv_bytes(3, 4, vectors=2) == 32 + 2 * 2 * 3 * 4
    # bn1M: 92.0 MB (f32), 100.0 MB (df64)
    assert roofline.csr_spmv_bytes(1_000_000, 19_999_890) == 91_999_564
    assert roofline.csr_spmv_bytes(1_000_000, 19_999_890, 2) == 99_999_564


def test_roofline_pct():
    card = "NVIDIA H100 80GB HBM3"
    assert roofline.roofline_pct(3.35e9, 2e-3, card) == pytest.approx(50.0)
    assert roofline.roofline_pct(1, 1.0, "some other card") is None
    assert roofline.roofline_pct(1, 0.0, card) is None


def test_union_and_gaps():
    iv = [(5, 7), (0, 2), (1, 3), (6, 6.5), (10, 12)]
    assert trace.union(iv) == [(0, 3), (5, 7), (10, 12)]
    assert trace.union_length(iv) == 7
    assert trace.gaps(iv, -1, 13) == [(-1, 0), (3, 5), (7, 10), (12, 13)]
    assert trace.gaps(iv, 1, 11) == [(3, 5), (7, 10)]
    assert trace.gaps([], 0, 4) == [(0, 4)]
    assert trace.union_length([]) == 0


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize():
    q = trace.QUERY_SPAN
    events = [
        _x("user_annotation", q, 0, 50), _x("user_annotation", q, 60, 40),
        _x("kernel", "level", 5, 20), _x("kernel", "level", 20, 10),
        _x("kernel", "step", 70, 10), _x("gpu_memcpy", "Memcpy DtoH", 90, 5),
        _x("kernel", "outside", 200, 10),
        _x("cpu_op", "aten::item", 30, 30), _x("cpu_op", "aten::mm", 40, 5),
        _x("cuda_runtime", "cudaStreamSynchronize", 81, 8),
    ]
    s = trace.summarize(events)
    assert s.queries == 2 and s.kernels == 3
    assert s.window_s == pytest.approx(100e-6)
    # busy: [5, 30) + [70, 80) + [90, 95)
    assert s.busy_s == pytest.approx(40e-6)
    assert s.idle_pct == pytest.approx(60.0)
    assert s.device_ops[0] == ["level", pytest.approx(30e-6)]  # summed
    idle = dict(s.idle_gaps)
    # [0, 5) outside any op; [30, 70) midpoint 50 in aten::item (the mm
    # ended at 45); [80, 90) in the synchronize; [95, 100) outside
    assert idle["aten::item"] == pytest.approx(40e-6)
    assert idle["cudaStreamSynchronize"] == pytest.approx(10e-6)
    assert idle["host outside any traced op"] == pytest.approx(10e-6)
    with pytest.raises(ValueError):
        trace.summarize([_x("kernel", "k", 0, 1)])
