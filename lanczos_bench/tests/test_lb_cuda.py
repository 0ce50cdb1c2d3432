"""The cells' traffic through the harness on the card, at a small size:
correct, every metric read, the trace's busy time and breakdown.  Run on
a machine with a card:

    python -m pytest lanczos_bench/tests/test_lb_cuda.py -q
"""

import pytest

from lanczos_bench.harness.cell import run_cell
from lanczos_bench.tests.helpers import small_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", ["ba1M.topk20.f32", "ba1M.expm.df64"])
def test_cell_on_the_card(card, workload, trace):
    cell = small_cell(workload, warmup=1)
    out = run_cell(cell, 2**31 + 5, 0.5, trace)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(out["metrics"]) == {m.name for m in wanted}
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"]
