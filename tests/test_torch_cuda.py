"""The CUDA SpMV kernel against its plain PyTorch version on the card.

Marked ``cuda``: each test skips (with its reason) where no CUDA device
is present, and runs on a GPU machine with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

This file imports only the port, and ``--noconftest`` skips
tests/conftest.py, which imports jax (the GPU machine has none).
"""

import numpy as np
import pytest
import torch

from tpu_lanczos_torch import expm_action, generators
from tpu_lanczos_torch.kernels import cpg, spmv_cpg
from tpu_lanczos_torch.eval import oracle

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("sub", [128, 256, 512])
def test_kernel_equals_plain_version(dev, sub):
    g = generators.barabasi_albert(40000, 6, seed=3)
    cg = cpg.pack_cpg(g, sub=sub, device=dev)
    x = torch.from_numpy(cg.permute_in(
        np.random.default_rng(0).standard_normal(g.n), np.float32)).to(dev)
    before = spmv_cpg.launches
    y = spmv_cpg.spmv_cpg(cg, x)
    torch.cuda.synchronize()
    assert spmv_cpg.launches - before == len(cg.levels)
    assert torch.equal(y, spmv_cpg.spmv_cpg_ref(cg, x))


def test_pipeline_on_cuda_matches_oracle(dev):
    g = generators.barabasi_albert(2000, 8, seed=2)
    res = expm_action(g, k=30, dtype="float64", device=dev)
    want = oracle.expm_action(g, np.ones(g.n), 30)
    assert oracle.rel_error(res.ans, want) < 1e-12
