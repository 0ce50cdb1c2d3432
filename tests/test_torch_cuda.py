"""The CUDA SpMV kernels against their plain PyTorch versions on the card,
and the f32 and df64 pipelines on CUDA against the float64 oracle.

Marked ``cuda``: each test skips (with its reason) where no CUDA device
is present, and runs on a GPU machine with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

This file imports only the port, and ``--noconftest`` skips
tests/conftest.py, which imports jax (the GPU machine has none).
"""

import numpy as np
import pytest
import torch

from tpu_lanczos_torch import expm_action, expm_action_df, generators
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


@pytest.mark.parametrize("sub", [128, 256, 512])
def test_comp_kernel_equals_plain_version(dev, sub):
    """Every level of one df SpMV, fed the inputs spmv_cpg_df gives it,
    through the compensated kernel and its plain version: equal acc and
    err; the whole df SpMV equal to spmv_cpg_df_ref."""
    g = generators.barabasi_albert(40000, 6, seed=3)
    cg = cpg.pack_cpg(g, sub=sub, device=dev)
    x64 = cg.permute_in(np.random.default_rng(1).standard_normal(g.n),
                        np.float64)
    hi = torch.from_numpy(x64.astype(np.float32)).to(dev)
    lo = torch.from_numpy((x64 - x64.astype(np.float32)).astype(
        np.float32)).to(dev)

    def checked_comp(x2d, level, n_chunks, sub_):
        acc, err = spmv_cpg.run_level_comp(x2d, level, n_chunks, sub_)
        acc_ref, err_ref = spmv_cpg.run_level_comp_ref(x2d, level, n_chunks,
                                                       sub_)
        assert torch.equal(acc, acc_ref) and torch.equal(err, err_ref)
        return acc, err

    before = spmv_cpg.launches_comp
    yh, yl = spmv_cpg._spmv_df(cg, hi, lo, spmv_cpg.run_level, checked_comp)
    torch.cuda.synchronize()
    assert spmv_cpg.launches_comp - before == len(cg.levels) - cg.n_bcast
    h, l = spmv_cpg.spmv_cpg_df_ref(cg, hi, lo)
    assert torch.equal(yh, h) and torch.equal(yl, l)


def test_df64_on_cuda_matches_oracle(dev):
    g = generators.barabasi_albert(2000, 8, seed=2)
    res = expm_action_df(g, k=30, device=dev)
    want = oracle.expm_action(g, np.ones(g.n), 30)
    assert oracle.rel_error(res.ans, want) < 1e-12
