"""The CUDA SpMV kernels (classic and slab layout, plain and compensated)
against their plain PyTorch versions on the card, and the f32 and df64
pipelines on CUDA against the float64 oracle.

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

    def checked_comp(x2d, level, n_chunks, sub_, slab=False):
        acc, err = spmv_cpg.run_level_comp(x2d, level, n_chunks, sub_, slab)
        acc_ref, err_ref = spmv_cpg.run_level_comp_ref(x2d, level, n_chunks,
                                                       sub_, slab)
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


@pytest.mark.parametrize("sub", [128, 256, 512])
def test_slab_kernels_equal_plain_versions(dev, sub):
    """A slab pack of a graph with several slabs per chunk: every level
    of the f32 and f64 SpMV through the slab kernel, and of one df SpMV
    through the compensated slab kernel, equal to the plain versions on
    the same inputs; the launch counters advance by exactly the levels
    run; the f64 SpMV matches scipy."""
    g = generators.barabasi_albert(40000, 4, seed=1)
    cg = cpg.pack_cpg(g, sub=sub, layout="slab", device=dev)
    assert cg.layout == "slab"
    xr = np.random.default_rng(2).standard_normal(g.n)

    def checked_plain(x2d, level, n_chunks, sub_, base=None, slab=False):
        assert slab
        got = spmv_cpg.run_level(x2d, level, n_chunks, sub_, base, slab)
        assert torch.equal(got, spmv_cpg.run_level_ref(
            x2d, level, n_chunks, sub_, base, slab))
        return got

    def checked_comp(x2d, level, n_chunks, sub_, slab=False):
        assert slab
        got = spmv_cpg.run_level_comp(x2d, level, n_chunks, sub_, slab)
        want = spmv_cpg.run_level_comp_ref(x2d, level, n_chunks, sub_, slab)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return got

    L = len(cg.levels)
    before = (spmv_cpg.launches_slab, spmv_cpg.launches_comp_slab,
              spmv_cpg.launches, spmv_cpg.launches_comp)
    for np_dtype in (np.float32, np.float64):
        x = torch.from_numpy(cg.permute_in(xr, np_dtype)).to(dev)
        y = spmv_cpg._spmv(cg, x, checked_plain)
        if np_dtype == np.float64:
            np.testing.assert_allclose(cg.permute_out(y), g.to_scipy() @ xr,
                                       rtol=1e-11, atol=1e-11)
    x64 = cg.permute_in(xr, np.float64)
    hi = torch.from_numpy(x64.astype(np.float32)).to(dev)
    lo = torch.from_numpy((x64 - x64.astype(np.float32)).astype(
        np.float32)).to(dev)
    yh, yl = spmv_cpg._spmv_df(cg, hi, lo, checked_plain, checked_comp)
    torch.cuda.synchronize()
    after = (spmv_cpg.launches_slab, spmv_cpg.launches_comp_slab,
             spmv_cpg.launches, spmv_cpg.launches_comp)
    nb = cg.n_bcast
    assert after[0] - before[0] == 2 * L + (L + nb)
    assert after[1] - before[1] == L - nb
    assert after[2:] == before[2:]  # the classic counters do not move
    h, l = spmv_cpg.spmv_cpg_df_ref(cg, hi, lo)
    assert torch.equal(yh, h) and torch.equal(yl, l)


def test_serving_paths_on_cuda(dev):
    """The fused device-eigh summary gives the host path's top nodes; the
    pipelined answers equal sequential expm_action bit for bit; the COO
    format and reorthogonalization hold the f64 oracle."""
    from tpu_lanczos_torch import expm_action_pipelined, expm_action_summary

    g = generators.barabasi_albert(2000, 8, seed=2)
    s_h = expm_action_summary(g, k=30, topk=10, device=dev)
    s_d = expm_action_summary(g, k=30, topk=10, eig_impl="device",
                              device=dev)
    assert set(s_d.top_nodes) == set(s_h.top_nodes)
    np.testing.assert_allclose(
        s_d.top_values * np.exp(s_d.log_scale - s_h.log_scale),
        s_h.top_values, rtol=1e-4)
    cg = cpg.pack_cpg(g, device=dev)
    xs = [None, np.random.default_rng(0).standard_normal(g.n)]
    piped = expm_action_pipelined(g, xs, k=30, dg=cg)
    for x, got in zip(xs, piped):
        want = expm_action(g, x, k=30, dg=cg)
        np.testing.assert_array_equal(got.ans, want.ans)
    ref = oracle.expm_action(g, np.ones(g.n), 30)
    for kw in (dict(fmt="coo"), dict(reorthogonalize=True)):
        res = expm_action(g, k=30, dtype="float64", device=dev, **kw)
        assert oracle.rel_error(res.ans, ref) < 1e-12, kw
