"""The whole CPG SpMV (broadcast, main and reduce levels, realmask) of the
port against the reference's ``spmv_cpg(cg, x, interpret=True)`` on the
same pack, bit for bit, and against scipy in float64 within 1e-11 (the
reference's own bar, tests/test_cpg.py:38).  Plus the wrapper's argument
checks and the format dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos.kernels.spmv_cpg import spmv_cpg as ref_spmv_cpg
from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.cpg import LANE
from tpu_lanczos_torch.kernels.spmv import spmv

from _torch_cases import PACK_CASES, port_pack


@pytest.fixture(scope="module", params=list(PACK_CASES))
def case(request):
    build, sub = PACK_CASES[request.param]
    g = build()
    ref = ref_cpg.pack_cpg(g, sub=sub)
    return g, ref, port_pack(ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_cpg_bit_identical_to_reference(case, dtype):
    g, ref, port = case
    xp = ref.permute_in(np.random.default_rng(1).standard_normal(g.n), dtype)
    want = np.asarray(ref_spmv_cpg(ref, jnp.asarray(xp), interpret=True))
    got = spmv(port, torch.from_numpy(xp))
    assert got.dtype == torch.from_numpy(xp).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_spmv_cpg_matches_scipy_f64(case):
    g, _, port = case
    xr = np.random.default_rng(2).standard_normal(g.n)
    x = torch.from_numpy(port.permute_in(xr, np.float64))
    x_before = x.clone()
    got = port.permute_out(spmv_cpg.spmv_cpg(port, x))
    np.testing.assert_allclose(got, g.to_scipy() @ xr, rtol=1e-11,
                               atol=1e-11)
    # the broadcast level must not write into the caller's x (lanczos
    # has already stored it in q_basis)
    assert torch.equal(x, x_before)
    # ghost and padding positions of y stay zero
    y = spmv_cpg.spmv_cpg_ref(port, x).numpy()
    assert not y[port.realmask.numpy() == 0].any()


def _level_args(port, dtype=torch.float32):
    x2d = torch.zeros((port.n_sub, LANE), dtype=dtype)
    return x2d, dict(port.levels[0]), port.n_chunks, port.sub


@pytest.mark.parametrize("bad", [
    "x_dtype", "x_shape", "x_stride", "l2_dtype", "l1_shape",
    "counts_dtype", "base_shape",
])
def test_kernel_wrapper_rejects_bad_arguments(case, bad):
    """What the CUDA wrapper checks before passing pointers (the check
    itself runs on any device)."""
    _, _, port = case
    x2d, level, C, sub = _level_args(port)
    base = None
    if bad == "x_dtype":
        x2d = x2d.to(torch.float16)
    elif bad == "x_shape":
        x2d = x2d[:-1]
    elif bad == "x_stride":
        x2d = torch.zeros((LANE, port.n_sub)).t()
    elif bad == "l2_dtype":
        level["l2"] = level["l2"].to(torch.int32)
    elif bad == "l1_shape":
        level["l1"] = level["l1"][:-1]
    elif bad == "counts_dtype":
        level["counts"] = level["counts"].long()
    elif bad == "base_shape":
        base = x2d[:-1]
    with pytest.raises((TypeError, ValueError)):
        spmv_cpg._check(x2d, level, C, sub, base)


def test_kernel_wrapper_accepts_pack_arrays(case):
    _, _, port = case
    for dtype in (torch.float32, torch.float64):
        x2d, _, C, sub = _level_args(port, dtype)
        for level in port.levels:
            spmv_cpg._check(x2d, level, C, sub, x2d)


def test_spmv_rejects_unported_formats():
    class CSTGraph:
        pass

    with pytest.raises(NotImplementedError, match="queue 2 item 6"):
        spmv(CSTGraph(), torch.zeros(4))


def test_run_level_rejects_other_devices(case):
    _, _, port = case
    x2d, level, C, sub = _level_args(port)
    with pytest.raises(ValueError, match="no CPG SpMV"):
        spmv_cpg.run_level(x2d.to("meta"), level, C, sub)
