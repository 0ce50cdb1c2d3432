"""One CPG level: the port's plain version (run_level_ref, what the CUDA
kernel is held to on the card) against the reference Pallas kernel in
interpret mode, on the same pack and input, bit for bit.

Bar: exact equality.  Both sum each dest cell's tile values from 0 in
tile order, and a ghost cell adds an exact 0, so no rounding differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos.kernels.spmv_cpg import _run_level
from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.cpg import LANE

from _torch_cases import PACK_CASES, port_pack, untranspose


@pytest.fixture(scope="module", params=list(PACK_CASES))
def packs(request):
    build, sub = PACK_CASES[request.param]
    g = build()
    ref = ref_cpg.pack_cpg(g, sub=sub)
    return ref, port_pack(ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_run_level_ref_bit_identical_to_pallas(packs, dtype):
    ref, port = packs
    rng = np.random.default_rng(0)
    for i, (lv_r, lv_p) in enumerate(zip(ref.levels, port.levels)):
        x2d = ref.permute_in(rng.standard_normal(ref.n), dtype).reshape(
            -1, LANE)
        want = untranspose(np.asarray(_run_level(
            jnp.asarray(x2d), lv_r, ref.n_chunks, ref.sub, True,
            t_real=ref.t_reals[i], sparse_dispatch=ref.mask_sparse[i])),
            ref.n_chunks, ref.sub)
        xt = torch.from_numpy(x2d)
        got = spmv_cpg.run_level_ref(xt, lv_p, port.n_chunks, port.sub)
        assert got.dtype == xt.dtype and got.shape == xt.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"lv{i}")
        # base is added after the tile sum, as the reference adds it
        base = spmv_cpg.run_level_ref(xt, lv_p, port.n_chunks, port.sub,
                                      base=xt)
        np.testing.assert_array_equal(base.numpy(), x2d + want)


def test_run_level_on_cpu_is_the_plain_version(packs):
    _, port = packs
    x2d = torch.from_numpy(port.permute_in(
        np.random.default_rng(4).standard_normal(port.n),
        np.float32)).reshape(-1, LANE)
    before = spmv_cpg.launches
    for lv in port.levels:
        assert torch.equal(
            spmv_cpg.run_level(x2d, lv, port.n_chunks, port.sub),
            spmv_cpg.run_level_ref(x2d, lv, port.n_chunks, port.sub))
    assert spmv_cpg.launches == before  # CPU: no kernel launch counted
