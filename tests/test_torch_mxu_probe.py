"""The dense-block probe's plain version against the reference's Pallas
kernel in interpret mode (``tpu_lanczos.eval.mxu_probe._run(...,
interpret=True)``) on the reference's self-check slice: 8 blocks, u=2,
m_rows=8, every variant, on the same data from ``default_rng(7)``.

Bars: the bf16 inputs bit-identical (torch's and ml_dtypes'
round-to-nearest-even agree); dma exactly equal (sums of 0/1 are exact);
mxu1 and mxu2 within 1e-5 element-wise relative, the reference's own bar
(mxu_probe.py:160-163), as both sum float32 products in their own order.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_lanczos.eval import mxu_probe as ref_probe
from tpu_lanczos_torch.eval import mxu_probe

BLOCKS, U, M_ROWS = 8, 2, 8


@pytest.fixture(scope="module")
def data():
    """The port's inputs and the reference's, drawn as its main() does."""
    a, xh, xl = mxu_probe.make_data(BLOCKS, U, M_ROWS, device="cpu")
    rng = np.random.default_rng(7)
    a_np = (rng.random((BLOCKS * 128, 128)) < 0.05).astype(np.float32)
    x_np = rng.standard_normal(128).astype(np.float32)
    bf16 = ml_dtypes.bfloat16
    xh_np = x_np.astype(bf16)
    xl_np = (x_np - xh_np.astype(np.float32)).astype(bf16)
    ref_args = (jnp.asarray(a_np.astype(bf16)),
                jnp.broadcast_to(jnp.asarray(xh_np), (M_ROWS, 128)),
                jnp.broadcast_to(jnp.asarray(xl_np), (M_ROWS, 128)))
    return (a, xh, xl), ref_args, (a_np, xh_np, xl_np)


def test_inputs_equal_reference(data):
    (a, xh, xl), _, (a_np, xh_np, xl_np) = data
    np.testing.assert_array_equal(a.float().numpy(), a_np)
    for got, want in ((xh, xh_np), (xl, xl_np)):
        assert got.shape == (M_ROWS, 128)
        for row in got:
            np.testing.assert_array_equal(row.view(torch.int16).numpy(),
                                          want.view(np.int16))


@pytest.mark.parametrize("variant", ["dma", "mxu1", "mxu2"])
def test_plain_version_matches_pallas(data, variant):
    port_args, ref_args, _ = data
    want = np.asarray(ref_probe._run(*ref_args, U, BLOCKS // U, M_ROWS,
                                     variant, interpret=True))
    got = mxu_probe.probe(*port_args, M_ROWS, variant, u=U)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if variant == "dma":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert mxu_probe.rel_err(got, torch.tensor(want), M_ROWS) < 1e-5


def test_check_and_refusals(data, monkeypatch):
    """On the CPU ``probe`` is the plain version, so ``check`` passes with
    exact agreement; another device raises; the entry point refuses to
    run without a GPU."""
    a, xh, xl = data[0]
    before = mxu_probe.launches_mxu
    errs = mxu_probe.check(a, xh, xl, M_ROWS)
    assert errs == {"dma": 0.0, "mxu1": 0.0, "mxu2": 0.0}
    assert mxu_probe.launches_mxu == before  # the CPU runs no kernel
    with pytest.raises(ValueError, match="no probe"):
        mxu_probe.probe(a.to("meta"), xh, xl, M_ROWS, "mxu1")
    with pytest.raises(ValueError, match="unknown variant"):
        mxu_probe.probe_ref(a, xh, xl, M_ROWS, "mxu3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        mxu_probe.main(["--check-only"])


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("n_blocks,u", [(8, 2), (16384, 4), (20, 4), (7, 1),
                                        (10, 2), (1001, 1), (264, 4)])
def test_cta_partition(n_blocks, u, sms):
    """The probe's CTA partition at a stubbed SM count: CTA i takes
    blocks [i*per_cta, (i+1)*per_cta) cut at n_blocks; every CTA holds
    whole groups of u blocks, at least one; every block is taken exactly
    once, in order; at most CTAS_PER_SM CTAs an SM."""
    per_cta, n_cta = mxu_probe._ctas(n_blocks, u,
                                     mxu_probe.CTAS_PER_SM * sms)
    assert per_cta % u == 0 and n_cta <= mxu_probe.CTAS_PER_SM * sms
    runs = [range(i * per_cta, min(n_blocks, (i + 1) * per_cta))
            for i in range(n_cta)]
    assert all(len(r) > 0 and len(r) % u == 0 for r in runs)
    assert [b for r in runs for b in r] == list(range(n_blocks))


def test_cuda_path_argument_checks(data, monkeypatch):
    """What the CUDA path checks before it passes pointers, on CPU
    tensors: the unaltered inputs pass; m_rows outside 1..16, a block
    count that is not a multiple of u, a misaligned a (TMA) and x of the
    wrong shape or type raise."""
    a, xh, xl = data[0]
    assert mxu_probe._check_args(a, xh, xl, M_ROWS, "mxu2", U) == BLOCKS
    raw = torch.empty(a.numel() * 2 + 16, dtype=torch.uint8)
    off = (-raw.data_ptr()) % 16 + 2
    a_mis = raw[off:off + a.numel() * 2].view(torch.bfloat16).view(a.shape)
    a_mis.copy_(a)
    bad = [(a, xh, xl, 0, "dma", U), (a, xh, xl, 17, "dma", U),
           (a, xh, xl, M_ROWS, "dma", 3), (a_mis, xh, xl, M_ROWS, "dma", U),
           (a, xh[:4], xl, M_ROWS, "mxu1", U),
           (a, xh, xl.float(), M_ROWS, "mxu2", U),
           (a.float(), xh, xl, M_ROWS, "dma", U),
           (a, xh, xl, M_ROWS, "mxu3", U)]
    for args in bad:
        with pytest.raises(ValueError):
            mxu_probe._check_args(*args)
