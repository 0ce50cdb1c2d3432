"""The ELL / COO / HYB fallback formats of the port against the JAX
package's (tpu_lanczos.kernels.formats, kernels/spmv.py): the packs, the
SpMV and e^A.x through them, on the CPU.

Bars and why:
- packs: every array equal to the reference's (the same host packing);
- SpMV within 1e-12 (f64) of the reference's XLA SpMV and of scipy: the
  sums run in another order (torch's masked slot sum and sorted segment
  sum against XLA's), nothing else differs;
- e^A.x (f64, k=30) within 1e-10 of the float64 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.graphs import generators
from tpu_lanczos.kernels import formats as ref_formats
from tpu_lanczos.kernels.spmv import spmv_xla as ref_spmv_xla
from tpu_lanczos_torch import expm_action
from tpu_lanczos_torch.eval import oracle
from tpu_lanczos_torch.kernels import formats
from tpu_lanczos_torch.kernels.spmv import spmv

from _torch_cases import to_port_graph

GRAPHS = {
    # power-law: auto picks COO, hyb spills its hubs
    "ba3000": lambda: generators.barabasi_albert(3000, 6, seed=11,
                                                 use_native=False),
    # bounded degree: auto picks ELL
    "stencil": lambda: generators.stencil_2d(45),
}
FMTS = ["auto", "ell", "coo", "hyb"]


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    return GRAPHS[request.param]()


def _arrays(dg):
    out = {}
    for k in ("ell_indices", "ell_degrees", "coo_cols", "coo_rows"):
        v = getattr(dg, k)
        if v is not None:
            out[k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


@pytest.mark.parametrize("fmt", FMTS)
def test_pack_equals_reference(graph, fmt):
    ref = ref_formats.pack(graph, fmt)
    port = formats.pack(to_port_graph(graph), fmt, device="cpu")
    assert (port.fmt, port.n, port.n_pad, port.nnz) == (
        ref.fmt, ref.n, ref.n_pad, ref.nnz)
    want, got = _arrays(ref), _arrays(port)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if port.coo_rows is not None:  # the segment offsets bracket each row
        rows = port.coo_rows.numpy()
        off = port.coo_offsets.numpy()
        assert off[-1] == rows.size and np.all(np.diff(off) >= 0)
        for r in (0, port.n - 1, port.n_pad):
            assert np.all(rows[off[r]:off[r + 1]] == r)


@pytest.mark.parametrize("fmt", FMTS)
def test_spmv_matches_reference_and_scipy(graph, fmt):
    ref = ref_formats.pack(graph, fmt)
    port = formats.pack(to_port_graph(graph), fmt, device="cpu")
    xr = np.random.default_rng(1).standard_normal(graph.n)
    xp = port.permute_in(xr, np.float64)
    got = spmv(port, torch.from_numpy(xp)).numpy()
    want = np.asarray(ref_spmv_xla(ref, jnp.asarray(xp)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[: graph.n], graph.to_scipy() @ xr,
                               rtol=1e-12, atol=1e-12)
    assert not got[graph.n:].any()  # padding stays zero
    # float32 in, float32 out
    assert spmv(port, torch.from_numpy(xp.astype(np.float32))).dtype == \
        torch.float32


@pytest.mark.parametrize("fmt", FMTS)
def test_expm_action_formats_match_oracle(graph, fmt):
    g = to_port_graph(graph)
    res = expm_action(g, k=30, dtype="float64", fmt=fmt, device="cpu")
    want = oracle.expm_action(g, np.ones(g.n), 30)
    assert oracle.rel_error(res.ans, want) < 1e-10


def test_unknown_format_raises():
    g = to_port_graph(GRAPHS["ba3000"]())
    with pytest.raises(ValueError, match="unknown format"):
        formats.pack(g, "csr", device="cpu")
