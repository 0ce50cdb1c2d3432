"""The port on the inputs of tests/test_edge_cases.py and of
tests/test_aux.py::test_load_cpg_extends_short_ghost_tail, on the CPU,
each held against the JAX package (and the oracle) at the bar of its own
test; and the smallest graphs (2 nodes, 5 edgeless nodes) at k = 1, 3
and 10 through the single-device modes.

Bars: the reference's own (f64 1e-10 against the dense oracle, 1e-11
for a custom start vector, the isolated node's value 1 within 1e-10,
the CPG SpMV 1e-12 absolute and 1e-11 for the old pack, the K120 f32
shift 119 within 0.5); port against reference in f64 within 1e-12
(the same recurrence with sums in other orders), and K120's f32 answer
direction within 1e-5 (its f32 shifts differ in the third decimal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.core import pipeline as ref_pipeline
from tpu_lanczos.core import lanczos_df as ref_lanczos_df
from tpu_lanczos.graphs import generators
from tpu_lanczos.graphs.csr import CSRGraph
from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos.kernels.spmv_cpg import spmv_cpg as ref_spmv_cpg
from tpu_lanczos_torch import expm_action
from tpu_lanczos_torch.core.lanczos_df import expm_action_df
from tpu_lanczos_torch.eval import oracle
from tpu_lanczos_torch.kernels import cpg as port_cpg
from tpu_lanczos_torch.kernels.spmv_cpg import spmv_cpg

from _torch_cases import to_port_graph


def _both(g, **kw):
    """(port result, reference result) of expm_action on g."""
    port = expm_action(to_port_graph(g), device="cpu", **kw)
    ref = ref_pipeline.expm_action(g, **kw)
    return port, ref


def test_k_equals_1():
    g = generators.uniform_random(100, 300, seed=0)
    port, ref = _both(g, k=1, dtype="float64")
    assert port.k == ref.k == 1
    assert np.all(np.isfinite(port.ans))
    assert oracle.rel_error(port.ans, np.asarray(ref.ans)) < 1e-12


def test_disconnected_components():
    iu, ju = np.triu_indices(5, k=1)
    edges = np.concatenate([np.stack([iu, ju], axis=1),
                            np.stack([iu + 10, ju + 10], axis=1)])
    g = CSRGraph.from_edges(20, edges)
    assert g.degrees[5] == 0
    port, ref = _both(g, k=10, dtype="float64")
    want = oracle.expm_action_dense(to_port_graph(g), np.ones(g.n))
    assert oracle.rel_error(port.ans, want) < 1e-10
    assert abs(port.ans[5] - 1.0) < 1e-10
    assert oracle.rel_error(port.ans, np.asarray(ref.ans)) < 1e-12


def test_isolated_vertices_cpg():
    iu, ju = np.triu_indices(6, k=1)
    g = CSRGraph.from_edges(40, np.stack([iu, ju], axis=1))
    cg = port_cpg.pack_cpg(to_port_graph(g), device="cpu")
    rcg = ref_cpg.pack_cpg(g)
    xr = np.random.default_rng(0).standard_normal(g.n)
    got = cg.permute_out(spmv_cpg(cg, torch.from_numpy(
        cg.permute_in(xr, np.float64))))
    np.testing.assert_allclose(got, g.to_scipy() @ xr, atol=1e-12)
    ref = rcg.permute_out(np.asarray(ref_spmv_cpg(
        rcg, jnp.asarray(rcg.permute_in(xr, np.float64)), interpret=True)))
    np.testing.assert_array_equal(got, ref)


def test_path_graph_line():
    n = 500
    g = CSRGraph.from_edges(n, np.stack([np.arange(n - 1),
                                         np.arange(1, n)], axis=1))
    port, ref = _both(g, k=40, dtype="float64")
    want = oracle.expm_action_dense(to_port_graph(g), np.ones(n))
    assert oracle.rel_error(port.ans, want) < 1e-10
    assert oracle.rel_error(port.ans, np.asarray(ref.ans)) < 1e-12


def test_complete_graph_dense():
    n = 120
    iu, ju = np.triu_indices(n, k=1)
    g = CSRGraph.from_edges(n, np.stack([iu, ju], axis=1))
    port, ref = _both(g, k=20, dtype="float32", log_scale=True)
    assert np.all(np.isfinite(port.ans))
    assert port.log_scale == pytest.approx(119.0, abs=0.5)
    assert ref.log_scale == pytest.approx(119.0, abs=0.5)
    # the f32 top Ritz values (the shifts) differ by ~2e-3 (ROADMAP §3);
    # the answers' directions, all-equal vectors, agree
    a, b = port.ans, np.asarray(ref.ans, np.float64)
    assert oracle.rel_error(a / np.linalg.norm(a),
                            b / np.linalg.norm(b)) < 1e-5


def test_expm_x_custom_start_vector():
    g = generators.uniform_random(200, 600, seed=4)
    x = np.random.default_rng(0).standard_normal(g.n)
    port, ref = _both(g, x=x, k=30, dtype="float64")
    assert oracle.rel_error(port.ans, oracle.expm_action(
        to_port_graph(g), x, 30)) < 1e-11
    assert oracle.rel_error(port.ans, np.asarray(ref.ans)) < 1e-12


def _tiny(name):
    if name == "two_nodes":
        return CSRGraph.from_edges(2, np.array([[0, 1]]))
    return CSRGraph.from_edges(5, np.zeros((0, 2), dtype=np.int64))


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("name", ["two_nodes", "edgeless_5"])
def test_smallest_graphs(name, k):
    """Plain, two-pass and df64 e^A.1 of a 2-node graph and of an
    edgeless 5-node graph (e^A.1 = 1, every step a breakdown) against
    the dense oracle and the reference."""
    g = _tiny(name)
    pg = to_port_graph(g)
    want = oracle.expm_action_dense(pg, np.ones(g.n))
    for low_mem in (False, True):
        port, ref = _both(g, k=k, dtype="float64", low_mem=low_mem)
        assert port.k == ref.k == min(k, g.n - 1)
        assert oracle.rel_error(port.ans, want) < 1e-12
        assert oracle.rel_error(port.ans, np.asarray(ref.ans)) < 1e-12
    df = expm_action_df(pg, k=k, device="cpu")
    ref_df = ref_lanczos_df.expm_action_df(g, k=k, interpret=True)
    assert oracle.rel_error(df.ans, want) < 1e-12
    assert oracle.rel_error(df.ans, np.asarray(ref_df.ans)) < 1e-12


def test_load_cpg_extends_short_ghost_tail(tmp_path):
    """A pack saved by the reference without its ghost-tile tail loads
    into the port with the tail extended to GROUP_PAD, equal to the
    reference's load, and computes the right SpMV."""
    g = generators.barabasi_albert(5000, 6, seed=2, use_native=False)
    cg = ref_cpg.pack_cpg(g, sub=128)
    path = str(tmp_path / "old_pack.npz")
    ref_cpg.save_cpg(cg, path)
    z = dict(np.load(path))
    for i in range(int(z["n_levels"])):
        T = int(z[f"lv{i}_counts"].sum())
        z[f"lv{i}_l1"] = z[f"lv{i}_l1"][: T * cg.sub]
        z[f"lv{i}_l2"] = z[f"lv{i}_l2"][: T * 128]
        for key in ("s_ids", "d_ids", "run_ids"):
            z[f"lv{i}_{key}"] = z[f"lv{i}_{key}"][:T]
    np.savez(path, **z)
    port = port_cpg.load_cpg(path, device="cpu")
    ref = ref_cpg.load_cpg(path)
    for lv, rlv in zip(port.levels, ref.levels):
        tail = lv["s_ids"].shape[0] - int(lv["counts"].sum())
        assert tail >= port_cpg.GROUP_PAD
        for key in ("l1", "l2", "s_ids", "starts", "counts"):
            np.testing.assert_array_equal(lv[key].numpy(),
                                          np.asarray(rlv[key]))
    xr = np.random.default_rng(0).standard_normal(g.n)
    y = port.permute_out(spmv_cpg(port, torch.from_numpy(
        port.permute_in(xr, np.float64))))
    np.testing.assert_allclose(y, g.to_scipy() @ xr, rtol=1e-11, atol=1e-11)
