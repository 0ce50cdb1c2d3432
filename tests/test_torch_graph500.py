"""The Graph500 Kronecker generator (``generators.graph500``), its frozen
copy in the benchmark (``lanczos_bench/graphs/graph500.py``), the port's
queries on a SCALE-12 Graph500 graph, the ``chain_tiles`` counter and the
CLI's ``--graph500``, on the CPU.

SCALE 12 (4,096 vertices, ~97k stored nonzeros, ~18% isolated, a hub of
degree ~1,300) packs into a broadcast level, the main level and a reduce
level, with isolated vertices among the real rows.  Bars, as the
pipeline tests' (tests/test_torch_pipeline.py): f64 e^A.x within 1e-12
of the plain f64 reference and of the JAX package; f32 top-20 nodes the
reference's, their values within 1e-4.
"""

import numpy as np
import pytest
import torch

from lanczos_bench.graphs import graph500 as bench_graph500
from lanczos_bench.harness import control, correct
from lanczos_bench.reference.lanczos_expm import expm_lanczos
from tpu_lanczos.core import pipeline as ref_pipeline
from tpu_lanczos.graphs.csr import CSRGraph as RefCSRGraph
from tpu_lanczos_torch import (best_device_pack, expm_action,
                               expm_action_summary, generators, obs)
from tpu_lanczos_torch.cli.main import main as cli_main
from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.cpg import pack_cpg

torch.set_num_threads(1)

K = 20
TOPK = 20


@pytest.mark.parametrize("scale, edgefactor", [(3, 16), (9, 16), (11, 4)])
def test_graph500_shape(scale, edgefactor):
    g = generators.graph500(scale, edgefactor, seed=7)
    n = 2 ** scale
    assert g.n == n and g.indptr.shape == (n + 1,)
    assert g.indptr.dtype == np.int64 and g.indices.dtype == np.int32
    g.validate()  # symmetric, indices in range
    rows = g.row_ids()
    assert not np.any(rows == g.indices)  # no self-loops
    keys = rows.astype(np.int64) * n + g.indices
    assert np.all(np.diff(keys) > 0)  # sorted rows, no duplicates
    # at most edgefactor * 2^scale generated edges, both orientations
    assert 0 < g.nnz <= 2 * edgefactor * n


def test_graph500_is_a_function_of_its_seed():
    a, b = (generators.graph500(10, seed=5) for _ in range(2))
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    c = generators.graph500(10, seed=6)
    assert not np.array_equal(a.indices[:1000], c.indices[:1000])
    big = generators.graph500(8, seed=2**40 + 3)
    assert big.n == 256
    with pytest.raises(ValueError):
        generators.graph500(0)


def test_graph500_skew_and_permuted_labels():
    """The Kronecker skew (a hub, isolated vertices) with the labels
    permuted: the hub is not vertex 0, as it would be unpermuted."""
    g = generators.graph500(12, seed=1)
    deg = g.degrees
    assert deg.max() > 20 * deg.mean()
    assert 0.1 < np.mean(deg == 0) < 0.4
    assert int(np.argmax(deg)) != 0


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 11])
@pytest.mark.parametrize("scale", [8, 10, 12])
def test_frozen_bench_copy_equals_the_ports(scale, seed):
    g = generators.graph500(scale, 16, seed)
    indptr, indices = bench_graph500.graph500(scale, 16, seed)
    assert indptr.dtype == g.indptr.dtype and indices.dtype == g.indices.dtype
    assert np.array_equal(indptr, g.indptr)
    assert np.array_equal(indices, g.indices)
    cfg = {"generator": "graph500", "scale": scale, "edgefactor": 16}
    got = bench_graph500.generate(cfg, seed)
    assert all(np.array_equal(x, y) for x, y in zip(got, (indptr, indices)))


@pytest.fixture(scope="module")
def g500():
    g = generators.graph500(12, seed=1)
    dg = best_device_pack(g, device="cpu")
    ans, shift, _, _ = expm_lanczos(g.indptr, g.indices, K, "float64")
    return g, dg, ans, shift


def test_scale12_pack_has_broadcast_reduce_and_isolated_rows(g500):
    g, dg, _, _ = g500
    assert dg.n_bcast >= 1 and len(dg.levels) >= dg.n_bcast + 2
    assert np.any(g.degrees == 0)
    assert g.degrees.max() > dg.theta  # a hub split past theta


def test_scale12_f64_matches_reference_and_jax(g500):
    g, dg, ans, shift = g500
    res = expm_action(g, k=K, dtype="float64", dg=dg, log_scale=True)
    got = res.ans * np.exp(res.log_scale - shift)
    assert np.linalg.norm(got - ans) / np.linalg.norm(ans) < 1e-12
    want = ref_pipeline.expm_action(
        RefCSRGraph(indptr=g.indptr, indices=g.indices, n=g.n), k=K,
        dtype="float64", log_scale=True)
    other = np.asarray(want.ans) * np.exp(float(want.log_scale) - shift)
    assert np.linalg.norm(got - other) / np.linalg.norm(other) < 1e-12


def test_scale12_f32_topk_and_chain_tiles(g500):
    """The fused f32 query's top-20 against the f64 reference, and its
    ``chain_tiles``: k SpMVs, each the heaviest chunk's tiles of every
    level, summed."""
    g, dg, ans, _ = g500
    before = spmv_cpg.chain_tiles
    with obs.recording() as rec:
        summ = expm_action_summary(g, k=K, topk=TOPK, dg=dg,
                                   eig_impl="device", device="cpu")
    (q,) = rec.take()
    chain = sum(int(lv["counts"].max()) for lv in dg.levels)
    assert q.counts["chain_tiles"] == K * chain
    assert spmv_cpg.chain_tiles - before == K * chain
    assert "chain_tiles" in dict(obs.LAUNCH_COUNTERS)[spmv_cpg.__name__]
    top = np.argsort(ans)[-TOPK:]
    assert set(summ.top_nodes) == set(top)
    np.testing.assert_allclose(summ.top_values / summ.ans_norm,
                               np.sort(ans)[::-1][:TOPK]
                               / np.linalg.norm(ans), rtol=1e-4)


def test_chain_tiles_is_the_packs_chain_once_a_spmv(g500):
    """The pack keeps each level's heaviest chunk's tiles as host ints,
    and ``chain_tiles`` adds their sum once an SpMV (f32 and df), with
    no read of the level tensors."""
    g, dg, _, _ = g500
    assert dg.chains == tuple(int(lv["counts"].max()) for lv in dg.levels)
    assert all(isinstance(c, int) for c in dg.chains)
    x = dg.realmask.reshape(-1).double()
    before = spmv_cpg.chain_tiles
    spmv_cpg.spmv_cpg(dg, x)
    assert spmv_cpg.chain_tiles - before == sum(dg.chains)
    x32 = x.float()
    before = spmv_cpg.chain_tiles
    spmv_cpg.spmv_cpg_df(dg, x32, torch.zeros_like(x32))
    assert spmv_cpg.chain_tiles - before == sum(dg.chains)


@pytest.fixture(scope="module")
def g500_s14():
    """SCALE 14, seed 3: the smallest Graph500 pack found whose main level
    the Konig coloring once dealt two entries into one staging pair of a
    tile (graphs/native/graphcore.cc), 16 entries that read another
    source; f32 top-20 error 1.4e-5 then."""
    g = generators.graph500(14, seed=3)
    return g, g.to_scipy().astype(np.float64)


@pytest.mark.parametrize("layout", ["classic", "slab"])
def test_scale14_pack_is_the_matrix(g500_s14, layout):
    """Every entry of the pack reads its own source: the f64 SpMV of a
    random vector equals SciPy's product within rounding."""
    g, a = g500_s14
    dg = pack_cpg(g, layout=layout, device="cpu")
    x = np.random.default_rng(0).random(g.n)
    y = spmv_cpg.spmv_cpg(dg, torch.from_numpy(dg.permute_in(x, np.float64)))
    want = a @ x
    np.testing.assert_allclose(dg.permute_out(y), want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())


def test_scale14_f32_topk_matches_reference(g500_s14):
    """The fused f32 query at float32's accuracy on that graph:
    ``topk_err`` (the benchmark's number) well under 3e-6."""
    g, _ = g500_s14
    traffic = {"kwargs": {"k": 50, "topk": TOPK}}
    ref = control.reference(traffic, g.indptr, g.indices)
    res = expm_action_summary(g, k=50, topk=TOPK, eig_impl="device",
                              device="cpu")
    assert correct.numbers("topk", res, ref)["topk_err"] < 3e-6


def test_cli_graph500(capsys):
    argv = ["--graph500", "10", "-k", "10", "--topk", "5", "-v",
            "--device", "cpu"]
    assert cli_main(argv) == 0
    out = capsys.readouterr().out
    assert "graph: graph500(scale=10, edgefactor=16, seed=0)" in out
    assert "n = 1024," in out
    counters = next(line for line in out.splitlines()
                    if line.startswith("counters:"))
    assert "chain_tiles=" in counters
