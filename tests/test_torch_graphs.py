"""The port's graph layer (tpu_lanczos_torch.graphs) against the JAX
package's: the same arguments and seed give the same indptr/indices, on
the numpy path and on the native (graphcore.cc) path."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_lanczos.graphs import generators as ref_gen
from tpu_lanczos.graphs import io as ref_io
from tpu_lanczos.graphs import native as ref_native
from tpu_lanczos.graphs.csr import CSRGraph as RefCSR
from tpu_lanczos_torch.graphs import generators, native
from tpu_lanczos_torch.graphs import io as graph_io
from tpu_lanczos_torch.graphs.csr import CSRGraph
from tpu_lanczos_torch.utils import BUILD_DIR, ROOT_DIR

NUMPY_CASES = {
    "barabasi": ("barabasi_albert", (3000, 5), dict(seed=7)),
    "uniform": ("uniform_random", (2000, 8000), dict(seed=1)),
    "stencil_2d": ("stencil_2d", (30,), {}),
    "stencil_3d": ("stencil_3d", (6, 5, 4), {}),
    "rmat": ("rmat", (4096, 20000), dict(seed=3)),
    "clique_union": ("clique_union", (2560, 3000), dict(seed=4)),
}


def _same(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indices.dtype == b.indices.dtype


@pytest.mark.parametrize("name", list(NUMPY_CASES))
def test_generators_match_reference_numpy_path(name):
    fn, args, kw = NUMPY_CASES[name]
    _same(getattr(generators, fn)(*args, **kw),
          getattr(ref_gen, fn)(*args, **kw))


@pytest.mark.parametrize("fn,args", [
    ("barabasi_albert", (5000, 6)),
    ("uniform_random", (3000, 12000)),
])
def test_generators_match_reference_native_path(fn, args):
    assert native.available(), native.build_error()
    assert ref_native.available()
    _same(getattr(generators, fn)(*args, seed=11, use_native=True),
          getattr(ref_gen, fn)(*args, seed=11, use_native=True))


def test_native_builds_into_port_build_dir():
    """The port compiles its own copy of graphcore.cc (the reference's
    but for the coloring's path swap, tests/test_torch_slab.py) into its own build
    directory and never writes the reference's _graphcore.so."""
    assert native.available()
    assert native._SO.startswith(BUILD_DIR)
    assert os.path.exists(native._SO)
    assert native._SRC == os.path.join(
        ROOT_DIR, "tpu_lanczos_torch", "graphs", "native", "graphcore.cc")
    assert native._SO != ref_native._SO


@pytest.mark.parametrize("seed", range(0, 40, 8))
def test_native_edge_color_is_proper(seed):
    """gc_edge_color, the Konig coloring that deals a CPG level's entries
    into tiles: on random bipartite multigraphs (40 x 40 nodes, 400
    edges) no two edges at a node share a color, and Delta colors do.
    A path swap made edge by edge dropped an interior node's second
    color, so a later edge took it there (seed 25 of these)."""
    for s in range(seed, seed + 8):
        rng = np.random.default_rng(s)
        a = rng.integers(0, 40, 400)
        b = rng.integers(0, 40, 400)
        colors = native.edge_color(a, b)
        delta = max(np.bincount(a).max(), np.bincount(b).max())
        assert colors.min() >= 0 and colors.max() < delta
        for ends in (a, b):
            keys = ends.astype(np.int64) * delta + colors
            assert np.unique(keys).size == keys.size, s


def test_csr_from_edges_and_helpers_match_reference():
    rng = np.random.default_rng(5)
    edges = rng.integers(0, 500, size=(3000, 2))
    g, r = CSRGraph.from_edges(500, edges), RefCSR.from_edges(500, edges)
    _same(g, r)
    np.testing.assert_array_equal(g.row_ids(), r.row_ids())
    np.testing.assert_array_equal(g.degrees, r.degrees)
    assert (g.nnz, g.edge_count, g.max_degree) == (
        r.nnz, r.edge_count, r.max_degree)
    assert (g.to_scipy() != r.to_scipy()).nnz == 0
    g.validate()
    with pytest.raises(ValueError):
        CSRGraph.from_edges(10, np.array([[0, 10]]))
    bad = CSRGraph(indptr=g.indptr, indices=g.indices.copy(), n=g.n)
    bad.indices[0] = g.n
    with pytest.raises(ValueError):
        bad.validate()


@pytest.mark.parametrize("use_native", [False, True])
def test_mtx_round_trip_matches_reference(tmp_path, use_native):
    g = generators.barabasi_albert(1500, 4, seed=9)
    port_path, ref_path = tmp_path / "port.mtx", tmp_path / "ref.mtx"
    graph_io.write_mtx(g, str(port_path))
    ref_io.write_mtx(RefCSR(indptr=g.indptr, indices=g.indices, n=g.n),
                     str(ref_path))
    assert port_path.read_bytes() == ref_path.read_bytes()
    got = graph_io.read_mtx(str(port_path), use_native=use_native)
    _same(got, ref_io.read_mtx(str(ref_path), use_native=use_native))
    _same(got, g)


def test_read_mtx_rejects_malformed(tmp_path):
    p = tmp_path / "bad.mtx"
    p.write_text("% comment\n4 4 2\n1 2\n3 x\n")
    with pytest.raises(ValueError):
        graph_io.read_mtx(str(p), use_native=False)
    with pytest.raises(ValueError):
        graph_io.read_mtx(str(p), use_native=True)


def test_port_imports_without_jax():
    evals = ", ".join(f"tpu_lanczos_torch.eval.{m}" for m in (
        "oracle", "profiling", "bench_suite", "stage_breakdown",
        "fused_serving", "accuracy_gpu", "sweeps", "df_sweep",
        "df_accuracy_suite", "europe_df64", "stochastic_bench",
        "pack_truth"))
    code = ("import tpu_lanczos_torch, sys; "
            "import tpu_lanczos_torch.kernels.spmv_cpg, "
            "tpu_lanczos_torch.kernels.lanczos_step, "
            f"tpu_lanczos_torch.kernels._build, {evals}; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'tpu_lanczos' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT_DIR,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
