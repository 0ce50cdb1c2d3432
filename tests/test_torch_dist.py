"""The port's row mesh and its ELL/COO sharded path
(tpu_lanczos_torch/dist/mesh.py, partition.py, lanczos.py) against the JAX
package's (tpu_lanczos/dist/), on the CPU: the reference on the 8 virtual
CPU devices tests/conftest.py gives it, the port on N CPU shards of an
in-process mesh.

Bars and why:
- ``balanced_permutation`` and ``pack_sharded`` equal the reference's
  array for array at 1, 2, 4 and 5 shards: the host numpy is the same;
- f64 alpha/beta of ``lanczos_sharded`` within 1e-10 of the reference's
  over 15 steps: the SpMV and the dots sum in other orders (ROADMAP §3,
  plain Lanczos drift);
- the reference's own bars (tests/test_dist.py): e^A.x against the f64
  oracle < 1e-12, the same with 1, 2, 4 and 8 shards, against the
  single-device pipeline < 1e-12, reorthogonalized < 1e-10 against the
  dense oracle;
- the mesh: ``make_mesh`` refuses a mesh larger than the GPUs with the
  reference's "need N devices, have M"; ``all_gather`` concatenates in
  shard order and ``psum`` is one left fold;
- a 2-rank gloo run (one shard per process, ``init_distributed``) gives
  the in-process 2-shard run's alpha/beta and Estrada estimate bit for
  bit: at 2 shards the all_reduce's sum is the fold's;
- ``dryrun_multichip`` at 4 CPU shards.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos import dist as ref_dist
from tpu_lanczos.dist.mesh import ROWS
from tpu_lanczos.graphs import generators
from tpu_lanczos_torch import dist
from tpu_lanczos_torch.core.pipeline import expm_action
from tpu_lanczos_torch.dist.lanczos import multiply_out_sharded
from tpu_lanczos_torch.eval import oracle

from _torch_cases import to_port_graph

_HERE = os.path.dirname(os.path.abspath(__file__))

GRAPHS = {
    "barabasi": lambda: generators.barabasi_albert(2000, 5, seed=2,
                                                   use_native=False),
    "uniform": lambda: generators.uniform_random(1500, 6000, seed=1),
    "stencil": lambda: generators.stencil_2d(40),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: make() for name, make in GRAPHS.items()}


def cpu_mesh(n):
    return dist.make_mesh(n, device="cpu")


def _ref_shards(sg, x, mesh):
    return jax.device_put(jnp.asarray(x), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(ROWS)))


# ----------------------------------------------------------------- packs


@pytest.mark.parametrize("n_shards", [1, 2, 4, 5])
def test_balanced_permutation_equals_reference(graphs, n_shards):
    for g in graphs.values():
        np.testing.assert_array_equal(
            dist.balanced_permutation(to_port_graph(g), n_shards),
            ref_dist.balanced_permutation(g, n_shards))


@pytest.mark.parametrize("fmt", ["auto", "ell"])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 5])
def test_pack_sharded_equals_reference(graphs, n_shards, fmt):
    for g in graphs.values():
        ref = ref_dist.pack_sharded(g, n_shards, fmt=fmt)
        sg = dist.pack_sharded(to_port_graph(g), n_shards, fmt=fmt,
                               mesh=cpu_mesh(n_shards))
        for f in ("n_shards", "n", "n_pad", "n_loc", "nnz"):
            assert getattr(sg, f) == getattr(ref, f), f
        np.testing.assert_array_equal(sg.new_of_old, ref.new_of_old)
        np.testing.assert_array_equal(
            np.concatenate([t.numpy() for t in sg.ell_indices], axis=1),
            np.asarray(ref.ell_indices))
        np.testing.assert_array_equal(
            np.concatenate([t.numpy() for t in sg.ell_degrees]),
            np.asarray(ref.ell_degrees))
        for f in ("coo_rows", "coo_cols"):
            want = np.asarray(getattr(ref, f))
            got = np.stack([t.numpy() for t in getattr(sg, f)])
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_reference_pack_carried_across(graphs):
    """The reference's ShardedGraph as numpy becomes the port's through
    ``ShardedGraph.from_numpy``, and runs like the port's own pack."""
    g = graphs["barabasi"]
    ref = ref_dist.pack_sharded(g, 4)
    mesh = cpu_mesh(4)
    meta = {f: getattr(ref, f) for f in ("n_shards", "n", "n_pad", "n_loc",
                                         "nnz")}
    carried = dist.ShardedGraph.from_numpy(
        meta, *(np.asarray(getattr(ref, f)) for f in (
            "ell_indices", "ell_degrees", "coo_rows", "coo_cols")),
        ref.new_of_old, mesh)
    own = dist.pack_sharded(to_port_graph(g), 4, mesh=mesh)
    for f in ("ell_indices", "ell_degrees", "coo_rows", "coo_cols",
              "coo_offsets"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(carried, f),
                                                     getattr(own, f)))
    x = own.permute_in(np.ones(g.n), np.float64)
    a = dist.lanczos_sharded(carried, x, 12, mesh)
    b = dist.lanczos_sharded(own, x, 12, mesh)
    assert torch.equal(a.alpha, b.alpha) and torch.equal(a.beta, b.beta)
    with pytest.raises(ValueError, match="pack of 4 shards on a mesh of 2"):
        dist.ShardedGraph.from_numpy(meta, *(np.asarray(getattr(ref, f)) for f
                                             in ("ell_indices", "ell_degrees",
                                                 "coo_rows", "coo_cols")),
                                     ref.new_of_old, cpu_mesh(2))


# --------------------------------------------------------------- Lanczos


@pytest.mark.parametrize("n_shards", [2, 4])
def test_lanczos_sharded_matches_reference(graphs, n_shards):
    g = graphs["barabasi"]
    ref_mesh = ref_dist.make_mesh(n_shards)
    ref = ref_dist.pack_sharded(g, n_shards, mesh=ref_mesh)
    x = ref.permute_in(np.ones(g.n), np.float64)
    want = ref_dist.lanczos_sharded(ref, _ref_shards(ref, x, ref_mesh), 15,
                                    ref_mesh)
    mesh = cpu_mesh(n_shards)
    sg = dist.pack_sharded(to_port_graph(g), n_shards, mesh=mesh)
    got = dist.lanczos_sharded(sg, x, 15, mesh)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta),
                               rtol=1e-10, atol=1e-10)
    assert float(got.x_norm) == pytest.approx(float(want.x_norm), rel=1e-14)
    # the basis stays sharded: one (k, n_loc) block a shard
    assert len(got.q_basis) == n_shards
    assert all(tuple(q.shape) == (15, sg.n_loc) for q in got.q_basis)
    a, b, xn = dist.lanczos_alphabeta_sharded(sg, x, 15, mesh)
    assert torch.equal(a, got.alpha) and torch.equal(b[:14], got.beta)
    assert b.shape == (15,)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_sharded_matches_oracle(graphs, name):
    g = graphs[name]
    ans, shift, state, sg = dist.expm_action_sharded(
        to_port_graph(g), k=30, mesh=cpu_mesh(8), dtype="float64")
    assert shift is None and isinstance(sg, dist.ShardedGraph)
    ref = oracle.expm_action(to_port_graph(g), np.ones(g.n), 30)
    assert oracle.rel_error(ans, ref) < 1e-12


def test_sharded_matches_single_device(graphs):
    g = to_port_graph(graphs["uniform"])
    ans, _, _, _ = dist.expm_action_sharded(g, k=25, mesh=cpu_mesh(8),
                                            dtype="float64")
    single = expm_action(g, k=25, dtype="float64", fmt="auto", device="cpu")
    assert oracle.rel_error(ans, single.ans) < 1e-12


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_device_count_invariance(graphs, n_shards):
    g = to_port_graph(graphs["barabasi"])
    ans, _, _, _ = dist.expm_action_sharded(g, k=20, mesh=cpu_mesh(n_shards),
                                            dtype="float64")
    assert oracle.rel_error(ans, oracle.expm_action(g, np.ones(g.n), 20)) \
        < 1e-12


def test_sharded_reorthogonalize_and_device_eig(graphs):
    g = to_port_graph(graphs["uniform"])
    mesh = cpu_mesh(4)
    ans, _, _, _ = dist.expm_action_sharded(g, k=40, mesh=mesh,
                                            dtype="float64",
                                            reorthogonalize=True)
    assert oracle.rel_error(ans, oracle.expm_action_dense(
        g, np.ones(g.n))) < 1e-10
    # the device eigensolve and log-scale give the same answer
    a_h, s_h, state, sg = dist.expm_action_sharded(
        g, k=20, mesh=mesh, dtype="float64", log_scale=True)
    a_d, s_d, _, _ = dist.expm_action_sharded(
        sg, k=20, mesh=mesh, dtype="float64", log_scale=True,
        eig_impl="device")
    assert s_d == pytest.approx(s_h, rel=1e-12)
    assert oracle.rel_error(a_d, a_h) < 1e-12
    ans, shift = multiply_out_sharded(state, mesh, eig_impl="device")
    assert shift is None
    assert oracle.rel_error(sg.permute_out(mesh.to_host(ans)),
                            a_h * np.exp(s_h)) < 1e-12


def test_expm_action_sharded_coo_and_best_formats(graphs):
    g = to_port_graph(graphs["barabasi"])
    want = oracle.expm_action(g, np.ones(g.n), 20)
    for fmt, kind in (("coo", dist.ShardedGraph), ("best", None)):
        if fmt == "coo":
            # the hybrid packer covers coo, as the reference's
            sg = dist.pack_sharded(g, 4, fmt="auto", mesh=cpu_mesh(4))
            ans, _, _, _ = dist.expm_action_sharded(
                sg, k=20, mesh=cpu_mesh(4), dtype="float64")
        else:
            ans, _, _, sg = dist.expm_action_sharded(
                g, k=20, mesh=cpu_mesh(4), dtype="float64", fmt=fmt)
            # "best" packs CPG on every device (the CUDA kernel's format)
            from tpu_lanczos_torch.dist.cpg_sharded import ShardedCPG

            kind = ShardedCPG
        assert isinstance(sg, kind)
        assert oracle.rel_error(ans, want) < 1e-12


# ------------------------------------------------------------------ mesh


def test_make_mesh_needs_the_gpus():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError,
                       match=f"^need {have + 1} devices, have {have}$"):
        dist.make_mesh(have + 1)
    with pytest.raises(ValueError, match="^need 3 devices, have 2$"):
        dist.make_mesh(3, devices=["cpu", "cpu"])
    mesh = dist.make_mesh(devices=["cpu"] * 3)
    assert mesh.n_shards == 3 and mesh.shards == (0, 1, 2)
    assert mesh.group is None
    assert dist.make_mesh(device="cpu").n_shards == 1
    with pytest.raises(ValueError, match="cuda or cpu"):
        dist.make_mesh(2, device="tpu")


def test_mesh_collectives_fold_in_shard_order():
    mesh = cpu_mesh(3)
    xs = [torch.tensor([1e16, 1.0]), torch.tensor([1.0, 2.0]),
          torch.tensor([-1e16, 3.0])]
    full = mesh.all_gather(xs)
    assert len(full) == 3 and all(f is full[0] for f in full)
    assert torch.equal(full[0], torch.cat(xs))
    (s, *_) = mesh.psum(xs)
    # the left fold (1e16 + 1) + -1e16: 1.0 is lost, as shard order says
    want = (xs[0] + xs[1]) + xs[2]
    assert torch.equal(s, want)
    parts = mesh.split(np.arange(12.0), 4)
    assert [p.tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                           [8, 9, 10, 11]]
    np.testing.assert_array_equal(mesh.to_host(parts), np.arange(12.0))


def test_exports():
    names = {"make_mesh", "balanced_permutation", "pack_sharded",
             "ShardedGraph", "lanczos_sharded", "lanczos_alphabeta_sharded",
             "expm_action_sharded"}
    assert names <= set(dist.__all__) and names <= set(ref_dist.__all__)
    for name in dist.__all__:
        assert getattr(dist, name) is not None


def test_dryrun_multichip_on_four_cpu_shards():
    from tpu_lanczos_torch.dist.dryrun import dryrun_multichip, main

    dryrun_multichip(4, device="cpu")
    assert main(["2", "--device", "cpu"]) == 0


# ------------------------------------------------------- two gloo ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_equal_the_in_process_mesh(tmp_path):
    """One shard per process over gloo: the sharded CPG Lanczos and the
    sharded Estrada estimate bit-equal to the in-process 2-shard run."""
    import _torch_dist_worker as worker

    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(_HERE) + os.pathsep + env.get(
        "PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "_torch_dist_worker.py"),
         str(rank), str(port), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the 2-rank gloo run timed out")
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "DIST_OK" in out, out[-3000:]
    want = worker.run(cpu_mesh(2))
    for name, w in zip(("alpha", "beta", "per_probe", "log"), want):
        for rank in (0, 1):
            np.testing.assert_array_equal(
                np.load(tmp_path / f"{name}_{rank}.npy"), w)
