"""The port's row-sharded CPG path (tpu_lanczos_torch/dist/cpg_sharded.py,
row 1d: the CPG level kernel on each shard's tiles) against the JAX
package's (tpu_lanczos/dist/cpg_sharded.py), on the CPU: the reference on
its 8 virtual CPU devices with Pallas in interpret mode, the port on an
in-process mesh of CPU shards (its kernels' plain versions).

Bars and why:
- ``pack_cpg_sharded`` equals the reference's array for array (every
  level key, ``sel``, ``halo_sel``, ``run_ids``, ``t_reals``,
  ``mask_sparse``, ``overlap``, the realmask) at 1, 2, 4 and 5 shards, on
  the reference test file's graphs and the 360k-node stencil that takes
  the halo path: the host numpy is the reference's;
- every shard level (own, cross and reduce passes) through
  ``run_level_ref`` with ``c_loc`` dest chunks bit-identical to the
  reference's ``_run_level(..., interpret=True)``, untransposed, on the
  inputs one SpMV gives it: a Barabasi-Albert graph of 40,000 nodes at
  sub=128, whose 4-shard pack has tiles in two shards, so its cross pass
  is not empty (below ~16,000 units every tile is in shard 0's block);
- f64 alpha/beta of ``lanczos_cpg_sharded`` within 1e-10 of the
  reference's over 15 steps (ROADMAP §3, plain Lanczos drift);
- the reference's own bars (tests/test_cpg_sharded.py): e^A.x against the
  f64 oracle < 1e-12 (< 1e-10 on the hub and on the halo stencil), at 2,
  3, 5 and 8 shards, the overlap split against the unsplit main level
  within 1e-13;
- the 1-shard SpMV bit-identical to single-device ``spmv_cpg`` on the same
  dest-only pack (the sums and the final adds are the same);
- the refusals (theta_s, slab) with the reference's texts, and the
  pack-time check of every s_id against its source buffer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.dist import make_mesh as ref_make_mesh
from tpu_lanczos.dist import cpg_sharded as ref_cs
from tpu_lanczos.dist.mesh import ROWS
from tpu_lanczos.graphs import generators
from tpu_lanczos.kernels import spmv_cpg as ref_k
from tpu_lanczos_torch.dist import cpg_sharded as cs
from tpu_lanczos_torch.dist import expm_action_sharded
from tpu_lanczos_torch.dist.mesh import make_mesh
from tpu_lanczos_torch.eval import oracle
from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.cpg import GROUP_PAD, pack_cpg

from _torch_cases import star_graph, to_port_graph, untranspose

GRAPHS = {
    "barabasi": lambda: generators.barabasi_albert(3000, 8, seed=2,
                                                   use_native=False),
    "stencil": lambda: generators.stencil_2d(60),
    "uniform": lambda: generators.uniform_random(2500, 9000, seed=1),
    "hub": lambda: star_graph(2000),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: make() for name, make in GRAPHS.items()}


def cpu_mesh(n):
    return make_mesh(n, device="cpu")


def assert_pack_equal(ref, sg):
    """Every array and every static field of the two sharded packs."""
    for f in ("n", "n_shards", "n_chunks", "nnz", "theta", "sub", "c_loc",
              "n_main", "overlap", "t_reals", "mask_sparse"):
        assert getattr(sg, f) == getattr(ref, f), f
    np.testing.assert_array_equal(sg.new_of_old, ref.new_of_old)
    np.testing.assert_array_equal(
        np.concatenate([r.numpy() for r in sg.realmask]),
        np.asarray(ref.realmask))
    assert len(sg.levels) == len(ref.levels)
    for rl, pl in zip(ref.levels, sg.levels):
        assert set(pl[0]) == set(rl)
        for k, v in rl.items():
            want = np.asarray(v)
            got = np.stack([d[k].numpy() for d in pl])
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
            assert all(d[k].is_contiguous() for d in pl)


def _ref_x(mesh, x):
    return jax.device_put(jnp.asarray(x), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(ROWS)))


# ----------------------------------------------------------------- packs


@pytest.mark.parametrize("n_shards", [1, 2, 4, 5])
def test_pack_equals_reference(graphs, n_shards):
    for g in graphs.values():
        assert_pack_equal(
            ref_cs.pack_cpg_sharded(g, n_shards),
            cs.pack_cpg_sharded(to_port_graph(g), n_shards,
                                mesh=cpu_mesh(n_shards)))


def test_reference_pack_carried_across(graphs):
    """The reference's sharded pack, its arrays as numpy, becomes the
    port's through ``ShardedCPG.from_numpy``: equal arrays, and the port's
    Lanczos on it equals the Lanczos on the port's own pack bit for bit."""
    g = graphs["hub"]
    ref = ref_cs.pack_cpg_sharded(g, 4)
    mesh = cpu_mesh(4)
    meta = {f: getattr(ref, f) for f in (
        "n", "n_shards", "n_chunks", "nnz", "theta", "sub", "t_reals",
        "mask_sparse", "overlap")}
    carried = cs.ShardedCPG.from_numpy(
        meta, [{k: np.asarray(v) for k, v in lv.items()}
               for lv in ref.levels],
        np.asarray(ref.realmask), ref.new_of_old, mesh)
    assert_pack_equal(ref, carried)
    own = cs.pack_cpg_sharded(to_port_graph(g), 4, mesh=mesh)
    x = own.permute_in(np.ones(g.n), np.float64)
    a = cs.lanczos_cpg_sharded(carried, x, 12, mesh)
    b = cs.lanczos_cpg_sharded(own, x, 12, mesh)
    assert torch.equal(a.alpha, b.alpha) and torch.equal(a.beta, b.beta)


def test_pack_without_overlap_equals_reference(graphs):
    for name in ("barabasi", "stencil"):
        g = graphs[name]
        ref = ref_cs.pack_cpg_sharded(g, 4, overlap=False)
        sg = cs.pack_cpg_sharded(to_port_graph(g), 4, mesh=cpu_mesh(4),
                                 overlap=False)
        assert not sg.overlap and sg.n_main == 1
        assert_pack_equal(ref, sg)


def test_halo_stencil_pack_equals_reference_and_matches_scipy():
    """The 360k-node stencil's 4-shard pack takes the halo path; no JAX
    run on it: pack equality, and the port's plain SpMV against scipy."""
    g = generators.stencil_2d(600)
    ref = ref_cs.pack_cpg_sharded(g, 4)
    mesh = cpu_mesh(4)
    sg = cs.pack_cpg_sharded(to_port_graph(g), 4, mesh=mesh)
    assert_pack_equal(ref, sg)
    cross = sg.levels[sg.n_main - 1]
    assert "halo_sel" in cross[0] and "halo_sel" not in sg.levels[0][0]
    h_pad = int(cross[0]["halo_sel"].shape[0])
    assert 4 * h_pad * 2 <= sg.n_chunks
    xr = np.random.default_rng(0).standard_normal(g.n)
    y = cs.spmv_cpg_sharded(sg, mesh, sg.permute_in(xr, np.float64))
    got = sg.permute_out(mesh.to_host(y))
    np.testing.assert_allclose(got, g.to_scipy() @ xr, rtol=1e-12,
                               atol=1e-12)


def test_pack_keeps_group_pad_tail_and_pads_starts(graphs):
    g = to_port_graph(graphs["barabasi"])
    for n_shards in (2, 3, 5):
        sg = cs.pack_cpg_sharded(g, n_shards, mesh=cpu_mesh(n_shards))
        assert sg.n_chunks % n_shards == 0
        for lv, t_real in zip(sg.levels, sg.t_reals):
            counts = np.stack([d["counts"].numpy() for d in lv])
            starts = np.stack([d["starts"].numpy() for d in lv])
            t_loc = int(lv[0]["s_ids"].shape[0])
            assert int(counts.sum(axis=1).max()) <= max(t_real, 1)
            assert t_loc - t_real >= GROUP_PAD
            assert ((starts + counts) <= t_loc).all() and (starts >= 0).all()


def test_refusals_match_reference(graphs):
    g = graphs["uniform"]
    for kw in (dict(theta_s=50), dict(layout="slab")):
        with pytest.raises(ValueError) as want:
            ref_cs.pack_cpg_sharded(g, 2, **kw)
        with pytest.raises(ValueError) as got:
            cs.pack_cpg_sharded(to_port_graph(g), 2, mesh=cpu_mesh(2), **kw)
        assert str(got.value) == str(want.value)


def test_pack_checks_every_source_id():
    lvd = dict(s_ids=np.array([[0, 3, 7, 0]], np.int32),
               counts=np.array([[2, 1]], np.int32))
    cs._check_sources(lvd, 8, "level")
    with pytest.raises(ValueError, match="outside its 7-chunk source"):
        cs._check_sources(lvd, 7, "level")
    sg = cs.pack_cpg_sharded(to_port_graph(generators.stencil_2d(20)), 2,
                             mesh=cpu_mesh(2))
    split = cs.split_cpg(pack_cpg(to_port_graph(generators.stencil_2d(20)),
                                  theta_s=None, layout="classic",
                                  device="cpu"), 2)
    with pytest.raises(ValueError, match="pack of 2 shards on a mesh of 3"):
        cs.ShardedCPG.from_numpy(split["meta"], split["levels"],
                                 split["realmask"], split["new_of_old"],
                                 cpu_mesh(3))
    assert sg.n_shards == 2


# ---------------------------------------------------------------- levels


@pytest.fixture(scope="module")
def level_case():
    """A pack with own, cross and reduce passes on two shards."""
    g = generators.barabasi_albert(40000, 4, seed=5, use_native=False)
    ref = ref_cs.pack_cpg_sharded(g, 4, sub=128)
    mesh = cpu_mesh(4)
    sg = cs.pack_cpg_sharded(to_port_graph(g), 4, mesh=mesh, sub=128)
    return g, ref, sg, mesh


def test_every_shard_level_bit_identical_to_reference(level_case):
    g, ref, sg, mesh = level_case
    assert sg.overlap and min(sg.t_reals) > 0  # own, cross, reduce
    calls = []

    def record(x2d, level, n_chunks, sub, base=None, slab=False, halo=None):
        assert n_chunks == sg.c_loc and halo is None
        calls.append((x2d.clone(), level))
        return spmv_cpg.run_level_ref(x2d, level, n_chunks, sub, base)

    xr = np.random.default_rng(0).standard_normal(g.n)
    cs._local_spmv(sg, mesh, mesh.split(sg.permute_in(xr, np.float64),
                                        sg.n_loc), record)
    where = {id(d): (li, s) for li, lv in enumerate(sg.levels)
             for s, d in enumerate(lv)}
    seen = set()
    for x2d, level in calls:
        li, s = where[id(level)]
        seen.add(li)
        rl = {k: jnp.asarray(np.asarray(v)[s])
              for k, v in ref.levels[li].items()
              if k not in ("sel", "halo_sel")}
        yt = ref_k._run_level(jnp.asarray(x2d.numpy()), rl, sg.c_loc, sg.sub,
                              True, t_real=ref.t_reals[li],
                              sparse_dispatch=ref.mask_sparse[li])
        want = untranspose(np.asarray(yt), sg.c_loc, sg.sub)
        got = spmv_cpg.run_level_ref(x2d, level, sg.c_loc, sg.sub)
        np.testing.assert_array_equal(got.numpy(), want)
    assert seen == set(range(len(sg.levels)))
    # every level each shard runs
    assert len(calls) == sum(len(cs.shard_passes(sg, s)) for s in range(4))


# --------------------------------------------------------------- Lanczos


@pytest.mark.parametrize("n_shards", [2, 4])
def test_lanczos_cpg_sharded_matches_reference(graphs, n_shards):
    g = graphs["barabasi"]
    ref_mesh = ref_make_mesh(n_shards)
    ref = ref_cs.pack_cpg_sharded(g, n_shards, mesh=ref_mesh)
    x = ref.permute_in(np.ones(g.n), np.float64)
    want = ref_cs.lanczos_cpg_sharded(ref, _ref_x(ref_mesh, x), 15, ref_mesh,
                                      interpret=True)
    mesh = cpu_mesh(n_shards)
    sg = cs.pack_cpg_sharded(to_port_graph(g), n_shards, mesh=mesh)
    got = cs.lanczos_cpg_sharded(sg, x, 15, mesh)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta),
                               rtol=1e-10, atol=1e-10)
    assert len(got.q_basis) == n_shards
    a, b, xn = cs.lanczos_alphabeta_cpg_sharded(sg, x, 15, mesh)
    assert torch.equal(a, got.alpha) and torch.equal(b[:14], got.beta)


@pytest.mark.parametrize("name", ["barabasi", "stencil", "uniform"])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_cpg_matches_oracle(graphs, name, n_shards):
    g = to_port_graph(graphs[name])
    mesh = cpu_mesh(n_shards)
    sg = cs.pack_cpg_sharded(g, n_shards, mesh=mesh)
    ans, _, _, _ = expm_action_sharded(sg, k=25, mesh=mesh, dtype="float64")
    assert oracle.rel_error(ans, oracle.expm_action(g, np.ones(g.n), 25)) \
        < 1e-12


@pytest.mark.parametrize("n_shards", [3, 5])
def test_sharded_cpg_nondividing_shard_count(graphs, n_shards):
    g = to_port_graph(graphs["barabasi"])
    ans, _, _, sg = expm_action_sharded(g, k=20, mesh=cpu_mesh(n_shards),
                                        dtype="float64", fmt="cpg")
    assert sg.n_chunks % n_shards == 0
    assert oracle.rel_error(ans, oracle.expm_action(g, np.ones(g.n), 20)) \
        < 1e-12


def test_hub_reduce_levels_exchange_compact_buffers(graphs):
    g = to_port_graph(graphs["hub"])
    mesh = cpu_mesh(4)
    sg = cs.pack_cpg_sharded(g, 4, mesh=mesh)
    assert len(sg.levels) >= sg.n_main + 1
    for lv in sg.levels[sg.n_main:]:
        assert 4 * int(lv[0]["sel"].shape[0]) < sg.n_chunks
    ans, _, _, _ = expm_action_sharded(sg, k=15, mesh=mesh, dtype="float64")
    assert oracle.rel_error(ans, oracle.expm_action(g, np.ones(g.n), 15)) \
        < 1e-10


@pytest.mark.parametrize("name", ["barabasi", "stencil"])
def test_overlap_split_matches_unsplit(graphs, name):
    g = to_port_graph(graphs[name])
    mesh = cpu_mesh(4)
    runs = {}
    for overlap in (True, False):
        sg = cs.pack_cpg_sharded(g, 4, mesh=mesh, overlap=overlap)
        st = cs.lanczos_cpg_sharded(sg, sg.permute_in(np.ones(g.n),
                                                      np.float64), 20, mesh)
        runs[overlap] = (sg, st)
    (sg1, st1), (sg0, st0) = runs[True], runs[False]
    assert sg1.overlap and not sg0.overlap
    assert sum(sg1.t_reals[:2]) >= sg0.t_reals[0]
    np.testing.assert_allclose(st1.alpha.numpy(), st0.alpha.numpy(),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(st1.beta.numpy(), st0.beta.numpy(),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_one_shard_spmv_equals_single_device(graphs, dtype):
    g = to_port_graph(graphs["hub"])
    cg = pack_cpg(g, device="cpu", **cs.dest_only_kw())
    split = cs.split_cpg(cg, 1)
    mesh = cpu_mesh(1)
    sg = cs.ShardedCPG.from_numpy(split["meta"], split["levels"],
                                  split["realmask"], split["new_of_old"],
                                  mesh)
    x = torch.from_numpy(cg.permute_in(
        np.random.default_rng(1).standard_normal(g.n), dtype))
    (y,) = cs.spmv_cpg_sharded(sg, mesh, x)
    assert torch.equal(y, spmv_cpg.spmv_cpg_ref(cg, x))
    (y_ref,) = cs.spmv_cpg_sharded_ref(sg, mesh, [x])
    assert torch.equal(y_ref, y)


def test_expm_action_sharded_best_is_cpg(graphs):
    g = to_port_graph(graphs["barabasi"])
    ans, shift, _, sg = expm_action_sharded(g, k=20, mesh=cpu_mesh(4),
                                            dtype="float64", fmt="best",
                                            log_scale=True,
                                            pack_kw=dict(sub=256))
    assert isinstance(sg, cs.ShardedCPG) and sg.sub == 256
    want = oracle.expm_action(g, np.ones(g.n), 20)
    assert oracle.rel_error(ans * np.exp(shift), want) < 1e-12
