"""The port's row-sharded df64 pipeline (tpu_lanczos_torch/dist/
lanczos_df.py: kernel 1c on hi and kernel 1 on lo on every shard level,
exact df folds across shards) against the JAX package's
(tpu_lanczos/dist/lanczos_df.py) and the f64 oracle, on the CPU.

Bars and why:
- every compensated shard level (own, cross and reduce passes) through
  ``run_level_comp_ref`` with ``c_loc`` dest chunks bit-identical to the
  reference's ``_run_level(..., compensated=True, interpret=True)``, on
  the inputs one df SpMV gives it (the 40,000-node pack of
  tests/test_torch_cpg_sharded.py, whose cross pass is not empty);
- the 1-shard df SpMV bit-identical to single-device ``spmv_cpg_df`` on
  the same dest-only pack;
- the reference's own bars (tests/test_dist_df64.py): against the f64
  oracle < 5e-12 at 2, 5 and 8 shards and on every graph, against
  single-device df64 < 1e-12 (alpha within 1e-12), the overlap split
  against the unsplit main level < 1e-13, and the log-scale surface
  against single-device df64 < 1e-12 on the common scale;
- against the reference's sharded df64 on the same graph < 1e-12 (both
  are within ~1e-13 of the oracle; the folds' orders differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.dist import cpg_sharded as ref_cs
from tpu_lanczos.dist import make_mesh as ref_make_mesh
from tpu_lanczos.dist.lanczos_df import expm_action_df_sharded as ref_df_sh
from tpu_lanczos.graphs import generators
from tpu_lanczos.kernels import spmv_cpg as ref_k
from tpu_lanczos_torch.core.lanczos_df import expm_action_df, split_f64
from tpu_lanczos_torch.dist import cpg_sharded as cs
from tpu_lanczos_torch.dist import lanczos_df as ldf
from tpu_lanczos_torch.dist.mesh import make_mesh
from tpu_lanczos_torch.eval import oracle
from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.cpg import pack_cpg

from _torch_cases import to_port_graph, untranspose

GRAPHS = {
    "barabasi": lambda: generators.barabasi_albert(2000, 5, seed=2,
                                                   use_native=False),
    "uniform": lambda: generators.uniform_random(1500, 6000, seed=1),
    "stencil": lambda: generators.stencil_2d(40),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: to_port_graph(make()) for name, make in GRAPHS.items()}


def cpu_mesh(n):
    return make_mesh(n, device="cpu")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_every_compensated_shard_level_bit_identical_to_reference(
        monkeypatch):
    g = generators.barabasi_albert(40000, 4, seed=5, use_native=False)
    ref = ref_cs.pack_cpg_sharded(g, 4, sub=128)
    mesh = cpu_mesh(4)
    sg = cs.pack_cpg_sharded(to_port_graph(g), 4, mesh=mesh, sub=128)
    assert sg.overlap and min(sg.t_reals) > 0
    calls = []

    real_comp = spmv_cpg.run_level_comp_ref

    def comp(x2d, level, n_chunks, sub, slab=False):
        calls.append((x2d.clone(), level))
        return real_comp(x2d, level, n_chunks, sub)

    # the df64 shard level's plain version walks hi through this
    monkeypatch.setattr(spmv_cpg, "run_level_comp_ref", comp)
    hi, lo = split_f64(sg.permute_in(
        np.random.default_rng(2).standard_normal(g.n), np.float64))
    ldf._local_spmv_df(sg, mesh, list(zip(mesh.split(hi, sg.n_loc),
                                          mesh.split(lo, sg.n_loc))),
                       spmv_cpg.run_shard_level_df_ref)
    monkeypatch.undo()
    where = {id(d): (li, s) for li, lv in enumerate(sg.levels)
             for s, d in enumerate(lv)}
    # every level each shard runs
    assert len(calls) == sum(len(cs.shard_passes(sg, s)) for s in range(4))
    assert {where[id(lv)][0] for _, lv in calls} == set(range(len(sg.levels)))
    for x2d, level in calls:
        li, s = where[id(level)]
        rl = {k: jnp.asarray(np.asarray(v)[s])
              for k, v in ref.levels[li].items()
              if k not in ("sel", "halo_sel")}
        acc, err = ref_k._run_level(jnp.asarray(x2d.numpy()), rl, sg.c_loc,
                                    sg.sub, True, compensated=True,
                                    t_real=ref.t_reals[li],
                                    sparse_dispatch=ref.mask_sparse[li])
        got = spmv_cpg.run_level_comp_ref(x2d, level, sg.c_loc, sg.sub)
        for g_t, w_t in zip(got, (acc, err)):
            np.testing.assert_array_equal(
                g_t.numpy(), untranspose(np.asarray(w_t), sg.c_loc, sg.sub))


def test_one_shard_df_spmv_equals_single_device(graphs):
    g = graphs["barabasi"]
    cg = pack_cpg(g, device="cpu", **cs.dest_only_kw())
    split = cs.split_cpg(cg, 1)
    mesh = cpu_mesh(1)
    sg = cs.ShardedCPG.from_numpy(split["meta"], split["levels"],
                                  split["realmask"], split["new_of_old"],
                                  mesh)
    hi, lo = (torch.from_numpy(a) for a in split_f64(cg.permute_in(
        np.random.default_rng(3).standard_normal(g.n), np.float64)))
    ((yh, yl),) = ldf.spmv_cpg_df_sharded(sg, mesh, [hi], [lo])
    wh, wl = spmv_cpg.spmv_cpg_df_ref(cg, hi, lo)
    assert torch.equal(yh, wh) and torch.equal(yl, wl)
    ((rh, rl),) = ldf.spmv_cpg_df_sharded_ref(sg, mesh, [hi], [lo])
    assert torch.equal(rh, yh) and torch.equal(rl, yl)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_sharded_df64_matches_oracle(graphs, name):
    g = graphs[name]
    res = ldf.expm_action_df_sharded(g, k=30, mesh=cpu_mesh(8))
    assert _rel(res.ans, oracle.expm_action(g, np.ones(g.n), 30)) < 5e-12


def test_sharded_df64_matches_single_device_df64(graphs):
    g = graphs["uniform"]
    res_sh = ldf.expm_action_df_sharded(g, k=25, mesh=cpu_mesh(8))
    res_1 = expm_action_df(g, k=25, device="cpu")
    assert _rel(res_sh.ans, res_1.ans) < 1e-12
    np.testing.assert_allclose(res_sh.alpha, res_1.alpha, rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("n_shards", [2, 5, 8])
def test_sharded_df64_device_count_invariance(graphs, n_shards):
    g = graphs["barabasi"]
    res = ldf.expm_action_df_sharded(g, k=20, n_shards=n_shards,
                                     device="cpu")
    assert _rel(res.ans, oracle.expm_action(g, np.ones(g.n), 20)) < 5e-12


def test_sharded_df64_overlap_split_matches_unsplit(graphs):
    g = graphs["stencil"]
    mesh = cpu_mesh(4)
    r_ov = ldf.expm_action_df_sharded(g, k=20, mesh=mesh, overlap=True)
    r_no = ldf.expm_action_df_sharded(g, k=20, mesh=mesh, overlap=False)
    assert _rel(r_ov.ans, r_no.ans) < 1e-13


def test_sharded_df64_log_scale_and_start_vector(graphs):
    g = graphs["barabasi"]
    mesh = cpu_mesh(4)
    r_sh = ldf.expm_action_df_sharded(g, k=20, mesh=mesh, log_scale=True)
    r_1 = expm_action_df(g, k=20, log_scale=True, device="cpu")
    a = r_sh.ans * np.exp(r_sh.log_scale - r_1.log_scale)
    assert _rel(a, r_1.ans) < 1e-12
    x = np.random.default_rng(4).standard_normal(g.n)
    r_x = ldf.expm_action_df_sharded(g, x, k=12, mesh=mesh)
    assert _rel(r_x.ans, oracle.expm_action(g, x, 12)) < 5e-12


def test_sharded_df64_matches_reference():
    g = generators.barabasi_albert(2000, 5, seed=2, use_native=False)
    want = ref_df_sh(g, k=12, mesh=ref_make_mesh(2))
    got = ldf.expm_action_df_sharded(to_port_graph(g), k=12, mesh=cpu_mesh(2))
    assert _rel(got.ans, want.ans) < 1e-12
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=1e-12,
                               atol=1e-13)
    assert got.x_norm == pytest.approx(want.x_norm, rel=1e-15)
