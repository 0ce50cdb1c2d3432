"""The row-sharded SpMV (row 1d: kernel 1 a pass, ``run_level`` with its
halo read in place, and the df64 shard level ``run_shard_level_df`` in
tpu_lanczos_torch/kernels/spmv_cpg.py, through dist/cpg_sharded.py and
dist/lanczos_df.py) on the CPU, where the wrappers run their plain
versions.

Bars and why:
- the plain versions equal, bit for bit, the composition the sharded
  SpMVs ran before (rebuilt here: a ``run_level_ref`` call a pass and a
  shard on the halo copied behind the shard's rows, ``run_level_comp_ref``
  on hi, the df folds as eager ops),
  in f32, f64 and df64, on a seeded Barabasi-Albert graph whose hub rows
  make reduce levels that exchange ``sel`` chunks (and whose 4-shard
  pack has shards with no tiles, no own tiles, or no reduce tiles), a
  star, a 2-D stencil whose pack takes the halo path (overlap on: the
  cross pass reads ``halo_sel`` chunks; off: the main level reads the
  shard's rows followed by its halo) and a small graph whose cross pass
  is empty, at 1, 3, 4 and 8 shards: skipping a pass or a level with no
  tiles on a shard changes no bit, since every sum starts at +0.0 and is
  never -0.0;
- the sharded SpMV and df SpMV equal the JAX package's sharded bodies
  (``_local_spmv`` / ``_local_spmv_df`` in ``shard_map``, Pallas in
  interpret mode) bit for bit, the bar the existing files hold every
  shard level to (the adds and folds are the same IEEE operations in the
  same order);
- the launches one SpMV makes on each shard (``shard_launches``): in
  f32/f64 one a main pass and one a reduce level with tiles on the
  shard, in df64 one for its main level and one a reduce level with
  tiles on it;
- ``eval/shard_alone.py``'s one shard alone, its exchanges replayed,
  returns what the whole mesh's SpMV returns for the shard, bit for bit.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.dist import cpg_sharded as ref_cs
from tpu_lanczos.dist import lanczos_df as ref_ldf
from tpu_lanczos.dist import make_mesh as ref_make_mesh
from tpu_lanczos.dist.mesh import ROWS
from tpu_lanczos.graphs import generators
from tpu_lanczos_torch.core.df64 import two_sum
from tpu_lanczos_torch.core.lanczos_df import split_f64
from tpu_lanczos_torch.dist import cpg_sharded as cs
from tpu_lanczos_torch.dist import lanczos_df as ldf
from tpu_lanczos_torch.dist.mesh import make_mesh
from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.cpg import LANE

from _torch_cases import star_graph, to_port_graph

# name -> (graph, pack keywords)
GRAPHS = {
    "barabasi40k": (lambda: generators.barabasi_albert(
        40000, 4, seed=5, use_native=False), dict(sub=128)),
    "star": (lambda: star_graph(3000), {}),
    "stencil_halo": (lambda: generators.stencil_2d(200), dict(sub=128)),
    "stencil_halo_unsplit": (lambda: generators.stencil_2d(200),
                             dict(sub=128, overlap=False)),
    "cross_empty": (lambda: generators.barabasi_albert(
        3000, 8, seed=2, use_native=False), {}),
}
SHARDS = [1, 3, 4, 8]


@pytest.fixture(scope="module")
def graphs():
    return {name: to_port_graph(make()) for name, (make, _) in GRAPHS.items()}


def _pack(graphs, name, n_shards):
    mesh = make_mesh(n_shards, device="cpu")
    return mesh, cs.pack_cpg_sharded(graphs[name], n_shards, mesh=mesh,
                                     **GRAPHS[name][1])


def _x(sg, seed=0):
    return sg.permute_in(np.random.default_rng(seed).standard_normal(
        sg.n), np.float64)


# ---- the former composition, one level call a pass and a shard


def _former_spmv(sg, mesh, q):
    """The sharded SpMV as it ran before: every pass of every shard one
    ``run_level_ref`` call, the halo copied behind the shard's rows, the
    cross pass and each reduce level given the running y as base."""
    c_loc, sub = sg.c_loc, sg.sub
    rows = c_loc * sub

    def run(level, src, base=None):
        return [spmv_cpg.run_level_ref(
            x.reshape(-1, LANE), lv, c_loc, sub,
            None if b is None else b.reshape(rows, LANE)).reshape(-1)
            for x, lv, b in zip(src, level, base or [None] * len(src))]

    if sg.overlap:
        lv_own, lv_cross = sg.levels[0], sg.levels[1]
        gathered = (None if sg.t_reals[1] == 0
                    else cs._exchange(sg, mesh, lv_cross, q, "halo_sel"))
        y = ([torch.zeros_like(t) for t in q] if sg.t_reals[0] == 0
             else run(lv_own, q))
        if sg.t_reals[1]:
            y = run(lv_cross, gathered, base=y)
        base = 2
    else:
        lv0 = sg.levels[0]
        src = cs._exchange(sg, mesh, lv0, q, "halo_sel")
        if "halo_sel" in lv0[0]:
            src = [torch.cat([t, h]) for t, h in zip(q, src)]
        y = run(lv0, src)
        base = 1
    for level in sg.levels[base:]:
        y = run(level, cs._exchange(sg, mesh, level, y, "sel"), base=y)
    return [t * r.to(t.dtype) for t, r in zip(y, sg.realmask)]


def _former_spmv_df(sg, mesh, q_hi, q_lo):
    """The sharded df SpMV as it ran before the shard kernels: every pass
    of every shard compensated on hi and plain on lo, the folds as eager
    ops."""
    c_loc, sub = sg.c_loc, sg.sub
    rows = c_loc * sub
    comp_fn, level_fn = spmv_cpg.run_level_comp_ref, spmv_cpg.run_level_ref

    def run(fn, level, src):
        return [fn(x.reshape(-1, LANE), lv, c_loc, sub)
                for x, lv in zip(src, level)]

    def gather(level, vec):
        return cs._exchange(sg, mesh, level, vec, "halo_sel")

    if sg.overlap:
        lv_own, lv_cross = sg.levels[0], sg.levels[1]
        if sg.t_reals[1]:
            g_hi, g_lo = gather(lv_cross, q_hi), gather(lv_cross, q_lo)
        if sg.t_reals[0] == 0:
            y2d = [t.new_zeros((rows, LANE)) for t in q_hi]
            e2d = [t.new_zeros((rows, LANE)) for t in q_hi]
        else:
            comp = run(comp_fn, lv_own, q_hi)
            lt = run(level_fn, lv_own, q_lo)
            y2d = [c[0] for c in comp]
            e2d = [c[1] + b for c, b in zip(comp, lt)]
        if sg.t_reals[1]:
            comp = run(comp_fn, lv_cross, g_hi)
            lt = run(level_fn, lv_cross, g_lo)
            for s, (c, b) in enumerate(zip(comp, lt)):
                y2d[s], t = two_sum(y2d[s], c[0])
                e2d[s] = ((e2d[s] + t) + c[1]) + b
        base = 2
    else:
        lv0 = sg.levels[0]
        src_hi, src_lo = gather(lv0, q_hi), gather(lv0, q_lo)
        if "halo_sel" in lv0[0]:
            src_hi = [torch.cat([t, h]) for t, h in zip(q_hi, src_hi)]
            src_lo = [torch.cat([t, h]) for t, h in zip(q_lo, src_lo)]
        comp = run(comp_fn, lv0, src_hi)
        lt = run(level_fn, lv0, src_lo)
        y2d = [c[0] for c in comp]
        e2d = [c[1] + b for c, b in zip(comp, lt)]
        base = 1
    y = [t.reshape(-1) for t in y2d]
    e = [t.reshape(-1) for t in e2d]
    for level in sg.levels[base:]:
        comp = run(comp_fn, level, cs._exchange(sg, mesh, level, y, "sel"))
        lt = run(level_fn, level, cs._exchange(sg, mesh, level, e, "sel"))
        out_y, out_e = [], []
        for ys, es, c, b in zip(y, e, comp, lt):
            ys, t = two_sum(ys, c[0].reshape(-1))
            out_y.append(ys)
            out_e.append(((es + t) + c[1].reshape(-1)) + b.reshape(-1))
        y, e = out_y, out_e
    out = []
    for ys, es, r in zip(y, e, sg.realmask):
        hi, lo = two_sum(ys, es)
        out.append((hi * r, lo * r))
    return out


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_plain_versions_equal_the_former_composition(graphs, name,
                                                     n_shards):
    mesh, sg = _pack(graphs, name, n_shards)
    x64 = _x(sg)
    for dt in (np.float32, np.float64):
        q = mesh.split(x64.astype(dt), sg.n_loc)
        want = _former_spmv(sg, mesh, q)
        assert _equal(cs.spmv_cpg_sharded_ref(sg, mesh, q), want)
        # the kernels' route: on CPU shards the wrappers run the plain
        # versions
        assert _equal(cs.spmv_cpg_sharded(sg, mesh, q), want)
    hi, lo = split_f64(x64)
    hi, lo = mesh.split(hi, sg.n_loc), mesh.split(lo, sg.n_loc)
    want = _former_spmv_df(sg, mesh, hi, lo)
    for fn in (ldf.spmv_cpg_df_sharded_ref, ldf.spmv_cpg_df_sharded):
        got = fn(sg, mesh, hi, lo)
        assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                   for a, b in zip(got, want))


def test_the_cases_reach_every_branch(graphs):
    """The packs above hold what the bars are about: reduce levels with
    tiles on one shard only, a shard with no tiles, a shard with cross
    tiles and no own tiles, a halo on the cross pass and on the unsplit
    main level, and an empty cross pass."""
    _, sg = _pack(graphs, "barabasi40k", 4)
    assert sg.overlap and len(sg.levels) > 2 and "sel" in sg.levels[2][0]
    tiles = np.asarray(sg.shard_tiles)
    assert (tiles[2:, 1:] == 0).all() and (tiles[2:, 0] > 0).all()
    assert (tiles[:, 3] == 0).all()
    assert tiles[0, 1] == 0 and tiles[1, 1] > 0
    _, sg = _pack(graphs, "stencil_halo", 4)
    assert sg.overlap and "halo_sel" in sg.levels[1][0]
    _, sg = _pack(graphs, "stencil_halo_unsplit", 4)
    assert not sg.overlap and "halo_sel" in sg.levels[0][0]
    _, sg = _pack(graphs, "cross_empty", 4)
    assert sg.overlap and sg.t_reals[1] == 0 and sg.t_reals[0] > 0
    _, sg = _pack(graphs, "star", 3)
    assert len(sg.levels) > 2


def _ref_args(ref_sg, x):
    mesh = ref_make_mesh(ref_sg.n_shards)
    spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(ROWS))
    return mesh, [jax.device_put(jnp.asarray(a), spec) for a in x]


def _ref_spmv(ref_sg, x):
    """The JAX package's sharded SpMV body on its pack (shard_map over
    virtual CPU devices, Pallas in interpret mode)."""
    P = jax.sharding.PartitionSpec
    mesh, (xj,) = _ref_args(ref_sg, [x])

    def f(levels, realmask, q):
        return ref_cs._local_spmv(levels, realmask, q, ref_sg.sub,
                                  ref_sg.c_loc, True, ref_sg.t_reals,
                                  ref_sg.mask_sparse, ref_sg.overlap)

    return np.asarray(jax.shard_map(
        f, mesh=mesh, in_specs=(ref_cs._rows_specs(ref_sg.levels), P(ROWS),
                                P(ROWS)), out_specs=P(ROWS),
        check_vma=False)(ref_sg.levels, ref_sg.realmask, xj))


def _ref_spmv_df(ref_sg, hi, lo):
    """The JAX package's sharded df SpMV body on its pack."""
    P = jax.sharding.PartitionSpec
    mesh, (hj, lj) = _ref_args(ref_sg, [hi, lo])

    def f(levels, realmask, q_hi, q_lo):
        return ref_ldf._local_spmv_df(levels, realmask, q_hi, q_lo,
                                      ref_sg.sub, ref_sg.c_loc, True,
                                      ref_sg.t_reals, ref_sg.mask_sparse,
                                      ref_sg.overlap)

    out = jax.shard_map(
        f, mesh=mesh, in_specs=(ref_cs._rows_specs(ref_sg.levels), P(ROWS),
                                P(ROWS), P(ROWS)),
        out_specs=(P(ROWS), P(ROWS)), check_vma=False)(
        ref_sg.levels, ref_sg.realmask, hj, lj)
    return [np.asarray(t) for t in out]


@pytest.mark.parametrize("name,n_shards", [
    ("star", 3), ("stencil_halo", 4), ("stencil_halo_unsplit", 4),
    ("cross_empty", 4), ("barabasi40k", 4)])
def test_sharded_spmvs_equal_the_reference_bodies(graphs, name, n_shards):
    make, kw = GRAPHS[name]
    ref_sg = ref_cs.pack_cpg_sharded(make(), n_shards, **kw)
    mesh, sg = _pack(graphs, name, n_shards)
    x64 = _x(sg, seed=3)
    for dt in (np.float32, np.float64):
        got = mesh.to_host(cs.spmv_cpg_sharded(
            sg, mesh, mesh.split(x64.astype(dt), sg.n_loc)))
        np.testing.assert_array_equal(got, _ref_spmv(ref_sg, x64.astype(dt)))
    hi, lo = split_f64(x64)
    got = ldf.spmv_cpg_df_sharded(sg, mesh, mesh.split(hi, sg.n_loc),
                                  mesh.split(lo, sg.n_loc))
    want = _ref_spmv_df(ref_sg, hi, lo)
    for i in range(2):
        np.testing.assert_array_equal(mesh.to_host([p[i] for p in got]),
                                      want[i])


@pytest.mark.parametrize("n_shards", SHARDS)
def test_shard_launches(graphs, n_shards):
    """f32/f64: a launch a main pass with tiles on the shard (the own
    pass, empty, where neither has) and one a reduce level with tiles on
    it; df64: one for the main level, both passes in it, and one a
    reduce level with tiles on the shard.  A reduce level with tiles on
    no shard takes no exchange."""
    _, sg = _pack(graphs, "barabasi40k", n_shards)
    reduce = range(sg.n_main, len(sg.levels))
    tiles = sg.shard_tiles
    n_reduce = [sum(1 for li in reduce if tiles[li][s])
                for s in range(n_shards)]
    n_main = [max(1, sum(1 for p in range(sg.n_main) if tiles[p][s]))
              for s in range(n_shards)]
    assert cs.shard_launches(sg) == [m + r for m, r in zip(n_main, n_reduce)]
    assert cs.shard_launches(sg, df=True) == [1 + r for r in n_reduce]
    assert cs._reduce_levels(sg) == [li for li in reduce
                                     if any(tiles[li])]
    # the static counts are the pack's own
    assert tiles == tuple(tuple(int(lv["counts"].sum()) for lv in level)
                          for level in sg.levels)


@pytest.mark.parametrize("name", ["barabasi40k", "stencil_halo_unsplit"])
def test_level_calls_of_a_sharded_spmv(graphs, name):
    """The f32 SpMV calls its level function once a pass a shard runs,
    the own pass with no base, every later pass and reduce level with
    the running y; the unsplit halo pack's level reads the shard's rows
    and the halo as two buffers, as the plain version's concatenation."""
    mesh, sg = _pack(graphs, name, 4)
    q = mesh.split(_x(sg).astype(np.float32), sg.n_loc)
    seen = []

    def record(x2d, level, n_chunks, sub, base=None, halo=None):
        seen.append((base is None, halo is None))
        return spmv_cpg.run_level_ref(x2d, level, n_chunks, sub, base,
                                      halo=halo)

    cs._local_spmv(sg, mesh, q, record)
    # (no base, no halo) a call, shard by shard, then the reduce levels
    want = []
    for s in range(4):
        main = [li for li in cs.shard_passes(sg, s) if li < sg.n_main]
        want += [(i == 0, "halo_sel" not in sg.levels[li][s] or sg.overlap)
                 for i, li in enumerate(main)]
    n_reduce = sum(1 for li in cs._reduce_levels(sg) for s in range(4)
                   if sg.shard_tiles[li][s])
    assert seen == want + [(False, True)] * n_reduce
    if not sg.overlap:
        lv = sg.levels[0][0]
        halo = cs._main_exchange(sg, mesh, q)[0]
        np.testing.assert_array_equal(
            spmv_cpg.run_level_ref(q[0].reshape(-1, LANE), lv, sg.c_loc,
                                   sg.sub, halo=halo).numpy(),
            spmv_cpg.run_level_ref(torch.cat([q[0], halo]).reshape(-1, LANE),
                                   lv, sg.c_loc, sg.sub).numpy())


def test_df_plain_version_keeps_and_finishes(graphs):
    """``run_shard_level_df_ref`` keeps or finishes what it is asked
    for, the mask exact, and refuses to do neither."""
    mesh, sg = _pack(graphs, "barabasi40k", 4)
    q = mesh.split(_x(sg).astype(np.float32), sg.n_loc)
    gathered = cs._main_exchange(sg, mesh, q)
    walks = cs._main_walks(sg, 1, 1, q[1], gathered[1])
    assert [w[0] is sg.levels[1][1] for w in walks] == [True]
    walks0 = cs._main_walks(sg, 0, 0, q[0], gathered[0])
    assert [w[0] is sg.levels[p][0] for p, w in enumerate(walks0)] == [
        True, True]  # shard 0 has own and cross tiles
    lo = [torch.full_like(t, 1e-9) * sg.realmask[0] for t in q]
    g_lo = cs._main_exchange(sg, mesh, lo)
    dwalks = [(lv, h, l_) for (lv, h), (_, l_) in zip(
        walks0, cs._main_walks(sg, 0, 0, lo[0], g_lo[0]))]
    ye, fin = spmv_cpg.run_shard_level_df_ref(dwalks, sg.c_loc, sg.sub,
                                              keep=True, finish=True,
                                              mask=sg.realmask[0])
    hi_, lo_ = two_sum(*ye)
    assert torch.equal(fin[0], hi_ * sg.realmask[0])
    assert torch.equal(fin[1], lo_ * sg.realmask[0])
    assert spmv_cpg.run_shard_level_df_ref(dwalks, sg.c_loc, sg.sub,
                                           keep=False, finish=True)[0] is None
    assert spmv_cpg.run_shard_level_df_ref(dwalks, sg.c_loc, sg.sub)[1] is None
    with pytest.raises(ValueError, match="keeps"):
        spmv_cpg.run_shard_level_df_ref(dwalks, sg.c_loc, sg.sub,
                                        keep=False)
    with pytest.raises(ValueError, match="keeps"):
        spmv_cpg.run_shard_level_df(dwalks, sg.c_loc, sg.sub, keep=False)


def test_wrappers_refuse_what_the_kernels_do_not_take(graphs):
    """The walk checks run before any launch: 1 or 2 (level, hi, lo)
    walks, float32 sources of whole chunks, both streams alike; a meta
    tensor is no device the kernels run on."""
    mesh, sg = _pack(graphs, "barabasi40k", 4)
    q = mesh.split(_x(sg).astype(np.float32), sg.n_loc)
    lv = sg.levels[0][0]
    walk = (lv, (q[0],), (q[0],))
    f64 = q[0].double()
    n = sg.c_loc * sg.sub * LANE
    with pytest.raises(ValueError, match="1 or 2"):
        spmv_cpg._check_shard([walk] * 3, sg.c_loc, sg.sub)
    with pytest.raises(ValueError, match="1 or 2"):
        spmv_cpg._check_shard([(lv, (q[0],))], sg.c_loc, sg.sub)
    with pytest.raises(ValueError, match="whole"):
        spmv_cpg._check_shard([(lv, (q[0][:-LANE],), (q[0][:-LANE],))],
                              sg.c_loc, sg.sub)
    with pytest.raises(ValueError, match="whole"):
        spmv_cpg._check_shard([(lv, (q[0],), (f64,))], sg.c_loc, sg.sub)
    with pytest.raises(ValueError, match="same number"):
        spmv_cpg._check_shard([(lv, (q[0],), (q[0], q[0]))], sg.c_loc,
                              sg.sub)
    with pytest.raises(ValueError, match="float32"):
        spmv_cpg._check_shard([(lv, (f64,), (f64,))], sg.c_loc, sg.sub)
    with pytest.raises(ValueError, match="mask must be"):
        spmv_cpg._check_vector(torch.zeros(n - 1), n, q[0].device, "mask")
    meta = q[0].to("meta")
    with pytest.raises(ValueError, match="no CPG SpMV"):
        spmv_cpg.run_level(meta.reshape(-1, LANE), lv, sg.c_loc, sg.sub,
                           halo=meta)
    with pytest.raises(ValueError, match="no CPG SpMV"):
        spmv_cpg.run_shard_level_df([(lv, (meta,), (meta,))], sg.c_loc,
                                    sg.sub)


@pytest.mark.parametrize("name", ["barabasi40k", "stencil_halo_unsplit",
                                  "stencil_halo"])
def test_one_shard_alone_equals_its_part_of_the_mesh(graphs, name):
    """eval/shard_alone.py: each shard's SpMV and df SpMV on a mesh of
    that shard alone, its exchanges replayed, twice in a row, equal its
    slice of the whole mesh's, bit for bit."""
    from tpu_lanczos_torch.eval.shard_alone import alone_fn

    mesh, sg = _pack(graphs, name, 4)
    x64 = _x(sg, seed=7)
    q = mesh.split(x64.astype(np.float32), sg.n_loc)
    hi, lo = (mesh.split(a, sg.n_loc) for a in split_f64(x64))
    want = cs.spmv_cpg_sharded(sg, mesh, q)
    want_df = ldf.spmv_cpg_df_sharded(sg, mesh, hi, lo)
    alone = alone_fn(cs.spmv_cpg_sharded, sg, mesh, q)
    alone_df = alone_fn(ldf.spmv_cpg_df_sharded, sg, mesh, hi, lo)
    for s in (0, 2, 0):
        assert torch.equal(alone(s), want[s])
        got = alone_df(s)
        assert torch.equal(got[0], want_df[s][0])
        assert torch.equal(got[1], want_df[s][1])


def test_one_shard_spmvs_equal_single_device(graphs):
    """At one shard the main level is the unsplit level on the gathered
    vector: the sharded SpMV and df SpMV equal the single-device ones on
    the same dest-only pack, bit for bit."""
    from tpu_lanczos_torch.kernels.cpg import pack_cpg

    g = graphs["star"]
    cg = pack_cpg(g, device="cpu", **cs.dest_only_kw())
    split = cs.split_cpg(cg, 1)
    mesh = make_mesh(1, device="cpu")
    sg = cs.ShardedCPG.from_numpy(split["meta"], split["levels"],
                                  split["realmask"], split["new_of_old"],
                                  mesh)
    x = _x(sg, seed=5)
    xt = torch.from_numpy(x.astype(np.float32))
    (y,) = cs.spmv_cpg_sharded(sg, mesh, [xt])
    assert torch.equal(y, spmv_cpg.spmv_cpg_ref(cg, xt))
    hi, lo = (torch.from_numpy(a) for a in split_f64(x))
    ((yh, yl),) = ldf.spmv_cpg_df_sharded(sg, mesh, [hi], [lo])
    wh, wl = spmv_cpg.spmv_cpg_df_ref(cg, hi, lo)
    assert torch.equal(yh, wh) and torch.equal(yl, wl)


@pytest.mark.parametrize("n_shards", [3, 4])
def test_sharded_queries_count_their_walks(graphs, n_shards, monkeypatch):
    """The Lanczos loops and the df64 query run each SpMV as the level
    calls ``shard_launches`` counts: in f32 one a pass and a reduce level
    a shard runs, in df64 one for a shard's main level and one a reduce
    level, and no other level call."""
    mesh, sg = _pack(graphs, "barabasi40k", n_shards)
    calls = {"level": 0, "df": 0}

    def counting(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(cs, "run_level", counting("level",
                                                  spmv_cpg.run_level))
    monkeypatch.setattr(ldf, "run_shard_level_df",
                        counting("df", spmv_cpg.run_shard_level_df))
    k = 6
    cs.lanczos_cpg_sharded(sg, sg.permute_in(np.ones(sg.n), np.float32), k,
                           mesh)
    assert calls == {"level": k * sum(cs.shard_launches(sg)), "df": 0}
    calls.update(level=0)
    ldf.expm_action_df_sharded(graphs["barabasi40k"], k=k, mesh=mesh, sg=sg)
    assert calls == {"level": 0, "df": (2 * k - 1) * sum(
        cs.shard_launches(sg, df=True))}
