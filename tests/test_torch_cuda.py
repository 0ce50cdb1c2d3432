"""The CUDA kernels against their plain PyTorch versions on the card: the
CPG SpMV kernels (classic and slab layout, plain and compensated, on one
device and on every shard level of the row-sharded path; both walks bit
for bit), the CST and GPG level kernels and the dense-block probe (at
several partitions); and the f32, df64, CST, GPG and row-sharded
pipelines on CUDA against the float64 oracle.

Marked ``cuda``: each test skips (with its reason) where no CUDA device
is present, and runs on a GPU machine with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

This file imports only the port, and ``--noconftest`` skips
tests/conftest.py, which imports jax (the GPU machine has none).
"""

import numpy as np
import pytest
import torch

from tpu_lanczos_torch import (CSRGraph, expm_action, expm_action_df,
                               generators)
from tpu_lanczos_torch.kernels import (cpg, cst, gpg, spmv_cpg, spmv_cst,
                                       spmv_gpg)
from tpu_lanczos_torch.eval import mxu_probe, oracle

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("sub", [128, 256, 512])
def test_kernel_equals_plain_version(dev, sub):
    g = generators.barabasi_albert(40000, 6, seed=3)
    cg = cpg.pack_cpg(g, sub=sub, device=dev)
    x = torch.from_numpy(cg.permute_in(
        np.random.default_rng(0).standard_normal(g.n), np.float32)).to(dev)
    before = spmv_cpg.launches
    y = spmv_cpg.spmv_cpg(cg, x)
    torch.cuda.synchronize()
    assert spmv_cpg.launches - before == len(cg.levels)
    assert torch.equal(y, spmv_cpg.spmv_cpg_ref(cg, x))


def test_pipeline_on_cuda_matches_oracle(dev):
    g = generators.barabasi_albert(2000, 8, seed=2)
    res = expm_action(g, k=30, dtype="float64", device=dev)
    want = oracle.expm_action(g, np.ones(g.n), 30)
    assert oracle.rel_error(res.ans, want) < 1e-12


@pytest.mark.parametrize("sub", [128, 256, 512])
def test_comp_kernel_equals_plain_version(dev, sub):
    """Every level of one df SpMV, fed the inputs spmv_cpg_df gives it,
    through the compensated kernel and its plain version: equal acc and
    err; the whole df SpMV equal to spmv_cpg_df_ref."""
    g = generators.barabasi_albert(40000, 6, seed=3)
    cg = cpg.pack_cpg(g, sub=sub, device=dev)
    x64 = cg.permute_in(np.random.default_rng(1).standard_normal(g.n),
                        np.float64)
    hi = torch.from_numpy(x64.astype(np.float32)).to(dev)
    lo = torch.from_numpy((x64 - x64.astype(np.float32)).astype(
        np.float32)).to(dev)

    def checked_comp(x2d, level, n_chunks, sub_, slab=False):
        acc, err = spmv_cpg.run_level_comp(x2d, level, n_chunks, sub_, slab)
        acc_ref, err_ref = spmv_cpg.run_level_comp_ref(x2d, level, n_chunks,
                                                       sub_, slab)
        assert torch.equal(acc, acc_ref) and torch.equal(err, err_ref)
        return acc, err

    before = spmv_cpg.launches_comp
    yh, yl = spmv_cpg._spmv_df(cg, hi, lo, spmv_cpg.run_level, checked_comp)
    torch.cuda.synchronize()
    assert spmv_cpg.launches_comp - before == len(cg.levels) - cg.n_bcast
    h, l = spmv_cpg.spmv_cpg_df_ref(cg, hi, lo)
    assert torch.equal(yh, h) and torch.equal(yl, l)


def test_df64_on_cuda_matches_oracle(dev):
    g = generators.barabasi_albert(2000, 8, seed=2)
    res = expm_action_df(g, k=30, device=dev)
    want = oracle.expm_action(g, np.ones(g.n), 30)
    assert oracle.rel_error(res.ans, want) < 1e-12


@pytest.mark.parametrize("sub", [128, 256, 512])
def test_slab_kernels_equal_plain_versions(dev, sub):
    """A slab pack of a graph with several slabs per chunk: every level
    of the f32 and f64 SpMV through the slab kernel, and of one df SpMV
    through the compensated slab kernel, equal to the plain versions on
    the same inputs; the launch counters advance by exactly the levels
    run; the f64 SpMV matches scipy."""
    g = generators.barabasi_albert(40000, 4, seed=1)
    cg = cpg.pack_cpg(g, sub=sub, layout="slab", device=dev)
    assert cg.layout == "slab"
    xr = np.random.default_rng(2).standard_normal(g.n)

    def checked_plain(x2d, level, n_chunks, sub_, base=None, slab=False):
        assert slab
        got = spmv_cpg.run_level(x2d, level, n_chunks, sub_, base, slab)
        assert torch.equal(got, spmv_cpg.run_level_ref(
            x2d, level, n_chunks, sub_, base, slab))
        return got

    def checked_comp(x2d, level, n_chunks, sub_, slab=False):
        assert slab
        got = spmv_cpg.run_level_comp(x2d, level, n_chunks, sub_, slab)
        want = spmv_cpg.run_level_comp_ref(x2d, level, n_chunks, sub_, slab)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return got

    L = len(cg.levels)
    before = (spmv_cpg.launches_slab, spmv_cpg.launches_comp_slab,
              spmv_cpg.launches, spmv_cpg.launches_comp)
    for np_dtype in (np.float32, np.float64):
        x = torch.from_numpy(cg.permute_in(xr, np_dtype)).to(dev)
        y = spmv_cpg._spmv(cg, x, checked_plain)
        if np_dtype == np.float64:
            np.testing.assert_allclose(cg.permute_out(y), g.to_scipy() @ xr,
                                       rtol=1e-11, atol=1e-11)
    x64 = cg.permute_in(xr, np.float64)
    hi = torch.from_numpy(x64.astype(np.float32)).to(dev)
    lo = torch.from_numpy((x64 - x64.astype(np.float32)).astype(
        np.float32)).to(dev)
    yh, yl = spmv_cpg._spmv_df(cg, hi, lo, checked_plain, checked_comp)
    torch.cuda.synchronize()
    after = (spmv_cpg.launches_slab, spmv_cpg.launches_comp_slab,
             spmv_cpg.launches, spmv_cpg.launches_comp)
    nb = cg.n_bcast
    assert after[0] - before[0] == 2 * L + (L + nb)
    assert after[1] - before[1] == L - nb
    assert after[2:] == before[2:]  # the classic counters do not move
    h, l = spmv_cpg.spmv_cpg_df_ref(cg, hi, lo)
    assert torch.equal(yh, h) and torch.equal(yl, l)


def test_serving_paths_on_cuda(dev):
    """The fused device-eigh summary gives the host path's top nodes; the
    pipelined answers equal sequential expm_action bit for bit; the COO
    format and reorthogonalization hold the f64 oracle."""
    from tpu_lanczos_torch import expm_action_pipelined, expm_action_summary

    g = generators.barabasi_albert(2000, 8, seed=2)
    s_h = expm_action_summary(g, k=30, topk=10, device=dev)
    s_d = expm_action_summary(g, k=30, topk=10, eig_impl="device",
                              device=dev)
    assert set(s_d.top_nodes) == set(s_h.top_nodes)
    np.testing.assert_allclose(
        s_d.top_values * np.exp(s_d.log_scale - s_h.log_scale),
        s_h.top_values, rtol=1e-4)
    cg = cpg.pack_cpg(g, device=dev)
    xs = [None, np.random.default_rng(0).standard_normal(g.n)]
    piped = expm_action_pipelined(g, xs, k=30, dg=cg)
    for x, got in zip(xs, piped):
        want = expm_action(g, x, k=30, dg=cg)
        np.testing.assert_array_equal(got.ans, want.ans)
    ref = oracle.expm_action(g, np.ones(g.n), 30)
    for kw in (dict(fmt="coo"), dict(reorthogonalize=True)):
        res = expm_action(g, k=30, dtype="float64", device=dev, **kw)
        assert oracle.rel_error(res.ans, ref) < 1e-12, kw


def _star(n: int = 3000):
    hub = np.stack([np.zeros(n - 1, dtype=np.int64),
                    np.arange(1, n, dtype=np.int64)], axis=1)
    ring = np.stack([np.arange(1, n - 1), np.arange(2, n)], axis=1)
    return CSRGraph.from_edges(n, np.concatenate([hub, ring]))


def _hub(n: int = 1200):
    return CSRGraph.from_edges(n, np.stack([
        np.zeros(n - 1, dtype=np.int64), np.arange(1, n, dtype=np.int64)],
        axis=1))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


# name -> (graph, sub): uint8 l2 at sub 128 and 256, int16 at 512; each
# pack has chunks with count 0 and a chunk with more tiles than one
# unrolled batch of the walk (8), the star and the hub in the levels of
# their reduce trees
_WALK_CASES = {
    "ba2000_sub128": (lambda: generators.barabasi_albert(2000, 8, seed=2),
                      128),
    "ba40000_sub256": (lambda: generators.barabasi_albert(40000, 6, seed=3),
                       256),
    "ba40000_sub512": (lambda: generators.barabasi_albert(40000, 6, seed=3),
                       512),
    "star_sub128": (_star, 128),
    "hub_sub512": (_hub, 512),
}


@pytest.mark.parametrize("name", list(_WALK_CASES))
def test_classic_walk_bit_for_bit(dev, name):
    """The classic level kernels against their plain versions, bit for
    bit (int views, so -0.0 != +0.0): every level of the pack; f32 and
    f64; base given and absent; x holding -0.0 in every lane-127 slot,
    where the plain version adds x's -0.0 and the compensated kernel
    skips the ghost's load and adds +0.0 (acc and err)."""
    build, sub = _WALK_CASES[name]
    g = build()
    cg = cpg.pack_cpg(g, sub=sub, device=dev)
    C, LANE = cg.n_chunks, cpg.LANE
    counts = [lv["counts"] for lv in cg.levels]
    assert all(bool((c == 0).any()) for c in counts)
    assert max(int(c.max()) for c in counts) > 8
    xr = np.random.default_rng(4).standard_normal(g.n)
    for np_dtype in (np.float32, np.float64):
        x2d = torch.from_numpy(cg.permute_in(xr, np_dtype)).to(dev).reshape(
            cg.n_sub, LANE)
        x2d[:, LANE - 1] = -0.0
        for level in cg.levels:
            for base in (None, x2d):
                got = spmv_cpg.run_level(x2d, level, C, sub, base=base)
                want = spmv_cpg.run_level_ref(x2d, level, C, sub, base=base)
                assert torch.equal(_bits(got), _bits(want))
            if np_dtype == np.float32:
                got = spmv_cpg.run_level_comp(x2d, level, C, sub)
                want = spmv_cpg.run_level_comp_ref(x2d, level, C, sub)
                assert all(torch.equal(_bits(a), _bits(b))
                           for a, b in zip(got, want))
    torch.cuda.synchronize()


# name -> (graph, sub): slab packs whose main level has a chunk longer
# than the walk's ring (8 stages) and chunks with 0 tiles, at sub 128,
# 256 and 512; the star's four levels hold chunks of 2 to 23 tiles
_SLAB_WALK_CASES = {
    "ba2000_sub128": (lambda: generators.barabasi_albert(2000, 8, seed=2),
                      128),
    "ba40000_m6_sub128": (lambda: generators.barabasi_albert(
        40000, 6, seed=3), 128),
    "ba40000_m4_sub256": (lambda: generators.barabasi_albert(
        40000, 4, seed=1), 256),
    "ba40000_m4_sub512": (lambda: generators.barabasi_albert(
        40000, 4, seed=1), 512),
    "star_sub512": (_star, 512),
}


def _ghost_chunk(level: dict) -> dict:
    """The level with every tile of its longest chunk made all ghosts
    (l2 = 255): that chunk's cells sum nothing but +0.0."""
    out = dict(level)
    d = int(level["counts"].argmax())
    s0, n = int(level["starts"][d]), int(level["counts"][d])
    out["l2"] = level["l2"].clone()
    out["l2"][s0 * cpg.LANE:(s0 + n) * cpg.LANE] = 255
    return out


@pytest.mark.parametrize("name", list(_SLAB_WALK_CASES))
def test_slab_walk_bit_for_bit(dev, name):
    """The slab level kernels against their plain versions, bit for bit
    (int views, so -0.0 != +0.0): every level of the pack and a copy of
    the main level whose longest chunk is all ghost tiles; f32 and f64;
    base given and absent; the compensated kernel's acc and err; x
    holding -0.0 in every lane-127 slot.  The launch counters move by
    exactly the launches made."""
    build, sub = _SLAB_WALK_CASES[name]
    g = build()
    cg = cpg.pack_cpg(g, sub=sub, layout="slab", device=dev)
    C, LANE, nb = cg.n_chunks, cpg.LANE, cg.n_bcast
    main = cg.levels[nb]["counts"]
    assert int(main.max()) > 16 and bool((main == 0).any())
    levels = list(cg.levels) + [_ghost_chunk(cg.levels[nb])]
    xr = np.random.default_rng(5).standard_normal(g.n)
    before = (spmv_cpg.launches_slab, spmv_cpg.launches_comp_slab)
    for np_dtype in (np.float32, np.float64):
        x2d = torch.from_numpy(cg.permute_in(xr, np_dtype)).to(dev).reshape(
            cg.n_sub, LANE)
        x2d[:, LANE - 1] = -0.0
        for level in levels:
            for base in (None, x2d):
                got = spmv_cpg.run_level(x2d, level, C, sub, base=base,
                                         slab=True)
                want = spmv_cpg.run_level_ref(x2d, level, C, sub, base=base,
                                              slab=True)
                assert torch.equal(_bits(got), _bits(want))
            if np_dtype == np.float32:
                got = spmv_cpg.run_level_comp(x2d, level, C, sub, slab=True)
                want = spmv_cpg.run_level_comp_ref(x2d, level, C, sub,
                                                   slab=True)
                assert all(torch.equal(_bits(a), _bits(b))
                           for a, b in zip(got, want))
    torch.cuda.synchronize()
    n = len(levels)
    assert (spmv_cpg.launches_slab - before[0],
            spmv_cpg.launches_comp_slab - before[1]) == (4 * n, n)


def _checked(kernel, plain):
    def level(*args):
        got = kernel(*args)
        assert torch.equal(got, plain(*args)), kernel.__name__
        return got
    return level


@pytest.mark.parametrize("name", ["ba2000", "star"])
def test_cst_kernel_equals_plain_version(dev, name):
    """Every level of the f32 and f64 CST SpMV (the star graph with its
    reduce levels) through the kernel and its plain version on the same
    inputs; the counter advances by the levels run; f64 matches scipy."""
    g = (generators.barabasi_albert(2000, 8, seed=2) if name == "ba2000"
         else _star())
    cg = cst.pack_cst(g, device=dev)
    xr = np.random.default_rng(0).standard_normal(g.n)
    level = _checked(spmv_cst.run_level_cst, spmv_cst.run_level_cst_ref)
    before = spmv_cst.launches_cst
    for np_dtype in (np.float32, np.float64):
        x = torch.from_numpy(cg.permute_in(xr, np_dtype)).to(dev)
        y = spmv_cst._spmv(cg, x, level)
    torch.cuda.synchronize()
    assert spmv_cst.launches_cst - before == 2 * len(cg.idx1)
    np.testing.assert_allclose(cg.permute_out(y), g.to_scipy() @ xr,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kw", [{}, dict(sub_d=512), dict(g_s=8),
                                dict(sub_s=128, g_s=16)])
def test_gpg_kernel_equals_plain_version(dev, kw):
    """Every level of the f32 and f64 GPG SpMV, at the default shapes and
    the parameter variants, through the kernel and its plain version;
    f64 matches scipy."""
    g = generators.barabasi_albert(1500, 6, seed=2)
    gg = gpg.pack_gpg(g, device=dev, **kw)
    xr = np.random.default_rng(1).standard_normal(g.n)
    level = _checked(spmv_gpg.run_level_gpg, spmv_gpg.run_level_gpg_ref)
    before = spmv_gpg.launches_gpg
    for np_dtype in (np.float32, np.float64):
        x = torch.from_numpy(gg.permute_in(xr, np_dtype)).to(dev)
        y = spmv_gpg._spmv(gg, x, level)
    torch.cuda.synchronize()
    assert spmv_gpg.launches_gpg - before == 2 * len(gg.levels)
    np.testing.assert_allclose(gg.permute_out(y), g.to_scipy() @ xr,
                               rtol=1e-12, atol=1e-12)


# ghost-heavy: ~1% of the GPG and ~12% of the CST steps are real (and
# a reduce level); dense: a grid, ~7% and ~35%
_LINEAGE_GRAPHS = {
    "ghost_heavy": lambda: generators.barabasi_albert(2000, 8, seed=2),
    "dense": lambda: generators.stencil_2d(60),
}


def _real_share(cg) -> float:
    """Real (slot, staging cell) steps over all of a CST pack."""
    zero = cg.n_cols - 1
    return (sum(int((a != zero).sum()) for a in cg.idx1)
            / (cg.total_slots * cg.n_pad))


@pytest.mark.parametrize("idx1_bytes", [2, 4])
@pytest.mark.parametrize("name", list(_LINEAGE_GRAPHS))
def test_cst_kernel_bit_for_bit(dev, name, idx1_bytes, monkeypatch):
    """Every level of the f32 and f64 CST SpMV through the kernel and its
    plain version, bit for bit (int views), on int16 and int32 idx1 (the
    int32 branch forced by lowering the column limit), idx3 uint8, with
    an x of both signs whose zero column holds -0.0: the plain version
    adds that -0.0 for ghost cells, the kernel +0.0 without a load."""
    if idx1_bytes == 4:
        monkeypatch.setattr(cst, "IDX1_INT16_MAX_COLS", 0)
    cg = cst.pack_cst(_LINEAGE_GRAPHS[name](), device=dev)
    assert all(a.element_size() == idx1_bytes for a in cg.idx1)
    assert all(a.dtype == torch.uint8 for a in cg.idx3)
    assert (_real_share(cg) > 0.3) == (name == "dense")

    def level(src, acc, i1, i3):
        got = spmv_cst.run_level_cst(src, acc, i1, i3)
        want = spmv_cst.run_level_cst_ref(src, acc, i1, i3)
        assert torch.equal(_bits(got), _bits(want))
        return got

    rng = np.random.default_rng(6)
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(rng.standard_normal(
            (cst.CLASSES, cg.n_cols))).to(dev, dtype)
        x[:, -1] = -0.0
        spmv_cst._spmv(cg, x.reshape(-1), level)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", list(_LINEAGE_GRAPHS))
def test_gpg_kernel_bit_for_bit(dev, name):
    """Every level of the f32 and f64 GPG SpMV through the kernel and
    its plain version, bit for bit (int views), with an x of both signs
    whose lane 127 holds -0.0, on sub_d 256 (clusters of 4) and 128
    (clusters of 2); test_gpg_kernel_equals_plain_version has sub_d 512
    (clusters of 8)."""
    g = _LINEAGE_GRAPHS[name]()
    for sub_d in (256, 128):
        gg = gpg.pack_gpg(g, sub_d=sub_d, device=dev)
        assert (gg.real_step_share > 0.05) == (name == "dense")

        def level(*args):
            got = spmv_gpg.run_level_gpg(*args)
            assert torch.equal(_bits(got), _bits(
                spmv_gpg.run_level_gpg_ref(*args)))
            return got

        rng = np.random.default_rng(7)
        for dtype in (torch.float32, torch.float64):
            x = torch.from_numpy(rng.standard_normal(
                (gg.n_sub, gpg.LANE))).to(dev, dtype)
            x[:, gpg.LANE - 1] = -0.0
            spmv_gpg._spmv(gg, x.reshape(-1), level)
    torch.cuda.synchronize()


def test_lineage_pipelines_on_cuda_match_oracle(dev):
    g = generators.barabasi_albert(2000, 8, seed=2)
    want = oracle.expm_action(g, np.ones(g.n), 30)
    res = expm_action(g, k=30, dtype="float64", fmt="cst", device=dev)
    assert oracle.rel_error(res.ans, want) < 1e-12
    gg = gpg.pack_gpg(g, device=dev)
    res = expm_action(g, k=30, dtype="float64", dg=gg)
    assert oracle.rel_error(res.ans, want) < 1e-12


def test_mxu_probe_kernel_equals_plain_version(dev):
    """The probe's own check (8 blocks: dma exact, mxu within 1e-5), then
    64 blocks in groups of 4 against the plain version."""
    a, xh, xl = mxu_probe.make_data(64, 4, 8)
    mxu_probe.check(a, xh, xl, 8)
    for variant in mxu_probe.VARIANTS:
        got = mxu_probe.probe(a, xh, xl, 8, variant, u=4)
        want = mxu_probe.probe_ref(a, xh, xl, 8, variant)
        if variant == "dma":
            assert torch.equal(got, want)
        else:
            assert mxu_probe.rel_err(got, want, 8) < 1e-5


@pytest.mark.parametrize("m_rows", [1, 8, 16])
@pytest.mark.parametrize("blocks,u", [(7, 1), (10, 2), (20, 4), (1001, 1)])
def test_mxu_probe_partitions(dev, blocks, u, m_rows):
    """The probe on fewer blocks than SMs (one group a CTA, fewer blocks
    than the ring's stages) and on 1,001 blocks (8 a CTA, the ring turned
    over once and part-way), u = 1, 2 and 4, m_rows 1, 8 and 16: dma
    equal to the plain version, mxu1 and mxu2 within 1e-5 of the plain
    version's largest value (chip_smoke's full-size bar: the tensor cores
    round a sum at the scale of its largest term, so an element that
    cancels to near zero carries that error relative to the row, not to
    itself; the earlier wmma kernel with a serial reduce misses the
    element-wise bar at 20 blocks, u=4, m_rows=1 by the same 1.3e-4 in
    mxu2), and rows m_rows.. zero."""
    a, xh, xl = mxu_probe.make_data(blocks, u, m_rows)
    before = mxu_probe.launches_mxu
    for variant in mxu_probe.VARIANTS:
        got = mxu_probe.probe(a, xh, xl, m_rows, variant, u=u)
        want = mxu_probe.probe_ref(a, xh, xl, m_rows, variant)
        assert got.shape == want.shape
        assert not bool(got[m_rows:].any())
        if variant == "dma":
            assert torch.equal(got, want)
        else:
            err = mxu_probe.scaled_err(got, want, m_rows)
            assert err < 1e-5, (variant, err)
    torch.cuda.synchronize()
    assert mxu_probe.launches_mxu - before == len(mxu_probe.VARIANTS)


# ------------------------------------------------------ the row-sharded path


def _sharded(dev, n_shards, sub=128):
    """A 40,000-node power-law pack split over ``n_shards`` shards of one
    card (its tiles span two shards at sub=128: own, cross and reduce
    passes), and its mesh."""
    from tpu_lanczos_torch.dist import make_mesh
    from tpu_lanczos_torch.dist.cpg_sharded import pack_cpg_sharded

    g = generators.barabasi_albert(40000, 4, seed=5)
    mesh = make_mesh(devices=[dev] * n_shards)
    return g, mesh, pack_cpg_sharded(g, n_shards, mesh=mesh, sub=sub)


def _checked_shard_fns():
    """The sharded SpMVs' kernel wrappers, each call held against its
    plain version on the same inputs, bit for bit: kernel 1 on a pass or
    a reduce level (its halo read in place) and the df shard kernel
    (``run_shard_level_df``)."""
    def level(x2d, level, n_chunks, sub, base=None, halo=None):
        got = spmv_cpg.run_level(x2d, level, n_chunks, sub, base, halo=halo)
        assert torch.equal(got, spmv_cpg.run_level_ref(
            x2d, level, n_chunks, sub, base, halo=halo))
        return got

    def df(walks, n_chunks, sub, **kw):
        got = spmv_cpg.run_shard_level_df(walks, n_chunks, sub, **kw)
        want = spmv_cpg.run_shard_level_df_ref(walks, n_chunks, sub, **kw)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            assert g is None or (torch.equal(g[0], w[0])
                                 and torch.equal(g[1], w[1]))
        return got

    return level, df


def _shard_counters():
    return (spmv_cpg.launches, spmv_cpg.launches_shard_df,
            spmv_cpg.launches_comp)


def _check_sharded_spmvs(sg, mesh, x64):
    """One SpMV (f32 and f64) and one df SpMV through the checked
    wrappers, each equal to the plain SpMVs, with exactly the launches
    of ``shard_launches``: in f32/f64 kernel 1 once a pass and a reduce
    level with tiles on a shard, in df64 the df kernel once a shard's
    main level and once a reduce level with tiles on it."""
    from tpu_lanczos_torch.core.lanczos_df import split_f64
    from tpu_lanczos_torch.dist import cpg_sharded as cs, lanczos_df as ldf

    level, df = _checked_shard_fns()
    for dt in (np.float32, np.float64):
        xs = mesh.split(x64.astype(dt), sg.n_loc)
        before = _shard_counters()
        y = cs._local_spmv(sg, mesh, xs, level)
        torch.cuda.synchronize()
        after = _shard_counters()
        assert tuple(a - b for a, b in zip(after, before)) == (
            sum(cs.shard_launches(sg)), 0, 0)
        assert all(torch.equal(a, b) for a, b in zip(
            y, cs.spmv_cpg_sharded_ref(sg, mesh, xs)))
    hi, lo = split_f64(x64)
    hi, lo = mesh.split(hi, sg.n_loc), mesh.split(lo, sg.n_loc)
    before = _shard_counters()
    got = ldf._local_spmv_df(sg, mesh, list(zip(hi, lo)), df)
    after = _shard_counters()
    assert tuple(a - b for a, b in zip(after, before)) == (
        0, sum(cs.shard_launches(sg, df=True)), 0)
    want = ldf.spmv_cpg_df_sharded_ref(sg, mesh, hi, lo)
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(got, want))


def test_sharded_levels_equal_plain_versions(dev):
    """Every shard's passes and reduce levels (kernel 1) and df64 levels
    (the df shard kernel) of one SpMV and one df SpMV, on 4 shards of
    the card, equal their plain versions on the same inputs, with
    exactly the launches of ``shard_launches``: the 40,000-node
    power-law pack has a hub shard with reduce levels, a shard with
    cross tiles and no own tiles, and two shards with no tiles at all."""
    g, mesh, sg = _sharded(dev, 4)
    assert sg.overlap and min(sg.t_reals) > 0
    assert [any(t[s] for t in sg.shard_tiles) for s in range(4)] == [
        True, True, False, False]
    _check_sharded_spmvs(sg, mesh, sg.permute_in(
        np.random.default_rng(0).standard_normal(g.n), np.float64))


@pytest.mark.parametrize("overlap", [True, False])
def test_shard_kernels_on_the_stencil_halo_pack(dev, overlap):
    """The 2-D stencil's 4-shard pack exchanges halo chunks: with the
    overlap split the cross pass reads the compact halo buffer, without
    it the main level reads the shard's rows and the halo, each in place
    (kernel 1's two-source launch, the df kernel's two sources); each
    kernel equals its plain version on every shard."""
    from tpu_lanczos_torch.dist import make_mesh
    from tpu_lanczos_torch.dist.cpg_sharded import pack_cpg_sharded

    g = generators.stencil_2d(200)
    mesh = make_mesh(devices=[dev] * 4)
    sg = pack_cpg_sharded(g, 4, mesh=mesh, sub=128, overlap=overlap)
    assert "halo_sel" in sg.levels[sg.n_main - 1][0]
    _check_sharded_spmvs(sg, mesh, sg.permute_in(
        np.random.default_rng(1).standard_normal(g.n), np.float64))


def test_df_shard_spmvs_on_two_streams(dev):
    """Two df SpMVs queued on two streams of the card at once, each
    launch of two walks with its own pair flags: every result equals the
    plain version, bit for bit."""
    from tpu_lanczos_torch.core.lanczos_df import split_f64
    from tpu_lanczos_torch.dist import lanczos_df as ldf

    g, mesh, sg = _sharded(dev, 4)
    xs = [sg.permute_in(np.random.default_rng(seed).standard_normal(g.n),
                        np.float64) for seed in (2, 3)]
    ins = [[mesh.split(t, sg.n_loc) for t in split_f64(x)] for x in xs]
    wants = [ldf.spmv_cpg_df_sharded_ref(sg, mesh, hi, lo)
             for hi, lo in ins]
    streams = [torch.cuda.Stream(device=dev) for _ in ins]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for i, (st, (hi, lo)) in enumerate(zip(streams, ins)):
            with torch.cuda.stream(st):
                outs[i].append(ldf.spmv_cpg_df_sharded(sg, mesh, hi, lo))
    torch.cuda.synchronize()
    for got_all, want in zip(outs, wants):
        for got in got_all:
            assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                       for a, b in zip(got, want))


def test_sharded_queries_launch_exactly(dev):
    """Per SpMV the launches of ``shard_launches``:
    ``expm_action_sharded`` k SpMVs through kernel 1,
    ``expm_action_df_sharded`` 2k - 1 df SpMVs through the df shard
    kernel alone (no other level kernel), and an estimator its probes'
    steps."""
    from tpu_lanczos_torch.core import stochastic
    from tpu_lanczos_torch.dist import cpg_sharded as cs
    from tpu_lanczos_torch.dist import expm_action_sharded
    from tpu_lanczos_torch.dist.lanczos_df import expm_action_df_sharded

    g, mesh, sg = _sharded(dev, 4)
    per = sum(cs.shard_launches(sg))
    per_df = sum(cs.shard_launches(sg, df=True))
    k = 10
    before = _shard_counters()
    expm_action_sharded(sg, k=k, mesh=mesh, fmt="cpg")
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_shard_counters(), before)) == (
        k * per, 0, 0)
    before = _shard_counters()
    expm_action_df_sharded(g, k=k, mesh=mesh, sg=sg)
    assert tuple(a - b for a, b in zip(_shard_counters(), before)) == (
        0, (2 * k - 1) * per_df, 0)
    before = _shard_counters()
    d = stochastic.spectral_density_sharded(sg, mesh=mesh, fmt="cpg", k=8,
                                            probes=3)
    torch.cuda.synchronize()
    assert np.isfinite(d.density).all()
    assert tuple(a - b for a, b in zip(_shard_counters(), before)) == (
        3 * 8 * per, 0, 0)


def test_one_shard_spmv_equals_single_device(dev):
    from tpu_lanczos_torch.dist import make_mesh
    from tpu_lanczos_torch.dist.cpg_sharded import (
        ShardedCPG, dest_only_kw, split_cpg, spmv_cpg_sharded)

    g = generators.barabasi_albert(40000, 4, seed=5)
    cg = cpg.pack_cpg(g, sub=256, device=dev, **dest_only_kw())
    split = split_cpg(cg, 1)
    mesh = make_mesh(devices=[dev])
    sg = ShardedCPG.from_numpy(split["meta"], split["levels"],
                               split["realmask"], split["new_of_old"], mesh)
    for dt in (np.float32, np.float64):
        x = torch.from_numpy(cg.permute_in(np.random.default_rng(1)
                                           .standard_normal(g.n), dt)).to(dev)
        (y,) = spmv_cpg_sharded(sg, mesh, x)
        assert torch.equal(y, spmv_cpg.spmv_cpg(cg, x))


def test_sharded_pipelines_on_cuda_match_oracle(dev):
    """f64 e^A.x and df64 through 4 shards of the card against the
    oracle, and a mesh of more GPUs than the machine has refused with the
    reference's message."""
    from tpu_lanczos_torch.dist import expm_action_sharded, make_mesh
    from tpu_lanczos_torch.dist.lanczos_df import expm_action_df_sharded

    g, mesh, sg = _sharded(dev, 4)
    want = oracle.expm_action(g, np.ones(g.n), 30)
    ans, _, _, _ = expm_action_sharded(sg, k=30, mesh=mesh, dtype="float64")
    assert oracle.rel_error(ans, want) < 1e-12
    res = expm_action_df_sharded(g, k=30, mesh=mesh, sg=sg)
    assert oracle.rel_error(res.ans, want) < 1e-11
    have = torch.cuda.device_count()
    with pytest.raises(ValueError,
                       match=f"need {have + 1} devices, have {have}"):
        make_mesh(have + 1)


# ---- rows 5 and 5c: the Lanczos step kernels (kernels/lanczos_step.py)

def _step_inputs(dev, n, dtype, seed):
    """v, q and q_prev of n elements on the card (q normalized), and
    (k,) alpha and beta buffers with beta[2] set: inputs of step j=3."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(n)
    q /= np.linalg.norm(q)
    vecs = [torch.from_numpy(a).to(dev, dtype) for a in (
        rng.standard_normal(n), q, rng.standard_normal(n) / np.sqrt(n))]
    alpha = torch.zeros(8, dtype=dtype, device=dev)
    beta = torch.zeros(8, dtype=dtype, device=dev)
    beta[2] = 0.75
    return vecs, alpha, beta


def _rel(got, want):
    return float(abs(got - want) / max(abs(want), 1e-300))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [128, 4099, 1 << 20])
def test_lanczos_step_kernel_equals_plain_version(dev, dtype, n):
    """Row 5: alpha and beta within 1e-6 (f32) or 1e-13 (f64) relative
    of the plain version's torch.dot (the sum runs in another order);
    given the kernel's own scalars, q_{j+1}, the stored row and the
    recombine fold equal the plain version's bit for bit; two runs equal
    bit for bit; one count a step."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    (v, q, qp), alpha, beta = _step_inputs(dev, n, dtype, n)
    coeff = torch.linspace(0.5, 1.5, 8, dtype=dtype, device=dev)
    ans0 = torch.from_numpy(np.random.default_rng(1).standard_normal(n)).to(
        dev, dtype)
    runs = []
    for _ in range(2):
        a, b, vk, store, ans = (alpha.clone(), beta.clone(), v.clone(),
                                torch.zeros_like(v), ans0.clone())
        before = ls.launches_step
        qn = ls.lanczos_step(vk, q, qp, a, b, 3, store=store, ans=ans,
                             coeff=coeff)
        torch.cuda.synchronize()
        assert ls.launches_step - before == 1
        runs.append((a, b, qn, store, ans))
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    a, b, qn, store, ans = runs[0]
    ar, br = alpha.clone(), beta.clone()
    ls.lanczos_step_ref(v.clone(), q, qp, ar, br, 3)
    bar = 1e-6 if dtype == torch.float32 else 1e-13
    assert _rel(a[3].item(), ar[3].item()) < bar
    assert _rel(b[3].item(), br[3].item()) < bar
    want = ls.normalize_ref(ls.update_ref(v, q, qp, a[3], b[2]), b[3])
    assert torch.equal(qn, want) and torch.equal(store, want)
    assert torch.equal(ans, ans0 + coeff[4] * want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lanczos_step_reorthogonalized_equals_plain_version(dev, dtype):
    """Row 5 with the two GEMVs between its passes: given the kernel's
    scalars, q_{j+1} equals the plain version's bit for bit."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    n = 40000
    (v, q, qp), alpha, beta = _step_inputs(dev, n, dtype, 5)
    basis = torch.linalg.qr(torch.from_numpy(np.random.default_rng(6)
                                             .standard_normal((n, 8))).to(
        dev, dtype))[0].T.contiguous()
    qn = ls.lanczos_step(v.clone(), q, qp, alpha, beta, 3, q_basis=basis)
    v1 = ls.update_ref(v, q, qp, alpha[3], beta[2])
    v1 = v1 - ls._reorthogonalize(v1, basis, 3)
    assert torch.equal(qn, ls.normalize_ref(v1, beta[3]))
    assert _rel(beta[3].item(), torch.linalg.vector_norm(v1).item()) < (
        1e-6 if dtype == torch.float32 else 1e-13)


def test_lanczos_step_breakdown_gives_zero(dev):
    """v' = 0 (v = alpha q, beta_prev = 0): beta = 0 and q_{j+1} = 0."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    q = torch.full((4096,), 1 / 64.0, device=dev)
    alpha, beta = torch.zeros(4, device=dev), torch.zeros(4, device=dev)
    qn = ls.lanczos_step(2.0 * q, q, torch.zeros_like(q), alpha, beta, 0)
    assert alpha[0].item() == 2.0 and beta[0].item() == 0.0
    assert not bool(qn.any())
    h, l = (2.0 * q, torch.zeros_like(q))
    z = torch.zeros_like(q)
    ab = [torch.zeros(4, device=dev) for _ in range(4)]
    qh, ql = ls.lanczos_step_df((h, l), (q, z), (z, z), ab[:2], ab[2:], 0)
    assert ab[2][0].item() == 0.0 and not bool(qh.any() or ql.any())


def _df_inputs(dev, n, seed):
    rng = np.random.default_rng(seed)

    def pair(x):
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
        return (torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev))

    q = rng.standard_normal(n)
    q /= np.linalg.norm(q)
    return (pair(rng.standard_normal(n)), pair(q),
            pair(rng.standard_normal(n) / np.sqrt(n)))


@pytest.mark.parametrize("n", [128, 5000, 1 << 20, (1 << 23) + 1,
                               (1 << 26) + 1])
def test_lanczos_step_df_kernel_equals_plain_version(dev, n):
    """Row 5c at each node-stack depth of the dot tree (one row a thread
    up to P = 2^23, 2 rows at 2^24, 16 at 2^27): alpha and beta within
    5e-11 of the plain version's df values, q_{j+1} and the recombine
    fold bit-identical to the plain version's given the kernel's
    scalars, two runs bit-identical, one count a step; df_norm within
    5e-11 of core.df64's."""
    from tpu_lanczos_torch.core import df64 as df
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    v, q, qp = _df_inputs(dev, n, 3)
    zk = [torch.zeros(8, device=dev) for _ in range(4)]
    zk[2][2], zk[3][2] = 0.75, 1e-9
    coeff = (torch.linspace(0.5, 1.5, 8, device=dev),
             torch.full((8,), 1e-9, device=dev))
    ans0 = (q[0] * 3, q[1] * 3)
    runs = []
    for _ in range(2):
        ab = [t.clone() for t in zk]
        ans = (ans0[0].clone(), ans0[1].clone())
        before = ls.launches_step_df
        qn = ls.lanczos_step_df((v[0].clone(), v[1].clone()), q, qp, ab[:2],
                                ab[2:], 3, ans=ans, coeff=coeff)
        torch.cuda.synchronize()
        assert ls.launches_step_df - before == 1
        runs.append((*ab, *qn, *ans))
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    ah, al, bh, bl, qh, ql, sh, sl = runs[0]
    ref = [t.clone() for t in zk]
    ls.lanczos_step_df_ref(v, q, qp, ref[:2], ref[2:], 3)
    for got, want in (((ah, al), ref[:2]), ((bh, bl), ref[2:])):
        g64 = df.df_to_f64((got[0][3], got[1][3]))
        w64 = df.df_to_f64((want[0][3], want[1][3]))
        assert _rel(float(g64), float(w64)) < 5e-11
    a, bp, b = (ah[3], al[3]), (bh[2], bl[2]), (bh[3], bl[3])
    want = ls.normalize_df_ref(ls.update_df_ref(v, q, qp, a, bp), b)
    assert torch.equal(qh, want[0]) and torch.equal(ql, want[1])
    acc = (ans0[0].clone(), ans0[1].clone())
    ls.accum_df_ref(acc, coeff, 4, want)
    assert torch.equal(sh, acc[0]) and torch.equal(sl, acc[1])
    got = df.df_to_f64(tuple(t.cpu() for t in ls.df_norm(q)))
    assert _rel(float(got), float(df.df_to_f64(df.df_norm(q)))) < 5e-11


class _Cut(Exception):
    """Raised by a spy to cut a checkpointed run after its first chunk."""


def test_lanczos_loops_through_the_step_kernels(dev):
    """On the card every loop runs the step kernels, one count a step:
    lanczos_alphabeta == stored-Q lanczos bit for bit (f32 and f64), the
    recombine pass, and the df64 checkpoint resumed bit for bit."""
    import importlib

    from tpu_lanczos_torch.core import checkpoint
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    lz = importlib.import_module("tpu_lanczos_torch.core.lanczos")
    ldf = importlib.import_module("tpu_lanczos_torch.core.lanczos_df")
    g = generators.barabasi_albert(20000, 4, seed=9)
    cg = cpg.pack_cpg(g, device=dev)
    k = 15
    for dt in (torch.float32, torch.float64):
        x = cg.realmask.to(dt)
        before = ls.launches_step
        st = lz.lanczos(cg, x, k)
        a, b, xn = lz.lanczos_alphabeta(cg, x, k)
        ans = lz.lanczos_recombine(cg, x, torch.ones(k, dtype=dt,
                                                     device=dev), k)
        torch.cuda.synchronize()
        assert ls.launches_step - before == 3 * k - 1
        assert torch.equal(a, st.alpha) and torch.equal(b[:k - 1], st.beta)
        assert torch.equal(xn, st.x_norm)
        want = st.q_basis.sum(dim=0)
        assert float((ans - want).norm() / want.norm()) < (
            1e-5 if dt == torch.float32 else 1e-12)
    hi, lo = cg.realmask.float(), torch.zeros(cg.n_pad, device=dev)
    before = ls.launches_step_df
    (ah, al), (bh, bl), _ = ldf.lanczos_alphabeta_df(cg, hi, lo, k)
    torch.cuda.synchronize()
    assert ls.launches_step_df - before == k
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/df.npz"
        real = ldf.lanczos_alphabeta_df_range
        calls = []

        def cut(*args, **kw):
            if calls:
                raise _Cut
            calls.append(1)
            return real(*args, **kw)

        ldf.lanczos_alphabeta_df_range = cut
        try:
            with pytest.raises(_Cut):
                checkpoint.lanczos_alphabeta_df_checkpointed(
                    cg, hi, lo, k, checkpoint_path=path, chunk=6)
        finally:
            ldf.lanczos_alphabeta_df_range = real
        (h2, l2), (h3, l3), _ = checkpoint.lanczos_alphabeta_df_checkpointed(
            cg, hi, lo, k, checkpoint_path=path, chunk=6)
    for x, y in ((h2, ah), (l2, al), (h3, bh), (l3, bl)):
        assert torch.equal(x, y)


def test_lanczos_step_refuses_what_the_kernel_does_not_take(dev):
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    v = torch.ones(256, device=dev)
    ab = (torch.zeros(4, device=dev), torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match="alias"):
        ls.lanczos_step(v, v, torch.zeros_like(v), *ab, 0)
    with pytest.raises(ValueError, match="aligned"):
        ls.lanczos_step(torch.ones(257, device=dev)[1:], v, v.clone(), *ab, 0)
    with pytest.raises(TypeError):
        ls.lanczos_step(v.half(), v.half(), v.half(), *ab, 0)


# ---- the one-launch step: its residency tiers, the folded mask, a
# refused launch

def _row5_edges(vb):
    """n at the edges of row 5's tiers on this card: the register tier's
    capacity (then shared memory) and the most the chip holds (then
    re-read), each and one 16-byte chunk and an element past it."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    vec = 16 // vb
    caps = []
    for s in range(ls.MAX_SMEM_CHUNKS + 1):
        g = min(ls._occupancy_on(0, 0, vb, s * ls.SMEM_CHUNK_BYTES),
                ls.MAX_GRID)
        caps.append(g * ls.THREADS * (ls.REG_CHUNKS + s) * vec)
    edges = []
    for cap in (caps[0], max(caps)):
        edges += [cap, cap + vec + 1]
    return edges


def _mask(dev, n, seed):
    m = np.random.default_rng(seed).random(n) < 0.9
    return torch.from_numpy(m.astype(np.float32)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lanczos_step_tiers_and_mask(dev, dtype):
    """Row 5 at each residency tier's edges (registers, shared memory,
    re-read; up to ~5.4M float32 elements on an H100), with and without
    ``mask=``, on a v shaped as a step's A q_j: with the mask on the raw v, the
    kernel equals the kernel without it on v * mask bit for bit (alpha,
    beta, q_{j+1}, the stored row, the fold); given the kernel's scalars
    q_{j+1} and the fold equal the plain version's bit for bit; alpha and
    beta within 1e-6 (f32) or 1e-13 (f64) of the plain version's; two
    runs bit-identical."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    vb = torch.finfo(dtype).bits // 8
    tiers = set()
    for n in _row5_edges(vb):
        tiers.add(ls.plan_for(dev, n, vb).tier(n, vb))
        (noise, q, qp), alpha, beta = _step_inputs(dev, n, dtype, n % 1000)
        # v as A q is in a Lanczos step, 2.5 q plus a part orthogonal-ish
        # to it: alpha does not cancel (a random v's <v, q> would, and
        # its relative error would grow with n whatever the order)
        v = 2.5 * q + noise / n ** 0.5
        mask = _mask(dev, n, 2)
        coeff = torch.linspace(0.5, 1.5, 8, dtype=dtype, device=dev)
        runs = []
        for m in (mask, mask, None):
            vin = v.clone() if m is not None else v * mask.to(dtype)
            a, b, store, ans = (alpha.clone(), beta.clone(),
                                torch.zeros_like(v), qp.clone())
            qn = ls.lanczos_step(vin, q, qp, a, b, 3, store=store, ans=ans,
                                 coeff=coeff, mask=m)
            runs.append((a, b, qn, store, ans))
        torch.cuda.synchronize()
        for other in runs[1:]:
            for x, y in zip(runs[0], other):
                assert torch.equal(x, y), n
        a, b, qn, store, ans = runs[0]
        vm = v * mask.to(dtype)
        ar, br = alpha.clone(), beta.clone()
        ls.lanczos_step_ref(v.clone(), q, qp, ar, br, 3, mask=mask)
        bar = 1e-6 if dtype == torch.float32 else 1e-13
        assert _rel(a[3].item(), ar[3].item()) < bar
        assert _rel(b[3].item(), br[3].item()) < bar
        want = ls.normalize_ref(ls.update_ref(vm, q, qp, a[3], b[2]), b[3])
        assert torch.equal(qn, want) and torch.equal(store, want)
        assert torch.equal(ans, qp + coeff[4] * want)
    assert tiers == {"registers", "shared", "stream"}


@pytest.mark.parametrize("n", [5000, 1 << 20, (1 << 20) + 1, (1 << 23) + 1])
def test_lanczos_step_df_mask_and_tree(dev, n):
    """Row 5c with ``mask=`` equals the kernel on the masked v bit for
    bit, q_{j+1} and the fold equal the plain version's given the
    kernel's scalars, and alpha's hi word equals the plain version's (the
    same pairwise tree: the hi sums agree, and the error sums differ at
    second order only)."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    v, q, qp = _df_inputs(dev, n, 5)
    mask = _mask(dev, n, 3)
    zk = [torch.zeros(8, device=dev) for _ in range(4)]
    zk[2][2], zk[3][2] = 0.75, 1e-9
    coeff = (torch.linspace(0.5, 1.5, 8, device=dev),
             torch.full((8,), 1e-9, device=dev))
    runs = []
    for m in (mask, None):
        vin = ((v[0].clone(), v[1].clone()) if m is not None
               else (v[0] * mask, v[1] * mask))
        ab = [t.clone() for t in zk]
        ans = (qp[0].clone(), qp[1].clone())
        qn = ls.lanczos_step_df(vin, q, qp, ab[:2], ab[2:], 3, ans=ans,
                                coeff=coeff, mask=m)
        runs.append((*ab, *qn, *ans))
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    ah, al, bh, bl, qh, ql, sh, sl = runs[0]
    vm = (v[0] * mask, v[1] * mask)
    ref = [t.clone() for t in zk]
    ls.lanczos_step_df_ref(v, q, qp, ref[:2], ref[2:], 3, mask=mask)
    assert ah[3].item() == ref[0][3].item()
    want = ls.normalize_df_ref(ls.update_df_ref(
        vm, q, qp, (ah[3], al[3]), (bh[2], bl[2])), (bh[3], bl[3]))
    assert torch.equal(qh, want[0]) and torch.equal(ql, want[1])
    acc = (qp[0].clone(), qp[1].clone())
    ls.accum_df_ref(acc, coeff, 4, want)
    assert torch.equal(sh, acc[0]) and torch.equal(sl, acc[1])


def test_lanczos_step_cooperative_launch_too_large_raises(dev):
    """A grid that cannot be co-resident is refused by the launch: the
    wrapper raises, nothing runs (v, alpha and the counter unchanged),
    and the next step runs."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    n = 1 << 22
    (v, q, qp), alpha, beta = _step_inputs(dev, n, torch.float32, 9)
    whole = ls._occupancy_on(0, 0, 4, 0)
    v0, before = v.clone(), ls.launches_step
    # 720: cudaErrorCooperativeLaunchTooLarge
    with pytest.raises(RuntimeError, match="CUDA error 720"):
        ls.lanczos_step(v, q, qp, alpha, beta, 3,
                        plan=ls.StepPlan(whole + 1, 0))
    torch.cuda.synchronize()
    assert torch.equal(v, v0) and not bool(alpha.any())
    assert ls.launches_step == before
    # row 5c: 512 blocks, each with a node stack of 20 levels (160 KB of
    # shared memory: one block an SM)
    hd, qd, pd = _df_inputs(dev, 512 * ls.DF_SPAN, 4)
    ab = [torch.zeros(8, device=dev) for _ in range(4)]
    h0 = hd[0].clone()
    with pytest.raises(RuntimeError, match="CUDA error 720"):
        ls.lanczos_step_df(hd, qd, pd, ab[:2], ab[2:], 3,
                           plan=ls.DfPlan(512, 20, 0))
    torch.cuda.synchronize()
    assert torch.equal(hd[0], h0) and not bool(ab[0].any())
    ls.lanczos_step(v, q, qp, alpha, beta, 3)
    torch.cuda.synchronize()
    assert ls.launches_step == before + 1 and bool(alpha[3] != 0)


def test_loops_fold_the_mask_bit_for_bit(dev, monkeypatch):
    """On a CPG pack every loop passes the realmask to the step: alpha,
    beta and Q equal the loop over the masked SpMV bit for bit (f32, f64,
    df64)."""
    import importlib

    from tpu_lanczos_torch.kernels import lanczos_step as ls
    from tpu_lanczos_torch.kernels.spmv import spmv

    lz = importlib.import_module("tpu_lanczos_torch.core.lanczos")
    ldf = importlib.import_module("tpu_lanczos_torch.core.lanczos_df")
    g = generators.barabasi_albert(20000, 4, seed=9)
    cg = cpg.pack_cpg(g, device=dev)
    k = 15
    x = torch.from_numpy(cg.permute_in(np.random.default_rng(2)
                                       .standard_normal(g.n), np.float64))
    hi, lo = (torch.from_numpy(t).to(dev) for t in ldf.split_f64(
        x.numpy()))
    folded = {dt: (lz.lanczos(cg, x.to(dev, dt), k),
                   lz.lanczos_alphabeta(cg, x.to(dev, dt), k))
              for dt in (torch.float32, torch.float64)}
    df_folded = ldf.lanczos_alphabeta_df(cg, hi, lo, k)
    monkeypatch.setattr(lz, "step_spmv", lambda dg, q: (spmv(dg, q), None))
    for dt, (st, ab) in folded.items():
        st2 = lz.lanczos(cg, x.to(dev, dt), k)
        ab2 = lz.lanczos_alphabeta(cg, x.to(dev, dt), k)
        for a, b in ((st.alpha, st2.alpha), (st.beta, st2.beta),
                     (st.q_basis, st2.q_basis), *zip(ab, ab2)):
            assert torch.equal(a, b)
    real_step = ls.lanczos_step_df

    def masked(v, *a, mask=None, **kw):
        return real_step((v[0] * mask, v[1] * mask), *a, **kw)

    monkeypatch.setattr(ldf, "lanczos_step_df", masked)
    for got, want in zip(ldf.lanczos_alphabeta_df(cg, hi, lo, k), df_folded):
        for g_t, w_t in zip(got, want):
            assert torch.equal(g_t, w_t)


# ---- rows 5d and 5cd: the per-shard passes of the sharded loops


def _at(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of t starting ``offset`` elements into a fresh buffer (an
    offset of 1 leaves it off 16-byte alignment)."""
    buf = t.new_zeros(t.shape[0] + offset)
    buf[offset:] = t
    return buf[offset:]


def _pass_inputs(dev, n, dtype, seed, offset=0):
    """v, q, q_prev and a float32 0/1 mask of n elements on the card."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(n)
    q /= np.linalg.norm(q)
    vecs = [_at(torch.from_numpy(a).to(dev, dtype), offset) for a in (
        rng.standard_normal(n), q, rng.standard_normal(n) / np.sqrt(n))]
    mask = torch.from_numpy((rng.random(n) < 0.9).astype(np.float32))
    return vecs, _at(mask.to(dev), offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offset", [(1 << 18, 0), (3 * 128 * 128, 0),
                                      (4099, 0), (4099, 1)])
def test_shard_step_passes_equal_plain_versions(dev, dtype, n, offset):
    """Row 5d at a shard's n_loc of bn1M over 4 shards (2^18), an odd
    chunk count (3 chunks of 128 x 128), a tail past the 16-byte chunks
    and unaligned vectors (the one-value path; V = 4, 2 and 1): the dot
    written to its slot (shard 1 of 3) and the partial norm within 1e-6
    (f32) or 1e-13 (f64) relative of torch.dot, equal in two runs; given
    the same 3 dot slots and 3 norm slots, v', alpha[j] (the fold),
    q_{j+1}, beta[j], the stored row and v - w equal the plain versions
    bit for bit; the early loads give the same bits; one count a pass
    launch."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    (v, q, qp), mask = _pass_inputs(dev, n, dtype, n, offset)
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    before = ls.launches_step_sharded
    dots = torch.tensor([0.75, 0.0, -0.125], dtype=dtype, device=dev)
    ls.shard_step_dot(v, q, mask=mask, slots=dots, shard=1)
    assert torch.equal(dots[1:2], ls.shard_step_dot(v, q, mask=mask))
    assert _rel(dots[1], ls.shard_step_dot_ref(v, q, mask)[0]) < tol
    ss_prev = torch.tensor([0.5625, 0.25, 1e-3], dtype=dtype, device=dev)
    alpha, beta = (torch.zeros(4, dtype=dtype, device=dev) for _ in "ab")
    vr, part_r = ls.shard_step_update_ref(v, q, qp, dots, ss_prev, mask)
    parts = []
    for early in (False, True):
        vk = _at(v.clone(), offset)
        torch.cuda.synchronize()  # nothing the early loads read in flight
        vk, part = ls.shard_step_update(vk, q, qp, dots, ss_prev, mask=mask,
                                        alpha=alpha, j=2, early=early)
        assert torch.equal(vk, vr) and _rel(part[0], part_r[0]) < tol
        parts.append(part)
    assert torch.equal(*parts)
    assert torch.equal(alpha[2], ls.fold_slots_ref(dots))
    norms = torch.cat([parts[0], ss_prev[1:]])
    store = _at(torch.zeros_like(v), offset)
    qk = ls.shard_step_normalize(_at(vr.clone(), offset), norms, beta=beta,
                                 j=2, store=store)
    qr = ls.shard_step_normalize_ref(vr, norms)
    assert torch.equal(qk, qr) and torch.equal(store, qr)
    assert torch.equal(beta[2], torch.sqrt(ls.fold_slots_ref(norms)))
    w = _at(torch.roll(q, 1) * 1e-3, offset)
    vs, part_s = ls.shard_step_sub_norm(_at(vr.clone(), offset), w)
    assert torch.equal(vs, vr - w)
    assert _rel(part_s[0], torch.dot(vr - w, vr - w)) < tol
    torch.cuda.synchronize()
    assert ls.launches_step_sharded - before == 2 + 2 + 1 + 1


@pytest.mark.parametrize("n", [1 << 18, 3 * 128 * 128, 5000])
def test_shard_df_passes_equal_plain_versions(dev, n):
    """Row 5cd: the df dot (slot 1 of 3) and the update's norm pair with
    the hi word of the plain tree's and within 5e-11 of its df value,
    equal in two runs and with the early loads; given the same 3 dot and
    3 norm slots, v', alpha (the df fold), q_{j+1}, beta and the
    recombine fold equal the plain versions bit for bit; one count a pass
    launch."""
    from tpu_lanczos_torch.core import df64 as df
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    vd, qd, pd = _df_inputs(dev, n, 5)
    mask = _pass_inputs(dev, n, torch.float32, 6)[1]
    before = ls.launches_step_df_sharded

    def df_rel(got, want):
        g, w = df.df_to_f64((got[0], got[1])), df.df_to_f64((want[0],
                                                             want[1]))
        return float(abs(g - w) / abs(w))

    dots = torch.tensor([[0.75, 1e-9], [0.0, 0.0], [-0.125, -3e-10]],
                        device=dev)
    ls.shard_df_dot(vd, qd, mask=mask, slots=dots, shard=1)
    a_ref = ls.shard_df_dot_ref(vd, qd, mask)[0]
    assert torch.equal(dots[1:2], ls.shard_df_dot(vd, qd, mask=mask))
    assert float(dots[1, 0]) == float(a_ref[0])
    assert df_rel(dots[1], a_ref) < 5e-11
    ssp = torch.tensor([[0.5625, 1e-9], [0.25, 0.0], [1e-3, 2e-12]],
                       device=dev)
    ab = [torch.zeros(6, device=dev) for _ in range(4)]
    vr, part_r = ls.shard_df_update_ref(vd, qd, pd, dots, ssp, mask)
    parts = []
    for early in (False, True):
        vk = (vd[0].clone(), vd[1].clone())
        torch.cuda.synchronize()  # nothing the early loads read in flight
        vk, part = ls.shard_df_update(vk, qd, pd, dots, ssp, mask=mask,
                                      alpha=ab[:2], j=2, early=early)
        assert torch.equal(vk[0], vr[0]) and torch.equal(vk[1], vr[1])
        assert float(part[0, 0]) == float(part_r[0, 0])
        assert df_rel(part[0], part_r[0]) < 5e-11
        parts.append(part)
    assert torch.equal(*parts)
    a = ls.fold_df_slots_ref(dots)
    assert torch.equal(ab[0][2], a[0]) and torch.equal(ab[1][2], a[1])
    norms = torch.cat([parts[0], ssp[1:]])
    coeff = (torch.linspace(0.5, 1.5, 6, device=dev),
             torch.full((6,), 1e-9, device=dev))
    ans = (3.0 * pd[0], 3.0 * pd[1])
    acc = (ans[0].clone(), ans[1].clone())
    qk = ls.shard_df_normalize((vr[0].clone(), vr[1].clone()), norms,
                               beta=ab[2:], j=2, ans=ans, coeff=coeff)
    qr = ls.shard_df_normalize_ref(vr, norms, ans=acc, coeff=coeff, j=2)
    for got, want in zip((*qk, *ans), (*qr, *acc)):
        assert torch.equal(got, want)
    b = df.df_sqrt(ls.fold_df_slots_ref(norms))
    assert torch.equal(ab[2][2], b[0]) and torch.equal(ab[3][2], b[1])
    torch.cuda.synchronize()
    assert ls.launches_step_df_sharded - before == 2 + 2 + 1


def test_shard_passes_on_an_all_zero_shard(dev):
    """A shard whose rows are all padding: every partial exactly zero,
    q_{j+1} zero (breakdown, decided on the device)."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    z = torch.zeros(1 << 14, device=dev)
    zero = torch.zeros(1, device=dev)
    assert torch.equal(ls.shard_step_dot(z, z, mask=z), zero)
    v, part = ls.shard_step_update(z.clone(), z, z, zero, zero, mask=z)
    assert torch.equal(part, zero)
    q = ls.shard_step_normalize(v, part)
    zp = (z, z.clone())
    d = ls.shard_df_dot(zp, zp, mask=z)
    v2, part2 = ls.shard_df_update((z.clone(), z.clone()), zp, zp, d, None,
                                   mask=z)
    q2 = ls.shard_df_normalize(v2, part2)
    torch.cuda.synchronize()
    assert not (q.any() or q2[0].any() or q2[1].any() or d.any()
                or part2.any())


def _eager_passes(monkeypatch):
    """Every sharded loop on the plain versions of the passes (the eager
    step of the first port)."""
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    for name in ("shard_step_dot", "shard_step_update", "shard_step_sub_norm",
                 "shard_step_normalize", "shard_df_dot", "shard_df_update",
                 "shard_df_normalize"):
        ref = getattr(ls, name + "_ref")
        monkeypatch.setattr(ls, name, lambda *a, ref=ref, work=None,
                            early=False, **kw: ref(*a, **kw))


def test_sharded_loop_folds_equal_plain_folds(dev, monkeypatch):
    """On 4 shards of the card (f32 ``lanczos_cpg_sharded`` and the df64
    pass 1): every alpha[j] and beta[j] the kernels wrote equals, bit for
    bit, the plain passes' fold (``fold_slots_ref`` / its df twin, then
    sqrt or df_sqrt for beta) of the slots the kernels read, recorded
    from the stream as each consuming pass was queued.  The recording
    copies break the dependent-launch chain where a producer pass hands
    off to a consumer, so the run with them must first equal, bit for
    bit, the unbroken chain that the loops run."""
    from tpu_lanczos_torch.core import df64 as df
    from tpu_lanczos_torch.dist import cpg_sharded as cs
    from tpu_lanczos_torch.dist import lanczos_df as ldf
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    g, mesh, sg = _sharded(dev, 4)
    k = 12
    x = sg.permute_in(np.random.default_rng(3).standard_normal(g.n),
                      np.float64)
    xd = list(zip(*(mesh.split(t, sg.n_loc) for t in (
        x.astype(np.float32), (x - x.astype(np.float32)).astype(
            np.float32)))))
    # the unbroken chain, with nothing queued between its passes
    chained = cs.lanczos_cpg_sharded(sg, x.astype(np.float32), k, mesh)
    chained_df = ldf.lanczos_alphabeta_df_sharded(sg, mesh, xd, k)[:2]
    seen = {"a": [], "ss": []}
    for name, key in (("shard_step_update", "a"), ("shard_df_update", "a"),
                      ("shard_step_normalize", "ss"),
                      ("shard_df_normalize", "ss")):
        real = getattr(ls, name)

        def spy(v, *a, real=real, key=key, **kw):
            slots = a[2] if key == "a" else a[0]
            if kw.get("alpha", kw.get("beta", "x")) is not None:
                seen[key].append(slots.clone())
            return real(v, *a, **kw)
        monkeypatch.setattr(ls, name, spy)
    st = cs.lanczos_cpg_sharded(sg, x.astype(np.float32), k, mesh)
    assert torch.equal(st.alpha, chained.alpha)
    assert torch.equal(st.beta, chained.beta)
    for j in range(k):
        assert torch.equal(st.alpha[j], ls.fold_slots_ref(seen["a"][j]))
    for j in range(k - 1):
        assert torch.equal(st.beta[j],
                           torch.sqrt(ls.fold_slots_ref(seen["ss"][j])))
    seen["a"].clear()
    seen["ss"].clear()
    (ah, al), (bh, bl), _ = ldf.lanczos_alphabeta_df_sharded(sg, mesh, xd, k)
    for got, want in zip((ah, al, bh, bl),
                         (t for pair in chained_df for t in pair)):
        assert torch.equal(got, want)
    for j in range(k):
        a = ls.fold_df_slots_ref(seen["a"][j])
        b = df.df_sqrt(ls.fold_df_slots_ref(seen["ss"][j]))
        assert torch.equal(ah[j], a[0]) and torch.equal(al[j], a[1])
        assert torch.equal(bh[j], b[0]) and torch.equal(bl[j], b[1])


def test_sharded_loops_through_the_step_passes(dev, monkeypatch):
    """On 4 shards of the card: lanczos_cpg_sharded (f32, f64, and f64
    reorthogonalized) and the df64 query launch exactly their pass counts
    (3 a shard a step, 4 with reorthogonalization; the df64 query 3 a
    shard a step of its 2k - 1 and each pass's start norm) and no
    single-device step; alpha and beta within rtol 1e-5 plus 1e-5 of
    the spectrum's scale, max(|alpha|, |beta|) (f32: the kernel's dot
    rounds in another order than torch.dot, and fifteen f32 steps grow
    that to 4.3e-5 relative on the smallest alpha, 8e-6 absolute on
    alphas up to 14), and rtol 1e-12 (f64), of the eager passes'; the mask-folded loop equals the loop over the masked SpMV
    bit for bit; the df64 answer within 1e-11 of the oracle."""
    from tpu_lanczos_torch.dist import cpg_sharded as cs
    from tpu_lanczos_torch.dist.lanczos_df import expm_action_df_sharded
    from tpu_lanczos_torch.dist.mesh import LocalSpmv
    from tpu_lanczos_torch.kernels import lanczos_step as ls

    g, mesh, sg = _sharded(dev, 4)
    k = 15
    x = sg.permute_in(np.ones(g.n), np.float64)
    got = {}
    for dt, reo in ((np.float32, False), (np.float64, False),
                    (np.float64, True)):
        before = (ls.launches_step_sharded, ls.launches_step)
        got[dt, reo] = cs.lanczos_cpg_sharded(sg, x.astype(dt), k, mesh,
                                              reorthogonalize=reo)
        torch.cuda.synchronize()
        assert (ls.launches_step_sharded - before[0],
                ls.launches_step - before[1]) == ((4 if reo else 3) * k * 4,
                                                  0)
    before = ls.launches_step_df_sharded
    res = expm_action_df_sharded(g, k=k, mesh=mesh, sg=sg)
    assert ls.launches_step_df_sharded - before == 4 * (2 + 3 * (2 * k - 1))
    assert oracle.rel_error(res.ans, oracle.expm_action(
        g, np.ones(g.n), k)) < 1e-11
    with monkeypatch.context() as m:
        m.setattr(cs, "_local", lambda sg, mesh: LocalSpmv(
            lambda q: cs._local_spmv(sg, mesh, q, cs.run_level)))
        for (dt, reo), st in got.items():
            st2 = cs.lanczos_cpg_sharded(sg, x.astype(dt), k, mesh,
                                         reorthogonalize=reo)
            assert torch.equal(st.alpha, st2.alpha)
            assert torch.equal(st.beta, st2.beta)
            assert all(torch.equal(a, b)
                       for a, b in zip(st.q_basis, st2.q_basis))
    _eager_passes(monkeypatch)
    for (dt, reo), st in got.items():
        st2 = cs.lanczos_cpg_sharded(sg, x.astype(dt), k, mesh,
                                     reorthogonalize=reo)
        want = [t.cpu().numpy() for t in (st2.alpha, st2.beta)]
        f32 = dt == np.float32
        atol = 1e-5 * max(np.abs(w).max() for w in want) if f32 else 0.0
        for mine, w in zip((st.alpha, st.beta), want):
            np.testing.assert_allclose(mine.cpu().numpy(), w,
                                       rtol=1e-5 if f32 else 1e-12,
                                       atol=atol)
