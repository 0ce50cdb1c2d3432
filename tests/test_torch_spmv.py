"""The whole CPG SpMV (broadcast, main and reduce levels, realmask) of the
port against the reference's ``spmv_cpg(cg, x, interpret=True)`` on the
same pack, bit for bit, and against scipy in float64 within 1e-11 (the
reference's own bar, tests/test_cpg.py:38).  Plus the premise of the
compensated kernel's ghost skip (lane-127 slots), on one device and on
every buffer a shard reads in the row-sharded SpMVs, the wrapper's
argument checks (a source of another chunk count than the dest's
included) and the format dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos.kernels.spmv_cpg import spmv_cpg as ref_spmv_cpg
from tpu_lanczos.graphs import generators
from tpu_lanczos_torch.core.lanczos_df import split_f64
from tpu_lanczos_torch.dist import cpg_sharded as cs
from tpu_lanczos_torch.dist import lanczos_df as ldf
from tpu_lanczos_torch.dist.mesh import make_mesh
from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.cpg import LANE, pack_cpg
from tpu_lanczos_torch.kernels.spmv import spmv

from _torch_cases import PACK_CASES, port_pack, star_graph, to_port_graph


@pytest.fixture(scope="module", params=list(PACK_CASES))
def case(request):
    build, sub = PACK_CASES[request.param]
    g = build()
    ref = ref_cpg.pack_cpg(g, sub=sub)
    return g, ref, port_pack(ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_cpg_bit_identical_to_reference(case, dtype):
    g, ref, port = case
    xp = ref.permute_in(np.random.default_rng(1).standard_normal(g.n), dtype)
    want = np.asarray(ref_spmv_cpg(ref, jnp.asarray(xp), interpret=True))
    got = spmv(port, torch.from_numpy(xp))
    assert got.dtype == torch.from_numpy(xp).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_spmv_cpg_matches_scipy_f64(case):
    g, _, port = case
    xr = np.random.default_rng(2).standard_normal(g.n)
    x = torch.from_numpy(port.permute_in(xr, np.float64))
    x_before = x.clone()
    got = port.permute_out(spmv_cpg.spmv_cpg(port, x))
    np.testing.assert_allclose(got, g.to_scipy() @ xr, rtol=1e-11,
                               atol=1e-11)
    # the broadcast level must not write into the caller's x (lanczos
    # has already stored it in q_basis)
    assert torch.equal(x, x_before)
    # ghost and padding positions of y stay zero
    y = spmv_cpg.spmv_cpg_ref(port, x).numpy()
    assert not y[port.realmask.numpy() == 0].any()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lane_127_sign_leaves_every_level_unchanged(case, dtype):
    """The premise of the compensated kernel's ghost skip: a ghost's term
    is x's lane-127 slot, and whether that slot holds -0.0 or +0.0 (the
    +0.0 the kernel adds in its place) leaves the plain level (base given
    or absent) and the compensated level (acc and err) unchanged bit for
    bit, on every level of the pack."""
    _, _, port = case
    C, sub = port.n_chunks, port.sub
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (port.n_sub, LANE))).to(dtype)
    neg, pos = x.clone(), x.clone()
    neg[:, LANE - 1] = -0.0
    pos[:, LANE - 1] = 0.0
    for level in port.levels:
        for base in (False, True):
            a = spmv_cpg.run_level_ref(neg, level, C, sub,
                                       base=neg if base else None)
            b = spmv_cpg.run_level_ref(pos, level, C, sub,
                                       base=pos if base else None)
            assert torch.equal(_bits(a), _bits(b))
        for a, b in zip(spmv_cpg.run_level_comp_ref(neg, level, C, sub),
                        spmv_cpg.run_level_comp_ref(pos, level, C, sub)):
            assert torch.equal(_bits(a), _bits(b))


def test_every_level_input_is_zero_in_lane_127(case):
    """Every level's input through spmv_cpg_ref and spmv_cpg_df_ref holds
    +-0.0 in every lane-127 slot (the broadcast levels' outputs, the main
    level's output fed to the reduce levels, the df error streams), for a
    random x with zero lane-127 slots: the pack places no unit there."""
    _, _, port = case
    seen = []

    def zero_in_lane_127(x2d):
        seen.append(x2d)
        assert not x2d[:, LANE - 1].any()

    def plain(x2d, level, n_chunks, sub, base=None, slab=False):
        zero_in_lane_127(x2d)
        return spmv_cpg.run_level_ref(x2d, level, n_chunks, sub, base, slab)

    def comp(x2d, level, n_chunks, sub, slab=False):
        zero_in_lane_127(x2d)
        return spmv_cpg.run_level_comp_ref(x2d, level, n_chunks, sub, slab)

    xr = np.random.default_rng(5).standard_normal(port.n)
    x64 = port.permute_in(xr, np.float64)
    assert not x64.reshape(-1, LANE)[:, LANE - 1].any()
    spmv_cpg._spmv(port, torch.from_numpy(x64.astype(np.float32)), plain)
    hi = x64.astype(np.float32)
    lo = (x64 - hi).astype(np.float32)
    spmv_cpg._spmv_df(port, torch.from_numpy(hi), torch.from_numpy(lo),
                      plain, comp)
    L, nb = len(port.levels), port.n_bcast
    assert len(seen) == L + (2 * nb + 2 * (L - nb))


SHARDED_GRAPHS = {
    # tests/test_cpg_sharded.py's graphs: a power-law pack (full
    # gathers), the 360k-node stencil (the halo path) and the hub (deep
    # reduce levels, compact exchanges); and a 40,000-node power-law pack
    # at sub=128 whose tiles span two shards (a cross pass that is not
    # empty: below ~16,000 units every tile is in shard 0's block)
    "barabasi": (lambda: generators.barabasi_albert(
        3000, 8, seed=2, use_native=False), None),
    "stencil600": (lambda: generators.stencil_2d(600), None),
    "hub": (lambda: star_graph(2000), None),
    "barabasi40k": (lambda: generators.barabasi_albert(
        40000, 4, seed=5, use_native=False), 128),
}


@pytest.fixture(scope="module", params=list(SHARDED_GRAPHS))
def dest_only_pack(request):
    build, sub = SHARDED_GRAPHS[request.param]
    g = to_port_graph(build())
    return g, pack_cpg(g, sub=sub, device="cpu", **cs.dest_only_kw())


@pytest.mark.parametrize("n_shards", [2, 4, 5])
def test_every_sharded_level_input_is_zero_in_lane_127(dest_only_pack,
                                                       n_shards,
                                                       monkeypatch):
    """The ghost-skip premise on the row-sharded path: every buffer a
    shard's level reads (its own rows, the gathered vector, its rows
    followed by the halo, the halo buffer, the compact reduce buffer,
    each with its padded chunks) holds +-0.0 in every lane-127 slot, in
    the plain SpMV and in both streams of the df SpMV, with the main
    level split (overlap) and unsplit."""
    g, cg = dest_only_pack
    mesh = make_mesh(n_shards, device="cpu")
    xr = np.random.default_rng(6).standard_normal(g.n)
    real_plain, real_comp = spmv_cpg.run_level_ref, spmv_cpg.run_level_comp_ref
    for overlap in (True, False):
        split = cs.split_cpg(cg, n_shards, overlap)
        sg = cs.ShardedCPG.from_numpy(split["meta"], split["levels"],
                                      split["realmask"],
                                      split["new_of_old"], mesh)
        n = {"calls": 0}

        def check(x2d):
            assert not x2d[:, LANE - 1].any()
            assert x2d.shape[0] % sg.sub == 0

        def plain(x2d, level, n_chunks, sub, base=None, slab=False,
                  halo=None):
            check(x2d)
            for t in (base, halo):
                if t is not None:
                    check(t.reshape(-1, LANE))
            n["calls"] += 1
            return real_plain(x2d, level, n_chunks, sub, base, halo=halo)

        def comp(x2d, level, n_chunks, sub, slab=False):
            check(x2d)
            n["calls"] += 1
            return real_comp(x2d, level, n_chunks, sub)

        x64 = sg.permute_in(xr, np.float64)
        x32 = mesh.split(x64.astype(np.float32), sg.n_loc)
        cs._local_spmv(sg, mesh, x32, plain)
        hi, lo = split_f64(x64)
        # the df64 shard level's plain version walks hi and lo through
        # these
        with monkeypatch.context() as m:
            m.setattr(spmv_cpg, "run_level_ref", plain)
            m.setattr(spmv_cpg, "run_level_comp_ref", comp)
            ldf._local_spmv_df(sg, mesh, list(zip(
                mesh.split(hi, sg.n_loc), mesh.split(lo, sg.n_loc))),
                spmv_cpg.run_shard_level_df_ref)
        # every pass a shard runs, thrice: the plain SpMV, and the df
        # SpMV's compensated and plain runs (a pass or a reduce level
        # with no tiles on a shard is not run there)
        passes = sum(len(cs.shard_passes(sg, s))
                     for s in range(n_shards))
        assert n["calls"] == 3 * passes


def _level_args(port, dtype=torch.float32):
    x2d = torch.zeros((port.n_sub, LANE), dtype=dtype)
    return x2d, dict(port.levels[0]), port.n_chunks, port.sub


@pytest.mark.parametrize("bad", [
    "x_dtype", "x_shape", "x_stride", "l2_dtype", "l1_shape",
    "counts_dtype", "base_shape",
])
def test_kernel_wrapper_rejects_bad_arguments(case, bad):
    """What the CUDA wrapper checks before passing pointers (the check
    itself runs on any device)."""
    _, _, port = case
    x2d, level, C, sub = _level_args(port)
    base = None
    if bad == "x_dtype":
        x2d = x2d.to(torch.float16)
    elif bad == "x_shape":
        x2d = x2d[:-1]
    elif bad == "x_stride":
        x2d = torch.zeros((LANE, port.n_sub)).t()
    elif bad == "l2_dtype":
        level["l2"] = level["l2"].to(torch.int32)
    elif bad == "l1_shape":
        level["l1"] = level["l1"][:-1]
    elif bad == "counts_dtype":
        level["counts"] = level["counts"].long()
    elif bad == "base_shape":
        base = x2d[:-1]
    with pytest.raises((TypeError, ValueError)):
        spmv_cpg._check(x2d, level, C, sub, base)


def test_kernel_wrapper_accepts_pack_arrays(case):
    _, _, port = case
    for dtype in (torch.float32, torch.float64):
        x2d, _, C, sub = _level_args(port, dtype)
        for level in port.levels:
            spmv_cpg._check(x2d, level, C, sub, x2d)


def test_kernel_wrapper_takes_a_source_of_other_chunks(case):
    """A shard's level reads a source of another chunk count than its
    dest (``n_chunks``): any whole number of sub-row chunks passes, a
    partial chunk does not, and base must be shaped like the dest."""
    _, _, port = case
    _, level, C, sub = _level_args(port)
    level = dict(level)
    for extra in (-C + 1, 3):
        x2d = torch.zeros(((C + extra) * sub, LANE))
        spmv_cpg._check(x2d, level, C, sub, torch.zeros((C * sub, LANE)))
    with pytest.raises(ValueError, match="whole number"):
        spmv_cpg._check(torch.zeros((C * sub + 1, LANE)), level, C, sub, None)
    x2d = torch.zeros(((C + 3) * sub, LANE))
    with pytest.raises(ValueError, match="base must be"):
        spmv_cpg._check(x2d, level, C, sub, x2d)


def test_spmv_rejects_unported_formats():
    """Every format of the JAX package is ported; a pack of any other type
    is refused by name."""

    class CSTGraph:
        pass

    with pytest.raises(NotImplementedError, match="no SpMV for CSTGraph"):
        spmv(CSTGraph(), torch.zeros(4))


def test_run_level_rejects_other_devices(case):
    _, _, port = case
    x2d, level, C, sub = _level_args(port)
    with pytest.raises(ValueError, match="no CPG SpMV"):
        spmv_cpg.run_level(x2d.to("meta"), level, C, sub)
