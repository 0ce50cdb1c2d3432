"""The GPG format in the port against the JAX package: every level array
of the packs (the parameter variants and the hub graph's reduce levels
included), one level of the plain version against the Pallas kernel in
interpret mode, the whole SpMV, .npz packs in both directions, the spmv
dispatch and the f64 pipeline against the oracle.

The graphs are tests/test_gpg.py's.  Bars: exact equality for packs,
levels and SpMVs (both sum each dest cell's tile values from +0.0 in tile
order; the reference's clamped padding tiles add +0.0, and ghost cells
read lane 127, a zero of x); the f64 answer within 1e-12 of the oracle.

The reference level runs under one ``jax.jit`` so that packs of equal
shapes share its interpret-mode compile (~15 s each on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.graphs import generators
from tpu_lanczos.graphs.csr import CSRGraph
from tpu_lanczos.kernels import gpg as ref_gpg
from tpu_lanczos.kernels import spmv_gpg as ref_spmv_gpg
from tpu_lanczos_torch import expm_action
from tpu_lanczos_torch.eval import oracle
from tpu_lanczos_torch.kernels import gpg, spmv_gpg
from tpu_lanczos_torch.kernels.spmv import spmv

from _torch_cases import to_port_graph


def _hub(n: int = 1200) -> CSRGraph:
    hub = np.stack([np.zeros(n - 1, dtype=np.int64),
                    np.arange(1, n, dtype=np.int64)], axis=1)
    return CSRGraph.from_edges(n, hub)


def _ba():
    return generators.barabasi_albert(1500, 6, seed=2)


# name -> (graph factory, pack_gpg keyword arguments)
CASES = {
    "uniform": (lambda: generators.uniform_random(1500, 5000, seed=1), {}),
    "barabasi": (_ba, {}),
    "rmat": (lambda: generators.rmat(1500, 5000, seed=3), {}),
    "stencil": (lambda: generators.stencil_2d(40), {}),
    "hub": (_hub, {}),  # one row of degree 1199: reduce levels
    "sub_d512": (_ba, dict(sub_d=512)),
    "g_s8": (_ba, dict(g_s=8)),
    "sub_s128": (_ba, dict(sub_s=128, g_s=16)),
}
# the cases whose levels run through the Pallas interpret kernel: the
# default shapes (which uniform, barabasi, hub, rmat and stencil share),
# the hub for its reduce levels, and the taller dest chunk and the lower
# staging height; g_s=8 (~30 s more to compile) is held by the scipy bar
LEVEL_CASES = ("barabasi", "hub", "sub_d512", "sub_s128")

_META = ("n", "n_chunks", "nnz", "theta", "g_s", "sub_s", "sub_d")


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    build, kw = CASES[request.param]
    g = build()
    return request.param, g, kw, ref_gpg.pack_gpg(g, **kw)


def port_pack(ref, device="cpu"):
    """The reference GPGGraph's arrays as the port's GPGGraph."""
    return gpg.from_numpy({k: getattr(ref, k) for k in _META},
                          [{k: np.asarray(lv[k]) for k in gpg.LEVEL_KEYS}
                           for lv in ref.levels],
                          np.asarray(ref.realmask), ref.new_of_old, device)


def assert_pack_equal(port, ref):
    for k in _META + ("n_slots", "n_sub", "n_pad", "total_tiles", "fill"):
        assert getattr(port, k) == getattr(ref, k), k
    np.testing.assert_array_equal(port.new_of_old, ref.new_of_old)
    np.testing.assert_array_equal(port.realmask.numpy(),
                                  np.asarray(ref.realmask))
    assert len(port.levels) == len(ref.levels)
    for i, (lv_p, lv_r) in enumerate(zip(port.levels, ref.levels)):
        for k in gpg.LEVEL_KEYS:
            want = np.asarray(lv_r[k])
            got = lv_p[k].numpy()
            assert got.dtype == want.dtype, (i, k)
            np.testing.assert_array_equal(got, want, err_msg=f"lv{i} {k}")
    assert port.t_reals == tuple(int(np.asarray(lv["counts"]).sum())
                                 for lv in ref.levels)


def test_pack_equals_reference(case):
    _, g, kw, ref = case
    assert_pack_equal(gpg.pack_gpg(to_port_graph(g), device="cpu", **kw),
                      ref)


_ref_level = jax.jit(ref_spmv_gpg._run_level, static_argnums=(2, 3, 4, 5, 6))


def _untranspose(yt, gg):
    return yt.reshape(gg.n_chunks, 128, gg.sub_d).transpose(0, 2, 1).reshape(
        gg.n_sub, 128)


@pytest.mark.parametrize("name", LEVEL_CASES)
def test_levels_and_spmv_bit_identical_to_pallas(name):
    """Every level of run_level_gpg_ref, fed the inputs spmv_gpg gives it,
    equals the reference's _run_level(interpret=True) on the same inputs
    (float64; the main case also float32), and spmv_gpg equals the
    reference's level loop over those levels."""
    build, kw = CASES[name]
    ref = ref_gpg.pack_gpg(build(), **kw)
    port = port_pack(ref)
    rng = np.random.default_rng(0)
    for dtype in ((np.float64, np.float32) if name == "barabasi"
                  else (np.float64,)):
        x = ref.permute_in(rng.standard_normal(ref.n), dtype)
        x2d = torch.from_numpy(x).reshape(port.n_sub, 128)
        y2d = None
        for i, (lv_p, lv_r) in enumerate(zip(port.levels, ref.levels)):
            src = x2d if y2d is None else y2d
            got = spmv_gpg.run_level_gpg_ref(src, lv_p, port.n_chunks,
                                             port.g_s, port.sub_s, port.sub_d)
            want = np.asarray(_ref_level(
                jnp.asarray(src.numpy()), lv_r, ref.n_chunks, ref.g_s,
                ref.sub_s, ref.sub_d, True))
            assert got.dtype == src.dtype
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"lv{i}")
            # the reference's fold (spmv_gpg.py:190-199), in numpy
            yt = _untranspose(want, ref)
            y2d = torch.from_numpy(yt if y2d is None else y2d.numpy() + yt)
        y_want = y2d.numpy().reshape(-1) * np.asarray(ref.realmask).astype(
            dtype)
        y = spmv_gpg.spmv_gpg(port, torch.from_numpy(x))
        np.testing.assert_array_equal(y.numpy(), y_want)


def test_spmv_bit_identical_to_reference_spmv_gpg():
    """The whole SpMV against the reference's own jitted spmv_gpg in
    interpret mode (one level, so one compile)."""
    ref = ref_gpg.pack_gpg(CASES["uniform"][0]())
    port = port_pack(ref)
    x = ref.permute_in(np.random.default_rng(3).standard_normal(ref.n),
                       np.float64)
    want = np.asarray(ref_spmv_gpg.spmv_gpg(ref, jnp.asarray(x),
                                            interpret=True))
    np.testing.assert_array_equal(
        spmv_gpg.spmv_gpg(port, torch.from_numpy(x)).numpy(), want)


def test_spmv_matches_scipy_and_dispatch(case):
    """spmv_gpg and the spmv dispatch on every pack: f64 against scipy
    (the reference's 1e-12 bar) and equal to each other."""
    _, g, _, ref = case
    port = port_pack(ref)
    xr = np.random.default_rng(4).standard_normal(g.n)
    x = torch.from_numpy(port.permute_in(xr, np.float64))
    y = spmv_gpg.spmv_gpg(port, x)
    want = g.to_scipy() @ xr
    got = port.permute_out(y)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12
    assert torch.equal(spmv(port, x), y)
    assert torch.equal(spmv_gpg.spmv_gpg_ref(port, x), y)


def test_run_level_gpg_on_cpu_is_the_plain_version():
    port = port_pack(ref_gpg.pack_gpg(_ba()))
    x2d = torch.from_numpy(port.permute_in(
        np.random.default_rng(5).standard_normal(port.n),
        np.float32)).reshape(port.n_sub, 128)
    args = (port.levels[0], port.n_chunks, port.g_s, port.sub_s, port.sub_d)
    before = spmv_gpg.launches_gpg
    assert torch.equal(spmv_gpg.run_level_gpg(x2d, *args),
                       spmv_gpg.run_level_gpg_ref(x2d, *args))
    assert spmv_gpg.launches_gpg == before  # the CPU runs no kernel
    spmv_gpg._check(x2d, *args)
    with pytest.raises(ValueError, match="no GPG SpMV"):
        spmv_gpg.run_level_gpg(x2d.to("meta"), *args)
    bad = dict(port.levels[0], l2=port.levels[0]["l2"].to(torch.int16))
    with pytest.raises(ValueError, match="l2"):
        spmv_gpg._check(x2d, bad, *args[1:])
    with pytest.raises(ValueError):
        spmv_gpg._check(x2d[:-1].contiguous(), *args)


@pytest.mark.parametrize("g_s,sub_s,sub_d,ok", [
    (16, 256, 128, True), (8, 256, 512, True), (16, 128, 256, True),
    (32, 256, 384, True), (16, 256, 640, True), (16, 256, 2048, True),
    (16, 256, 200, False), (16, 192, 512, False), (48, 256, 512, False)])
def test_check_takes_exactly_the_kernel_shapes(g_s, sub_s, sub_d, ok):
    """The wrapper's check takes the shapes csrc/spmv_gpg.cu launches
    (g_s a power of two dividing sub_s, sub_s 128 or 256, sub_d a
    multiple of 128: 32-row blocks, 4 or 8 to a cluster) and refuses the
    others before any launch."""
    n_chunks, t_pad = 2, 4
    x2d = torch.zeros((n_chunks * sub_d, 128), dtype=torch.float32)
    level = dict(
        l1=torch.zeros((t_pad * sub_s, 128), dtype=torch.int8),
        l2=torch.zeros((t_pad * 128, sub_d), dtype=torch.uint8),
        g_ids=torch.zeros((t_pad * max(sub_s // g_s, 1),),
                          dtype=torch.int32),
        d_ids=torch.zeros((t_pad,), dtype=torch.int32),
        starts=torch.zeros((n_chunks,), dtype=torch.int32),
        counts=torch.zeros((n_chunks,), dtype=torch.int32))
    args = (x2d, level, n_chunks, g_s, sub_s, sub_d)
    if ok:
        spmv_gpg._check(*args)
    else:
        with pytest.raises(ValueError, match="GPG kernel takes"):
            spmv_gpg._check(*args)


@pytest.mark.parametrize("name", ["barabasi", "hub", "sub_s128"])
def test_real_step_share_counts_the_real_dest_steps(name):
    """real_step_share (from the staging side) equals the share of (tile,
    dest cell) steps whose staging row holds a real lane, counted on the
    dest side as the kernel walks them."""
    build, kw = CASES[name]
    port = port_pack(ref_gpg.pack_gpg(build(), **kw))
    real = steps = 0
    for lv, t in zip(port.levels, port.t_reals):
        l1 = lv["l1"][: t * port.sub_s].view(t, port.sub_s, 128).long()
        l2 = lv["l2"][: t * 128].view(t, 128, port.sub_d).long()
        lane = torch.gather(l1.transpose(1, 2), 2, l2)  # l1[t, r, c]
        real += int((lane != 127).sum())
        steps += lane.numel()
    assert 0 < real < steps
    assert port.real_step_share == real / steps


def test_save_load_both_directions(tmp_path):
    ref = ref_gpg.pack_gpg(CASES["uniform"][0]())
    port = port_pack(ref)
    p_ref, p_port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_gpg.save_gpg(ref, p_ref)
    gpg.save_gpg(port, p_port)
    assert_pack_equal(gpg.load_gpg(p_ref, device="cpu"), ref)
    assert_pack_equal(port_pack(ref_gpg.load_gpg(p_port)), ref)


def test_expm_action_through_gpg_matches_oracle():
    g = to_port_graph(_ba())
    gg = gpg.pack_gpg(g, device="cpu")
    res = expm_action(g, k=30, dtype="float64", dg=gg, device="cpu")
    want = oracle.expm_action(g, np.ones(g.n), 30)
    assert oracle.rel_error(res.ans, want) < 1e-12
