"""The slab layout of the CPG format in the port against the JAX package:
the packs (numpy and native level builders), one level of the plain and
the compensated kernel's plain versions against the Pallas kernel in
interpret mode (``_run_level(..., slab=True, interpret=True)``), the
whole f32/f64 and df SpMVs, and .npz packs in both directions.

The graphs span several source slabs per chunk (a graph that fits one
slab per chunk packs to the same tiles in both layouts and cannot tell
them apart): BA n=40,000 at sub 256 and 512, with its broadcast and
reduce levels, and the star graph's deep split at sub 512; uniform at
sub 128, where a chunk is one slab.

Bars: exact equality everywhere.  The plain versions sum each dest
cell's tile values from 0 in tile order, a ghost cell adds +0.0 as the
Pallas body's ``where(idx < LANE, part, zero)`` does, and the packer is
the reference's code, so nothing rounds differently.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.graphs import generators
from tpu_lanczos.core import lanczos_df as ref_ldf
from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos.kernels.spmv_cpg import _run_level
from tpu_lanczos.kernels.spmv_cpg import spmv_cpg as ref_spmv_cpg
from tpu_lanczos.kernels.spmv_cpg import spmv_cpg_df as ref_spmv_cpg_df
from tpu_lanczos_torch.graphs import native
from tpu_lanczos_torch.kernels import cpg, spmv_cpg
from tpu_lanczos_torch.kernels.cpg import LANE

from _torch_cases import (LEVEL_KEYS, port_pack, star_graph, to_port_graph,
                          untranspose)


def _ba40k():
    return generators.barabasi_albert(40000, 4, seed=1, use_native=False)


# name -> (graph factory, pack sub)
SLAB_CASES = {
    "ba40000_m4_sub256": (_ba40k, 256),
    "ba40000_m4_sub512": (_ba40k, 512),
    "star_sub512": (star_graph, 512),
    "uniform_sub128": (lambda: generators.uniform_random(
        20000, 60000, seed=4), 128),
}


@pytest.fixture(scope="module", params=list(SLAB_CASES))
def case(request):
    build, sub = SLAB_CASES[request.param]
    g = build()
    ref = ref_cpg.pack_cpg(g, sub=sub, layout="slab")
    return g, ref, port_pack(ref)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_pack_equal(port, ref):
    for k in ("n", "n_chunks", "nnz", "theta", "sub", "n_bcast", "layout",
              "t_reals", "mask_sparse"):
        assert getattr(port, k) == getattr(ref, k), k
    np.testing.assert_array_equal(port.new_of_old, ref.new_of_old)
    np.testing.assert_array_equal(port.realmask.numpy(),
                                  np.asarray(ref.realmask))
    assert len(port.levels) == len(ref.levels)
    for i, (lv_p, lv_r) in enumerate(zip(port.levels, ref.levels)):
        for k in LEVEL_KEYS:
            want = np.asarray(lv_r[k])
            got = lv_p[k].numpy()
            assert got.dtype == want.dtype, (i, k)
            np.testing.assert_array_equal(got, want, err_msg=f"lv{i} {k}")


@pytest.mark.parametrize("builder", ["native", "numpy"])
def test_slab_pack_equals_reference(case, builder, monkeypatch):
    """Each package's native builders against the other's, and each
    one's numpy builders (``_build_cpg_level_slab_np`` and the numpy
    tier colouring, which colour differently from the native ones)
    against the other's."""
    g, ref, _ = case
    if builder == "numpy":
        for mod in (cpg, ref_cpg):
            monkeypatch.setattr(mod, "_native", lambda *a, **k: None)
        ref = ref_cpg.pack_cpg(g, sub=ref.sub, layout="slab")
    else:
        assert native.available(), native.build_error()
    port = cpg.pack_cpg(to_port_graph(g), sub=ref.sub, layout="slab",
                        device="cpu")
    assert_pack_equal(port, ref)
    assert port.layout == "slab"
    # the slab layout's l2 is uint8 at every sub; l1 has 128 rows a tile
    for lv in port.levels:
        assert lv["l2"].dtype == torch.uint8
        assert lv["l1"].shape == (lv["s_ids"].shape[0] * LANE, LANE)
    rows = sum(t * (LANE * LANE + LANE * ref.sub) for t in ref.t_reals)
    assert port.index_bytes() == rows


def test_ba40k_spans_several_slabs_per_chunk():
    """The slab pack of the BA graph really differs from the classic one:
    more tiles, fewer index bytes per tile at sub 512."""
    g = to_port_graph(_ba40k())
    slab = cpg.pack_cpg(g, sub=512, layout="slab", device="cpu")
    classic = cpg.pack_cpg(g, sub=512, device="cpu")
    assert classic.layout == "classic"
    assert slab.total_tiles > classic.total_tiles
    assert (slab.index_bytes() / slab.total_tiles
            < classic.index_bytes() / classic.total_tiles)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_run_level_ref_slab_bit_identical_to_pallas(case, dtype):
    _, ref, port = case
    rng = np.random.default_rng(0)
    for i, (lv_r, lv_p) in enumerate(zip(ref.levels, port.levels)):
        x2d = ref.permute_in(rng.standard_normal(ref.n), dtype).reshape(
            -1, LANE)
        want = untranspose(np.asarray(_run_level(
            jnp.asarray(x2d), lv_r, ref.n_chunks, ref.sub, True, slab=True,
            t_real=ref.t_reals[i], sparse_dispatch=ref.mask_sparse[i])),
            ref.n_chunks, ref.sub)
        got = spmv_cpg.run_level_ref(_t(x2d), lv_p, port.n_chunks, port.sub,
                                     slab=True)
        assert got.dtype == _t(x2d).dtype and got.shape == x2d.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"lv{i}")


def test_run_level_comp_ref_slab_bit_identical_to_pallas(case):
    _, ref, port = case
    rng = np.random.default_rng(1)
    for i, (lv_r, lv_p) in enumerate(zip(ref.levels, port.levels)):
        x2d = ref.permute_in(rng.standard_normal(ref.n),
                             np.float32).reshape(-1, LANE)
        acc_r, err_r = _run_level(
            jnp.asarray(x2d), lv_r, ref.n_chunks, ref.sub, True,
            compensated=True, slab=True, t_real=ref.t_reals[i],
            sparse_dispatch=ref.mask_sparse[i])
        acc, err = spmv_cpg.run_level_comp_ref(_t(x2d), lv_p, port.n_chunks,
                                               port.sub, slab=True)
        np.testing.assert_array_equal(
            acc.numpy(), untranspose(np.asarray(acc_r), ref.n_chunks, ref.sub),
            err_msg=f"acc lv{i}")
        np.testing.assert_array_equal(
            err.numpy(), untranspose(np.asarray(err_r), ref.n_chunks, ref.sub),
            err_msg=f"err lv{i}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_cpg_slab_bit_identical_to_reference(case, dtype):
    g, ref, port = case
    xr = np.random.default_rng(2).standard_normal(g.n)
    xp = ref.permute_in(xr, dtype)
    want = np.asarray(ref_spmv_cpg(ref, jnp.asarray(xp), interpret=True))
    before = (spmv_cpg.launches, spmv_cpg.launches_slab)
    got = spmv_cpg.spmv_cpg(port, _t(xp))
    assert (spmv_cpg.launches, spmv_cpg.launches_slab) == before  # CPU
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == np.float64:
        np.testing.assert_allclose(port.permute_out(got), g.to_scipy() @ xr,
                                   rtol=1e-11, atol=1e-11)


def test_spmv_cpg_df_slab_bit_identical_to_reference(case):
    g, ref, port = case
    x64 = np.random.default_rng(5).standard_normal(g.n)
    hi, lo = ref_ldf.split_f64(ref.permute_in(x64, np.float64))
    yh_r, yl_r = ref_spmv_cpg_df(ref, jnp.asarray(hi), jnp.asarray(lo),
                                 interpret=True)
    yh, yl = spmv_cpg.spmv_cpg_df(port, _t(hi), _t(lo))
    np.testing.assert_array_equal(yh.numpy(), np.asarray(yh_r))
    np.testing.assert_array_equal(yl.numpy(), np.asarray(yl_r))


def test_slab_save_load_across_packages(case, tmp_path):
    _, ref, port = case
    path = str(tmp_path / "ref.npz")
    ref_cpg.save_cpg(ref, path)
    assert_pack_equal(cpg.load_cpg(path, device="cpu"), ref)
    path = str(tmp_path / "port.npz")
    cpg.save_cpg(port, path)
    assert_pack_equal(port_pack(ref_cpg.load_cpg(path)), ref)


def test_load_extends_short_slab_ghost_tail(tmp_path):
    """A slab pack saved without the ghost-tile tail loads to the same
    arrays in both packages: l2's padding is 255 (ghost), not 0."""
    build, sub = SLAB_CASES["ba40000_m4_sub512"]
    ref = ref_cpg.pack_cpg(build(), sub=sub, layout="slab")
    path = str(tmp_path / "full.npz")
    ref_cpg.save_cpg(ref, path)
    z = dict(np.load(path))
    for i in range(int(z["n_levels"])):
        t = int(z[f"lv{i}_counts"].sum())
        z[f"lv{i}_l1"] = z[f"lv{i}_l1"][: t * LANE]
        z[f"lv{i}_l2"] = z[f"lv{i}_l2"][: t * LANE]
        for k in ("s_ids", "d_ids", "run_ids", "pair_mask"):
            z[f"lv{i}_{k}"] = z[f"lv{i}_{k}"][:t]
    short = str(tmp_path / "short.npz")
    np.savez(short, **z)
    port = cpg.load_cpg(short, device="cpu")
    assert_pack_equal(port, ref_cpg.load_cpg(short))
    assert int(port.levels[0]["l2"][-1, 0]) == 255


def test_kernel_wrapper_checks_slab_shapes(case):
    """What the CUDA wrapper checks before it passes pointers: a slab
    level passes as slab, and is refused as classic (its l1 has 128 rows
    a tile, or at sub 512 its l2 is uint8, not int16)."""
    _, _, port = case
    for dtype in (torch.float32, torch.float64):
        x2d = torch.zeros((port.n_sub, LANE), dtype=dtype)
        for lv in port.levels:
            spmv_cpg._check(x2d, lv, port.n_chunks, port.sub, x2d, slab=True)
            if port.sub > LANE:
                with pytest.raises(ValueError):
                    spmv_cpg._check(x2d, lv, port.n_chunks, port.sub, None)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data starts 1 byte past a 16-byte
    boundary."""
    raw = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8)
    off = (-raw.data_ptr()) % 16 + 1
    out = raw[off:off + t.numel() * t.element_size()].view(t.dtype)
    out = out.view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("fault", ["l1_misaligned", "l2_misaligned",
                                   "l2_int16", "l1_uint8", "l1_short",
                                   "l2_short", "too_many_tiles", "x_int32"])
def test_check_refuses_what_the_slab_kernel_cannot_take(case, fault,
                                                        monkeypatch):
    """``_check`` (run before every CUDA launch) refuses, with
    ValueError or TypeError and never a fallback, what the slab walk
    cannot read: l1 or l2 not 16-byte aligned (its TMA boxes), index
    types other than int8 l1 and uint8 l2, l1 or l2 a tile short, more
    tiles than its int32 TMA row coordinates reach, a non-float x.  The
    unaltered level passes."""
    _, _, port = case
    lv = dict(port.levels[port.n_bcast])
    x2d = torch.zeros((port.n_sub, LANE), dtype=torch.float32)
    spmv_cpg._check(x2d, lv, port.n_chunks, port.sub, None, slab=True)
    if fault == "l1_misaligned":
        lv["l1"] = _misaligned(lv["l1"])
        assert lv["l1"].data_ptr() % 16 and lv["l1"].is_contiguous()
    elif fault == "l2_misaligned":
        lv["l2"] = _misaligned(lv["l2"])
    elif fault == "l2_int16":
        lv["l2"] = lv["l2"].to(torch.int16)
    elif fault == "l1_uint8":
        lv["l1"] = lv["l1"].to(torch.uint8)
    elif fault in ("l1_short", "l2_short"):
        k = fault[:2]
        lv[k] = lv[k][:-LANE]
    elif fault == "too_many_tiles":
        t_pad = lv["s_ids"].shape[0]
        monkeypatch.setattr(spmv_cpg, "SLAB_MAX_ROWS", t_pad * LANE - 1)
    elif fault == "x_int32":
        x2d = x2d.to(torch.int32)
    with pytest.raises((ValueError, TypeError)):
        spmv_cpg._check(x2d, lv, port.n_chunks, port.sub, None, slab=True)


def test_graphcore_copy_is_byte_identical():
    """The port's copy of graphcore.cc is the reference's byte for byte
    but for one block: the Konig coloring's path swap, which the port
    does in two passes (clear every old color, then set every new one),
    so an interior node of the path keeps both of its colors."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    with open(os.path.join(root, "tpu_lanczos", "graphs", "native",
                           "graphcore.cc"), "rb") as f:
        want = f.read()
    with open(os.path.join(root, "tpu_lanczos_torch", "graphs", "native",
                           "graphcore.cc"), "rb") as f:
        got = f.read()
    end = b"      c = alpha;\n"
    ref_start = want.index(b"      for (const int64_t f : path) {\n")
    port_start = got.index(b"      // Swap in two passes")
    ref_block = want[ref_start:want.index(end, ref_start)]
    port_block = got[port_start:got.index(end, port_start)]
    assert port_block.count(b"for (const int64_t f : path)") == 2
    assert want.count(ref_block) == 1
    assert want.replace(ref_block, port_block) == got