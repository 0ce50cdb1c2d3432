"""The port's CPG packer (tpu_lanczos_torch.kernels.cpg) against the JAX
package's: the same graph packs to the same arrays, exactly, and packs
cross between the packages through .npz files."""

import numpy as np
import pytest
import torch

from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos_torch.kernels import cpg

from _torch_cases import LEVEL_KEYS, PACK_CASES, port_pack, to_port_graph

META = ("n", "n_chunks", "nnz", "theta", "sub", "n_bcast", "layout",
        "t_reals", "mask_sparse")


@pytest.fixture(scope="module", params=list(PACK_CASES))
def case(request):
    build, sub = PACK_CASES[request.param]
    g = build()
    return g, sub, ref_cpg.pack_cpg(g, sub=sub)


def assert_pack_equal(port, ref):
    """Every level array, realmask, new_of_old and the metadata, exact."""
    for k in META:
        assert getattr(port, k) == getattr(ref, k), k
    np.testing.assert_array_equal(port.new_of_old, ref.new_of_old)
    assert port.realmask.dtype == torch.float32
    np.testing.assert_array_equal(port.realmask.numpy(),
                                  np.asarray(ref.realmask))
    assert len(port.levels) == len(ref.levels)
    for lv_p, lv_r in zip(port.levels, ref.levels):
        assert set(lv_p) == set(LEVEL_KEYS)
        for k in LEVEL_KEYS:
            want = np.asarray(lv_r[k])
            got = lv_p[k].numpy()
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_pack_cpg_equals_reference(case):
    g, sub, ref = case
    port = cpg.pack_cpg(to_port_graph(g), sub=sub, device="cpu")
    assert_pack_equal(port, ref)
    assert port.device == torch.device("cpu")
    assert port.total_tiles == sum(ref.t_reals)
    if sub == 512:
        assert all(lv["l2"].dtype == torch.int16 for lv in port.levels)
        assert any(port.mask_sparse)


def test_reference_save_port_load_round_trip(case, tmp_path):
    _, _, ref = case
    path = str(tmp_path / "pack.npz")
    ref_cpg.save_cpg(ref, path)
    assert_pack_equal(cpg.load_cpg(path, device="cpu"), ref)


def test_port_save_reference_load_round_trip(case, tmp_path):
    _, _, ref = case
    path = str(tmp_path / "pack.npz")
    cpg.save_cpg(port_pack(ref), path)
    back = ref_cpg.load_cpg(path)
    assert_pack_equal(port_pack(back), ref)


def test_load_upgrades_legacy_pack_like_reference(tmp_path):
    """A pack saved before run_ids / pair_mask existed loads to the same
    arrays in both packages (masks recovered from l1/l2)."""
    build, sub = PACK_CASES["ba40000_sub512"]
    ref = ref_cpg.pack_cpg(build(), sub=sub)
    path = str(tmp_path / "full.npz")
    ref_cpg.save_cpg(ref, path)
    z = dict(np.load(path))
    for i in range(len(ref.levels)):
        del z[f"lv{i}_run_ids"], z[f"lv{i}_pair_mask"]
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, **z)
    assert_pack_equal(cpg.load_cpg(legacy, device="cpu"),
                      ref_cpg.load_cpg(legacy))


def test_slab_layout_not_ported():
    """The slab layout, once refused here, now packs to the reference's
    arrays (tests/test_torch_slab.py holds it on larger graphs); an
    unknown layout is refused."""
    build, _ = PACK_CASES["ba2000"]
    g = build()
    port = cpg.pack_cpg(to_port_graph(g), layout="slab", device="cpu")
    assert_pack_equal(port, ref_cpg.pack_cpg(g, layout="slab"))
    with pytest.raises(ValueError, match="layout"):
        cpg.pack_cpg(to_port_graph(g), layout="diagonal", device="cpu")


def test_permute_round_trip():
    build, _ = PACK_CASES["ba2000"]
    port = cpg.pack_cpg(to_port_graph(build()), device="cpu")
    x = np.random.default_rng(1).standard_normal(port.n)
    xp = port.permute_in(x, np.float64)
    assert xp.shape == (port.n_pad,)
    np.testing.assert_array_equal(port.permute_out(torch.from_numpy(xp)), x)
    # lane 127 of every sublane is the structural zero
    assert not xp.reshape(-1, cpg.LANE)[:, -1].any()
