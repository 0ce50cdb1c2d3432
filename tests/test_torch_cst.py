"""The CST format in the port against the JAX package: the packs (native
and numpy row splitting), the greedy slot colouring, one level and the
whole SpMV of the plain version against the Pallas kernels in interpret
mode, and the f64 pipeline against the oracle and the reference.

The graphs are tests/test_cst.py's.  The port's pack stores the
reference's int32 indices narrowed (idx1 int16 up to
``cst.IDX1_INT16_MAX_COLS`` columns, else int32; idx3 uint8), so packs
are compared by value.  Bars: exact equality for packs, levels and SpMVs (both add a level's slots in order from its starting
accumulator, and ghost cells add +0.0); the f64 answer within 1e-12 of
the oracle (the reference's CST bar) and 1e-10 of the reference's answer
(two correct f64 pipelines, docs/ACCURACY.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.core import pipeline as ref_pipeline
from tpu_lanczos.graphs import generators
from tpu_lanczos.graphs import native as ref_native
from tpu_lanczos.kernels import cst as ref_cst
from tpu_lanczos.kernels import spmv_pallas2
from tpu_lanczos_torch import Config, expm_action, expm_action_summary
from tpu_lanczos_torch import run_config
from tpu_lanczos_torch.eval import oracle
from tpu_lanczos_torch.graphs import native
from tpu_lanczos_torch.kernels import cst, spmv_cst
from tpu_lanczos_torch.kernels.spmv import spmv

from _torch_cases import star_graph, to_port_graph

GRAPHS = {
    "uniform": lambda: generators.uniform_random(2000, 8000, seed=1),
    "barabasi": lambda: generators.barabasi_albert(2000, 8, seed=2,
                                                   use_native=False),
    "stencil": lambda: generators.stencil_2d(40),
    "tiny": lambda: generators.uniform_random(50, 100, seed=0),
    "star": star_graph,  # deep row splitting: reduce levels
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def case(request):
    g = GRAPHS[request.param]()
    ref = ref_cst.pack_cst(g)
    return g, ref, port_pack(ref)


def port_pack(ref):
    """The reference CSTGraph's arrays as the port's CSTGraph."""
    meta = dict(n=ref.n, n_cols=ref.n_cols, nnz=ref.nnz, theta=ref.theta)
    return cst.from_numpy(meta, [np.asarray(a) for a in ref.idx1],
                          [np.asarray(a) for a in ref.idx3],
                          np.asarray(ref.realmask), ref.new_of_old,
                          device="cpu")


def assert_pack_equal(port, ref):
    for k in ("n", "n_cols", "nnz", "theta", "n_pad", "total_slots"):
        assert getattr(port, k) == getattr(ref, k), k
    np.testing.assert_array_equal(port.new_of_old, ref.new_of_old)
    np.testing.assert_array_equal(port.realmask.numpy(),
                                  np.asarray(ref.realmask))
    assert len(port.idx1) == len(ref.idx1) == len(port.idx3)
    for i in range(len(ref.idx1)):
        for name in ("idx1", "idx3"):
            got = getattr(port, name)[i].numpy()
            want = np.asarray(getattr(ref, name)[i])
            assert want.dtype == np.int32, (i, name)
            assert got.dtype == narrowed_dtype(name, port.n_cols), (i, name)
            np.testing.assert_array_equal(got, want, err_msg=f"lv{i} {name}")


def narrowed_dtype(name, n_cols):
    if name == "idx3":
        return np.uint8
    return np.int16 if n_cols <= cst.IDX1_INT16_MAX_COLS else np.int32


@pytest.mark.parametrize("split", ["native", "numpy"])
def test_pack_equals_reference(case, split, monkeypatch):
    """pack_cst on the port's graph equals the reference's pack, with
    both packages' native gc_split_rows and with their numpy fallback."""
    g, ref, _ = case
    if split == "numpy":
        monkeypatch.setattr(ref_native, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
        ref = ref_cst.pack_cst(g)
    else:
        assert native.available(), native.build_error()
    port = cst.pack_cst(to_port_graph(g), device="cpu")
    assert_pack_equal(port, ref)
    assert port.fill == ref.fill


def test_greedy_slots_equal_reference():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 50, size=5000)
    b = rng.integers(0, 80, size=5000)
    np.testing.assert_array_equal(cst._greedy_slots(a, b),
                                  ref_cst._greedy_slots(a, b))


@jax.jit
def _ref_level(src, acc, idx1, idx3):
    """One level of the reference's spmv_cst (spmv_pallas2.py:67-74): its
    two Pallas kernels per slot under a scan, in interpret mode."""

    def body(acc, slot):
        i1, i3 = slot
        g = spmv_pallas2._stage(src, i1, True)
        return spmv_pallas2._deliver(g, i3, acc, True), None

    acc, _ = jax.lax.scan(body, acc, (idx1, idx3))
    return acc


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_levels_and_spmv_bit_identical_to_pallas(case, dtype):
    """Every level of run_level_cst_ref, fed the inputs spmv_cst gives it,
    equals the reference's scan of Pallas kernels on the same inputs; the
    whole spmv_cst equals the reference's spmv_cst(interpret=True)."""
    _, ref, port = case
    x = ref.permute_in(np.random.default_rng(1).standard_normal(ref.n),
                       dtype)
    src = torch.from_numpy(x).reshape(cst.CLASSES, port.n_cols)
    acc = None
    for i, (i1, i3) in enumerate(zip(port.idx1, port.idx3)):
        got = spmv_cst.run_level_cst_ref(src, acc, i1, i3)
        start = jnp.zeros(src.shape, dtype) if acc is None else acc.numpy()
        want = np.asarray(_ref_level(jnp.asarray(src.numpy()), start,
                                     ref.idx1[i], ref.idx3[i]))
        assert got.dtype == src.dtype
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"lv{i}")
        src = acc = got
    y_ref = np.asarray(spmv_pallas2.spmv_cst(ref, jnp.asarray(x),
                                             interpret=True))
    y = spmv_cst.spmv_cst(port, torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), y_ref)
    np.testing.assert_array_equal(spmv(port, torch.from_numpy(x)).numpy(),
                                  y_ref)


def test_run_level_cst_on_cpu_is_the_plain_version(case):
    _, _, port = case
    x = torch.from_numpy(port.permute_in(
        np.random.default_rng(2).standard_normal(port.n), np.float32))
    src = x.reshape(cst.CLASSES, port.n_cols)
    before = spmv_cst.launches_cst
    got = spmv_cst.run_level_cst(src, src, port.idx1[0], port.idx3[0])
    assert torch.equal(got, spmv_cst.run_level_cst_ref(
        src, src, port.idx1[0], port.idx3[0]))
    assert spmv_cst.launches_cst == before  # the CPU runs no kernel
    with pytest.raises(ValueError, match="no CST SpMV"):
        spmv_cst.run_level_cst(src.to("meta"), None, port.idx1[0],
                               port.idx3[0])


@pytest.mark.parametrize("bad", ["dtype", "shape", "idx_dtype", "slots"])
def test_kernel_wrapper_rejects_bad_inputs(case, bad):
    _, _, port = case
    src = torch.zeros((cst.CLASSES, port.n_cols), dtype=torch.float32)
    i1, i3 = port.idx1[0], port.idx3[0]
    if bad == "dtype":
        src = src.half()
    elif bad == "shape":
        src = src[:, :-1].contiguous()
    elif bad == "idx_dtype":
        i1 = i1.long()
    else:
        i3 = i3[:0]
    with pytest.raises((TypeError, ValueError)):
        spmv_cst._check(src, None, i1, i3)
    spmv_cst._check(torch.zeros((cst.CLASSES, port.n_cols)), None,
                    port.idx1[0], port.idx3[0])


def test_device_index_types_and_bytes(case):
    """idx3 is uint8 and idx1 int16 on every level (every pack here has
    far fewer than 32,767 columns); index_bytes counts 3 bytes a slot
    cell, 3/8 of the reference's int32 pair."""
    _, ref, port = case
    assert port.n_cols <= cst.IDX1_INT16_MAX_COLS
    assert all(a.dtype == torch.int16 for a in port.idx1)
    assert all(a.dtype == torch.uint8 for a in port.idx3)
    # idx3's rows start 16-byte aligned (TMA), padded where n_cols is not
    # a multiple of 16
    pitch = -(-port.n_cols // 16) * 16
    assert all(a.stride() == (cst.CLASSES * pitch, pitch, 1)
               for a in port.idx3)
    cells = sum(np.asarray(a).size for a in ref.idx1)
    assert port.index_bytes() == 3 * cells
    assert port.index_bytes() * 8 == 3 * sum(
        np.asarray(a).nbytes for a in list(ref.idx1) + list(ref.idx3))


def test_int32_idx1_above_the_column_limit(case, monkeypatch):
    """Past IDX1_INT16_MAX_COLS columns idx1 stays int32 (idx3 uint8):
    the same values, accepted by the kernel's check, and the plain level
    equal to the narrowed pack's."""
    _, ref, narrow = case
    monkeypatch.setattr(cst, "IDX1_INT16_MAX_COLS", ref.n_cols - 1)
    port = port_pack(ref)
    assert all(a.dtype == torch.int32 for a in port.idx1)
    assert all(a.dtype == torch.uint8 for a in port.idx3)
    for a, b in zip(port.idx1 + port.idx3, narrow.idx1 + narrow.idx3):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert port.index_bytes() == 5 * sum(a.numel() for a in port.idx1)
    x = torch.from_numpy(port.permute_in(
        np.random.default_rng(3).standard_normal(port.n), np.float64))
    src = x.reshape(cst.CLASSES, port.n_cols)
    spmv_cst._check(src, None, port.idx1[0], port.idx3[0])
    assert torch.equal(
        spmv_cst.run_level_cst_ref(src, None, port.idx1[0], port.idx3[0]),
        spmv_cst.run_level_cst_ref(src, None, narrow.idx1[0], narrow.idx3[0]))
    np.testing.assert_array_equal(spmv_cst.spmv_cst(port, x).numpy(),
                                  spmv_cst.spmv_cst(narrow, x).numpy())


@pytest.mark.parametrize("bad", ["idx1_high", "idx1_negative", "idx3_high",
                                 "idx3_negative"])
def test_from_numpy_checks_that_indices_fit(bad):
    """from_numpy refuses a pack whose idx1 is not a column below n_cols
    or whose idx3 is not a class in 0..127 (the narrowed types would
    wrap them)."""
    ref = ref_cst.pack_cst(GRAPHS["tiny"]())
    idx1 = [np.array(a) for a in ref.idx1]
    idx3 = [np.array(a) for a in ref.idx3]
    target, value = {"idx1_high": (idx1, ref.n_cols),
                     "idx1_negative": (idx1, -1),
                     "idx3_high": (idx3, cst.CLASSES),
                     "idx3_negative": (idx3, -1)}[bad]
    target[0][0, 0, 0] = value
    meta = dict(n=ref.n, n_cols=ref.n_cols, nnz=ref.nnz, theta=ref.theta)
    with pytest.raises(ValueError, match="outside"):
        cst.from_numpy(meta, idx1, idx3, np.asarray(ref.realmask),
                       ref.new_of_old, device="cpu")


@pytest.mark.parametrize("i1,i3,ok", [
    (torch.int16, torch.uint8, True), (torch.int32, torch.uint8, True),
    (torch.int64, torch.uint8, False), (torch.int8, torch.uint8, False),
    (torch.uint8, torch.uint8, False), (torch.int16, torch.int32, False),
    (torch.int16, torch.int8, False), (torch.int32, torch.int32, False)])
def test_check_accepts_exactly_the_kernel_index_types(i1, i3, ok):
    """The wrapper's check takes idx1 int16 or int32 and idx3 uint8, the
    types csrc/spmv_cst.cu is built for, and nothing else."""
    src = torch.zeros((cst.CLASSES, 16), dtype=torch.float32)
    idx1 = torch.zeros((2, cst.CLASSES, 16), dtype=i1)
    idx3 = torch.zeros((2, cst.CLASSES, 16), dtype=i3)
    if ok:
        spmv_cst._check(src, None, idx1, idx3)
    else:
        with pytest.raises(ValueError):
            spmv_cst._check(src, None, idx1, idx3)


@pytest.mark.parametrize("n_cols,padded,ok", [
    (16, False, True), (24, True, True), (24, False, False),
    (40, True, True), (40, False, False)])
def test_check_wants_idx3_rows_16_byte_aligned(n_cols, padded, ok):
    """idx3's rows must start 16 bytes apart (as from_numpy pads them);
    a contiguous idx3 of a width that is not a multiple of 16 is
    refused."""
    src = torch.zeros((cst.CLASSES, n_cols), dtype=torch.float32)
    idx1 = torch.zeros((2, cst.CLASSES, n_cols), dtype=torch.int16)
    idx3 = cst._padded_rows(np.zeros((2, cst.CLASSES, n_cols), np.uint8),
                            "cpu") if padded else torch.zeros(
        (2, cst.CLASSES, n_cols), dtype=torch.uint8)
    if ok:
        spmv_cst._check(src, None, idx1, idx3)
    else:
        with pytest.raises(ValueError, match="16 bytes"):
            spmv_cst._check(src, None, idx1, idx3)


def test_expm_action_f64_matches_oracle_and_reference():
    g = GRAPHS["barabasi"]()
    pg = to_port_graph(g)
    res = expm_action(pg, k=30, dtype="float64", fmt="cst", device="cpu")
    ref = ref_pipeline.expm_action(g, k=30, dtype="float64", fmt="cst",
                                   spmv_impl="interpret")
    want = oracle.expm_action(pg, np.ones(g.n), 30)
    assert oracle.rel_error(res.ans, want) < 1e-12
    assert oracle.rel_error(res.ans, np.asarray(ref.ans)) < 1e-10
    # a CST pack passed in serves the other entry points too
    cg = cst.pack_cst(pg, device="cpu")
    summ = expm_action_summary(pg, k=30, topk=10, dtype="float64", dg=cg,
                               device="cpu")
    assert set(summ.top_nodes) == set(np.argsort(want)[-10:])
    low = expm_action(pg, k=30, dtype="float64", dg=cg, low_mem=True,
                      device="cpu")
    assert oracle.rel_error(low.ans, want) < 1e-12
    cfg = Config(krylov_dim=30, dtype="float64", fmt="cst")
    assert oracle.rel_error(run_config(cfg, pg, device="cpu").ans,
                            want) < 1e-12


def test_expm_action_summary_refuses_fmt_cst_in_both():
    g = GRAPHS["tiny"]()
    with pytest.raises(ValueError, match="CST"):
        ref_pipeline.expm_action_summary(g, k=10, fmt="cst")
    with pytest.raises(ValueError, match="CST"):
        expm_action_summary(to_port_graph(g), k=10, fmt="cst", device="cpu")
