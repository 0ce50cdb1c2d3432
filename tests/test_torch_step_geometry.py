"""The one-launch Lanczos step's plans and its folded realmask multiply
(``kernels/lanczos_step.py``), on the CPU, against the JAX package.

Bars and why:
- row 5c's reduction order: a numpy model of the kernel's steps (rows
  pushed in bit-reversed order into a binary counter, the thread levels
  t with t + 128 ... 1, the fold of the 8*G block partials, index i with
  i + 4G first) on the element map ``df_geometry`` returns gives a
  root bit-identical to ``core.df64._pair_tree``'s (the plain tree's hi
  sum), at n = 1, 7, 2047, 2048, 2049, 2^16 + 3 and 2^22 + 5 and every G
  the function returns for them (1 to 512); finished with its error
  sum, its hi equals the JAX package's ``df_dot(...)[0]`` on the same
  seeded inputs (the error sums differ in order only at second order);
- ``step_plan`` and ``df_geometry`` on made-up occupancies: every grid
  co-resident, G a power of 2, the tiers in order, the held chunks
  covering n whenever the chip can hold it;
- the mask fold is exact: ``lanczos`` and ``lanczos_alphabeta`` (f32,
  f64) and ``lanczos_alphabeta_df`` with the mask passed to the step
  give alpha, beta and Q bit-identical to the loop over the masked SpMV,
  and f64 ``lanczos`` stays within 1e-10 of the JAX reference's alpha
  and beta over 15 steps (tests/test_torch_pipeline.py's bar).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.core import df64 as ref_df
from tpu_lanczos.core.lanczos import lanczos as ref_lanczos
from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos_torch.core import df64 as df
from tpu_lanczos_torch.core import lanczos_df
from tpu_lanczos_torch.kernels import lanczos_step as ls
from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.spmv import spmv

from _torch_cases import PACK_CASES, port_pack

# the module (the package's ``lanczos`` is the function)
lz = importlib.import_module("tpu_lanczos_torch.core.lanczos")
F32 = np.float32


# ---- row 5c: a numpy model of the kernel's reduction order


def _two_sum(a, b):
    s = a + b
    z = s - a
    return s, (a - (s - z)) + (b - z)


def _bitrev(m: int, bits: int) -> int:
    return int(format(m, f"0{bits}b")[::-1], 2) if bits else 0


def _counter(vals, bits: int, err: list):
    """Values pushed in bit-reversed order into a binary counter of
    partial nodes (csrc/lanczos_step.cu push_smem, TreeStack): the
    root."""
    nodes = {}
    x = None
    for m in range(1 << bits):
        x = vals[_bitrev(m, bits)].copy()
        level = 0
        while level < bits and (m >> level) & 1:
            x, t = _two_sum(nodes.pop(level), x)
            err.append(t.sum(dtype=np.float64))
            level += 1
        if level < bits:
            nodes[level] = x
    return x


def _halve(x, count: int, err: list):
    """Index t with t + count/2, ..., 1 along the first axis."""
    while count > 1:
        count //= 2
        x, t = _two_sum(x[:count], x[count:2 * count])
        err.append(t.sum(dtype=np.float64))
    return x


def kernel_tree(p: np.ndarray, plan):
    """The kernel's two-sum tree over p (float32, n) for element i = row *
    (G * 2048) + (t * G + b) * 8 + r: its root and the sum of its error
    terms (in float64; the kernel's own order differs at second
    order)."""
    g, rows_log = plan.grid, plan.rows_log
    total = g * ls.DF_SPAN << rows_log
    full = np.zeros(total, F32)
    full[:p.shape[0]] = p
    err = []
    a = full.reshape(1 << rows_log, ls.THREADS, g, 8)  # [row, t, b, r]
    x = _counter(a, rows_log, err)  # rows, inside each thread
    x = _halve(x, ls.THREADS, err)[0]  # threads: smem then shuffles
    part = x.reshape(-1)  # block b's lane r at b * 8 + r
    root = _halve(part, part.shape[0], err)[0]  # the fold, in shared memory
    return F32(root), float(np.sum(err))


def _every_plan(n: int):
    """Every plan df_geometry returns for n, one per co-resident grid."""
    plans = {}
    for g in (1 << e for e in range(10)):
        plan = ls.df_geometry(n, lambda smem, g=g: g)
        plans[plan.grid] = plan
    return sorted(plans.values(), key=lambda p: p.grid)


@pytest.mark.parametrize("n", [1, 7, 2047, 2048, 2049, (1 << 16) + 3,
                               (1 << 22) + 5])
def test_df_kernel_tree_equals_plain_tree(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n)
    y = rng.standard_normal(n)
    xs = [(a.astype(F32), (a - a.astype(F32)).astype(F32)) for a in (x, y)]
    (xh, xl), (yh, yl) = [tuple(torch.from_numpy(t) for t in pair)
                          for pair in xs]
    p, e = df.two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    root, _ = df._pair_tree(p, torch.zeros((), dtype=torch.float32))
    hi_ref = np.asarray(ref_df.df_dot(
        tuple(jnp.asarray(t) for t in xs[0]),
        tuple(jnp.asarray(t) for t in xs[1]))[0])
    plans = _every_plan(n)
    if n > 1 << 20:
        # 2^22 + 5 pads to P = 2^23: the grids past 64 blocks
        plans = [pl for pl in plans if pl.grid >= 128]
        assert [pl.grid for pl in plans] == [128, 256, 512]
    else:
        assert [pl.grid for pl in plans] == [
            1 << i for i in range(len(plans))]
    for plan in plans:
        got, tree_err = kernel_tree(p.numpy(), plan)
        assert got.tobytes() == root.numpy().tobytes(), plan
        err = float(np.sum(e.numpy(), dtype=np.float64)) + tree_err
        hi = df.fast_two_sum(torch.tensor(got), torch.tensor(F32(err)))[0]
        assert hi.numpy().tobytes() == hi_ref.tobytes(), plan


# ---- the plans on made-up occupancies


def _occupancy(per_sm: int, sms: int = 132, smem_per_sm: int = 232448):
    """Row 5's co-resident blocks: a register limit of per_sm blocks an
    SM, and the shared memory an SM has."""
    def coresident(smem):
        return min(per_sm, smem_per_sm // (smem + 1024)) * sms
    return coresident


@pytest.mark.parametrize("value_bytes", [4, 8])
def test_step_plan_tiers(value_bytes):
    occ = _occupancy(3)
    vec = 16 // value_bytes
    seen = []
    for n in (1, 5, 4099, 1 << 20, (1 << 20) * 3, 1 << 23, 1 << 26):
        plan = ls.step_plan(n, value_bytes, occ)
        c, s = ls.REG_CHUNKS, plan.smem_chunks
        assert 1 <= plan.grid <= occ(s * ls.SMEM_CHUNK_BYTES)
        tier = plan.tier(n, value_bytes)
        chunks = n // vec
        if tier == "stream":
            # nothing holds more: the largest candidate, on its full grid
            assert plan.held_chunks() < chunks
            assert plan.grid == occ(s * ls.SMEM_CHUNK_BYTES)
        else:
            assert plan.held_chunks() >= chunks
            # no fewer blocks would do
            assert (plan.grid - 1) * ls.THREADS * (c + s) < max(chunks, 1)
        seen.append(("registers", "shared", "stream").index(tier))
    assert seen == sorted(seen) and set(seen) == {0, 1, 2}
    assert ls.step_plan(1 << 20, value_bytes, occ).grid <= 132 * 3


def test_df_geometry_is_coresident():
    for n in (1, 2049, 1 << 20, (1 << 23) + 1, (1 << 26) + 1):
        for per_sm in (1, 2, 4, 8):
            def occ(smem, per_sm=per_sm):
                return min(per_sm, 232448 // (smem + 9216)) * 132
            plan = ls.df_geometry(n, occ)
            p = max(1 << max(n - 1, 1).bit_length(), ls.DF_SPAN)
            assert plan.grid & (plan.grid - 1) == 0
            assert plan.grid * ls.DF_SPAN << plan.rows_log == p
            assert occ(plan.smem_bytes()) >= plan.grid
            # no larger power of 2 fits, with or without the held row
            bigger = plan.grid * 2
            if bigger * ls.DF_SPAN <= p and bigger <= ls.DF_MAX_GRID:
                rl = plan.rows_log - 1
                assert occ(rl * ls.DF_LEVEL_BYTES) < bigger
    # bn1M on 4 blocks an SM: 512 blocks, one row, held
    plan = ls.df_geometry(1 << 20, lambda smem: 4 * 132)
    assert (plan.grid, plan.rows_log, plan.hold) == (512, 0, 1)


# ---- the mask fold: bit for bit against the masked SpMV's loop


@pytest.fixture(scope="module")
def ba():
    build, _ = PACK_CASES["ba2000"]
    g = build()
    ref = ref_cpg.pack_cpg(g)
    return g, ref, port_pack(ref)


def _masked_spmv(dg, q):
    return spmv(dg, q), None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mask_fold_bit_identical(ba, monkeypatch, dtype):
    g, ref, port = ba
    xr = np.random.default_rng(3).standard_normal(g.n)
    x = torch.from_numpy(port.permute_in(xr, np.float64)).to(dtype)
    k = 15
    seen = []
    real_step = ls.lanczos_step_ref

    def spy(*a, **kw):
        seen.append(kw.get("mask") is not None)
        return real_step(*a, **kw)

    monkeypatch.setattr(ls, "lanczos_step_ref", spy)
    folded = lz.lanczos(port, x, k)
    ab_folded = lz.lanczos_alphabeta(port, x, k)
    assert seen == [True] * 2 * k
    monkeypatch.setattr(lz, "step_spmv", _masked_spmv)
    plain = lz.lanczos(port, x, k)
    ab_plain = lz.lanczos_alphabeta(port, x, k)
    assert seen[2 * k:] == [False] * 2 * k
    for a, b in ((folded.alpha, plain.alpha), (folded.beta, plain.beta),
                 (folded.q_basis, plain.q_basis), *zip(ab_folded, ab_plain)):
        assert torch.equal(a, b)
    if dtype == torch.float64:
        st_ref = ref_lanczos(ref, jnp.asarray(ref.permute_in(xr, np.float64)),
                             k, spmv_impl="interpret")
        np.testing.assert_allclose(folded.alpha.numpy(),
                                   np.asarray(st_ref.alpha), rtol=1e-10)
        np.testing.assert_allclose(folded.beta.numpy(),
                                   np.asarray(st_ref.beta), rtol=1e-10)


def test_mask_fold_bit_identical_df(ba):
    _, _, port = ba
    rng = np.random.default_rng(4)
    x = port.permute_in(rng.standard_normal(port.n), np.float64)
    hi, lo = (torch.from_numpy(t) for t in lanczos_df.split_f64(x))
    k = 12
    got = lanczos_df.lanczos_alphabeta_df(port, hi, lo, k)
    # the same loop over the masked df SpMV, no mask in the step
    q0h, q0l, xnh, xnl = lanczos_df._alphabeta_df_init(hi, lo)
    (qh, ql, ph, pl, ah, al, bh, bl) = lanczos_df._fresh_carry(q0h, q0l, k)
    for j in range(k):
        v = spmv_cpg.spmv_cpg_df(port, qh, ql)
        q_next = ls.lanczos_step_df(v, (qh, ql), (ph, pl), (ah, al),
                                    (bh, bl), j)
        (ph, pl), (qh, ql) = (qh, ql), q_next
    want = ((ah, al), (bh, bl), (xnh, xnl))
    for g_pair, w_pair in zip(got, want):
        for g_t, w_t in zip(g_pair, w_pair):
            assert torch.equal(g_t, w_t)
    # the unmasked SpMV times the mask is the masked SpMV, bit for bit
    yh, yl = spmv_cpg.spmv_cpg_df(port, hi, lo, masked=False)
    mh, ml = spmv_cpg.spmv_cpg_df(port, hi, lo)
    m = port.realmask
    assert torch.equal(yh * m, mh) and torch.equal(yl * m, ml)
    assert torch.equal(spmv_cpg.spmv_cpg(port, hi.double(), masked=False)
                       * m.double(), spmv_cpg.spmv_cpg(port, hi.double()))
