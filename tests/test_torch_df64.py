"""The port's df64 pipeline against the JAX package's, on the CPU: the
double-word primitives, the compensated CPG level (the plain version the
CUDA kernel is held to on the card), the df SpMV, the df64 recurrence,
the answers and the pass-1 checkpoint.  The JAX side runs as its own
tests run it (Pallas interpret mode), on the same packs (the reference's,
carried over with ``port_pack``) and the same numpy inputs.

Bars and why:
- primitives against numpy float64 at the reference's own bars
  (tests/test_df64.py:44-48): dot and norm of 50,000 elements below
  1e-13 relative, df_div(1, 3) and df_sqrt(2) below 1e-15;
- two_sum and two_prod bit-identical to the reference's: both are
  exact transformations made of the same IEEE float32 ops;
- df_mul, df_div, df_sqrt and df_dot within 1e-13 relative of the
  reference's (hi + lo in float64): XLA:CPU may contract a multiply
  into a following add where torch runs separate ops, and the dot's
  error terms are summed in another order (~n * 2^-48);
- run_level_comp_ref (acc, err) and spmv_cpg_df (hi, lo) bit-identical
  to the reference: the same adds per cell in tile order, and the same
  two-sum folds; the df SpMV also below 1e-13 against scipy in float64;
- df64 alpha/beta within 5e-11 relative of the reference's and of a
  numpy float64 recurrence over the first 15 steps (the reference's bar,
  tests/test_df64.py:63-86); the top Ritz value over k=30 within 1e-12;
- e^A.x below 1e-12 against the oracle (the reference measures 1.1e-13
  on ba2000, k=30 and 1.0e-14 on uniform 800, k=40), within 1e-12 of the
  reference's answer, and its log-scale shift within 1e-12 relative;
- expm_action_ks_df within 1e-13 of separate runs, diffs[kmax] == 0 and
  the diffs decreasing (tests/test_df64.py:110-128);
- the checkpoint: a resumed pass 1 equal bit for bit to a one-shot run;
  a changed x or k, or a corrupt file, starts fresh; snapshots read
  field for field across the two packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.core import checkpoint as ref_ckpt
from tpu_lanczos.core import df64 as ref_df
from tpu_lanczos.core import lanczos_df as ref_ldf
from tpu_lanczos.graphs import generators
from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos.kernels.spmv_cpg import _run_level
from tpu_lanczos.kernels.spmv_cpg import spmv_cpg_df as ref_spmv_cpg_df
from tpu_lanczos_torch.core import checkpoint, lanczos_df
from tpu_lanczos_torch.core import df64 as df
from tpu_lanczos_torch.core.tridiag import eigh_host
from tpu_lanczos_torch.eval import oracle
from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.cpg import LANE

from _torch_cases import PACK_CASES, port_pack, to_port_graph, untranspose


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair_ref(hi, lo):
    return jnp.asarray(hi), jnp.asarray(lo)


# ------------------------------------------------------------ primitives


def _random_pairs(n=50_000, seed=0):
    rng = np.random.default_rng(seed)
    a64 = rng.standard_normal(n)
    b64 = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)
    return ref_ldf.split_f64(a64), ref_ldf.split_f64(b64)


def test_primitives_against_numpy_f64():
    (ah, al), (bh, bl) = _random_pairs()
    x, y = (_t(ah), _t(al)), (_t(bh), _t(bl))
    av = ah.astype(np.float64) + al
    bv = bh.astype(np.float64) + bl
    d = df.df_to_f64(df.df_dot(x, y))
    assert abs(d - av @ bv) / abs(av @ bv) < 1e-13
    nrm = df.df_to_f64(df.df_norm(x))
    assert abs(nrm - np.linalg.norm(av)) / np.linalg.norm(av) < 1e-13
    assert abs(df.df_to_f64(df.df_div(df.df_from(1.0), df.df_from(3.0)))
               - 1 / 3) < 1e-15
    assert abs(df.df_to_f64(df.df_sqrt(df.df_from(2.0))) - np.sqrt(2)) < 1e-15


@pytest.mark.parametrize("name", ["two_sum", "two_prod"])
def test_error_free_transforms_bit_identical_to_reference(name):
    (ah, al), (bh, bl) = _random_pairs(seed=1)
    a = np.concatenate([ah, al, [0.0, -0.0, 1.0, -3.5]]).astype(np.float32)
    b = np.concatenate([bh, bl * 1e3, [0.0, 2.0, -0.0, 7.25]]).astype(
        np.float32)
    want = getattr(ref_df, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(df, name)(_t(a), _t(b))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["df_mul", "df_div", "df_sqrt", "df_dot"])
def test_df_ops_match_reference(name):
    (ah, al), (bh, bl) = _random_pairs(seed=2)
    if name == "df_sqrt":
        args = ((np.abs(ah), np.where(ah < 0, -al, al)),)
    else:
        args = ((ah, al), (bh, bl))
    want = df.df_to_f64(getattr(ref_df, name)(
        *[_pair_ref(*p) for p in args]))
    got = df.df_to_f64(getattr(df, name)(*[(_t(h), _t(l)) for h, l in args]))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


# ------------------------------------------------- compensated level, df SpMV


@pytest.fixture(scope="module", params=list(PACK_CASES))
def packs(request):
    build, sub = PACK_CASES[request.param]
    g = build()
    ref = ref_cpg.pack_cpg(g, sub=sub)
    return g, ref, port_pack(ref)


def test_run_level_comp_ref_bit_identical_to_pallas(packs):
    _, ref, port = packs
    rng = np.random.default_rng(0)
    for i, (lv_r, lv_p) in enumerate(zip(ref.levels, port.levels)):
        x2d = ref.permute_in(rng.standard_normal(ref.n),
                             np.float32).reshape(-1, LANE)
        acc_r, err_r = _run_level(
            jnp.asarray(x2d), lv_r, ref.n_chunks, ref.sub, True,
            compensated=True, t_real=ref.t_reals[i],
            sparse_dispatch=ref.mask_sparse[i])
        acc, err = spmv_cpg.run_level_comp_ref(_t(x2d), lv_p, port.n_chunks,
                                               port.sub)
        assert acc.shape == err.shape == x2d.shape
        np.testing.assert_array_equal(
            acc.numpy(), untranspose(np.asarray(acc_r), ref.n_chunks, ref.sub),
            err_msg=f"acc lv{i}")
        np.testing.assert_array_equal(
            err.numpy(), untranspose(np.asarray(err_r), ref.n_chunks, ref.sub),
            err_msg=f"err lv{i}")
        # the plain level's sum is the compensated level's acc
        assert torch.equal(acc, spmv_cpg.run_level_ref(
            _t(x2d), lv_p, port.n_chunks, port.sub))


def test_spmv_cpg_df_bit_identical_to_reference_and_scipy(packs):
    g, ref, port = packs
    x64 = np.random.default_rng(5).standard_normal(g.n)
    hi, lo = ref_ldf.split_f64(ref.permute_in(x64, np.float64))
    yh_r, yl_r = ref_spmv_cpg_df(ref, jnp.asarray(hi), jnp.asarray(lo),
                                 interpret=True)
    before = (spmv_cpg.launches, spmv_cpg.launches_comp)
    yh, yl = spmv_cpg.spmv_cpg_df(port, _t(hi), _t(lo))
    assert (spmv_cpg.launches, spmv_cpg.launches_comp) == before  # CPU
    np.testing.assert_array_equal(yh.numpy(), np.asarray(yh_r))
    np.testing.assert_array_equal(yl.numpy(), np.asarray(yl_r))
    h, l = spmv_cpg.spmv_cpg_df_ref(port, _t(hi), _t(lo))
    assert torch.equal(h, yh) and torch.equal(l, yl)
    y = port.permute_out(df.df_to_f64((yh, yl)))
    want = g.to_scipy() @ port.permute_out(hi.astype(np.float64) + lo)
    assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-13


# ------------------------------------------------------------- recurrence


def test_alphabeta_df_matches_reference_and_f64_recurrence():
    g = generators.uniform_random(2000, 8000, seed=1)
    ref = ref_cpg.pack_cpg(g)
    port = port_pack(ref)
    k = 15
    hi, lo = ref_ldf.split_f64(ref.permute_in(np.ones(g.n), np.float64))
    a_r, b_r, _ = ref_ldf.lanczos_alphabeta_df(
        ref, jnp.asarray(hi), jnp.asarray(lo), k, interpret=True)
    alpha, beta, x_norm = lanczos_df.lanczos_alphabeta_df(port, _t(hi),
                                                          _t(lo), k)
    a64, b64 = df.df_to_f64(alpha), df.df_to_f64(beta)
    ar64, br64 = df.df_to_f64(a_r), df.df_to_f64(b_r)
    assert abs(df.df_to_f64(x_norm) - np.sqrt(g.n)) < 1e-13 * np.sqrt(g.n)
    A = g.to_scipy()
    q = np.ones(g.n) / np.sqrt(g.n)
    qp = np.zeros_like(q)
    bprev = 0.0
    for j in range(k):
        v = A @ q
        aj = v @ q
        v = v - aj * q - bprev * qp
        bj = np.linalg.norm(v)
        qp, q, bprev = q, v / bj, bj
        for got, want in ((a64[j], aj), (b64[j], bj), (a64[j], ar64[j]),
                          (b64[j], br64[j])):
            assert abs(got - want) < 5e-11 * max(abs(want), 1), j


# ---------------------------------------------------------------- answers

ANSWER_CASES = {
    # BA n=2000 m=8 (a broadcast, a main and a reduce level), k=30,
    # log-scaled; oracle: the float64 Lanczos at the same k
    "ba2000": dict(build=PACK_CASES["ba2000"][0], k=30, log_scale=True),
    # uniform n=800, k=40 (converged); oracle: dense expm
    "uniform800": dict(build=lambda: generators.uniform_random(800, 2400,
                                                               seed=3),
                       k=40, log_scale=False),
}


@pytest.fixture(scope="module", params=list(ANSWER_CASES))
def answers(request):
    case = ANSWER_CASES[request.param]
    g = case["build"]()
    ref = ref_cpg.pack_cpg(g)
    port = port_pack(ref)
    k, ls = case["k"], case["log_scale"]
    got = lanczos_df.expm_action_df(to_port_graph(g), k=k, dg=port,
                                    log_scale=ls)
    want_ref = ref_ldf.expm_action_df(g, k=k, dg=ref, log_scale=ls)
    if request.param == "uniform800":
        oracle_ans = oracle.expm_action_dense(to_port_graph(g), np.ones(g.n))
    else:
        oracle_ans = oracle.expm_action(to_port_graph(g), np.ones(g.n), k)
    return request.param, g, port, got, want_ref, oracle_ans


def test_expm_action_df_matches_oracle_and_reference(answers):
    name, g, _, got, want_ref, oracle_ans = answers
    assert got.ans.dtype == np.float64 and got.ans.shape == (g.n,)
    assert got.alpha.dtype == np.float64 and got.beta.shape == (got.k - 1,)
    assert oracle.rel_error(got.full_ans(), oracle_ans) < 1e-12
    assert oracle.rel_error(got.full_ans(), want_ref.full_ans()) < 1e-12
    assert (got.log_scale is None) == (want_ref.log_scale is None)
    if got.log_scale is not None:
        np.testing.assert_allclose(got.log_scale, want_ref.log_scale,
                                   rtol=1e-12)
        assert oracle.rel_error(got.ans, want_ref.ans) < 1e-12


def test_df_top_ritz_value_matches_reference(answers):
    _, _, _, got, want_ref, _ = answers
    ritz = eigh_host(got.alpha, got.beta)[0][-1]
    ritz_ref = eigh_host(want_ref.alpha, want_ref.beta)[0][-1]
    np.testing.assert_allclose(ritz, ritz_ref, rtol=1e-12)


def test_expm_action_ks_df_matches_per_k_runs():
    g = to_port_graph(ANSWER_CASES["uniform800"]["build"]())
    port = port_pack(ref_cpg.pack_cpg(g))
    ks = [5, 15, 40]
    results, diffs = lanczos_df.expm_action_ks_df(g, ks, dg=port)
    assert sorted(results) == ks
    for k in ks:
        single = lanczos_df.expm_action_df(g, k=k, dg=port)
        assert oracle.rel_error(results[k].ans, single.ans) < 1e-13, k
        np.testing.assert_array_equal(results[k].alpha, single.alpha)
    assert diffs[40] == 0.0
    assert diffs[5] > diffs[15] > diffs[40]


# ------------------------------------------------------------- checkpoint

K_CK, CHUNK = 12, 5


@pytest.fixture(scope="module")
def ck_case():
    g = generators.uniform_random(800, 3200, seed=4)
    ref = ref_cpg.pack_cpg(g)
    port = port_pack(ref)
    x_hi = port.realmask.clone()
    return g, ref, port, x_hi, torch.zeros_like(x_hi)


def _one_shot(port, x_hi, x_lo, k):
    return lanczos_df.lanczos_alphabeta_df(port, x_hi, x_lo, k)


def _assert_runs_equal(got, want):
    for g_pair, w_pair in zip(got, want):
        for g_t, w_t in zip(g_pair, w_pair):
            assert torch.equal(g_t, w_t)


class _Preempted(Exception):
    pass


def _count_ranges(monkeypatch, fail_after=None):
    """Record each pass-1 chunk's j0; raise on chunk ``fail_after``."""
    calls = []
    real = lanczos_df.lanczos_alphabeta_df_range

    def counted(cg, carry, j0, j1):
        if fail_after is not None and len(calls) == fail_after:
            raise _Preempted
        calls.append(j0)
        return real(cg, carry, j0, j1)

    monkeypatch.setattr(lanczos_df, "lanczos_alphabeta_df_range", counted)
    return calls


def test_checkpoint_resume_bit_identical(ck_case, tmp_path, monkeypatch):
    _, _, port, x_hi, x_lo = ck_case
    p = str(tmp_path / "df.npz")
    want = _one_shot(port, x_hi, x_lo, K_CK)
    # preempted after two chunks: the snapshot holds j = 10
    _count_ranges(monkeypatch, fail_after=2)
    with pytest.raises(_Preempted):
        checkpoint.lanczos_alphabeta_df_checkpointed(
            port, x_hi, x_lo, K_CK, checkpoint_path=p, chunk=CHUNK)
    assert checkpoint.AlphaBetaDFCheckpoint.load(p).j_done == 2 * CHUNK
    monkeypatch.undo()
    calls = _count_ranges(monkeypatch)
    got = checkpoint.lanczos_alphabeta_df_checkpointed(
        port, x_hi, x_lo, K_CK, checkpoint_path=p, chunk=CHUNK)
    assert calls == [2 * CHUNK]  # resumed, not restarted
    _assert_runs_equal(got, want)
    assert checkpoint.AlphaBetaDFCheckpoint.load(p).j_done == K_CK


@pytest.mark.parametrize("change", ["x", "k", "corrupt"])
def test_checkpoint_starts_fresh(ck_case, tmp_path, monkeypatch, change):
    g, ref, port, x_hi, x_lo = ck_case
    p = tmp_path / "df.npz"
    k = K_CK
    checkpoint.lanczos_alphabeta_df_checkpointed(
        port, x_hi, x_lo, K_CK, checkpoint_path=str(p), chunk=CHUNK)
    if change == "x":
        x2 = np.ones(g.n)
        x2[0] = 2.0
        hi, lo = ref_ldf.split_f64(port.permute_in(x2, np.float64))
        x_hi, x_lo = _t(hi), _t(lo)
    elif change == "k":
        k = K_CK - 2
    else:
        p.write_bytes(b"not a checkpoint")
    calls = _count_ranges(monkeypatch)
    got = checkpoint.lanczos_alphabeta_df_checkpointed(
        port, x_hi, x_lo, k, checkpoint_path=str(p), chunk=CHUNK)
    assert calls[0] == 0
    monkeypatch.undo()
    _assert_runs_equal(got, _one_shot(port, x_hi, x_lo, k))
    with pytest.raises(ValueError, match="chunk"):
        checkpoint.lanczos_alphabeta_df_checkpointed(
            port, x_hi, x_lo, k, checkpoint_path=str(p), chunk=0)


def test_snapshots_read_across_packages(ck_case, tmp_path):
    _, ref, port, x_hi, x_lo = ck_case
    p_ref, p_port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    xh = jnp.asarray(x_hi.numpy())
    ref_ckpt.lanczos_alphabeta_df_checkpointed(
        ref, xh, jnp.zeros_like(xh), K_CK, checkpoint_path=p_ref,
        chunk=CHUNK, interpret=True)
    checkpoint.lanczos_alphabeta_df_checkpointed(
        port, x_hi, x_lo, K_CK, checkpoint_path=p_port, chunk=CHUNK)
    for path in (p_ref, p_port):
        mine = checkpoint.AlphaBetaDFCheckpoint.load(path)
        theirs = ref_ckpt.AlphaBetaDFCheckpoint.load(path)
        for f in ("j_done", "k", "xnh", "xnl", "fingerprint"):
            assert getattr(mine, f) == getattr(theirs, f), f
        for f in checkpoint.AlphaBetaDFCheckpoint._FIELDS:
            np.testing.assert_array_equal(getattr(mine, f),
                                          getattr(theirs, f))
    # the same run has the same fingerprint in both packages, so either
    # resumes the other's snapshot; the runs agree at df64 grade (not bit
    # for bit: the dot's error terms are summed in another order)
    a, b = (checkpoint.AlphaBetaDFCheckpoint.load(p) for p in (p_port, p_ref))
    assert a.fingerprint == b.fingerprint
    np.testing.assert_allclose(df.df_to_f64((a.ah, a.al)),
                               df.df_to_f64((b.ah, b.al)), rtol=5e-11)


def test_expm_action_df_checkpointed_matches(ck_case, tmp_path):
    g, _, port, _, _ = ck_case
    plain = lanczos_df.expm_action_df(to_port_graph(g), k=K_CK, dg=port)
    ck = lanczos_df.expm_action_df(
        to_port_graph(g), k=K_CK, dg=port,
        checkpoint_path=str(tmp_path / "c.npz"), checkpoint_chunk=CHUNK)
    np.testing.assert_array_equal(ck.ans, plain.ans)
    np.testing.assert_array_equal(ck.alpha, plain.alpha)
    np.testing.assert_array_equal(ck.beta, plain.beta)
