"""The row-sharded loops' step passes (``kernels/lanczos_step.py`` rows 5d
and 5cd, and their loops in ``dist/mesh.py`` and ``dist/lanczos_df.py``)
on the CPU, where the pass wrappers run their plain versions, against the
single-device step and the JAX package.

Bars and why:
- row 5d's three passes composed (the dot, the update with the last
  step's norm, the normalize), over four steps on one shard, equal
  ``lanczos_step_ref`` bit for bit: alpha, beta, q_{j+1} and the stored
  row, float32 and float64, with and without the mask (the passes are the
  step's own eager ops, split at the psums);
- row 5cd's passes composed equal ``lanczos_step_df_ref`` bit for bit,
  with and without the recombine fold into ``ans``;
- each shard's df dot is the plain pairwise tree on its slice: the pass's
  pair equals ``core.df64.df_dot`` on the slice exactly, its hi word
  equals the JAX package's ``df_dot(...)[0]``, and a numpy model of the
  dot kernel's reduction order on its element map (csrc/lanczos_step.cu
  ``df_geometry``: G = min(P / 2048, 4096) blocks, P / (G * 2048) rows)
  gives the plain tree's root bit for bit at every n_loc of the sharded
  packs below (1-5 shards, 3 and 5 not dividing the chunks) and at 2^18,
  3 * 2^16 and 2^21;
- ``lanczos_cpg_sharded`` (float64) on 1, 2, 3 and 4 CPU shards within
  1e-10 of the JAX package's alpha and beta over 12 steps (ROADMAP §3),
  ``lanczos_alphabeta_cpg_sharded`` equal to it bit for bit, and
  ``expm_action_df_sharded`` within 1e-12 of the JAX package's answer and
  alpha (tests/test_torch_dist_df64.py's bars);
- the mask-folded loops (the SpMV without its realmask multiply, the
  mask passed to the passes) equal the loops over the masked SpMV bit for
  bit: float32, float64 and df64, with reorthogonalization too;
- the slots: the reducing passes write each shard's partial into its
  slot of one buffer that the shards of a device share (gathering them
  runs nothing), and the consuming passes fold them in shard order, so
  1e16, 1.0 and -1e16 on three shards sum to 0.0 as ``Mesh.psum``'s left
  fold does; the df fold equals the JAX package's ``_df_allsum`` bit for
  bit at 3 and 5 shards; a two-step 3-shard loop on one norm buffer
  differs from the loop on fresh buffers every step (the hazard the
  parity buffers remove) and the loop as it runs equals the fresh one,
  float64 and df64;
- an all-zero shard gives exact zero partials, and the dispatch runs the
  plain versions on a CPU tensor with no launch counted and raises on a
  ``meta`` one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.core import df64 as ref_df
from tpu_lanczos.dist import cpg_sharded as ref_cs
from tpu_lanczos.dist import make_mesh as ref_make_mesh
from tpu_lanczos.dist import lanczos_df as ref_ldf
from tpu_lanczos.dist.lanczos_df import expm_action_df_sharded as ref_df_sh
from tpu_lanczos.dist.mesh import ROWS
from tpu_lanczos.graphs import generators
from tpu_lanczos_torch.core import df64 as df
from tpu_lanczos_torch.dist import cpg_sharded as cs
from tpu_lanczos_torch.dist import lanczos_df as ldf
from tpu_lanczos_torch.dist import mesh as dmesh
from tpu_lanczos_torch.dist.mesh import LocalSpmv, make_mesh
from tpu_lanczos_torch.kernels import lanczos_step as ls

from _torch_cases import to_port_graph
from test_torch_step_geometry import kernel_tree

F32 = np.float32
K = 12


@pytest.fixture(scope="module")
def graph():
    return generators.barabasi_albert(2000, 5, seed=2, use_native=False)


def _sym(n: int, seed: int) -> np.ndarray:
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / np.sqrt(n)


def _mask(n: int, seed: int) -> torch.Tensor:
    keep = np.random.default_rng(seed).random(n) < 0.8
    return torch.from_numpy(keep.astype(F32))


# ---- row 5d: the passes composed are the step


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row5d_passes_compose_to_the_step(dtype, masked, store):
    n, k = 300, 5
    a_mat = torch.from_numpy(_sym(n, 1)).to(dtype)
    mask = _mask(n, 2) if masked else None
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n)).to(
        dtype)
    q0 = x / torch.linalg.norm(x)
    runs = []
    for passes in (False, True):
        q, qp = q0.clone(), torch.zeros_like(q0)
        alpha, beta = torch.zeros(k, dtype=dtype), torch.zeros(k,
                                                                dtype=dtype)
        basis = torch.zeros((k, n), dtype=dtype) if store else None
        ss = None
        for j in range(k - 1):
            v = a_mat @ q
            row = basis[j + 1] if store else None
            if passes:
                a = ls.shard_step_dot(v, q, mask=mask)
                v, part = ls.shard_step_update(v, q, qp, a, ss, mask=mask,
                                               alpha=alpha, j=j)
                q_next = ls.shard_step_normalize(v, part, beta=beta, j=j,
                                                 store=row)
                ss = part
            else:
                q_next = ls.lanczos_step_ref(v, q, qp, alpha, beta, j,
                                             store=row, mask=mask)
            qp, q = q, q_next
        runs.append((alpha, beta, q) + ((basis,) if store else ()))
    for got, want in zip(*runs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row5d_sub_norm_is_the_reorthogonalized_norm(dtype):
    rng = np.random.default_rng(4)
    v, w = (torch.from_numpy(rng.standard_normal(257)).to(dtype)
            for _ in range(2))
    got, part = ls.shard_step_sub_norm(v, w)
    assert torch.equal(got, v - w)
    assert torch.equal(part, torch.dot(v - w, v - w).reshape(1))


# ---- row 5cd: the df passes composed are the df step


def _df_pair(a: np.ndarray):
    hi = a.astype(F32)
    return torch.from_numpy(hi), torch.from_numpy((a - hi).astype(F32))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_ans", [False, True])
def test_row5cd_passes_compose_to_the_df_step(with_ans, masked):
    n, k = 300, 5
    a_mat = _sym(n, 5)
    mask = _mask(n, 6) if masked else None
    x = np.random.default_rng(7).standard_normal(n)
    q0 = _df_pair(x / np.linalg.norm(x))
    coeff = _df_pair(np.linspace(0.5, 1.5, k))
    runs = []
    for passes in (False, True):
        q = q0
        qp = (torch.zeros(n), torch.zeros(n))
        ab = [torch.zeros(k) for _ in range(4)]
        ans = (3.0 * q0[0], 3.0 * q0[1]) if with_ans else None
        ss = None
        for j in range(k - 1):
            # a df "SpMV": the f64 product of the pair, split again
            v = _df_pair(a_mat @ df.df_to_f64(q))
            kw = dict(ans=ans, coeff=coeff if with_ans else None)
            if passes:
                a = ls.shard_df_dot(v, q, mask=mask)
                v, ss = ls.shard_df_update(v, q, qp, a, ss, mask=mask,
                                           alpha=ab[:2], j=j)
                q_next = ls.shard_df_normalize(v, ss, beta=ab[2:], j=j, **kw)
            else:
                q_next = ls.lanczos_step_df_ref(v, q, qp, ab[:2], ab[2:], j,
                                                mask=mask, **kw)
            qp, q = q, q_next
        runs.append((*ab, *q) + (tuple(ans) if with_ans else ()))
    for got, want in zip(*runs):
        assert torch.equal(got, want)


# ---- the per-shard df dot is the plain tree on the shard's slice


def dot_pass_plan(n: int) -> ls.DfPlan:
    """The dot pass's element map (csrc/lanczos_step.cu df_geometry): P
    the padded length (a power of 2, at least 2048), G = min(P / 2048,
    4096) blocks, P / (G * 2048) rows."""
    p = ls.DF_SPAN
    while p < n:
        p <<= 1
    g = min(p // ls.DF_SPAN, 4096)
    return ls.DfPlan(g, (p // (g * ls.DF_SPAN)).bit_length() - 1, 0)


def _slices(graph):
    """Every shard's n_loc of the sharded packs at 1-5 shards."""
    out = []
    for shards in (1, 2, 3, 4, 5):
        sg = cs.pack_cpg_sharded(to_port_graph(graph), shards,
                                 mesh=make_mesh(shards, device="cpu"),
                                 sub=128)
        out.append(sg)
    return out


def test_shard_df_dot_is_the_plain_tree_on_each_slice(graph):
    x = np.random.default_rng(8).standard_normal
    sizes = set()
    for sg in _slices(graph):
        mesh = make_mesh(sg.n_shards, device="cpu")
        xv = x(sg.n_pad)
        yv = x(sg.n_pad)
        mask = mesh.split(sg.permute_in(np.ones(sg.n), F32), sg.n_loc)
        xs = list(zip(*(mesh.split(t.numpy(), sg.n_loc)
                        for t in _df_pair(xv))))
        ys = list(zip(*(mesh.split(t.numpy(), sg.n_loc)
                        for t in _df_pair(yv))))
        for xp, yp, m in zip(xs, ys, mask):
            (got,) = ls.shard_df_dot(xp, yp, mask=m)
            xm = (xp[0] * m, xp[1] * m)
            assert torch.equal(got, torch.stack(df.df_dot(xm, yp)))
            want = ref_df.df_dot(tuple(jnp.asarray(t.numpy()) for t in xm),
                                 tuple(jnp.asarray(t.numpy()) for t in yp))
            assert got[0].numpy().tobytes() == np.asarray(
                want[0]).tobytes()
        sizes.add(sg.n_loc)
    assert len(sizes) >= 3
    for n in sorted(sizes) + [1 << 18, 3 << 16, 1 << 21]:
        rng = np.random.default_rng(n)
        xh, xl = _df_pair(rng.standard_normal(n))
        yh, yl = _df_pair(rng.standard_normal(n))
        p, _ = df.two_prod(xh, yh)
        root, _ = df._pair_tree(p, torch.zeros((), dtype=torch.float32))
        got, _ = kernel_tree(p.numpy(), dot_pass_plan(n))
        assert got.tobytes() == root.numpy().tobytes(), n


# ---- the sharded loops against the JAX package


def _ref_x(mesh, x):
    return jax.device_put(jnp.asarray(x), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(ROWS)))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_sharded_loops_match_reference(graph, n_shards):
    ref_mesh = ref_make_mesh(n_shards)
    ref = ref_cs.pack_cpg_sharded(graph, n_shards, mesh=ref_mesh)
    x = ref.permute_in(np.ones(graph.n), np.float64)
    want = ref_cs.lanczos_cpg_sharded(ref, _ref_x(ref_mesh, x), K, ref_mesh,
                                      interpret=True)
    mesh = make_mesh(n_shards, device="cpu")
    sg = cs.pack_cpg_sharded(to_port_graph(graph), n_shards, mesh=mesh)
    got = cs.lanczos_cpg_sharded(sg, x, K, mesh)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta),
                               rtol=1e-10, atol=1e-10)
    a, b, _ = cs.lanczos_alphabeta_cpg_sharded(sg, x, K, mesh)
    assert torch.equal(a, got.alpha) and torch.equal(b[:K - 1], got.beta)
    want_df = ref_df_sh(graph, k=K, mesh=ref_mesh)
    got_df = ldf.expm_action_df_sharded(to_port_graph(graph), k=K,
                                        mesh=mesh, sg=sg)
    rel = np.linalg.norm(got_df.ans - want_df.ans) / np.linalg.norm(
        want_df.ans)
    assert rel < 1e-12
    np.testing.assert_allclose(got_df.alpha, want_df.alpha, rtol=1e-12,
                               atol=1e-13)


# ---- the mask fold is exact


def _masked_spmv_loops(monkeypatch):
    """Every CPG loop over the SpMV with its realmask multiply and no mask
    passed to the passes."""
    monkeypatch.setattr(cs, "_local", lambda sg, mesh: LocalSpmv(
        lambda q: cs._local_spmv(sg, mesh, q, cs.run_level)))
    real = ldf._local_spmv_df
    monkeypatch.setattr(ldf, "_local_spmv_df",
                        lambda *a, masked=True: real(*a))
    for name in ("shard_df_dot", "shard_df_update"):
        fn = getattr(ls, name)
        monkeypatch.setattr(ls, name, lambda *a, fn=fn, mask=None, **kw:
                            fn(*a, **kw))


@pytest.mark.parametrize("n_shards", [2, 3])
def test_mask_folded_loops_equal_masked_spmv_loops(graph, n_shards,
                                                   monkeypatch):
    mesh = make_mesh(n_shards, device="cpu")
    sg = cs.pack_cpg_sharded(to_port_graph(graph), n_shards, mesh=mesh)
    x = sg.permute_in(np.random.default_rng(9).standard_normal(graph.n),
                      np.float64)
    xd = list(zip(*(mesh.split(t.numpy(), sg.n_loc) for t in _df_pair(x))))

    def run():
        out = []
        for dt in (np.float32, np.float64):
            st = cs.lanczos_cpg_sharded(sg, x.astype(dt), K, mesh)
            ro = cs.lanczos_cpg_sharded(sg, x.astype(dt), K, mesh,
                                        reorthogonalize=True)
            out += [st.alpha, st.beta, *st.q_basis, ro.alpha, ro.beta,
                    *cs.lanczos_alphabeta_cpg_sharded(sg, x.astype(dt), K,
                                                      mesh)]
        (ah, al), (bh, bl), (xh, xl) = ldf.lanczos_alphabeta_df_sharded(
            sg, mesh, xd, K)
        ans = ldf.lanczos_recombine_df_sharded(sg, mesh, xd, ah, bl, K)
        return out + [ah, al, bh, bl, xh, xl] + [t for p in ans for t in p]

    folded = run()
    _masked_spmv_loops(monkeypatch)
    for got, want in zip(run(), folded, strict=True):
        assert torch.equal(got, want)


# ---- the slots: shard order, the df fold, the norm-slot hazard


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slot_fold_keeps_shard_order(dtype):
    """Three shards whose partials are 1e16, 1.0 and -1e16: the dot
    passes write them into one shared buffer, the update folds them to
    (1e16 + 1) - 1e16 = 0.0 (the 1.0 lost, as Mesh.psum's left fold
    loses it; another order would give 1.0), and the normalize folds the
    norm slots the same way."""
    mesh = make_mesh(3, device="cpu")
    one = torch.ones(1, dtype=dtype)
    vals = [torch.tensor([x], dtype=dtype) for x in (1e16, 1.0, -1e16)]
    dots = mesh.slots(dtype)
    assert all(d is dots[0] for d in dots)
    for s, x in enumerate(vals):
        ls.shard_step_dot(x, one, slots=dots[s], shard=s)
    assert mesh.gather_slots(dots) is dots
    assert torch.equal(dots[0], torch.cat(vals))
    want = mesh.psum([x[0] for x in vals])[0]
    assert float(want) == 0.0
    alpha = torch.zeros(2, dtype=dtype)
    norms = mesh.slots(dtype)
    for s, x in enumerate(vals):
        v, _ = ls.shard_step_update(x.clone(), torch.zeros_like(x),
                                    torch.zeros_like(x), dots[s], None,
                                    alpha=alpha if s == 0 else None, j=1,
                                    slots=norms[s], shard=s)
    assert torch.equal(alpha[1], want)
    norms[0].copy_(torch.tensor([1e16, 1.0, -1e16], dtype=dtype))
    beta = torch.zeros(2, dtype=dtype)
    ls.shard_step_normalize(one.clone(), norms[0], beta=beta, j=1)
    assert float(beta[1]) == 0.0


@pytest.mark.parametrize("n_shards", [3, 5])
def test_df_slot_fold_equals_reference_allsum(n_shards):
    """The df fold of an (n_shards, 2) slot buffer (the consuming passes'
    plain fold, and through the update and normalize passes) equals the
    JAX package's ``_df_allsum`` over the same pairs in shard_map, bit
    for bit, on pairs with cancellation between shards."""
    rng = np.random.default_rng(20 + n_shards)
    x = rng.standard_normal(n_shards) * 10.0 ** rng.integers(-3, 9,
                                                              n_shards)
    x[-1] = -x[0] * (1 + 2.0 ** -30)
    hi, lo = _df_pair(x)
    slots = torch.stack([hi, lo], dim=1)

    def body(h, l_):
        return ref_ldf._df_allsum((h[0], l_[0]), n_shards)

    ref_mesh = ref_make_mesh(n_shards)
    spec = jax.sharding.PartitionSpec(ROWS)
    want = jax.shard_map(body, mesh=ref_mesh, in_specs=(spec, spec),
                         out_specs=(jax.sharding.PartitionSpec(),) * 2,
                         check_vma=False)(jnp.asarray(hi.numpy()),
                                          jnp.asarray(lo.numpy()))
    got = ls.fold_df_slots_ref(slots)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    # the update's alpha is the fold; the normalize's beta its df_sqrt
    z = torch.zeros(4)
    ab = [torch.zeros(2) for _ in range(4)]
    ls.shard_df_update((z.clone(), z.clone()), (z, z), (z, z), slots, None,
                       alpha=ab[:2], j=1)
    assert torch.equal(ab[0][1], got[0]) and torch.equal(ab[1][1], got[1])
    pos = torch.stack([hi.abs(), lo * hi.sign()], dim=1)
    ls.shard_df_normalize((z.clone(), z.clone()), pos, beta=ab[2:], j=1)
    b = df.df_sqrt(ls.fold_df_slots_ref(pos))
    assert torch.equal(ab[2][1], b[0]) and torch.equal(ab[3][1], b[1])


class _FreshNorms:
    """Norm slots never reused: a new buffer every step, so no step can
    overwrite a slot that another shard has still to read."""

    def __init__(self, mesh, dtype, width):
        self.args = (mesh, dtype, width)

    def __getitem__(self, parity):
        mesh, dtype, width = self.args
        return mesh.slots(dtype, width)


def _norm_buffers(monkeypatch, mod, kind: str):
    """The loops' StepBuffers with the norm slots ``kind``: "fresh" (a new
    buffer each step) or "single" (one buffer for both parities)."""
    real = dmesh.step_buffers

    def patched(mesh, dtype, width=()):
        bufs = real(mesh, dtype, width)
        norm = (_FreshNorms(mesh, dtype, width) if kind == "fresh"
                else (bufs.norm[0], bufs.norm[0]))
        return dmesh.StepBuffers(bufs.work, bufs.dot, norm)

    monkeypatch.setattr(mod, "step_buffers", patched)


@pytest.mark.parametrize("kind", ["float64", "df64"])
def test_norm_slots_by_parity(kind, monkeypatch):
    """A two-step loop on 3 shards of a dense symmetric operator: step
    1's update of shard 0 writes its norm slot before shard 1's reads the
    step-0 norms as b_prev.  One norm buffer for both steps gives other
    bits (beta[1], q_2) than fresh buffers each step; the parity buffers
    give the fresh buffers' bits."""
    mesh = make_mesh(3, device="cpu")
    n_loc, k = 40, 2
    a_mat = _sym(3 * n_loc, 12)
    rows = [slice(s * n_loc, (s + 1) * n_loc) for s in range(3)]
    x = np.random.default_rng(13).standard_normal(3 * n_loc)
    if kind == "float64":
        blocks = [torch.from_numpy(a_mat[r]) for r in rows]
        spmv = LocalSpmv(lambda q: [b @ torch.cat(q) for b in blocks])
        xs = mesh.split(x, n_loc)

        def run():
            alpha, beta, q_basis, _ = dmesh.sharded_lanczos_body(
                mesh, spmv, xs, k)
            return [alpha, beta, *q_basis]
        mod = dmesh
    else:
        # a df "SpMV": the f64 product of the pairs, split again
        monkeypatch.setattr(ldf, "_local_spmv_df", lambda sg, mesh, q, *a,
                            masked=True: [_df_pair(a_mat[r] @ np.concatenate(
                                [df.df_to_f64(p) for p in q])) for r in rows])
        sg = type("Shards", (), {"realmask": [torch.ones(n_loc)] * 3})
        xd = list(zip(*(mesh.split(t.numpy(), n_loc) for t in _df_pair(x))))

        def run():
            (ah, al), (bh, bl), _ = ldf.lanczos_alphabeta_df_sharded(
                sg, mesh, xd, k)
            return [ah, al, bh, bl]
        mod = ldf
    got = run()
    with monkeypatch.context() as m:
        _norm_buffers(m, mod, "fresh")
        fresh = run()
    with monkeypatch.context() as m:
        _norm_buffers(m, mod, "single")
        single = run()
    assert all(torch.equal(g, f) for g, f in zip(got, fresh, strict=True))
    assert not all(torch.equal(s_, f) for s_, f in zip(single, fresh))


# ---- zeros and the dispatch


def test_zero_shard_partials_and_dispatch():
    z = torch.zeros(4096)
    zp = (z, z.clone())
    before = (ls.launches_step_sharded, ls.launches_step_df_sharded)
    assert torch.equal(ls.shard_step_dot(z, z), torch.zeros(1))
    v, part = ls.shard_step_update(z.clone(), z, z, torch.zeros(1), None)
    assert torch.equal(part, torch.zeros(1)) and not v.any()
    assert torch.equal(ls.shard_df_dot(zp, zp), torch.zeros(1, 2))
    v, part = ls.shard_df_update((z.clone(), z.clone()), zp, zp,
                                 torch.zeros(1, 2), None)
    assert torch.equal(part, torch.zeros(1, 2))
    q = ls.shard_df_normalize(v, part)
    assert not q[0].any() and not q[1].any()
    assert (ls.launches_step_sharded, ls.launches_step_df_sharded) == before
    m = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="device meta"):
        ls.shard_step_dot(m, m)
    with pytest.raises(ValueError, match="device meta"):
        ls.shard_df_dot((m, m), (m, m))
