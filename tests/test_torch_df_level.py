"""The single-device df64 level (``run_level_df``, one launch a level on
the card) on the CPU: its plain version ``run_level_df_ref`` against the
reference's composition of each level written out here, the level loop
of ``spmv_cpg_df`` against ``spmv_cpg_df_ref`` and against the JAX
package's ``spmv_cpg_df(..., interpret=True)``, the loop's calls, and
the wrapper's refusals.

The packs: the star graph (tests/test_cpg.py's hub of degree 2,999) in
the classic layout at sub 128 and in the slab layout at sub 512 (four
source slabs a chunk), each with a broadcast level, the main level and
two reduce levels; BA n=2,000 (one reduce level).  The inputs, from a
numpy seed: random float64 vectors split into (hi, lo); a cancellation
vector, whose hub row sums hi values of +-1e8 to zero while lo keeps
0.5 a leaf (so |e| > |y| where the pair is finished), with -0.0 in hi
and lo and in every lane-127 slot; and a vector holding inf and NaN.

Bars: exact, in int views (so -0.0 != +0.0 and NaN payloads count).
The plain version is the reference's level: the same adds per cell in
tile order and the same two-sum folds, so nothing may round
differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.core import lanczos_df as ref_ldf
from tpu_lanczos.graphs import generators
from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos.kernels.spmv_cpg import spmv_cpg_df as ref_spmv_cpg_df
from tpu_lanczos_torch.core.df64 import two_sum
from tpu_lanczos_torch.kernels import spmv_cpg
from tpu_lanczos_torch.kernels.cpg import LANE

from _torch_cases import port_pack, star_graph

# name -> (graph factory, sub, layout)
DF_PACKS = {
    "star_classic": (star_graph, None, "classic"),
    "star_slab_sub512": (star_graph, 512, "slab"),
    "ba2000_classic": (lambda: generators.barabasi_albert(
        2000, 8, seed=2, use_native=False), None, "classic"),
}


@pytest.fixture(scope="module", params=list(DF_PACKS))
def packs(request):
    build, sub, layout = DF_PACKS[request.param]
    g = build()
    ref = ref_cpg.pack_cpg(g, sub=sub, layout=layout)
    return request.param, g, ref, port_pack(ref)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _same(got, want) -> bool:
    return all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


def _inputs(kind: str, g, port, seed: int = 7):
    """The (hi, lo) float32 pair of one input kind, permuted, flat."""
    rng = np.random.default_rng(seed)
    x64 = rng.standard_normal(g.n)
    if kind == "cancel":
        # the hub (node 0) sums its leaves: hi +-1e8 in pairs, cancelling
        # to 0, lo 0.5 on every other leaf
        x64[1:] = 1e8 * np.where(np.arange(1, g.n) % 2, 1.0, -1.0)
        x64[1::2] += 0.5
    hi, lo = ref_ldf.split_f64(port.permute_in(x64, np.float64))
    hi, lo = torch.from_numpy(hi), torch.from_numpy(lo)
    if kind == "cancel":
        hi2d, lo2d = hi.view(-1, LANE), lo.view(-1, LANE)
        hi2d[:, LANE - 1] = -0.0
        lo2d[:, LANE - 1] = -0.0
        lo[(lo == 0) & (torch.arange(lo.numel()) % 3 == 0)] = -0.0
        hi[(hi == 0) & (torch.arange(hi.numel()) % 5 == 0)] = -0.0
    elif kind == "nonfinite":
        real = torch.nonzero(port.realmask).flatten()
        hi[real[3]] = float("inf")
        lo[real[len(real) // 2]] = float("nan")
        hi[real[-2]] = -float("inf")
    return hi, lo


def _walk(x_hi, x_lo, level, C, sub, slab):
    """The reference composition's walks of one level: the compensated
    level on hi and the plain level on lo."""
    acc, err = spmv_cpg.run_level_comp_ref(x_hi, level, C, sub, slab)
    return acc, err, spmv_cpg.run_level_ref(x_lo, level, C, sub, slab=slab)


def _finished(y, e, mask):
    hi, lo = two_sum(y, e)
    return (hi, lo) if mask is None else (hi * mask, lo * mask)


@pytest.mark.parametrize("packs,kind", [
    (name, kind) for name in DF_PACKS
    for kind in ("random", "cancel", "nonfinite")
    if kind != "cancel" or name.startswith("star")], indirect=["packs"])
def test_level_df_ref_equals_the_composition_level_by_level(packs, kind):
    """Every level of one df SpMV through ``run_level_df_ref`` in its mode
    (broadcast, main, reduce; the main and reduce levels also finished,
    with and without the mask) equals the reference's composition of
    that level written out, fed the composition's inputs; the whole loop
    (masked and not) equals ``spmv_cpg_df_ref``'s composition."""
    _, g, _, port = packs
    C, sub, nb = port.n_chunks, port.sub, port.n_bcast
    slab = port.layout == "slab"
    mask = port.realmask.reshape(-1, LANE)
    hi, lo = _inputs(kind, g, port)
    x_hi, x_lo = hi.reshape(-1, LANE), lo.reshape(-1, LANE)
    for level in port.levels[:nb]:
        got = spmv_cpg.run_level_df_ref(x_hi, x_lo, level, C, sub, "bcast",
                                        slab=slab)
        x_hi = spmv_cpg.run_level_ref(x_hi, level, C, sub, base=x_hi,
                                      slab=slab)
        x_lo = spmv_cpg.run_level_ref(x_lo, level, C, sub, base=x_lo,
                                      slab=slab)
        assert _same(got, (x_hi, x_lo))
    above = False
    y = e = None
    for i, level in enumerate(port.levels[nb:], nb):
        mode = "main" if i == nb else "reduce"
        src = (x_hi, x_lo) if y is None else (y, e)
        acc, err, b = _walk(*src, level, C, sub, slab)
        if y is None:
            y, e = acc, err + b
        else:
            y, t = two_sum(y, acc)
            e = ((e + t) + err) + b
        got = spmv_cpg.run_level_df_ref(*src, level, C, sub, mode, slab=slab)
        assert _same(got, (y, e)), (i, mode)
        for m in (None, mask):
            got = spmv_cpg.run_level_df_ref(*src, level, C, sub, mode,
                                            finish=True, mask=m, slab=slab)
            assert _same(got, _finished(y, e, m)), (i, mode, m is None)
        above |= bool((e.abs() > y.abs()).any())
    if kind == "cancel":
        assert above  # a cell whose |e| exceeds |y| where it is finished
    want = spmv_cpg.spmv_cpg_df_ref(port, hi, lo)
    assert _same(spmv_cpg.spmv_cpg_df(port, hi, lo), want)
    assert _same(want, tuple(t.reshape(-1) for t in _finished(
        y, e, mask)))
    got = spmv_cpg.spmv_cpg_df(port, hi, lo, masked=False)
    assert _same(got, spmv_cpg._spmv_df(
        port, hi, lo, spmv_cpg.run_level_ref, spmv_cpg.run_level_comp_ref,
        masked=False))


@pytest.mark.parametrize("packs,kind", [
    (name, kind) for name in ("star_classic", "star_slab_sub512")
    for kind in ("random", "cancel")], indirect=["packs"])
def test_spmv_cpg_df_bit_identical_to_jax(packs, kind):
    """``spmv_cpg_df`` through the per-level loop equals the JAX
    package's ``spmv_cpg_df`` in Pallas interpret mode, bit for bit, and
    launches nothing on the CPU (tests/test_torch_df64.py and
    tests/test_torch_slab.py hold the other packs)."""
    _, g, ref, port = packs
    hi, lo = _inputs(kind, g, port, seed=11)
    want = ref_spmv_cpg_df(ref, jnp.asarray(hi.numpy()),
                           jnp.asarray(lo.numpy()), interpret=True)
    before = (spmv_cpg.launches_df, spmv_cpg.launches_df_slab,
              spmv_cpg.launches, spmv_cpg.launches_comp)
    got = spmv_cpg.spmv_cpg_df(port, hi, lo)
    assert (spmv_cpg.launches_df, spmv_cpg.launches_df_slab,
            spmv_cpg.launches, spmv_cpg.launches_comp) == before
    for g_t, w_t in zip(got, want):
        np.testing.assert_array_equal(g_t.numpy().view(np.int32),
                                      np.asarray(w_t).view(np.int32))


def test_level_loop_calls_one_level_function_a_level(packs):
    """The loop calls its level function once a level, in order: the
    broadcast levels, the main level, the reduce levels; only the last
    finishes, with the realmask only where masked, and every call gets
    the pack's layout and the previous call's outputs."""
    _, g, _, port = packs
    hi, lo = _inputs("random", g, port)
    for masked in (True, False):
        calls = []

        def spy(x_hi, x_lo, level, n_chunks, sub, **kw):
            out = spmv_cpg.run_level_df_ref(x_hi, x_lo, level, n_chunks,
                                            sub, **kw)
            calls.append((x_hi, level, kw, out))
            return out

        got = spmv_cpg._spmv_df_levels(port, hi, lo, spy, masked)
        L, nb = len(port.levels), port.n_bcast
        assert [c[2]["mode"] for c in calls] == (
            ["bcast"] * nb + ["main"] + ["reduce"] * (L - nb - 1))
        assert [c[1] for c in calls] == list(port.levels)
        assert [c[2]["finish"] for c in calls] == [False] * (L - 1) + [True]
        assert all(c[2]["slab"] == (port.layout == "slab") for c in calls)
        assert all(c[2]["mask"] is None for c in calls[:-1])
        assert (calls[-1][2]["mask"] is not None) == masked
        assert all(calls[i + 1][0] is calls[i][3][0] for i in range(L - 1))
        assert _same(got, tuple(t.reshape(-1) for t in calls[-1][3]))


def test_run_level_df_refuses_what_the_kernels_do_not_take(packs):
    """``_check_df`` (run before every CUDA launch) and the plain version
    refuse a mode the kernels do not know, a finished broadcast level, a
    source of another dtype, shape or device than the level's pair, a
    mask without the finish or of the wrong size or dtype; a tensor on
    another device than CPU or CUDA has no kernel."""
    _, g, _, port = packs
    C, sub, nb = port.n_chunks, port.sub, port.n_bcast
    slab = port.layout == "slab"
    level = port.levels[nb]
    hi, lo = (t.reshape(-1, LANE) for t in _inputs("random", g, port))
    mask = port.realmask
    spmv_cpg._check_df(hi, lo, level, C, sub, "reduce", True, mask, slab)
    bad = [
        ((hi, lo, level, C, sub, "scatter", False, None, slab), "broadcast"),
        ((hi, lo, level, C, sub, "bcast", True, None, slab), "broadcast"),
        ((hi.double(), lo, level, C, sub, "main", False, None, slab),
         "float32"),
        ((hi, lo.double(), level, C, sub, "main", False, None, slab),
         "float32"),
        ((hi[:-sub], lo[:-sub], level, C, sub, "main", False, None, slab),
         "float32"),
        ((hi, lo[:, :64], level, C, sub, "main", False, None, slab),
         "float32"),
        ((hi, lo.t(), level, C, sub, "main", False, None, slab), "float32"),
        ((hi, lo, level, C, sub, "main", False, mask, slab), "only where"),
        ((hi, lo, level, C, sub, "main", True, mask[:-1], slab), "mask"),
        ((hi, lo, level, C, sub, "main", True, mask.double(), slab), "mask"),
        ((hi, lo, dict(level, counts=level["counts"].long()), C, sub,
          "main", False, None, slab), "counts"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            spmv_cpg._check_df(*args)
    with pytest.raises(ValueError, match="broadcast"):
        spmv_cpg.run_level_df(hi, lo, level, C, sub, "bcast", finish=True,
                              slab=slab)
    meta = hi.to("meta")
    with pytest.raises(ValueError, match="no CPG SpMV"):
        spmv_cpg.run_level_df(meta, meta, level, C, sub, slab=slab)
