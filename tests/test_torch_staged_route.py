"""The route between kernel 1's two classic walks (``spmv_cpg.staged_walk``)
and the staged walk's launch counter, on the CPU: the route is a pure
function of what the wrapper sees (layout, sub, the l2 type, a halo, the
level's padded tile count and its per-chunk tile counts, the index
buffers' alignment), and
``launches_staged`` is a counter ``obs`` reads, 0 on a CPU query."""

import numpy as np
import pytest
import torch

from tpu_lanczos_torch import expm_action_summary, generators, obs
from tpu_lanczos_torch.kernels import cpg, spmv_cpg

LANE = cpg.LANE


def _level(t_pad: int, sub: int, l2_dtype=torch.uint8, offset: int = 0,
           tiles: int = 5856, heaviest: int = 436, n_chunks: int = 32):
    """A level of ``t_pad`` padded tiles at ``sub`` whose ``tiles`` real
    tiles lie in ``n_chunks`` dest chunks, the first holding ``heaviest``
    and the rest shared out (bn1M's main level by default); its index
    arrays are views of one element each (the route reads their shapes,
    types and addresses, never their values); ``offset`` moves l1's
    address by that many bytes."""
    def view(dtype, *shape):
        return torch.empty(1 + offset, dtype=dtype)[offset:].expand(*shape)

    rest = np.array_split(np.arange(tiles - heaviest), n_chunks - 1)
    counts = torch.tensor([heaviest] + [len(r) for r in rest],
                          dtype=torch.int32)
    assert int(counts.max()) == heaviest and int(counts.sum()) == tiles
    return dict(l1=view(torch.int8, t_pad * sub, LANE),
                l2=view(l2_dtype, t_pad * LANE, sub),
                s_ids=view(torch.int32, t_pad),
                starts=torch.cumsum(counts, 0, dtype=torch.int32) - counts,
                counts=counts)


# name -> (level arguments, route arguments, the walk it takes): bn1M's
# main level at sub 256 (5,856 real tiles, 436 in the heaviest chunk),
# the smallest level the staged walk takes, at the least spread it takes,
# a mesh's main level (8 tiles a chunk over 208 chunks); a main level at
# sub 128, a level whose heaviest chunk holds more than 1/12 of its tiles
# (a BA-800k m=4 pack's main level: 2,581 and 232), a small level (bn1M's
# broadcast and reduce levels: 256 padded tiles), a halo launch, an
# int16-l2 pack, a slab level, misaligned l1, l1 rows past int32
_ROUTES = {
    "bn_main_sub256": (dict(t_pad=5120, sub=256), {}, True),
    "main_sub128": (dict(t_pad=1024, sub=128), {}, False),
    "least_staged": (dict(t_pad=spmv_cpg.STAGED_MIN_TILES, sub=256,
                          tiles=spmv_cpg.STAGED_MIN_SPREAD * 30,
                          heaviest=30), {}, True),
    "mesh_spread": (dict(t_pad=2048, sub=256, tiles=1664, heaviest=8,
                         n_chunks=256), {}, True),
    "heavy_chunk": (dict(t_pad=3072, sub=256, tiles=2581, heaviest=232),
                    {}, False),
    "small_level": (dict(t_pad=256, sub=256), {}, False),
    "halo": (dict(t_pad=5120, sub=256),
             dict(halo=torch.zeros(256, LANE)), False),
    "int16_l2_sub512": (dict(t_pad=5120, sub=512, l2_dtype=torch.int16),
                        {}, False),
    "slab": (dict(t_pad=5120, sub=256), dict(slab=True), False),
    "misaligned_l1": (dict(t_pad=5120, sub=256, offset=1), {}, False),
    "rows_past_int32": (dict(t_pad=2**23 + 256, sub=256), {}, False),
}


@pytest.mark.parametrize("name", list(_ROUTES))
def test_staged_route_is_a_pure_function(name):
    kw, route_kw, want = _ROUTES[name]
    level = _level(**kw)
    sub = kw["sub"]
    got = [spmv_cpg.staged_walk(level, sub, **route_kw) for _ in range(2)]
    assert got == [want, want]
    # the same shapes in new buffers route the same way
    assert spmv_cpg.staged_walk(_level(**kw), sub, **route_kw) == want


def test_staged_route_on_a_power_law_pack():
    """A power-law pack at sub 256 whose main level spreads its tiles
    (BA n=1.05M, m=2: 2,794 tiles, 210 in the heaviest of 48 chunks):
    the main level takes the staged walk, its broadcast and reduce levels
    keep the current one; on BA-100k (8 chunks, 403 tiles, 212 in the
    heaviest) or at sub 512 (int16 l2) no level does."""
    g = generators.barabasi_albert(1_050_000, 2, seed=3, use_native=True)
    cg = cpg.pack_cpg(g, sub=256, device="cpu")
    assert [spmv_cpg.staged_walk(lv, cg.sub) for lv in cg.levels] == [
        i == cg.n_bcast for i in range(len(cg.levels))]
    assert cg.t_reals[cg.n_bcast] > 240
    small = cpg.pack_cpg(generators.barabasi_albert(100000, 10, seed=3),
                         sub=256, device="cpu")
    assert not any(spmv_cpg.staged_walk(lv, small.sub)
                   for lv in small.levels)
    wide = cpg.pack_cpg(generators.barabasi_albert(40000, 6, seed=3),
                        sub=512, device="cpu")
    assert not any(spmv_cpg.staged_walk(lv, wide.sub) for lv in wide.levels)


def test_launches_staged_is_read_by_obs_and_zero_on_the_cpu():
    names = dict(obs.LAUNCH_COUNTERS)["tpu_lanczos_torch.kernels.spmv_cpg"]
    assert "launches" in names and "launches_staged" in names
    g = generators.barabasi_albert(2000, 8, seed=2)
    dg = cpg.pack_cpg(g, sub=128, device="cpu")
    before = spmv_cpg.launches_staged
    with obs.recording() as rec:
        out = expm_action_summary(g, k=10, topk=5, dg=dg, device="cpu")
    (q,) = rec.take()
    assert spmv_cpg.launches_staged == before
    assert q.counts.get("launches_staged", 0) == 0
    assert np.all(np.isfinite(out.top_values))
