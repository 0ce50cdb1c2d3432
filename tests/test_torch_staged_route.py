"""The route between kernel 1's two classic walks (``spmv_cpg.staged_walk``)
and the staged walk's launch counter, on the CPU: the route is a pure
function of what the wrapper sees (layout, sub, the l2 type, a halo, the
level's padded tile count and its per-chunk tile counts, the index
buffers' alignment, the value type), and
``launches_staged`` is a counter ``obs`` reads, 0 on a CPU query."""

import numpy as np
import pytest
import torch

from tpu_lanczos_torch import expm_action_summary, generators, obs
from tpu_lanczos_torch.kernels import cpg, spmv_cpg

LANE = cpg.LANE


def _level(t_pad: int, sub: int, l2_dtype=torch.uint8, offset: int = 0,
           tiles: int = 5856, heaviest: int = 436, n_chunks: int = 32,
           holding: int | None = None):
    """A level of ``t_pad`` padded tiles at ``sub`` whose ``tiles`` real
    tiles lie in ``holding`` (default all ``n_chunks``) of its dest
    chunks, the first holding ``heaviest`` and the rest shared out
    (bn1M's main level by default); its index arrays are views of one
    element each (the route reads their shapes, types and addresses,
    never their values); ``offset`` moves l1's address by that many
    bytes."""
    def view(dtype, *shape):
        return torch.empty(1 + offset, dtype=dtype)[offset:].expand(*shape)

    holding = n_chunks if holding is None else holding
    rest = (np.array_split(np.arange(tiles - heaviest), holding - 1)
            if holding > 1 else [])
    counts = torch.tensor([heaviest] + [len(r) for r in rest]
                          + [0] * (n_chunks - holding), dtype=torch.int32)
    assert int(counts.max()) == heaviest and int(counts.sum()) == tiles
    return dict(l1=view(torch.int8, t_pad * sub, LANE),
                l2=view(l2_dtype, t_pad * LANE, sub),
                s_ids=view(torch.int32, t_pad),
                starts=torch.cumsum(counts, 0, dtype=torch.int32) - counts,
                counts=counts)


F64 = dict(dtype=torch.float64)
# float32's line: the staged walk takes T >= _K32 * H + _T32 real tiles
_K32, _T32 = spmv_cpg.STAGED_LINE[torch.float32]

# name -> (level arguments, route arguments, the walk it takes): bn1M's
# main level at sub 256 (5,856 real tiles, 436 in the heaviest chunk),
# the smallest level the staged walk takes, at the least spread it takes,
# and one tile under it; in float32 the least level on the line that
# the spread does not stage, and one tile under it; a mesh's main level
# (8 tiles a chunk over 208 chunks); a main level at sub 128, a BA-800k
# m=4 pack's main level (2,581 tiles, 232 in the heaviest chunk: staged
# in float32, one-thread in float64), a small level (bn1M's broadcast
# and reduce levels: 256 padded tiles), a halo launch, an int16-l2 pack,
# a slab level, misaligned l1, l1 rows past int32, a value type the
# kernels do not take; Graph500 SCALE 21's main level (9,300 tiles over
# 43 of 96 chunks, 830 in the heaviest) and its reduce level (one
# chunk's 600 tiles); the swept levels nearest the route's bound on each
# side: BA-600k m=4 and m=10 (float32), BA-800k m=8 and BA-1.05M m=2
# (float64)
_ROUTES = {
    "bn_main_sub256": (dict(t_pad=5120, sub=256), {}, True),
    "bn_main_sub256_f64": (dict(t_pad=5120, sub=256), F64, True),
    "main_sub128": (dict(t_pad=1024, sub=128), {}, False),
    "least_staged": (dict(t_pad=spmv_cpg.STAGED_MIN_TILES, sub=256,
                          tiles=spmv_cpg.STAGED_MIN_SPREAD * 30,
                          heaviest=30), {}, True),
    "under_least_staged": (dict(t_pad=spmv_cpg.STAGED_MIN_TILES, sub=256,
                                tiles=spmv_cpg.STAGED_MIN_SPREAD * 30 - 1,
                                heaviest=30), {}, False),
    "least_on_the_line": (dict(t_pad=3072, sub=256, tiles=_K32 * 300 + _T32,
                               heaviest=300), {}, True),
    "under_the_line": (dict(t_pad=3072, sub=256,
                            tiles=_K32 * 300 + _T32 - 1, heaviest=300),
                       {}, False),
    "mesh_spread": (dict(t_pad=2048, sub=256, tiles=1664, heaviest=8,
                         n_chunks=256), {}, True),
    "heavy_chunk": (dict(t_pad=3072, sub=256, tiles=2581, heaviest=232),
                    {}, True),
    "heavy_chunk_f64": (dict(t_pad=3072, sub=256, tiles=2581,
                             heaviest=232), F64, False),
    "small_level": (dict(t_pad=256, sub=256), {}, False),
    "halo": (dict(t_pad=5120, sub=256),
             dict(halo=torch.zeros(256, LANE)), False),
    "int16_l2_sub512": (dict(t_pad=5120, sub=512, l2_dtype=torch.int16),
                        {}, False),
    "slab": (dict(t_pad=5120, sub=256), dict(slab=True), False),
    "misaligned_l1": (dict(t_pad=5120, sub=256, offset=1), {}, False),
    "rows_past_int32": (dict(t_pad=2**23 + 256, sub=256), {}, False),
    "float16": (dict(t_pad=5120, sub=256), dict(dtype=torch.float16),
                False),
    "g500_main": (dict(t_pad=12288, sub=256, tiles=9300, heaviest=830,
                       n_chunks=96, holding=43), {}, True),
    "g500_main_f64": (dict(t_pad=12288, sub=256, tiles=9300, heaviest=830,
                           n_chunks=96, holding=43), F64, True),
    "g500_reduce": (dict(t_pad=768, sub=256, tiles=600, heaviest=600,
                         n_chunks=96, holding=1), {}, False),
    "nearest_one_f32": (dict(t_pad=2048, sub=256, tiles=1679, heaviest=203,
                             n_chunks=24, holding=19), {}, False),
    "nearest_staged_f32": (dict(t_pad=3072, sub=256, tiles=2673,
                                heaviest=343, n_chunks=24, holding=19),
                           {}, True),
    "nearest_one_f64": (dict(t_pad=4096, sub=256, tiles=3636, heaviest=332,
                             n_chunks=32, holding=25), F64, False),
    "nearest_staged_f64": (dict(t_pad=3072, sub=256, tiles=2794,
                                heaviest=210, n_chunks=48, holding=33),
                           F64, True),
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
    the main level takes the staged walk in float32 and float64, its
    broadcast and reduce levels keep the one-thread walk; on BA-100k (8
    chunks, 403 tiles, 212 in the heaviest) or at sub 512 (int16 l2) no
    level does."""
    g = generators.barabasi_albert(1_050_000, 2, seed=3, use_native=True)
    cg = cpg.pack_cpg(g, sub=256, device="cpu")
    for kw in ({}, F64):
        assert [spmv_cpg.staged_walk(lv, cg.sub, **kw)
                for lv in cg.levels] == [i == cg.n_bcast
                                         for i in range(len(cg.levels))]
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


def test_route_sweep_records_every_level_call():
    """``eval/route_sweep.py``'s recorder on the CPU: one SpMV's level
    calls in order, each with its (level, shard) place and the shape the
    route reads, on a single-device pack and on a 2-shard pack; its SPEC
    parser refuses a malformed SPEC."""
    from tpu_lanczos_torch.dist.cpg_sharded import pack_cpg_sharded
    from tpu_lanczos_torch.dist.mesh import make_mesh
    from tpu_lanczos_torch.eval import route_sweep

    g = generators.barabasi_albert(3000, 4, seed=1)
    cg = cpg.pack_cpg(g, sub=256, device="cpu")
    x = torch.from_numpy(cg.permute_in(np.ones(g.n), np.float32))
    calls = route_sweep.recorded_calls(cg, x)
    assert [c[6] for c in calls] == [(i, None) for i in range(len(cg.levels))]
    for c, t_real in zip(calls, cg.t_reals):
        shape = route_sweep.level_shape(c[1])
        assert shape["tiles"] == t_real and shape["n_chunks"] == cg.n_chunks
        assert shape["t_pad"] == c[1]["s_ids"].shape[0]
    mesh = make_mesh(2, device="cpu")
    sg = pack_cpg_sharded(g, 2, mesh=mesh, sub=256)
    places = [c[6] for c in route_sweep.recorded_calls(sg, x, mesh)]
    assert {s for _, s in places} == {0, 1}
    assert places == sorted(places)
    for bad in ("ba:1:2", "rmat:10:1", "g500:a:1", "stencil"):
        with pytest.raises(ValueError, match="a SPEC is"):
            route_sweep.parse_spec(bad)
    assert route_sweep.parse_spec("g500:21:2") == ("g500", [21, 2])
