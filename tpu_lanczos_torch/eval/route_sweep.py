"""Time kernel 1's two classic walks on every level of CPG packs at sub
256, in turns, beside the walk ``spmv_cpg.staged_walk`` routes each to.

    python -m tpu_lanczos_torch.eval.route_sweep [--reps 5] [--rounds 4]
        [--shards S] SPEC [SPEC ...]

SPEC is ``ba:N:M:SEED`` (Barabasi-Albert, native generator),
``g500:SCALE:SEED`` (the Graph500 Kronecker graph, edgefactor 16) or
``stencil:SIDE`` (the 5-point SIDE x SIDE mesh).  Each graph is packed
at sub 256 on the card, or with ``--shards S`` split for S shards of the
card as the row-sharded path packs it (``pack_cpg_sharded``).  One SpMV
of a random vector, in float32 and in float64, runs through a recorder
that keeps every level call's source, base and halo.  Each call is run
by the one-thread walk (``cpg_level_kernel``) and, where the kernel takes
it (one source buffer), by the staged walk (``cpg_staged_level_kernel``),
each held against ``run_level_ref`` bit for bit, then timed by CUDA
events (median of ``--reps`` after a warm run) in turns: one-thread then
staged, then staged then one-thread, ``--rounds`` times, the median over
the rounds.  One JSON line per call: the level's padded tiles, real
tiles, heaviest chunk's tiles and its place, the chunks holding tiles,
and in float32 and float64 the walk the route gives it and both walks'
ms.  The
first line is the card's name and power limit.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from tpu_lanczos_torch.eval.cpg_variants import cuda_ms


def parse_spec(spec: str) -> tuple:
    """(kind, whole numbers) of a SPEC; raises on any other form."""
    kind, *nums = spec.split(":")
    if not ({"ba": 3, "g500": 2, "stencil": 1}.get(kind) == len(nums)
            and all(v.isdigit() for v in nums)):
        raise ValueError(f"a SPEC is ba:N:M:SEED, g500:SCALE:SEED or "
                         f"stencil:SIDE, got {spec!r}")
    return kind, [int(v) for v in nums]


def graph_of(spec: str):
    """The graph a SPEC names."""
    from tpu_lanczos_torch import generators

    kind, nums = parse_spec(spec)
    if kind == "ba":
        return generators.barabasi_albert(nums[0], nums[1], seed=nums[2],
                                          use_native=True)
    if kind == "g500":
        return generators.graph500(nums[0], seed=nums[1])
    return generators.stencil_2d(nums[0])


def level_shape(level: dict) -> dict:
    """What the route may read of a level: its padded tiles, real tiles,
    heaviest chunk's tiles (and that chunk's place) and the chunks
    holding tiles, of ``n_chunks``."""
    c = level["counts"].cpu().long()
    return dict(t_pad=int(level["s_ids"].shape[0]), tiles=int(c.sum()),
                heaviest=int(c.max()), heaviest_at=int(c.argmax()),
                chunks_with_tiles=int((c > 0).sum()), n_chunks=c.numel())


def recorded_calls(pack, x: torch.Tensor, mesh=None) -> list:
    """Every level call (x2d, level, n_chunks, sub, base, halo, place) one
    SpMV of ``x`` (permuted) makes on ``pack``, a single-device pack or,
    with ``mesh``, a sharded one; ``place`` is the (level index, shard)
    of the call's level (shard None on one device).  Each call runs
    ``run_level``."""
    from tpu_lanczos_torch.kernels import spmv_cpg

    if mesh is None:
        places = {id(lv): (li, None) for li, lv in enumerate(pack.levels)}
    else:
        places = {id(lv): (li, s) for li, per_shard in enumerate(pack.levels)
                  for s, lv in enumerate(per_shard)}
    calls = []

    def record(x2d, level, n_chunks, sub, base=None, slab=False,
               halo=None):
        calls.append((x2d, level, n_chunks, sub, base, halo,
                      places[id(level)]))
        return spmv_cpg.run_level(x2d, level, n_chunks, sub, base, slab,
                                  halo)

    if mesh is None:
        spmv_cpg._spmv(pack, x, record)
    else:
        from tpu_lanczos_torch.dist import cpg_sharded

        cpg_sharded._local_spmv(pack, mesh, cpg_sharded._as_shards(
            mesh, x, pack.n_loc), record)
    return calls


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def time_call(call, reps: int, rounds: int) -> dict:
    """Both walks' bit-equality with ``run_level_ref`` and their medians
    in turns on one recorded call; the staged walk's entries None where
    its kernel refuses the call."""
    from tpu_lanczos_torch.kernels import spmv_cpg

    x2d, level, n_chunks, sub, base, halo, _ = call

    def walk(staged):
        return lambda: spmv_cpg._run_level_cuda(
            x2d, level, n_chunks, sub, base, False, halo, staged)

    want = spmv_cpg.run_level_ref(x2d, level, n_chunks, sub, base,
                                  halo=halo)
    walks = {"one": walk(False)}
    if halo is None:
        try:
            walks["staged"] = walk(True)
            walks["staged"]()
        except RuntimeError:
            del walks["staged"]
    row = {f"equal_{k}": bool(torch.equal(_bits(fn()), _bits(want)))
           for k, fn in walks.items()}
    times = {k: [] for k in walks}
    for r in range(rounds):
        for k in (list(walks) if r % 2 == 0 else list(walks)[::-1]):
            times[k].append(cuda_ms(walks[k], reps))
    row.update({f"{k}_ms": float(np.median(v)) for k, v in times.items()})
    row.setdefault("staged_ms", None)
    return row


def sweep(spec: str, reps: int, rounds: int, shards: int = 0):
    """Yields one JSON-able row per level call of one SpMV of ``spec``'s
    pack (float32 and float64 together), after a row of the pack."""
    from tpu_lanczos_torch.kernels import spmv_cpg
    from tpu_lanczos_torch.kernels.cpg import pack_cpg

    g = graph_of(spec)
    t0 = time.time()
    mesh = None
    if shards:
        from tpu_lanczos_torch.dist.cpg_sharded import pack_cpg_sharded
        from tpu_lanczos_torch.dist.mesh import make_mesh

        mesh = make_mesh(devices=["cuda"] * shards)
        pack = pack_cpg_sharded(g, shards, mesh=mesh, sub=spmv_cpg.STAGED_SUB)
    else:
        pack = pack_cpg(g, sub=spmv_cpg.STAGED_SUB, device="cuda")
    torch.cuda.synchronize()
    yield {"graph": spec, "n": g.n, "nnz": int(g.nnz), "shards": shards,
           "pack_s": time.time() - t0}
    xr = np.random.default_rng(0).standard_normal(g.n)
    by_dtype = [recorded_calls(pack, torch.from_numpy(pack.permute_in(
        xr, dt)).cuda(), mesh) for dt in (np.float32, np.float64)]
    for i, (c32, c64) in enumerate(zip(*by_dtype)):
        _, level, _, sub, _, halo, (li, shard) = c32
        row = {"graph": spec, "call": i, "level": li, "shard": shard,
               "halo": halo is not None, **level_shape(level)}
        for call, sfx in ((c32, ""), (c64, "_f64")):
            row["route" + sfx] = ("staged" if spmv_cpg.staged_walk(
                level, sub, halo=halo, dtype=call[0].dtype) else "one")
            row.update({k + sfx: v for k, v in
                        time_call(call, reps, rounds).items()})
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("specs", nargs="+", metavar="SPEC")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--shards", type=int, default=0)
    args = ap.parse_args(argv)
    for spec in args.specs:
        parse_spec(spec)
    if not torch.cuda.is_available():
        raise SystemExit("route_sweep needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    ok = True
    for spec in args.specs:
        for row in sweep(spec, args.reps, args.rounds, args.shards):
            ok = ok and all(v for k, v in row.items()
                            if k.startswith("equal"))
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
