"""A dry run of every sharded path on a small graph.

    python -m tpu_lanczos_torch.dist.dryrun 4 --device cpu

The port of ``__graft_entry__.py::dryrun_multichip``: builds an
``n_devices`` row mesh and runs each sharded path once on tiny shapes,
asserting what the reference asserts: the ELL/COO sharded Lanczos with
the device multiply-out, the CPG kernel's sharded Lanczos (the own/cross
overlap split active on a mesh of more than one shard) and its Q-free
pass, the sharded Estrada index and subgraph centrality on the CPG pack,
and the sharded df64 pipeline.
"""

from __future__ import annotations

import argparse

import numpy as np


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    from tpu_lanczos_torch.core.stochastic import (
        estrada_index_sharded, subgraph_centrality_sharded)
    from tpu_lanczos_torch.dist import make_mesh, pack_sharded
    from tpu_lanczos_torch.dist.cpg_sharded import (
        lanczos_alphabeta_cpg_sharded, lanczos_cpg_sharded, pack_cpg_sharded)
    from tpu_lanczos_torch.dist.lanczos import (lanczos_sharded,
                                                multiply_out_sharded)
    from tpu_lanczos_torch.dist.lanczos_df import expm_action_df_sharded
    from tpu_lanczos_torch.graphs import generators

    mesh = make_mesh(n_devices, device=device)
    graph = generators.uniform_random(64 * n_devices, 128 * n_devices,
                                      seed=0)
    sg = pack_sharded(graph, n_devices, mesh=mesh)

    # the ELL/COO sharded step: all_gather halo + psum reductions, the
    # device eigensolve and the sharded multiply-out
    x = sg.permute_in(np.ones(graph.n), np.float32)
    state = lanczos_sharded(sg, x, 8, mesh)
    ans, _ = multiply_out_sharded(state, mesh, eig_impl="device")
    result = sg.permute_out(mesh.to_host(ans))
    assert result.shape == (graph.n,)
    assert np.all(np.isfinite(result))

    # the CPG kernel on every shard
    scg = pack_cpg_sharded(graph, n_devices, mesh=mesh)
    if n_devices > 1:
        # the own/cross-source overlap split must be active on a mesh
        assert scg.overlap and scg.n_main == 2
    x2 = scg.permute_in(np.ones(graph.n), np.float32)
    st2 = lanczos_cpg_sharded(scg, x2, 4, mesh)
    assert np.all(np.isfinite(st2.alpha.cpu().numpy()))

    # the Q-free CPG pass (the sharded estimators' probe)
    a2, b2, _ = lanczos_alphabeta_cpg_sharded(scg, x2, 4, mesh)
    assert np.all(np.isfinite(a2.cpu().numpy()))
    assert tuple(b2.shape) == (4,)  # full-length beta (residual slot)

    # the sharded estimators end to end on the CPG pack
    r = estrada_index_sharded(scg, k=4, probes=2, mesh=mesh, deflate=2,
                              dtype="float32")
    assert np.isfinite(r.log_estimate)
    dr = subgraph_centrality_sharded(scg, k=4, probes=2, mesh=mesh,
                                     deflate=2, dtype="float32")
    assert np.all(np.isfinite(dr.diag_scaled))

    # the sharded df64 pipeline (exact df folds)
    res_df = expm_action_df_sharded(graph, k=6, mesh=mesh, sg=scg)
    assert res_df.ans.shape == (graph.n,)
    assert np.all(np.isfinite(res_df.ans))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    print(f"dryrun_multichip({args.n_devices}, device={args.device!r}): ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
