"""One shard's local SpMV of a row-sharded mesh, alone, as one GPU of a
real mesh runs it after its collectives.

``alone_fn(spmv, sg, mesh, *vecs)`` runs ``spmv(sg, mesh, *vecs)`` once
on the whole in-process mesh, recording every all_gather's result in
call order, and returns ``fn(i)``: the same SpMV of held shard ``i`` on a
mesh that holds that shard alone (as a distributed rank holds it), each
all_gather answered by the recorded buffer of the same place, so the
exchanges' values are made beforehand and only the shard's own work
runs.  ``fn(i)`` returns what the whole mesh's SpMV returned for the
shard, bit for bit.

It uses only the sharded SpMV's public form (``spmv_cpg_sharded(sg,
mesh, x)``, ``spmv_cpg_df_sharded(sg, mesh, x_hi, x_lo)``), ``Mesh``'s
``n_shards``, ``shards``, ``devices``, ``group`` and ``all_gather``, and
the pack's per-shard ``levels``, ``realmask`` and ``shards``, so
eval/main_path_times.py loads it by path to time another checkout of
the port with it.
"""

from __future__ import annotations

import dataclasses


class _Recording:
    """A mesh whose all_gathers are recorded in call order."""

    def __init__(self, mesh):
        self._mesh = mesh
        self.gathered = []

    def __getattr__(self, name):
        return getattr(self._mesh, name)

    def all_gather(self, xs: list) -> list:
        out = self._mesh.all_gather(xs)
        self.gathered.append(out)
        return out


class _Replay:
    """Held shard ``i`` of ``mesh`` alone; its all_gathers return the
    recorded buffers at place ``i`` in turn, from the first again after
    the last."""

    def __init__(self, mesh, i: int, gathered: list):
        self.n_shards = mesh.n_shards
        self.shards = (mesh.shards[i],)
        self.devices = (mesh.devices[i],)
        self.group = None
        self._bufs = [g[i] for g in gathered]
        self._next = 0

    def all_gather(self, xs: list) -> list:
        buf = self._bufs[self._next % len(self._bufs)]
        self._next += 1
        return [buf]


def alone_fn(spmv, sg, mesh, *vecs):
    """``fn(i)``: held shard i's part of ``spmv(sg, mesh, *vecs)`` (each
    of ``vecs`` a per-shard list) with every exchange made beforehand.
    Every call of ``fn`` must run a whole SpMV."""
    rec = _Recording(mesh)
    spmv(sg, rec, *vecs)
    views = []
    for i in range(len(mesh.shards)):
        sgi = dataclasses.replace(
            sg, levels=tuple([lv[i]] for lv in sg.levels),
            realmask=(sg.realmask[i],), shards=(sg.shards[i],))
        views.append((sgi, _Replay(mesh, i, rec.gathered)))

    def fn(i: int):
        sgi, mi = views[i]
        return spmv(sgi, mi, *([v[i]] for v in vecs))[0]

    return fn
