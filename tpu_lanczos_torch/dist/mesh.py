"""The row mesh of the sharded path, and the per-shard bodies that every
sharded backend runs.

The port of ``tpu_lanczos/dist/mesh.py``.  One logical axis, ``ROWS``:
the matrix rows are split into ``n_shards`` contiguous blocks, one a
shard.  The reference writes each sharded step once as an SPMD body
inside ``shard_map``, with a collective in the middle of every step: the
halo ``all_gather``, the compact reduce-level ``all_gather``, the
``psum`` of every dot and the df64 pair fold.

How a mesh maps onto PyTorch.  A :class:`Mesh` is that axis over
``n_shards`` shards, of which this process holds some, in one of two
kinds:

- in-process (no process group): every shard lives in this process, each
  on a ``torch.device`` of its own, and the list of devices may repeat
  one device: N CPU shards in the tests (where the reference's tests
  force 8 virtual CPU devices), ``[cuda:0] * 4`` on a machine with one
  GPU.  ``all_gather`` is the concatenation of the shards' buffers in
  shard order; ``psum`` sums the per-shard partials in one fixed left
  fold (shard 0 + shard 1 + ...), so every shard gets the same bits.
- distributed (``torch.distributed``): one shard per rank, after
  :func:`init_distributed` (as the reference's wraps
  ``jax.distributed.initialize``); ``make_mesh()`` then spans the world.
  ``all_gather`` is ``dist.all_gather`` and ``psum`` is
  ``dist.all_reduce``.  The backend is NCCL on CUDA and gloo on the CPU:
  gloo has no CUDA ``all_gather``, and NCCL puts no two ranks on one GPU.

Every per-shard body is written once, over the shards this process
holds: a "per-shard list" holds one tensor per held shard, in shard
order, and the mesh's collectives take and return such lists.  So the
in-process mesh and the distributed one run the same code and draw the
same per-shard probes.  A replicated value (alpha_j, a psum) comes back
as one tensor per held shard; shards on one device share one tensor.

The k-step loops are Python loops whose step after the SpMV runs on the
row 5d pass kernels (kernels/lanczos_step.py): a dot pass on every held
shard, an update pass, a normalize pass.  Each pass that reduces writes
the shard's partial into its slot of a small buffer (``Mesh.slots``), and
the pass that needs the sum folds every slot itself, in shard order, with
the psum's adds; ``Mesh.gather_slots`` delivers the slots to every
device, which on shards that share one device is nothing at all.  So no
op runs between a step's passes there.  The reference's one
``fori_loop`` fuses those ops around its psums (mesh.py:82-107,
:189-220); the split at the psums is the one the mesh needs.  On the CPU
the passes are the eager ops they replaced.  No step syncs the host: the
recurrence scalars stay on the device and breakdown is decided there
(dist/lanczos.py:14-17).
The reference's ``pcast``/``vma`` annotations have no counterpart: there
is no varying-axes checker to satisfy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from tpu_lanczos_torch.kernels import lanczos_step as ls

ROWS = "rows"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The row axis over ``n_shards`` shards.  ``shards`` are the shard
    indices this process holds (all of them in process, the rank's own
    one in a distributed mesh), ``devices`` the device of each, and
    ``group`` the process group of a distributed mesh (None in
    process)."""

    n_shards: int
    shards: tuple
    devices: tuple
    group: object = None

    def replicate(self, t: torch.Tensor) -> list:
        """One copy of ``t`` per held shard, on its device; shards on
        t's device share t itself."""
        return [t if d == t.device else t.to(d) for d in self.devices]

    def all_gather(self, xs: list) -> list:
        """Every shard's buffer concatenated in shard order, on every
        held shard (the reference's ``all_gather(..., tiled=True)``)."""
        if self.group is None:
            dev = xs[0].device
            return self.replicate(torch.cat([x.to(dev) for x in xs]))
        (x,) = xs
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.n_shards)]
        dist.all_gather(parts, x, group=self.group)
        return [torch.cat(parts)]

    def psum(self, xs: list) -> list:
        """The sum over shards of the per-shard partials, on every held
        shard: a left fold in shard order in process, ``all_reduce`` in
        a distributed mesh."""
        if self.group is None:
            acc = xs[0]
            for x in xs[1:]:
                acc = acc + x.to(acc.device)
            return self.replicate(acc)
        (x,) = xs
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return [out]

    def slots(self, dtype, width: tuple = ()) -> list:
        """The buffer the step passes write their partials into: one
        zeroed (n_shards, *width) buffer a held shard, shard s writing
        row s.  Shards on one device share one buffer."""
        by_dev: dict = {}
        for d in self.devices:
            if d not in by_dev:
                by_dev[d] = torch.zeros((self.n_shards, *width),
                                        dtype=dtype, device=d)
        return [by_dev[d] for d in self.devices]

    def gather_slots(self, bufs: list) -> list:
        """Every shard's slot in each held shard's buffer, for the pass
        that folds them: nothing when the held shards share one buffer
        (one device); in process over several devices, the slots gathered
        into the first device's buffer and copied once to each other
        device's; in a distributed mesh, the ranks' slots all-gathered
        in shard order into a new buffer."""
        if self.group is None:
            home = bufs[0]
            for s, b in zip(self.shards, bufs):
                if b is not home:
                    home[s].copy_(b[s])
            for b in {id(b): b for b in bufs if b is not home}.values():
                b.copy_(home)
            return bufs
        (b,) = bufs
        s = self.shards[0]
        return self.all_gather([b[s:s + 1]])

    def split(self, x, n_loc: int, dtype=None) -> list:
        """The held shards' slices of a full (n_shards * n_loc,) vector
        (a numpy array or a tensor), each on its shard's device.  Shards
        that share one device share one copy of x there (one host-to-device
        copy, not one a shard)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(x)
        if len(self.devices) > 1 and len(set(self.devices)) == 1:
            x = x.to(self.devices[0], dtype=dtype)
        return [x[s * n_loc:(s + 1) * n_loc].to(d, dtype=dtype).contiguous()
                for s, d in zip(self.shards, self.devices)]

    def to_host(self, xs: list):
        """The full (n_shards * n_loc,) vector of per-shard slices as a
        numpy array, on every process."""
        return self.all_gather(xs)[0].cpu().numpy()


def init_distributed(**kw) -> None:
    """Start the process group (``torch.distributed.init_process_group``
    with ``kw``: backend, init_method or store, world_size, rank) before
    any collective, as the reference's wraps ``jax.distributed.
    initialize``.  The backend defaults to NCCL when CUDA is available,
    else gloo.  After this, ``make_mesh()`` spans the world, one shard
    per rank, and the sharded code path is unchanged."""
    kw.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kw)


def make_mesh(n_devices: int | None = None, devices=None,
              device: str = "cuda") -> Mesh:
    """The 1-D row mesh.

    - ``devices`` given: an in-process mesh over them, repeats allowed
      (the first ``n_devices`` of them when that is given).
    - In a process group (after :func:`init_distributed`): a distributed
      mesh over the world, this rank's shard on ``cuda:rank % count`` or
      the CPU, by ``device``.
    - Else on ``"cuda"``: ``n_devices`` visible GPUs (default: all of
      them); short of them, the reference's ``ValueError("need N
      devices, have M")``.  On ``"cpu"``: ``n_devices`` CPU shards
      (default 1)."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"need {n_devices} devices, have {len(devices)}")
            devices = devices[:n_devices]
        return Mesh(n_shards=len(devices), shards=tuple(range(len(devices))),
                    devices=tuple(devices))
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"need {n_devices} devices, have {world}")
        dev = (torch.device("cuda", rank % torch.cuda.device_count())
               if device == "cuda" else torch.device("cpu"))
        return Mesh(n_shards=world, shards=(rank,), devices=(dev,),
                    group=dist.group.WORLD)
    if device == "cpu":
        n = 1 if n_devices is None else n_devices
        return Mesh(n_shards=n, shards=tuple(range(n)),
                    devices=(torch.device("cpu"),) * n)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(have, 1) if n_devices is None else n_devices
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return Mesh(n_shards=n, shards=tuple(range(n)),
                devices=tuple(torch.device("cuda", i) for i in range(n)))


def per_replica(ts: list, fn) -> list:
    """``fn`` of each replicated value, computed once per distinct tensor
    (shards on one device share theirs)."""
    done: dict = {}
    out = []
    for t in ts:
        if id(t) not in done:
            done[id(t)] = fn(t)
        out.append(done[id(t)])
    return out


def pdot(mesh: Mesh, a: list, b: list) -> list:
    """Mesh-wide dot: the local dots, then ``psum`` (no central-device
    reduce)."""
    return mesh.psum([torch.dot(x, y) for x, y in zip(a, b)])


@dataclasses.dataclass(frozen=True)
class LocalSpmv:
    """A backend's exchange and local SpMV on per-shard lists (``fn``),
    and ``mask``: the per-shard float32 0/1 vectors its output is still to
    be multiplied by, which the step's passes fold in (None: ``fn``'s
    output is final)."""

    fn: Callable
    mask: list | None = None

    def __call__(self, q: list) -> list:
        return self.fn(q)


def workspaces(mesh: Mesh) -> list:
    """One pass workspace a held shard (``lanczos_step.workspace``),
    shared by the shards on one device (their passes run in order on its
    stream)."""
    by_dev = {d: ls.workspace(d) for d in set(mesh.devices)}
    return [by_dev[d] for d in mesh.devices]


@dataclasses.dataclass(frozen=True)
class StepBuffers:
    """What a loop's step passes share from step to step, each a
    per-shard list: ``work`` the pass workspaces, ``dot`` the slots of
    the dot partials, ``norm`` two slot buffers of the norm partials,
    taken by step parity: step j's updates write norm[j % 2] while later
    shards' updates of that step still read step j-1's norm[(j - 1) % 2]
    as b_prev, and a single buffer would be overwritten under them."""

    work: list
    dot: list
    norm: tuple


def step_buffers(mesh: Mesh, dtype, width: tuple = ()) -> StepBuffers:
    """The StepBuffers of one loop: slots of ``dtype``, each slot of
    ``width`` ((2,) for df64's (hi, lo) pairs)."""
    return StepBuffers(workspaces(mesh), mesh.slots(dtype, width),
                       (mesh.slots(dtype, width), mesh.slots(dtype, width)))


def one_stream(mesh: Mesh) -> bool:
    """Whether the held shards' passes run in turn on one device's stream
    (several shards in process on one device): then the kernel just
    before a shard's normalize pass is another shard's pass, never its
    own update, and the normalize may load v before it waits."""
    return (mesh.group is None and len(mesh.devices) > 1
            and len(set(mesh.devices)) == 1)


def _step_passes(mesh: Mesh, local_spmv, q, q_prev, ss_prev, alpha, beta,
                 j: int, bufs: StepBuffers, q_basis=None,
                 reorthogonalize: bool = False):
    """One step of the recurrence on the mesh: v = A q by ``local_spmv``,
    then row 5d's passes on every held shard, each consuming pass folding
    the slots the passes before it wrote.  Writes alpha[j], beta[j] (the
    first held shard's passes) and, with ``q_basis``, row j+1 of each
    shard's basis.  Returns (q_{j+1}, the norm slots) as per-shard
    lists; ``ss_prev`` is the last step's (None at j = 0)."""
    k = alpha.shape[0]
    n = len(q)
    mask = getattr(local_spmv, "mask", None) or [None] * n
    first = [s == 0 for s in range(n)]
    v = local_spmv(q)
    for vs, qs, ms, w, d, s in zip(v, q, mask, bufs.work, bufs.dot,
                                   mesh.shards):
        ls.shard_step_dot(vs, qs, mask=ms, work=w, slots=d, shard=s,
                          early=True)
    a = mesh.gather_slots(bufs.dot)
    norm = bufs.norm[j % 2]
    sp = ss_prev or [None] * n
    upd = [ls.shard_step_update(vs, qs, qp, av, sv, mask=ms,
                                alpha=alpha if f else None, j=j,
                                norm=not reorthogonalize, work=w, slots=nb,
                                shard=s, early=True)
           for vs, qs, qp, av, sv, ms, f, w, nb, s in zip(
               v, q, q_prev, a, sp, mask, first, bufs.work, norm,
               mesh.shards)]
    if reorthogonalize:
        v = [u[0] for u in upd]
        proj = mesh.psum([qb @ vs for qb, vs in zip(q_basis, v)])
        rows = torch.arange(k, device=proj[0].device)
        keep = per_replica(proj, lambda p: torch.where(
            rows.to(p.device) <= j, p, p.new_zeros(())))
        upd = [ls.shard_step_sub_norm(vs, (p @ qb).contiguous(), work=w,
                                      slots=nb, shard=s)
               for vs, p, qb, w, nb, s in zip(v, keep, q_basis, bufs.work,
                                              norm, mesh.shards)]
    ss = mesh.gather_slots(norm)
    store = ([qb[j + 1] for qb in q_basis] if q_basis is not None
             and j + 1 < k else [None] * n)
    q_next = [ls.shard_step_normalize(u[0], sv, beta=beta if f else None,
                                      j=j, store=st, early=one_stream(mesh))
              for u, sv, f, st in zip(upd, ss, first, store)]
    return q_next, ss


def _start(mesh: Mesh, x: list, k: int):
    """q_0 = x / ||x|| (the psum'd norm, replicated as x_norm) and the
    zeroed q_prev, alpha and beta."""
    x_norm = [torch.sqrt(s) for s in pdot(mesh, x, x)]
    q = [xs / xn for xs, xn in zip(x, x_norm)]
    q_prev = [torch.zeros_like(t) for t in q]
    return (q, q_prev, x[0].new_zeros((k,)), x[0].new_zeros((k,)),
            x_norm[0])


def sharded_lanczos_body(mesh: Mesh, local_spmv, x: list, k: int,
                         reorthogonalize: bool = False):
    """The per-shard Lanczos recurrence shared by every sharded backend
    (the ELL/COO formats in dist/lanczos.py, the CPG kernel in
    dist/cpg_sharded.py).  ``local_spmv(q) -> v`` maps per-shard lists: it
    does the backend's exchange and local SpMV (a :class:`LocalSpmv`
    whose ``mask`` the passes fold in, or any callable whose output is
    final).  The three-term recurrence, the psum'd dots and norms, the
    masked reorthogonalization and the breakdown guard live here once, in
    the order of the single-device step (kernels/lanczos_step.py
    ``lanczos_step_ref``), on row 5d's passes.

    Returns (alpha (k,), beta (k,), q_basis, x_norm): alpha, beta (slot
    k-1 the residual norm) and x_norm replicated, as tensors on the first
    held shard's device, and q_basis a per-shard list of (k, n_loc)."""
    q, q_prev, alpha, beta, x_norm = _start(mesh, x, k)
    q_basis = [t.new_zeros((k, t.shape[0])) for t in q]
    for qb, t in zip(q_basis, q):
        qb[0] = t
    bufs, ss = step_buffers(mesh, alpha.dtype), None
    for j in range(k):
        q_next, ss = _step_passes(mesh, local_spmv, q, q_prev, ss, alpha,
                                  beta, j, bufs, q_basis, reorthogonalize)
        q_prev, q = q, q_next
    return alpha, beta, q_basis, x_norm


def sharded_alphabeta_body(mesh: Mesh, local_spmv, x: list, k: int):
    """Q-free variant of :func:`sharded_lanczos_body`: carries only (q,
    q_prev), O(n_loc) memory per shard, the mesh analog of
    core/lanczos.py ``lanczos_alphabeta``.  Returns (alpha, beta, x_norm)
    replicated; beta is FULL length k (slot k-1 the residual norm, which
    the deflation convergence filter needs)."""
    q, q_prev, alpha, beta, x_norm = _start(mesh, x, k)
    bufs, ss = step_buffers(mesh, alpha.dtype), None
    for j in range(k):
        q_next, ss = _step_passes(mesh, local_spmv, q, q_prev, ss, alpha,
                                  beta, j, bufs)
        q_prev, q = q, q_next
    return alpha, beta, x_norm


def shard_probes(mesh: Mesh, mask: list, seed: int, stream: int,
                 attempt: int, i: int) -> list:
    """Probe ``i`` of (seed, stream, attempt) on every held shard: a
    Rademacher vector on the shard's real cells, drawn on its device from
    (seed, stream, attempt, i, shard) alone (core/stochastic.py
    ``_masked_rademacher``).  Each shard has a stream of its own, as the
    reference folds the shard index into its key (mesh.py:136, :173):
    identical streams would correlate z across shards and bias E[z z^T]
    off the identity."""
    from tpu_lanczos_torch.core.stochastic import _masked_rademacher

    return [_masked_rademacher(m, seed, stream, attempt, i, shard=s)
            for m, s in zip(mask, mesh.shards)]


def _deflation_coeffs(mesh: Mesh, u_rows: list, z: list) -> list:
    """psum(u_rows @ z): the (m,) coefficients u_j . z, replicated."""
    if u_rows[0].shape[0] == 0:
        return [u.new_zeros((0,)) for u in u_rows]
    return mesh.psum([u @ zs for u, zs in zip(u_rows, z)])


def sharded_trace_probes_body(mesh: Mesh, local_spmv, mask: list, seed: int,
                              stream: int, k: int, probes: int,
                              u_rows: list):
    """Every trace probe, the mesh twin of core/stochastic.py
    ``_trace_probes_device``: per probe one Q-free sharded alpha/beta pass
    (via ``local_spmv``) and its psum'd deflation coefficients.  Returns
    stacked (probes, k) alphas and betas, (probes,) x_norms and (probes,
    m) coefficient rows, replicated on the first held shard's device."""
    m = u_rows[0].shape[0]
    ref = mask[0]
    A, B = ref.new_zeros((probes, k)), ref.new_zeros((probes, k))
    XN, C = ref.new_zeros((probes,)), ref.new_zeros((probes, m))
    for i in range(probes):
        z = shard_probes(mesh, mask, seed, stream, 0, i)
        A[i], B[i], XN[i] = sharded_alphabeta_body(mesh, local_spmv, z, k)
        C[i] = _deflation_coeffs(mesh, u_rows, z)[0]
    return A, B, XN, C


def sharded_diag_probes_body(mesh: Mesh, local_spmv, mask: list, seed: int,
                             stream: int, attempt: int, k: int, probes: int,
                             u_rows: list, w_defl: torch.Tensor,
                             shift: torch.Tensor) -> list:
    """Every diagonal probe, the mesh twin of core/stochastic.py
    ``_diag_probes_device``: per probe a k-step sharded Lanczos, ONE
    replicated on-device (k, k) tridiagonal eigensolve per process (not
    per shard), the local slice of the multiply-out GEMV, the rank-m
    deflation correction with psum'd coefficients, and the z * ans
    accumulation, all in e^{-shift}-scaled space.  ``u_rows`` is the
    per-shard (m, n_loc) column slices of the deflation basis (m may be
    0); ``w_defl`` (m,) and ``shift`` are on the first held shard's
    device.  Returns the per-shard slices of diag_m + mean_i z_i * (e^A
    z_i - M z_i), scaled by e^{-shift}."""
    from tpu_lanczos_torch.core import expmv, tridiag

    w = mesh.replicate(w_defl)
    acc = [torch.zeros_like(ms) for ms in mask]
    for i in range(probes):
        z = shard_probes(mesh, mask, seed, stream, attempt, i)
        alpha, beta, q_basis, x_norm = sharded_lanczos_body(
            mesh, local_spmv, z, k)
        evals, evecs = tridiag.eigh_device(alpha, beta[: k - 1])
        tmp, sh = expmv.coefficients(evals, evecs, x_norm)
        tmp = mesh.replicate(tmp)
        scale = mesh.replicate(torch.exp(sh - shift))
        c = _deflation_coeffs(mesh, u_rows, z)
        for s in range(len(acc)):
            ans = (tmp[s] @ q_basis[s]) * scale[s]
            ans = ans - (w[s] * c[s]) @ u_rows[s]  # subtract (M z)_loc
            acc[s] = acc[s] + z[s] * ans
    return [torch.einsum("m,mn->n", ws, u * u) + a / probes
            for ws, u, a in zip(w, u_rows, acc)]
