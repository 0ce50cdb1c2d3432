"""The Lanczos step outside the SpMV: the CUDA kernels of rows 5 and 5c
and their plain PyTorch versions.

The reference runs each k-step recurrence as one ``lax.fori_loop`` and
XLA fuses each step's dot, axpys, norm and normalize
(``tpu_lanczos/core/lanczos.py:84-96``), and for df64 the whole df-op
chain with its two-sum tree (``core/lanczos_df.py:30-40``).  Here a step
after the SpMV is ONE cooperative launch of ``csrc/lanczos_step.cu``: a
persistent grid whose three phases (the dot; the update and its norm;
the normalize) are separated by grid barriers, each thread holding its
slice of v and q_j on chip between them (with reorthogonalization, whose
two GEMVs stay ``torch.matmul``, the step keeps pass kernels around
them):

- ``lanczos_step`` (row 5, float32/float64) and ``lanczos_step_df`` (row
  5c, (hi, lo) float32 pairs) take the SpMV's output ``v``, q_j,
  q_{j-1} and the (k,) alpha and beta buffers; they read beta[j-1] (0 at
  j=0), write alpha[j] and beta[j] and return q_{j+1}, with no scalar
  sent to the host.  ``v`` is consumed: on the card q_{j+1} is written
  over it.  ``mask`` (a CPG pack's float32 0/1 ``realmask``) is the
  SpMV's last multiply, folded into the step: the step reads v as ``v *
  mask``, exactly the separate multiply's bits.
- ``store`` (a (n,) tensor, row 5) also receives q_{j+1}; ``ans`` and
  ``coeff`` fold ``ans += coeff[j + 1] * q_{j+1}`` into the last phase
  (the recombine pass's accumulation, in place).
- ``step_plan`` and ``df_geometry`` choose each launch's grid (every
  block co-resident, from the card's occupancy) and how much of the
  vectors is held on chip: the tiers of row 5 (registers, then shared
  memory, then re-read) and row 5c's element map (G blocks, 2^rows_log
  rows, row 0 held or not).  They are plain functions of n and the
  occupancy, so the CPU tests reach them.
- On a CUDA tensor the wrappers launch the kernels (and raise on what
  they do not take, or on a launch the card refuses); on a CPU tensor
  they run the plain versions ``lanczos_step_ref`` and
  ``lanczos_step_df_ref``, which are the eager ops of the first port; any
  other device raises.

The row-sharded loops (dist/mesh.py, dist/lanczos_df.py) cannot run a
step in one launch: the reference psums the dot and the norm across
shards between its phases.  Rows 5d and 5cd are the step split at those
psums, one launch a pass a shard.  A reducing pass writes the shard's
partial into its slot, ``slots[shard]`` of an (n_shards,) buffer
((n_shards, 2) (hi, lo) pairs in df64); the pass that consumes the sum
folds every slot itself, in shard order, with the arithmetic of the
mesh's psum (``fold_slots_ref``: a left fold of adds) or of the
reference's df allsum (``fold_df_slots_ref``: a chain of ``df_add``), so
no op runs between a step's passes when the shards share a device.  On
the card each pass is a programmatic dependent launch: it may start
while the pass before it drains, and with ``early`` it loads the inputs
the loops never write just before it (q, q_{j-1}, the mask; v in the
update pass, and in the normalize pass when several shards share the
device) before it waits.

- ``shard_step_dot`` (<v * mask, q>), ``shard_step_update`` (v' over v,
  b_prev = sqrt of the fold of the last step's norm slots, alpha[j], the
  partial ||v'||^2), ``shard_step_normalize`` (beta[j] = sqrt of the
  fold of the norm slots, q_{j+1} over v, the stored basis row) and,
  after reorthogonalization's GEMVs, ``shard_step_sub_norm``;
- ``shard_df_dot``, ``shard_df_update`` and ``shard_df_normalize``
  likewise on (hi, lo) pairs, the dot and the norm on core/df64.py's
  pairwise tree over the shard's elements, the normalize folding the
  recombine pass's ``ans``; ``shard_df_dot(x, x)`` is the start norm.

Their plain versions (``*_ref``) are the eager ops of the sharded bodies
before the split, the same folds included, so on the CPU the loops give
the bits they gave.

The kernels' reductions are fixed-order (no floating-point atomics), so
their alpha and beta differ from the plain version's torch.dot in
rounding only, and two runs agree bit for bit; given the same scalars,
q_{j+1} equals the plain version's bit for bit (``update_ref``,
``normalize_ref`` and their df64 twins take the scalars).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tpu_lanczos_torch.core import df64 as df

# CUDA steps launched by each wrapper; only the wrapper adds to it, once a
# step (one kernel launch; four with reorthogonalization)
launches_step = 0
launches_step_df = 0
# row 5d's and row 5cd's pass launches, once a pass (a shard's dot, update,
# sub_norm or normalize), counted by their wrappers only
launches_step_sharded = 0
launches_step_df_sharded = 0

# the kernels' shapes (csrc/lanczos_step.cu): blocks of THREADS threads,
# at most MAX_GRID of them; row 5 holds 16-byte chunks of v and of q a
# thread, REG_CHUNKS in registers and up to MAX_SMEM_CHUNKS more in
# shared memory (SMEM_CHUNK_BYTES a block each); row 5c runs at most
# DF_MAX_GRID blocks, maps 8 elements a thread a row (DF_SPAN a
# block-row), its node stack takes DF_LEVEL_BYTES of shared memory a
# level and a held row DF_HOLD_BYTES
THREADS = 256
MAX_GRID = 4096
REG_CHUNKS = 4
SMEM_CHUNK_BYTES = THREADS * 16 * 2
MAX_SMEM_CHUNKS = 28
DF_MAX_GRID = 512
DF_SPAN = THREADS * 8
DF_LEVEL_BYTES = 8 * THREADS * 4
DF_HOLD_BYTES = 4 * DF_LEVEL_BYTES
DF_MAX_ROWS_LOG = 20
# row 5c holds row 0 only up to 2^DF_HOLD_MAX_ROWS_LOG rows: the held row
# saves a re-read of 1/rows of the data but takes shared memory from the
# L1 cache, and at 2^7 rows (Europe's size, on an H100) it cost 22%
# (eval/step_tiers.py)
DF_HOLD_MAX_ROWS_LOG = 4


def workspace(device) -> torch.Tensor | None:
    """The scratch one loop of steps on ``device`` shares: the kernels'
    block partials and their arrival counter (zeroed here once; each
    reduction leaves it at zero).  None on the CPU.  Steps that share a
    workspace must run in order on one stream."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    from tpu_lanczos_torch.kernels import _build

    nbytes = _build.library().tlt_lanczos_step_workspace_bytes()
    return torch.zeros(nbytes, dtype=torch.uint8, device=device)


# ------------------------------------------------------------- the plans


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Row 5's launch: ``grid`` co-resident blocks, each thread holding
    REG_CHUNKS 16-byte chunks of v and of q in registers and
    ``smem_chunks`` more in shared memory; chunks past those are re-read
    in the later phases."""

    grid: int
    smem_chunks: int

    def held_chunks(self) -> int:
        return self.grid * THREADS * (REG_CHUNKS + self.smem_chunks)

    def tier(self, n: int, value_bytes: int) -> str:
        """"registers", "shared" or "stream" (part re-read)."""
        if self.held_chunks() < n // (16 // value_bytes):
            return "stream"
        return "shared" if self.smem_chunks else "registers"


def step_plan(n: int, value_bytes: int, coresident) -> StepPlan:
    """Row 5's tier and grid for n elements of ``value_bytes`` (4 or 8).
    ``coresident(smem_bytes)`` is the number of blocks of that kernel the
    card holds at once.  The fewest shared chunks (0: registers only)
    that hold all of v and q on chip, with only the blocks its chunks
    need; else the count that holds the most, on its full grid,
    re-reading the rest."""
    chunks = max(n // (16 // value_bytes), 1)
    best = None
    for s in range(MAX_SMEM_CHUNKS + 1):
        g = min(coresident(s * SMEM_CHUNK_BYTES), MAX_GRID)
        if g < 1:
            continue
        per_block = THREADS * (REG_CHUNKS + s)
        if g * per_block >= chunks:
            return StepPlan(-(-chunks // per_block), s)
        if best is None or g * per_block > best.held_chunks():
            best = StepPlan(g, s)
    if best is None:
        raise RuntimeError("lanczos_step: no block of the kernel fits the "
                           "card")
    return best


@dataclasses.dataclass(frozen=True)
class DfPlan:
    """Row 5c's launch: ``grid`` = G co-resident blocks (a power of 2),
    2^``rows_log`` rows of the element map, row 0 held in shared memory
    when ``hold``."""

    grid: int
    rows_log: int
    hold: int

    def smem_bytes(self) -> int:
        return (self.rows_log * DF_LEVEL_BYTES
                + self.hold * DF_HOLD_BYTES)


def df_geometry(n: int, coresident) -> DfPlan:
    """Row 5c's element map for n elements: P = the padded length (a
    power of 2, at least 2048), G = the largest power of 2 at most P /
    2048 and DF_MAX_GRID whose blocks are co-resident
    (``coresident(smem_bytes)`` blocks fit the card at once), with row 0
    held if that still fits and there are at most
    2^DF_HOLD_MAX_ROWS_LOG rows, and P / (G * 2048) rows.  bn1M (n_pad
    2^20) on an H100 (two blocks an SM): 256 blocks, two rows."""
    p = DF_SPAN
    while p < n:
        p <<= 1
    g = min(p // DF_SPAN, DF_MAX_GRID)
    while g >= 1:
        rows_log = (p // (g * DF_SPAN)).bit_length() - 1
        if rows_log <= DF_MAX_ROWS_LOG:
            holds = (1, 0) if rows_log <= DF_HOLD_MAX_ROWS_LOG else (0,)
            for hold in holds:
                plan = DfPlan(g, rows_log, hold)
                if coresident(plan.smem_bytes()) >= g:
                    return plan
        g //= 2
    raise RuntimeError(f"lanczos_step_df: no co-resident grid for n={n}")


@functools.lru_cache(maxsize=None)
def _occupancy_on(index: int, kind: int, value_bytes: int,
                  smem_bytes: int) -> int:
    """Blocks of a one-launch kernel (kind 0 row 5, 1 row 5c) the whole
    card holds at once."""
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    with torch.cuda.device(index):
        per_sm = lib.tlt_lanczos_step_occupancy(kind, value_bytes,
                                                smem_bytes)
    if per_sm < 0:
        raise RuntimeError(f"lanczos step occupancy failed: CUDA error "
                           f"{-per_sm}")
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan_on(index: int, n: int, value_bytes: int) -> StepPlan:
    return step_plan(n, value_bytes, lambda smem: _occupancy_on(
        index, 0, value_bytes, smem))


@functools.lru_cache(maxsize=None)
def _df_plan_on(index: int, n: int) -> DfPlan:
    return df_geometry(n, lambda smem: _occupancy_on(index, 1, 4, smem))


def plan_for(device, n: int, value_bytes: int) -> StepPlan:
    """The plan ``lanczos_step`` uses on ``device`` (a CUDA device)."""
    return _plan_on(torch.device(device).index or 0, n, value_bytes)


def df_plan_for(device, n: int) -> DfPlan:
    """The plan ``lanczos_step_df`` uses on ``device``."""
    return _df_plan_on(torch.device(device).index or 0, n)


# ------------------------------------------------------------- row 5, plain


def update_ref(v, q, q_prev, a, b_prev):
    """v - alpha_j q_j - beta_{j-1} q_{j-1}, as the eager ops round it."""
    return v - a * q - b_prev * q_prev


def normalize_ref(v, b):
    """q_{j+1} = v / beta_j, zero on breakdown (the reference's
    ``jnp.where``, lanczos.py:95)."""
    return torch.where(b > 0, v / torch.where(b > 0, b, 1),
                       torch.zeros_like(v))


def _reorthogonalize(v, q_basis, j: int):
    """Masked full Gram-Schmidt of v against rows 0..j of the (k, n)
    basis (lanczos.py:87-92): two GEMVs, no TF32.  Returns the vector
    subtracted from v."""
    proj = q_basis @ v  # (k,)
    row_ids = torch.arange(q_basis.shape[0], device=v.device)
    proj = torch.where(row_ids <= j, proj, proj.new_zeros(()))
    return proj @ q_basis


def lanczos_step_ref(v, q, q_prev, alpha, beta, j: int, *, q_basis=None,
                     store=None, ans=None, coeff=None, mask=None):
    """The plain version of ``lanczos_step``: the eager torch ops (with
    ``mask``, first the SpMV's multiply ``v * mask``)."""
    if mask is not None:
        v = v * mask.to(v.dtype)
    b_prev = beta[j - 1] if j > 0 else beta.new_zeros(())
    a = torch.dot(v, q)
    v = update_ref(v, q, q_prev, a, b_prev)
    if q_basis is not None:
        v = v - _reorthogonalize(v, q_basis, j)
    b = torch.sqrt(torch.dot(v, v))
    q_next = normalize_ref(v, b)
    alpha[j] = a
    beta[j] = b
    if store is not None:
        store.copy_(q_next)
    if ans is not None:
        ans += coeff[j + 1] * q_next
    return q_next


# ------------------------------------------------------------- row 5c, plain


def update_df_ref(v, q, q_prev, a, b_prev):
    """df_sub(v, df_add(df_scale(a, q), df_scale(b_prev, q_prev)))."""
    return df.df_sub(v, df.df_add(df.df_scale(a, q),
                                  df.df_scale(b_prev, q_prev)))


def normalize_df_ref(v, b):
    """where(ok, df_scale(1 / beta_j, v), 0), 1 / beta_j the df_div of 1
    by beta_j guarded against breakdown (lanczos_df.py:35-39)."""
    ok = b[0] > 0
    safe_b = (torch.where(ok, b[0], 1.0), torch.where(ok, b[1], 0.0))
    inv_b = df.df_div(df.df_from(1.0, device=ok.device), safe_b)
    q_next = df.df_scale(inv_b, v)
    return (torch.where(ok, q_next[0], 0.0),
            torch.where(ok, q_next[1], 0.0))


def accum_df_ref(ans, coeff, jc: int, q):
    """ans = df_add(ans, df_scale(coeff[jc], q)), in place; ``ans`` is a
    (hi, lo) pair of (n,) or (n_ans, n) tensors and ``coeff`` of (k,) or
    (n_ans, k) (the multi-answer recombine: row m by coeff[m, jc])."""
    if ans[0].dim() == 1:
        c = (coeff[0][jc], coeff[1][jc])
        prod = df.df_scale(c, q)
    else:
        c = (coeff[0][:, jc, None], coeff[1][:, jc, None])
        prod = df.df_mul(c, (q[0][None, :], q[1][None, :]))
    hi, lo = df.df_add(ans, prod)
    ans[0].copy_(hi)
    ans[1].copy_(lo)


def lanczos_step_df_ref(v, q, q_prev, alpha, beta, j: int, *, ans=None,
                        coeff=None, mask=None):
    """The plain version of ``lanczos_step_df``: core/df64.py's eager
    ops (with ``mask``, first the df SpMV's multiply of hi and lo)."""
    if mask is not None:
        m = mask.to(v[0].dtype)
        v = (v[0] * m, v[1] * m)
    zero = alpha[0].new_zeros(())
    b_prev = (beta[0][j - 1], beta[1][j - 1]) if j > 0 else (zero, zero)
    a = df.df_dot(v, q)
    v = update_df_ref(v, q, q_prev, a, b_prev)
    b = df.df_norm(v)
    q_next = normalize_df_ref(v, b)
    alpha[0][j], alpha[1][j] = a
    beta[0][j], beta[1][j] = b
    if ans is not None:
        accum_df_ref(ans, coeff, j + 1, q_next)
    return q_next


def df_norm(x, work=None):
    """df_norm of a (hi, lo) vector as a pair of 0-d tensors: one launch
    of the df dot kernel's tree on a CUDA tensor (not counted: it is no
    step), ``core.df64.df_norm`` on a CPU tensor."""
    hi, lo = x
    if hi.device.type == "cpu":
        return df.df_norm(x)
    _check_vectors("df_norm", torch.float32, hi.shape[0], hi, lo)
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    if work is None:
        work = workspace(hi.device)
    out = hi.new_empty(2)
    _raise_on(lib.tlt_df_norm(
        hi.data_ptr(), lo.data_ptr(), out[0:1].data_ptr(),
        out[1:2].data_ptr(), hi.shape[0], work.data_ptr(),
        torch.cuda.current_stream(hi.device).cuda_stream), "df_norm")
    return out[0], out[1]


# ------------------------------------------------------------- the kernels


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check_vectors(what: str, dtype, n: int, *ts) -> None:
    """Every tensor (None skipped): CUDA, ``dtype``, contiguous, n
    elements a row, 16-byte aligned, on one device."""
    dev = None
    for t in ts:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{what}: every tensor must be on the GPU, got "
                             f"{t.device}")
        dev = dev or t.device
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.shape[-1] != n:
            raise ValueError(f"{what}: expected contiguous rows of {n}, got "
                             f"{tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: vectors must be 16-byte aligned")


def _check_scalars(what: str, dtype, device, j: int, *bufs) -> None:
    """The coefficient buffers: contiguous (k,) of ``dtype`` on the
    vectors' ``device``, with slot j inside."""
    for b in bufs:
        if (b.dtype != dtype or b.dim() != 1 or not b.is_contiguous()
                or b.device != device):
            raise ValueError(f"{what}: alpha, beta and coeff must be "
                             f"contiguous (k,) {dtype} buffers on {device}")
        if not 0 <= j < b.shape[0]:
            raise ValueError(f"{what}: step {j} outside a buffer of "
                             f"{b.shape[0]}")


def _check_distinct(what: str, out, *ins) -> None:
    """The kernels write q_{j+1} over v: v may not share memory with an
    input it reads later."""
    for t in ins:
        if t is not None and out.data_ptr() == t.data_ptr():
            raise ValueError(f"{what}: v must not alias q, q_prev or mask")


def _ptr(t):
    return None if t is None else t.data_ptr()


def lanczos_step(v, q, q_prev, alpha, beta, j: int, *, q_basis=None,
                 store=None, ans=None, coeff=None, work=None, mask=None,
                 plan: StepPlan | None = None):
    """One step of the recurrence after the SpMV ``v = A q``: alpha[j] =
    <v, q>; v' = v - alpha[j] q - beta[j-1] q_prev; with ``q_basis``
    (k, n), v' is reorthogonalized against rows 0..j; beta[j] = ||v'||;
    returns q_{j+1} = v' / beta[j] (zero on breakdown).  ``store`` also
    receives q_{j+1}; with ``ans``, ``ans += coeff[j + 1] * q_{j+1}`` in
    place.  With ``mask`` (float32 0/1, (n,)) the step takes ``v * mask``
    for v.  ``work`` is the loop's ``workspace`` (made here if None);
    ``plan`` the launch (``plan_for``'s if None).

    The CUDA kernel on a CUDA tensor (``v`` is overwritten with the
    returned q_{j+1}), the plain version on a CPU tensor."""
    global launches_step
    if v.device.type == "cpu":
        return lanczos_step_ref(v, q, q_prev, alpha, beta, j,
                                q_basis=q_basis, store=store, ans=ans,
                                coeff=coeff, mask=mask)
    if v.device.type != "cuda":
        raise ValueError(f"no Lanczos step for device {v.device}")
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lanczos_step takes float32 or float64, got "
                        f"{v.dtype}")
    n = v.shape[0]
    _check_vectors("lanczos_step", v.dtype, n, v, q, q_prev, store, ans)
    _check_vectors("lanczos_step", torch.float32, n, mask)
    _check_scalars("lanczos_step", v.dtype, v.device, j, alpha, beta)
    if v.dim() != 1:
        raise ValueError(f"lanczos_step: v must be (n,), got {tuple(v.shape)}")
    _check_distinct("lanczos_step", v, q, q_prev, store, ans, mask)
    if ans is not None:
        _check_scalars("lanczos_step", v.dtype, v.device, j + 1, coeff)
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    if work is None:
        work = workspace(v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    vb = v.element_size()
    tail = (_ptr(store), _ptr(ans), _ptr(coeff), j + 1, work.data_ptr())
    if q_basis is None:
        if plan is None:
            plan = plan_for(v.device, n, vb)
        _raise_on(lib.tlt_lanczos_step(
            v.data_ptr(), _ptr(mask), q.data_ptr(), q_prev.data_ptr(),
            alpha.data_ptr(), beta.data_ptr(), n, j, vb, *tail, plan.grid,
            plan.smem_chunks, stream), "lanczos_step")
    else:
        # off the main path: the pass kernels around the two GEMVs, after
        # the mask's multiply in place
        if mask is not None:
            v.mul_(mask.to(v.dtype))
        _raise_on(lib.tlt_lanczos_step_head(
            v.data_ptr(), q.data_ptr(), q_prev.data_ptr(), alpha.data_ptr(),
            beta.data_ptr(), n, j, vb, work.data_ptr(), stream),
            "lanczos_step")
        w = _reorthogonalize(v, q_basis, j).contiguous()
        _check_vectors("lanczos_step", v.dtype, n, w)
        _raise_on(lib.tlt_lanczos_step_tail(
            v.data_ptr(), w.data_ptr(), beta.data_ptr(), n, j, vb, *tail,
            stream), "lanczos_step")
    launches_step += 1
    return v


def lanczos_step_df(v, q, q_prev, alpha, beta, j: int, *, ans=None,
                    coeff=None, work=None, mask=None,
                    plan: DfPlan | None = None):
    """One df64 step after the df SpMV ``v = A q``, every vector a (hi,
    lo) float32 pair and alpha, beta (hi, lo) pairs of (k,) buffers:
    alpha[j] = df_dot(v, q); v' = df_sub(v, df_add(df_scale(alpha[j], q),
    df_scale(beta[j-1], q_prev))); beta[j] = df_norm(v'); returns q_{j+1}
    = df_scale(1 / beta[j], v') (zero on breakdown).  With ``ans`` (a
    (hi, lo) pair of (n,) or (n_ans, n)) and ``coeff`` ((k,) or (n_ans,
    k) pairs), ``ans = df_add(ans, df_scale(coeff[j + 1], q_{j+1}))`` in
    place.  ``work`` and ``mask`` as in ``lanczos_step`` (the mask
    multiplies hi and lo); ``plan`` the launch (``df_plan_for``'s if
    None).

    The CUDA kernel on CUDA tensors (v's two tensors are overwritten
    with the returned q_{j+1}), the plain version on CPU tensors."""
    global launches_step_df
    vh, vl = v
    if vh.device.type == "cpu":
        return lanczos_step_df_ref(v, q, q_prev, alpha, beta, j, ans=ans,
                                   coeff=coeff, mask=mask)
    if vh.device.type != "cuda":
        raise ValueError(f"no df64 Lanczos step for device {vh.device}")
    n = vh.shape[0]
    f32 = torch.float32
    _check_vectors("lanczos_step_df", f32, n, *v, *q, *q_prev, mask)
    if vh.dim() != 1:
        raise ValueError(f"lanczos_step_df: v must be (n,) pairs, got "
                         f"{tuple(vh.shape)}")
    _check_scalars("lanczos_step_df", f32, vh.device, j, *alpha, *beta)
    _check_distinct("lanczos_step_df", vh, *q, *q_prev, vl, mask)
    _check_distinct("lanczos_step_df", vl, *q, *q_prev, mask)
    n_ans, c_stride, ans_p, coeff_p = 0, 0, (None, None), (None, None)
    if ans is not None:
        _check_vectors("lanczos_step_df", f32, n, *ans)
        if ans[0].shape != ans[1].shape or ans[0].dim() not in (1, 2):
            raise ValueError("lanczos_step_df: ans must be a pair of (n,) "
                             "or (n_ans, n) tensors")
        n_ans = 1 if ans[0].dim() == 1 else ans[0].shape[0]
        if n_ans > 1 and n % 4:
            # each answer row is read by 16-byte vector loads
            raise ValueError("lanczos_step_df: rows of several answers "
                             "need n divisible by 4")
        for c in coeff:
            if (c.dtype != f32 or not c.is_contiguous()
                    or c.device != vh.device
                    or c.shape[:-1] != ans[0].shape[:-1]
                    or not j + 1 < c.shape[-1]):
                raise ValueError("lanczos_step_df: coeff must be contiguous "
                                 "float32 pairs of (k,) or (n_ans, k) with "
                                 f"k > {j + 1}")
        c_stride = coeff[0].shape[-1]
        ans_p = tuple(t.data_ptr() for t in ans)
        coeff_p = tuple(t.data_ptr() for t in coeff)
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    if work is None:
        work = workspace(vh.device)
    if plan is None:
        plan = df_plan_for(vh.device, n)
    _raise_on(lib.tlt_lanczos_step_df(
        vh.data_ptr(), vl.data_ptr(), _ptr(mask), q[0].data_ptr(),
        q[1].data_ptr(), q_prev[0].data_ptr(), q_prev[1].data_ptr(),
        alpha[0].data_ptr(), alpha[1].data_ptr(), beta[0].data_ptr(),
        beta[1].data_ptr(), n, j, *ans_p, *coeff_p, j + 1, n_ans, c_stride,
        work.data_ptr(), plan.grid, plan.rows_log, plan.hold,
        torch.cuda.current_stream(vh.device).cuda_stream),
        "lanczos_step_df")
    launches_step_df += 1
    return vh, vl


# ------------------------------------------------------------- rows 5d, 5cd
# the per-shard passes of the row-sharded loops, their partials in slots


def fold_slots_ref(slots):
    """The sum of an (n_shards,) slot buffer in shard order, as
    ``Mesh.psum``'s left fold adds it: ((s0 + s1) + s2) + ..."""
    acc = slots[0]
    for s in slots[1:]:
        acc = acc + s
    return acc


def fold_df_slots_ref(slots):
    """The df sum of an (n_shards, 2) buffer of (hi, lo) pairs: slot 0
    ``df_add``-ed with each later slot in shard order (the reference's
    ``_df_allsum`` fold), as a pair of 0-d tensors."""
    acc = (slots[0, 0], slots[0, 1])
    for i in range(1, slots.shape[0]):
        acc = df.df_add(acc, (slots[i, 0], slots[i, 1]))
    return acc


def _own_slots(like, slots, width=()):
    """``slots``, or a fresh (1, *width) buffer (one shard) like ``like``."""
    return like.new_zeros((1, *width)) if slots is None else slots


def shard_step_dot_ref(v, q, mask=None, slots=None, shard: int = 0):
    """slots[shard] = <v * mask, q> (the plain torch.dot); returns the
    slot buffer (a new (1,) one when ``slots`` is None)."""
    if mask is not None:
        v = v * mask.to(v.dtype)
    slots = _own_slots(v, slots)
    slots[shard] = torch.dot(v, q)
    return slots


def shard_step_update_ref(v, q, q_prev, a, ss_prev, mask=None, alpha=None,
                          j: int = 0, norm: bool = True, slots=None,
                          shard: int = 0):
    """(v', the slot buffer or None): v' = v * mask - a q - b_prev q_prev
    with a the fold of the dot slots ``a`` and b_prev = sqrt of the fold
    of ``ss_prev`` (0 when None); alpha[j] = a; with ``norm``,
    slots[shard] = ||v'||^2."""
    if mask is not None:
        v = v * mask.to(v.dtype)
    a = fold_slots_ref(a)
    b_prev = (v.new_zeros(()) if ss_prev is None
              else torch.sqrt(fold_slots_ref(ss_prev)))
    v = update_ref(v, q, q_prev, a, b_prev)
    if alpha is not None:
        alpha[j] = a
    if not norm:
        return v, None
    slots = _own_slots(v, slots)
    slots[shard] = torch.dot(v, v)
    return v, slots


def shard_step_sub_norm_ref(v, w, slots=None, shard: int = 0):
    """(v - w, the slot buffer with slots[shard] = ||v - w||^2)."""
    v = v - w
    slots = _own_slots(v, slots)
    slots[shard] = torch.dot(v, v)
    return v, slots


def shard_step_normalize_ref(v, ss, beta=None, j: int = 0, store=None):
    """q_{j+1} = v / b (zero on breakdown), b = sqrt of the fold of the
    norm slots ``ss``; beta[j] = b; ``store`` receives q_{j+1}."""
    b = torch.sqrt(fold_slots_ref(ss))
    q_next = normalize_ref(v, b)
    if beta is not None:
        beta[j] = b
    if store is not None:
        store.copy_(q_next)
    return q_next


def shard_df_dot_ref(x, y, mask=None, slots=None, shard: int = 0):
    """slots[shard] = df_dot(x * mask, y) as (hi, lo); returns the
    (n_shards, 2) slot buffer (a new (1, 2) one when ``slots`` is
    None)."""
    if mask is not None:
        x = (x[0] * mask, x[1] * mask)
    slots = _own_slots(x[0], slots, (2,))
    slots[shard] = torch.stack(df.df_dot(x, y))
    return slots


def shard_df_update_ref(v, q, q_prev, a, ss_prev, mask=None, alpha=None,
                        j: int = 0, slots=None, shard: int = 0):
    """(v', the slot buffer): v' = update_df_ref(v * mask, q, q_prev, a,
    df_sqrt(ss)), a and ss the df folds of the slot buffers ``a`` and
    ``ss_prev`` (b_prev 0 when ss_prev is None); alpha[0][j], alpha[1][j]
    = a; slots[shard] = df_dot(v', v')."""
    if mask is not None:
        v = (v[0] * mask, v[1] * mask)
    a = fold_df_slots_ref(a)
    zero = v[0].new_zeros(())
    b_prev = ((zero, zero) if ss_prev is None
              else df.df_sqrt(fold_df_slots_ref(ss_prev)))
    v = update_df_ref(v, q, q_prev, a, b_prev)
    if alpha is not None:
        alpha[0][j], alpha[1][j] = a
    slots = _own_slots(v[0], slots, (2,))
    slots[shard] = torch.stack(df.df_dot(v, v))
    return v, slots


def shard_df_normalize_ref(v, ss, beta=None, j: int = 0, ans=None,
                           coeff=None):
    """q_{j+1} = normalize_df_ref(v, b), b = df_sqrt of the df fold of the
    norm slots ``ss``; beta[0][j], beta[1][j] = b; with ``ans`` (a (hi,
    lo) pair of (n,)), ans = df_add(ans, df_scale(coeff[j + 1], q_{j+1}))
    in place."""
    b = df.df_sqrt(fold_df_slots_ref(ss))
    q_next = normalize_df_ref(v, b)
    if beta is not None:
        beta[0][j], beta[1][j] = b
    if ans is not None:
        accum_df_ref(ans, coeff, j + 1, q_next)
    return q_next


def _pass_setup(what: str, dtype, v, *ts, scalars=()):
    """The checks of a pass on CUDA tensors: ``v`` and ``ts`` (None
    skipped) contiguous (n,) of ``dtype`` on one device, the (k,) buffers
    in ``scalars`` of ``dtype`` on that device.  Returns (the library, n,
    whether every vector is 16-byte aligned, the stream)."""
    if v.dim() != 1:
        raise ValueError(f"{what}: v must be (n,), got {tuple(v.shape)}")
    n = v.shape[0]
    for t in (v, *ts):
        if t is None:
            continue
        if t.device != v.device:
            raise ValueError(f"{what}: tensors on {v.device} and {t.device}")
        if not t.is_contiguous() or t.shape != (n,):
            raise ValueError(f"{what}: expected contiguous ({n},), got "
                             f"{tuple(t.shape)}")
    for t in scalars:
        if t is not None and (t.dtype != dtype or t.device != v.device
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: scalars and coefficient buffers must "
                             f"be contiguous {dtype} on {v.device}")
    from tpu_lanczos_torch.kernels import _build

    aligned = all(t.data_ptr() % 16 == 0 for t in (v, *ts) if t is not None)
    return (_build.library(), n, aligned,
            torch.cuda.current_stream(v.device).cuda_stream)


def _check_slots(what: str, slots, like, width=()) -> int:
    """A slot buffer on CUDA: contiguous (n_shards, *width) of like's
    dtype on like's device.  Returns n_shards."""
    if (slots.dtype != like.dtype or slots.device != like.device
            or not slots.is_contiguous() or slots.dim() != 1 + len(width)
            or tuple(slots.shape[1:]) != width or slots.shape[0] < 1):
        raise ValueError(f"{what}: slots must be a contiguous (n_shards, "
                         f"{', '.join(map(str, width))}) {like.dtype} "
                         f"buffer on {like.device}, got {slots.dtype} "
                         f"{tuple(slots.shape)} on {slots.device}")
    return slots.shape[0]


def _slot_ptr(what: str, slots, like, shard: int, width=()):
    """(the slot buffer a reducing pass writes, a new (1, *width) one when
    None; the address of its slot ``shard``)."""
    if slots is None:
        slots = like.new_zeros((1, *width))
    n_shards = _check_slots(what, slots, like, width)
    if not 0 <= shard < n_shards:
        raise ValueError(f"{what}: shard {shard} outside {n_shards} slots")
    offset = shard * slots.stride(0) * slots.element_size()
    return slots, slots.data_ptr() + offset


def _check_pass_types(what: str, v, mask, *ts):
    if v.device.type != "cuda":
        raise ValueError(f"no {what} for device {v.device}")
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, got {v.dtype}")
    for t in ts:
        if t is not None and t.dtype != v.dtype:
            raise TypeError(f"{what}: expected {v.dtype}, got {t.dtype}")
    if mask is not None and mask.dtype != torch.float32:
        raise TypeError(f"{what}: mask must be float32, got {mask.dtype}")


def _check_slot(what: str, buf, j: int):
    if buf is not None and (buf.dim() != 1 or not 0 <= j < buf.shape[0]):
        raise ValueError(f"{what}: step {j} outside a (k,) buffer of "
                         f"{tuple(buf.shape)}")


def shard_step_dot(v, q, *, mask=None, work=None, slots=None,
                   shard: int = 0, early: bool = False):
    """Row 5d's dot pass on one shard: slots[shard] = the shard's <v *
    mask, q>.  ``slots`` is the (n_shards,) buffer of the step's dot
    partials (a new (1,) one when None); returns it.  ``work`` is the
    loop's ``workspace`` on v's device (made here if None).  With
    ``early`` the kernel loads q and the mask before it waits on the
    kernel launched just before it, which then must not write them (the
    loops' order guarantees it).  The CUDA kernel on a CUDA tensor, the
    plain version on a CPU one."""
    global launches_step_sharded
    if v.device.type == "cpu":
        return shard_step_dot_ref(v, q, mask, slots, shard)
    what = "shard_step_dot"
    _check_pass_types(what, v, mask, q)
    lib, n, vec, stream = _pass_setup(what, v.dtype, v, q, mask)
    slots, out = _slot_ptr(what, slots, v, shard)
    work = workspace(v.device) if work is None else work
    _raise_on(lib.tlt_shard_step_dot(
        v.data_ptr(), _ptr(mask), q.data_ptr(), out, n, v.element_size(),
        int(vec), int(early), work.data_ptr(), stream), what)
    launches_step_sharded += 1
    return slots


def shard_step_update(v, q, q_prev, a, ss_prev, *, mask=None, alpha=None,
                      j: int = 0, norm: bool = True, work=None, slots=None,
                      shard: int = 0, early: bool = False):
    """Row 5d's update pass on one shard: v' = v * mask - a q - b_prev
    q_prev, where the kernel folds itself, in shard order, the dot slots
    ``a`` into a and the last step's norm slots ``ss_prev`` into b_prev**2
    (b_prev 0 when None); alpha[j] = a when ``alpha`` is given.  Returns
    (v', ``slots`` with slots[shard] = the shard's ||v'||^2, or None
    without ``norm``).  On a CUDA tensor v' is written over v.  ``work``
    as in ``shard_step_dot``; with ``early`` the kernel also loads v,
    q_prev before its wait."""
    global launches_step_sharded
    if v.device.type == "cpu":
        return shard_step_update_ref(v, q, q_prev, a, ss_prev, mask, alpha,
                                     j, norm, slots, shard)
    what = "shard_step_update"
    _check_pass_types(what, v, mask, q, q_prev)
    _check_slot(what, alpha, j)
    lib, n, vec, stream = _pass_setup(what, v.dtype, v, q, q_prev, mask,
                                      scalars=(alpha,))
    _check_distinct(what, v, q, q_prev, mask)
    n_shards = _check_slots(what, a, v)
    if ss_prev is not None and _check_slots(what, ss_prev, v) != n_shards:
        raise ValueError(f"{what}: {n_shards} dot slots, "
                         f"{ss_prev.shape[0]} norm slots")
    out = None
    if norm:
        slots, out = _slot_ptr(what, slots, v, shard)
    work = workspace(v.device) if work is None else work
    _raise_on(lib.tlt_shard_step_update(
        v.data_ptr(), _ptr(mask), q.data_ptr(), q_prev.data_ptr(),
        a.data_ptr(), _ptr(ss_prev), n_shards, _ptr(alpha), j, out, n,
        v.element_size(), int(vec), int(early), work.data_ptr(), stream),
        what)
    launches_step_sharded += 1
    return v, (slots if norm else None)


def shard_step_sub_norm(v, w, *, work=None, slots=None, shard: int = 0):
    """Reorthogonalization's pass on one shard, after the GEMVs: (v - w,
    ``slots`` with slots[shard] = the shard's ||v - w||^2); on a CUDA
    tensor v - w is written over v."""
    global launches_step_sharded
    if v.device.type == "cpu":
        return shard_step_sub_norm_ref(v, w, slots, shard)
    what = "shard_step_sub_norm"
    _check_pass_types(what, v, None, w)
    lib, n, vec, stream = _pass_setup(what, v.dtype, v, w)
    _check_distinct(what, v, w)
    slots, out = _slot_ptr(what, slots, v, shard)
    work = workspace(v.device) if work is None else work
    _raise_on(lib.tlt_shard_step_sub_norm(
        v.data_ptr(), w.data_ptr(), out, n, v.element_size(), int(vec),
        work.data_ptr(), stream), what)
    launches_step_sharded += 1
    return v, slots


def shard_step_normalize(v, ss, *, beta=None, j: int = 0, store=None,
                         early: bool = False):
    """Row 5d's normalize pass on one shard: b = sqrt of the kernel's fold
    of the norm slots ``ss`` (shard order), q_{j+1} = v / b (zero on
    breakdown); beta[j] = b when ``beta`` is given; ``store`` (a (n,)
    view, such as a row of the stored basis) receives q_{j+1}.  On a CUDA
    tensor q_{j+1} is written over v and returned.  With ``early`` the
    kernel loads v before it waits on the kernel launched just before it,
    which then must not write v (several shards' passes in turn on one
    device)."""
    global launches_step_sharded
    if v.device.type == "cpu":
        return shard_step_normalize_ref(v, ss, beta, j, store)
    what = "shard_step_normalize"
    _check_pass_types(what, v, None, store)
    _check_slot(what, beta, j)
    lib, n, vec, stream = _pass_setup(what, v.dtype, v, store,
                                      scalars=(beta,))
    _check_distinct(what, v, store)
    n_shards = _check_slots(what, ss, v)
    _raise_on(lib.tlt_shard_step_normalize(
        v.data_ptr(), ss.data_ptr(), n_shards, _ptr(beta), j, _ptr(store),
        n, v.element_size(), int(vec), int(early), stream), what)
    launches_step_sharded += 1
    return v


def _df_pass_setup(what: str, v, *pairs, mask=None, scalars=()):
    """Row 5cd's checks: every vector of the pairs float32, (n,), 16-byte
    aligned, on v's CUDA device; the (k,) buffers float32 there."""
    vh = v[0]
    if vh.device.type != "cuda":
        raise ValueError(f"no {what} for device {vh.device}")
    if vh.dim() != 1:
        raise ValueError(f"{what}: v must be (n,) pairs, got "
                         f"{tuple(vh.shape)}")
    n = vh.shape[0]
    vecs = [t for p in (v, *pairs) if p is not None for t in p]
    _check_vectors(what, torch.float32, n, *vecs, mask)
    for t in scalars:
        if t is not None and (t.dtype != torch.float32
                              or t.device != vh.device
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: scalars and coefficient buffers must "
                             f"be contiguous float32 on {vh.device}")
    from tpu_lanczos_torch.kernels import _build

    return (_build.library(), n,
            torch.cuda.current_stream(vh.device).cuda_stream)


def shard_df_dot(x, y, *, mask=None, work=None, slots=None, shard: int = 0,
                 early: bool = False):
    """Row 5cd's dot pass on one shard: slots[shard] = df_dot(x * mask, y)
    of (hi, lo) pairs on core/df64.py's pairwise tree over the shard's
    elements, as (hi, lo).  ``slots`` is the (n_shards, 2) float32 buffer
    of the partials (a new (1, 2) one when None); returns it.
    ``shard_df_dot(x, x)`` is the start norm's partial.  ``work`` and
    ``early`` (here: y and the mask) as in ``shard_step_dot``.  The CUDA
    kernel on CUDA tensors, the plain version on CPU ones."""
    global launches_step_df_sharded
    if x[0].device.type == "cpu":
        return shard_df_dot_ref(x, y, mask, slots, shard)
    what = "shard_df_dot"
    lib, n, stream = _df_pass_setup(what, x, y, mask=mask)
    slots, out = _slot_ptr(what, slots, x[0], shard, (2,))
    work = workspace(x[0].device) if work is None else work
    _raise_on(lib.tlt_shard_df_dot(
        x[0].data_ptr(), x[1].data_ptr(), _ptr(mask), y[0].data_ptr(),
        y[1].data_ptr(), out, out + 4, n, int(early), work.data_ptr(),
        stream), what)
    launches_step_df_sharded += 1
    return slots


def shard_df_update(v, q, q_prev, a, ss_prev, *, mask=None, alpha=None,
                    j: int = 0, work=None, slots=None, shard: int = 0,
                    early: bool = False):
    """Row 5cd's update pass on one shard: v' = df_sub(v * mask,
    df_add(df_scale(a, q), df_scale(b_prev, q_prev))), where the kernel
    folds the (n_shards, 2) dot slots ``a`` into a and the last step's
    norm slots ``ss_prev`` into b_prev = df_sqrt(...) (0 when None), each
    with df_adds in shard order; (alpha[0], alpha[1])[j] = a when
    ``alpha`` is given.  Returns (v', ``slots`` with slots[shard] =
    df_dot(v', v')); on CUDA tensors v' is written over v.  ``early`` as
    in ``shard_step_update``."""
    global launches_step_df_sharded
    if v[0].device.type == "cpu":
        return shard_df_update_ref(v, q, q_prev, a, ss_prev, mask, alpha, j,
                                   slots, shard)
    what = "shard_df_update"
    al = (None, None) if alpha is None else alpha
    for buf in al:
        _check_slot(what, buf, j)
    lib, n, stream = _df_pass_setup(what, v, q, q_prev, mask=mask,
                                    scalars=al)
    for t in v:
        _check_distinct(what, t, *q, *q_prev, mask)
    _check_distinct(what, v[0], v[1])
    n_shards = _check_slots(what, a, v[0], (2,))
    if (ss_prev is not None
            and _check_slots(what, ss_prev, v[0], (2,)) != n_shards):
        raise ValueError(f"{what}: {n_shards} dot slots, "
                         f"{ss_prev.shape[0]} norm slots")
    slots, out = _slot_ptr(what, slots, v[0], shard, (2,))
    work = workspace(v[0].device) if work is None else work
    _raise_on(lib.tlt_shard_df_update(
        v[0].data_ptr(), v[1].data_ptr(), _ptr(mask), q[0].data_ptr(),
        q[1].data_ptr(), q_prev[0].data_ptr(), q_prev[1].data_ptr(),
        a.data_ptr(), _ptr(ss_prev), n_shards, *map(_ptr, al), j, out,
        out + 4, n, int(early), work.data_ptr(), stream), what)
    launches_step_df_sharded += 1
    return v, slots


def shard_df_normalize(v, ss, *, beta=None, j: int = 0, ans=None,
                       coeff=None, early: bool = False):
    """Row 5cd's normalize pass on one shard: b = df_sqrt of the kernel's
    df fold of the (n_shards, 2) norm slots ``ss`` (shard order), q_{j+1}
    = df_scale(df_div(1, b), v) (zero on breakdown); (beta[0],
    beta[1])[j] = b when ``beta`` is given; with ``ans`` (a (hi, lo) pair
    of (n,)) and ``coeff`` ((k,) pairs), ans = df_add(ans,
    df_scale(coeff[j + 1], q_{j+1})) in place.  On CUDA tensors q_{j+1}
    is written over v and returned.  ``early`` (v and ans) as in
    ``shard_step_normalize``."""
    global launches_step_df_sharded
    if v[0].device.type == "cpu":
        return shard_df_normalize_ref(v, ss, beta, j, ans, coeff)
    what = "shard_df_normalize"
    bt = (None, None) if beta is None else beta
    for buf in bt:
        _check_slot(what, buf, j)
    ans_p, coeff_p = (None, None), (None, None)
    if ans is not None:
        for c in coeff:
            _check_slot(what, c, j + 1)
        ans_p, coeff_p = tuple(ans), tuple(coeff)
    lib, n, stream = _df_pass_setup(what, v, ans, mask=None,
                                    scalars=(*bt, *coeff_p))
    for t in v:
        _check_distinct(what, t, *(x for x in ans_p if x is not None))
    n_shards = _check_slots(what, ss, v[0], (2,))
    _raise_on(lib.tlt_shard_df_normalize(
        v[0].data_ptr(), v[1].data_ptr(), ss.data_ptr(), n_shards,
        *map(_ptr, bt), j, *map(_ptr, ans_p), *map(_ptr, coeff_p), j + 1, n,
        int(early), stream), what)
    launches_step_df_sharded += 1
    return v
