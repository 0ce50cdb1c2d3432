"""The Lanczos step outside the SpMV: the CUDA kernels of rows 5 and 5c
and their plain PyTorch versions.

The reference runs each k-step recurrence as one ``lax.fori_loop`` and
XLA fuses each step's dot, axpys, norm and normalize
(``tpu_lanczos/core/lanczos.py:84-96``), and for df64 the whole df-op
chain with its two-sum tree (``core/lanczos_df.py:30-40``).  Here a step
after the SpMV is three launches of ``csrc/lanczos_step.cu`` (a dot
pass, an update pass with the norm, a normalize pass; four with
reorthogonalization, whose two GEMVs stay ``torch.matmul`` between
them):

- ``lanczos_step`` (row 5, float32/float64) and ``lanczos_step_df`` (row
  5c, (hi, lo) float32 pairs) take the SpMV's output ``v``, q_j,
  q_{j-1} and the (k,) alpha and beta buffers; they read beta[j-1] (0 at
  j=0), write alpha[j] and beta[j] and return q_{j+1}, with no scalar
  sent to the host.  ``v`` is consumed: on the card q_{j+1} is written
  over it.
- ``store`` (a (n,) tensor, row 5) also receives q_{j+1}; ``ans`` and
  ``coeff`` fold ``ans += coeff[j + 1] * q_{j+1}`` into the last pass
  (the recombine pass's accumulation, in place).
- On a CUDA tensor the wrappers launch the kernels (and raise on what
  they do not take); on a CPU tensor they run the plain versions
  ``lanczos_step_ref`` and ``lanczos_step_df_ref``, which are the eager
  ops of the first port; any other device raises.

The kernels' reductions are fixed-order (no floating-point atomics), so
their alpha and beta differ from the plain version's torch.dot in
rounding only, and two runs agree bit for bit; given the same scalars,
q_{j+1} equals the plain version's bit for bit (``update_ref``,
``normalize_ref`` and their df64 twins take the scalars).
"""

from __future__ import annotations

import torch

from tpu_lanczos_torch.core import df64 as df

# CUDA steps launched by each wrapper; only the wrapper adds to it, once a
# step (three kernel launches, four with reorthogonalization)
launches_step = 0
launches_step_df = 0


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
                     store=None, ans=None, coeff=None):
    """The plain version of ``lanczos_step``: the eager torch ops."""
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
                        coeff=None):
    """The plain version of ``lanczos_step_df``: core/df64.py's eager
    ops."""
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
            raise ValueError(f"{what}: v must not alias q or q_prev")


def lanczos_step(v, q, q_prev, alpha, beta, j: int, *, q_basis=None,
                 store=None, ans=None, coeff=None, work=None):
    """One step of the recurrence after the SpMV ``v = A q``: alpha[j] =
    <v, q>; v' = v - alpha[j] q - beta[j-1] q_prev; with ``q_basis``
    (k, n), v' is reorthogonalized against rows 0..j; beta[j] = ||v'||;
    returns q_{j+1} = v' / beta[j] (zero on breakdown).  ``store`` also
    receives q_{j+1}; with ``ans``, ``ans += coeff[j + 1] * q_{j+1}`` in
    place.  ``work`` is the loop's ``workspace`` (made here if None).

    The CUDA kernels on a CUDA tensor (``v`` is overwritten with the
    returned q_{j+1}), the plain version on a CPU tensor."""
    global launches_step
    if v.device.type == "cpu":
        return lanczos_step_ref(v, q, q_prev, alpha, beta, j,
                                q_basis=q_basis, store=store, ans=ans,
                                coeff=coeff)
    if v.device.type != "cuda":
        raise ValueError(f"no Lanczos step for device {v.device}")
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lanczos_step takes float32 or float64, got "
                        f"{v.dtype}")
    n = v.shape[0]
    _check_vectors("lanczos_step", v.dtype, n, v, q, q_prev, store, ans)
    _check_scalars("lanczos_step", v.dtype, v.device, j, alpha, beta)
    if v.dim() != 1:
        raise ValueError(f"lanczos_step: v must be (n,), got {tuple(v.shape)}")
    _check_distinct("lanczos_step", v, q, q_prev, store, ans)
    if ans is not None:
        _check_scalars("lanczos_step", v.dtype, v.device, j + 1, coeff)
    from tpu_lanczos_torch.kernels import _build

    lib = _build.library()
    if work is None:
        work = workspace(v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    vb = v.element_size()

    def ptr(t):
        return None if t is None else t.data_ptr()

    tail = (ptr(store), ptr(ans), ptr(coeff), j + 1, work.data_ptr(),
            stream)
    if q_basis is None:
        _raise_on(lib.tlt_lanczos_step(
            v.data_ptr(), q.data_ptr(), q_prev.data_ptr(), alpha.data_ptr(),
            beta.data_ptr(), n, j, vb, *tail), "lanczos_step")
    else:
        _raise_on(lib.tlt_lanczos_step_head(
            v.data_ptr(), q.data_ptr(), q_prev.data_ptr(), alpha.data_ptr(),
            beta.data_ptr(), n, j, vb, work.data_ptr(), stream),
            "lanczos_step")
        w = _reorthogonalize(v, q_basis, j).contiguous()
        _check_vectors("lanczos_step", v.dtype, n, w)
        _raise_on(lib.tlt_lanczos_step_tail(
            v.data_ptr(), w.data_ptr(), beta.data_ptr(), n, j, vb, *tail),
            "lanczos_step")
    launches_step += 1
    return v


def lanczos_step_df(v, q, q_prev, alpha, beta, j: int, *, ans=None,
                    coeff=None, work=None):
    """One df64 step after the df SpMV ``v = A q``, every vector a (hi,
    lo) float32 pair and alpha, beta (hi, lo) pairs of (k,) buffers:
    alpha[j] = df_dot(v, q); v' = df_sub(v, df_add(df_scale(alpha[j], q),
    df_scale(beta[j-1], q_prev))); beta[j] = df_norm(v'); returns q_{j+1}
    = df_scale(1 / beta[j], v') (zero on breakdown).  With ``ans`` (a
    (hi, lo) pair of (n,) or (n_ans, n)) and ``coeff`` ((k,) or (n_ans,
    k) pairs), ``ans = df_add(ans, df_scale(coeff[j + 1], q_{j+1}))`` in
    place.  ``work`` as in ``lanczos_step``.

    The CUDA kernels on CUDA tensors (v's two tensors are overwritten
    with the returned q_{j+1}), the plain version on CPU tensors."""
    global launches_step_df
    vh, vl = v
    if vh.device.type == "cpu":
        return lanczos_step_df_ref(v, q, q_prev, alpha, beta, j, ans=ans,
                                   coeff=coeff)
    if vh.device.type != "cuda":
        raise ValueError(f"no df64 Lanczos step for device {vh.device}")
    n = vh.shape[0]
    f32 = torch.float32
    _check_vectors("lanczos_step_df", f32, n, *v, *q, *q_prev)
    if vh.dim() != 1:
        raise ValueError(f"lanczos_step_df: v must be (n,) pairs, got "
                         f"{tuple(vh.shape)}")
    _check_scalars("lanczos_step_df", f32, vh.device, j, *alpha, *beta)
    _check_distinct("lanczos_step_df", vh, *q, *q_prev, vl)
    _check_distinct("lanczos_step_df", vl, *q, *q_prev)
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
    _raise_on(lib.tlt_lanczos_step_df(
        vh.data_ptr(), vl.data_ptr(), q[0].data_ptr(), q[1].data_ptr(),
        q_prev[0].data_ptr(), q_prev[1].data_ptr(), alpha[0].data_ptr(),
        alpha[1].data_ptr(), beta[0].data_ptr(), beta[1].data_ptr(), n, j,
        *ans_p, *coeff_p, j + 1, n_ans, c_stride, work.data_ptr(),
        torch.cuda.current_stream(vh.device).cuda_stream),
        "lanczos_step_df")
    launches_step_df += 1
    return vh, vl
