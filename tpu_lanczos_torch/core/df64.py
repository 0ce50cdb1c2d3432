"""Double-word float32 ("df64") arithmetic in PyTorch.

The port of ``tpu_lanczos/core/df64.py``: the classical error-free
transformations (Knuth two-sum, an exact split product) over (hi, lo)
pairs of float32 tensors, ~2^-48 relative precision.  A df value is a
tuple ``(hi, lo)`` with |lo| <= ulp(hi)/2; scalars (0-d tensors) and
vectors alike, and the elementwise ops broadcast.

Every op is a separate eager torch op, so no multiply is ever fused into
a following add.  Even so the forms stay the reference's, which are
correct under fused multiply-add too: the split is a bit mask (no
Veltkamp multiply whose rounding an FMA would remove) and ``two_prod``
assembles the product from four exact half-products.  Nothing here is
run through ``torch.compile``, ``addcmul`` or ``lerp``.
"""

from __future__ import annotations

import numpy as np
import torch

# 0xFFFFF000 as an int32: keep sign, exponent and the top 11 mantissa
# bits, so each half of a split carries <= 12 significant bits and every
# half-product is exact in float32
_HI_MASK = -4096


def two_sum(a, b):
    """Error-free transformation: a + b = s + e exactly (Knuth)."""
    s = a + b
    z = s - a
    e = (a - (s - z)) + (b - z)
    return s, e


def fast_two_sum(a, b):
    """Error-free a + b = s + e, requiring |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a: torch.Tensor):
    """Bit-level split a = hi + lo with <= 12-significant-bit halves."""
    hi = (a.view(torch.int32) & _HI_MASK).view(torch.float32)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b = p + e from the four exact split products,
    summed by two_sums (no rounded product ever feeds an add)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    p, e1 = two_sum(ah * bh, ah * bl)
    p, e2 = two_sum(p, al * bh)
    p, e3 = two_sum(p, al * bl)
    return p, (e1 + e2) + e3


# ------------------------------------------------------------- df scalars


def df_add(x, y):
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return fast_two_sum(s, e)


def df_sub(x, y):
    return df_add(x, (-y[0], -y[1]))


def df_mul(x, y):
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return fast_two_sum(p, e)


def df_div(x, y):
    q1 = x[0] / y[0]
    r = df_sub(x, df_mul((q1, torch.zeros_like(q1)), y))
    q2 = (r[0] + r[1]) / y[0]
    return fast_two_sum(q1, q2)


def df_sqrt(x):
    s1 = torch.sqrt(x[0])
    zero = torch.zeros_like(s1)
    r = df_sub(x, df_mul((s1, zero), (s1, zero)))
    s2 = (r[0] + r[1]) / (2.0 * s1)
    s2 = torch.where(s1 > 0, s2, zero)
    return fast_two_sum(s1, s2)


def df_from(a, device=None):
    """A df value from a float32-representable number or tensor."""
    hi = torch.as_tensor(a, dtype=torch.float32, device=device)
    return hi, torch.zeros_like(hi)


def df_to_f64(x) -> np.ndarray:
    """Host side: collapse a df pair (tensors or arrays) to float64."""
    hi, lo = (t.cpu().numpy() if isinstance(t, torch.Tensor) else t
              for t in x)
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


# ------------------------------------------------------------- reductions


def _pair_tree(p, err):
    """The pairwise two-sum tree over p (n,) zero-padded to a power of 2,
    index i with i + half at each level: its root (the hi sum the step
    kernel's reduction must reproduce) and ``err`` plus each level's
    error terms."""
    n = p.shape[0]
    pow2 = 1 << max((n - 1).bit_length(), 0)
    if pow2 != n:
        p = torch.cat([p, p.new_zeros(pow2 - n)])
    while p.shape[0] > 1:
        m = p.shape[0] // 2
        p, t = two_sum(p[:m], p[m:])
        err = err + torch.sum(t)
    return p[0], err


def _tree_sum_df(p, e_vec):
    """Pairwise two-sum reduction of p (n,) to a df scalar.  The tree's
    error terms and the caller's ``e_vec`` are summed plainly: their own
    rounding is second order (~n * 2^-48 relative), and ``torch.sum``
    orders them differently from ``jnp.sum`` only at that order."""
    root, err = _pair_tree(p, torch.sum(e_vec))
    return fast_two_sum(root, err)


def df_dot(x, y):
    """df dot product of df vectors x, y -> df scalar (exact two-products,
    a two-sum tree over the hi parts, every error term summed plainly)."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return _tree_sum_df(p, e)


def df_norm(x):
    return df_sqrt(df_dot(x, x))


def df_scale(a, x):
    """df scalar a times df vector x (a broadcasts, as in the
    reference's explicit broadcast_to)."""
    return df_mul(a, x)
