"""Error-free transforms (two-float, double-f32) for f64-class residuals.

Counterpart of ``hypre_tpu/seq/twofloat.py``. hypre's 1e-8-class residuals
(``TEST_ij/solvers.saved:1-30``, all in ``HYPRE_Real`` = double) are out
of reach of a plain f32 residual: fl(b - A x) carries O(eps_f32 ||A||
||x||) rounding, a ~1e-4 relative floor on the bench Laplacians. Every
f32 product and sum here also yields its exact rounding error
(Dekker/Knuth), and the error is carried as a second f32: the pair
(hi, lo) holds hi + lo to ~48 significand bits.

No fused multiply-add anywhere: each product and each sum is its own
rounded PyTorch operation, because an FMA breaks Dekker's ``two_prod``.
So never ``torch.addcmul``, ``addcdiv``, ``lerp`` or ``torch.compile``
here. This is plain elementwise PyTorch (the reference has no Pallas
kernel here either: XLA fuses it); on the card each operation is its own
launch.
"""

from __future__ import annotations

import torch

from hypre_tpu_torch.seq.dia import DiaMatrix, _shift1d_dyn

_SPLIT = 4097.0  # 2^12 + 1: Dekker split constant for f32 (24-bit mantissa)


def two_sum(a, b):
    """s + e == a + b exactly (Knuth, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """s + e == a + b exactly, REQUIRES |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """a == hi + lo with hi carrying the top 12 significand bits."""
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly (Dekker product, no FMA)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dia_mv_2f(A: DiaMatrix, x: torch.Tensor):
    """(y_hi, y_lo) ~= A @ x with compensated products and sums: y_hi + y_lo
    is the exact product of the f32 inputs to ~2^-48 relative."""
    s = torch.zeros(A.n_rows, dtype=A.dtype, device=x.device)
    c = torch.zeros(A.n_rows, dtype=A.dtype, device=x.device)
    for d in range(A.D):
        p, pe = two_prod(A.dvals[d], _shift1d_dyn(x, A.offsets[d], A.margin))
        s, e = two_sum(s, p)
        c = c + (e + pe)
    return fast_two_sum(s, c)


def dia_residual_2f(A: DiaMatrix, b: torch.Tensor, x_hi: torch.Tensor,
                    x_lo: torch.Tensor):
    """(r_hi, r_lo) ~= b - A x_hi - A x_lo in double-f32.

    The A x_hi terms and the b subtraction are compensated (the
    cancellation b - A x is where a plain f32 residual dies); A x_lo is
    already ~eps ||x|| small, so a plain product (``A.mv``: the DIA kernel
    on the card) suffices, two_sum-accumulated so its cancellation
    against r is exact."""
    s = b
    c = torch.zeros_like(b)
    for d in range(A.D):
        p, pe = two_prod(A.dvals[d], _shift1d_dyn(x_hi, A.offsets[d],
                                                  A.margin))
        s, e = two_sum(s, -p)
        c = c + (e - pe)
    if x_lo is not None:
        s, e = two_sum(s, -A.mv(x_lo))
        c = c + e
    return fast_two_sum(s, c)
