"""Chebyshev polynomial filter — the plain PyTorch path.

Port of ``chase_tpu/ops/filter.py``: the reference's scaled-and-shifted
three-term recurrence (algorithm/algorithm.inc:942-1009).  As in the JAX
package, the shift ``H − cI`` is applied as ``H@X − c·X`` (H is never
modified) and per-column degree retirement is a mask: step ``t`` updates
column ``j`` iff ``t <= degrees[j]``; degree-0 columns pass through
bit-exact.

* :func:`chebyshev_filter` — the whole recurrence on one window (the
  reference filter the ring path and the tests are held against);
* :func:`filter_seg_init` / :func:`filter_seg_steps` — the segmented
  filter the solver drives (``solver._filter_windowed``): the window
  shrinks whenever a whole bucket of columns has retired.

Products are ``torch.matmul`` (cuBLAS on CUDA, at the precision
``config.set_matmul_precision`` selected).  Scalars (c, e, σ) are
computed with numpy in the carry's precision, mirroring the JAX
package's traced scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import numpy_scalar_type, real_dtype

__all__ = ["chebyshev_filter", "filter_seg_init", "filter_seg_steps"]


def _hemm_shift(H, X, c):
    """(H − c·I) @ X without touching H's diagonal."""
    return H @ X - float(c) * X


def _mask(deg, device):
    return torch.as_tensor(np.asarray(deg), device=device)[None, :]


def chebyshev_filter(H: torch.Tensor, X: torch.Tensor, degrees, lam1, lower,
                     upper, deg_max: int) -> torch.Tensor:
    """Apply the degree-masked scaled Chebyshev filter to the window ``X``.

    Args:
      H: (N, N) operator; the recurrence runs in H's dtype.
      X: (N, w) window of the search subspace.
      degrees: (w,) per-column polynomial degrees; 0 = leave untouched.
      lam1: estimate of the smallest eigenvalue (amplification point).
      lower, upper: interval of the spectrum to damp.
      deg_max: max(degrees); loop trip count.

    Returns: (N, w) filtered window in X's dtype (a new tensor).
    """
    carry = H.dtype
    rt = numpy_scalar_type(real_dtype(carry))
    Xc = X.to(carry)
    lam1, lower, upper = rt(lam1), rt(lower), rt(upper)
    c = (upper + lower) / rt(2)
    e = (upper - lower) / rt(2)
    sigma1 = e / (lam1 - c)
    deg = _mask(degrees, X.device)

    # step 1: Y = (sigma1/e) (H - cI) X  (algorithm.inc:962-975)
    Y = float(sigma1 / e) * _hemm_shift(H, Xc, c)
    Y = torch.where(deg >= 1, Y, Xc)
    Xp, sigma = Xc, sigma1
    for t in range(2, int(deg_max) + 1):
        sigma_new = rt(1) / (rt(2) / sigma1 - sigma)
        Z = float(rt(2) * sigma_new / e) * _hemm_shift(H, Y, c) \
            + float(-sigma * sigma_new) * Xp
        Xp, Y = Y, torch.where(deg >= t, Z, Y)
        sigma = sigma_new
    # degree-0 (locked/padding) columns bit-exact
    return torch.where(deg >= 1, Y.to(X.dtype), X)


def filter_seg_init(H: torch.Tensor, V: torch.Tensor, start: int, deg_win,
                    c, e, sigma1, *, w_pad: int):
    """Copy the window [start, start + w_pad) out of V and run step 1.

    Returns (X0, Xp, Yc, sigma): the window's original columns, the two
    recurrence carries (H's dtype) and σ1."""
    X0 = V[:, start:start + w_pad].clone()
    Xc = X0.to(H.dtype)
    Y = float(sigma1 / e) * _hemm_shift(H, Xc, c)
    Y = torch.where(_mask(deg_win, V.device) >= 1, Y, Xc)
    return X0, Xc, Y, sigma1


def filter_seg_steps(H: torch.Tensor, V: torch.Tensor, X0, Xp, Yc, deg_win,
                     sigma, sigma1, c, e, off: int, start_new: int,
                     t0: int, t1: int, *, w_new: int):
    """One segment: shrink the carries by ``off`` columns (0 = no
    shrink), run steps t in [t0, t1), write the masked window back into
    V's columns [start_new, start_new + w_new) in place.

    Returns (V, X0, Xp, Yc, sigma) at the new width."""
    if w_new != Xp.shape[1]:
        X0 = X0[:, off:off + w_new]
        Xp = Xp[:, off:off + w_new]
        Yc = Yc[:, off:off + w_new]
    rt = type(sigma1)
    deg = _mask(deg_win, V.device)
    for t in range(int(t0), int(t1)):
        sigma_new = rt(1) / (rt(2) / sigma1 - sigma)
        Z = float(rt(2) * sigma_new / e) * _hemm_shift(H, Yc, c) \
            + float(-sigma * sigma_new) * Xp
        Xp, Yc = Yc, torch.where(deg >= t, Z, Yc)
        sigma = sigma_new
    # degree-0 (locked pad) columns bit-exact from the original window
    V[:, start_new:start_new + w_new] = torch.where(deg >= 1,
                                                    Yc.to(V.dtype), X0)
    return V, X0, Xp, Yc, sigma
