"""Chebyshev filters whose HEMM is the ring kernel — the p = 1 ring.

Port of ``chase_tpu/parallel/ring.py``'s ``chebyshev_filter_ring_pallas``
and ``chebyshev_filter_refine_ring``, and of the pseudo-Hermitian (BSE)
``chebyshev_filter_h2_ring`` and ``chebyshev_filter_refine_h2_ring``, on a
single device.  The JAX versions
run the recurrence inside one shard_map with the ring as each step's H·V;
with one device the ring has one chunk, so each product is one
:func:`~chase_tpu_torch.ops.ring_hemm.ring_hemm` call that streams all of
H against the filter window — two per step on H² (``ring_hemm(H,
ring_hemm(H, v))``; the kernel reads no symmetry, so a BSE H, whose halves
differ, is fine).  The shift ``c·Y``, the three-term update,
the injection and the degree mask are plain torch.  The multi-GPU ring
(NCCL chunk exchange) belongs to the multi-GPU slice.

H may be the precision ladder's shadow, narrower than the window: the
carry follows ``types.filter_carry_dtype`` as in the JAX package's
``chebyshev_filter_ring``, so a c64 shadow with a c128 window runs the
kernel's c64 route, an f32 shadow with an f64 window its f32 route, and
a bf16 shadow with an f32 window its bf16 route.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.filter import inj_table, refine_combine
from ..ops.pseudo import _interval
from ..ops.ring_hemm import ring_hemm
from ..types import filter_carry_dtype, low_precision_dtype, \
    numpy_scalar_type

__all__ = ["chebyshev_filter_ring_pallas", "chebyshev_filter_refine_ring",
           "chebyshev_filter_h2_ring", "chebyshev_filter_refine_h2_ring"]


def _carry(H: torch.Tensor, X: torch.Tensor) -> torch.dtype:
    """The recurrence carry of an (H, X) pair; raises TypeError unless H
    has X's dtype or is X's ladder shadow (``low_precision_dtype``)."""
    if H.dtype not in (X.dtype, low_precision_dtype(X.dtype)):
        raise TypeError(f"ring filter needs H of the window's dtype or its "
                        f"reduced-precision shadow, got H={H.dtype} "
                        f"X={X.dtype}")
    return filter_carry_dtype(H.dtype, X.dtype)


def _ring_shift(H, v, c, products: int):
    """(Hᵖ − c·I)·v, p = ``products``, each product one ring_hemm call."""
    w = v
    for _ in range(products):
        w = ring_hemm(H, w)
    return w - c * v


def _filter_ring(H, X, degrees, lam1, lower, upper, deg_max, products):
    carry = _carry(H, X)
    # scalars in the carry's real precision, like the JAX version's traced
    # scalars
    rt = numpy_scalar_type(carry)
    lam1, lower, upper = rt(lam1), rt(lower), rt(upper)
    c = (upper + lower) / rt(2)
    e = (upper - lower) / rt(2)
    sigma1 = e / (lam1 - c)
    degs = torch.as_tensor(np.asarray(degrees), device=X.device)[None, :]
    Xc = X.to(carry)

    def hemm_shift(v):
        return _ring_shift(H, v, float(c), products)

    Y = float(sigma1 / e) * hemm_shift(Xc)
    Y = torch.where(degs >= 1, Y, Xc)
    Xp, sigma = Xc, sigma1
    for t in range(2, int(deg_max) + 1):
        sigma_new = rt(1) / (rt(2) / sigma1 - sigma)
        Z = float(rt(2) * sigma_new / e) * hemm_shift(Y) \
            - float(sigma * sigma_new) * Xp
        Xp, Y = Y, torch.where(degs >= t, Z, Y)
        sigma = sigma_new
    # degree-0 columns bit-exact: a reduced carry must not round-trip the
    # problem-dtype columns it leaves alone
    return torch.where(degs >= 1, Y.to(X.dtype), X)


def chebyshev_filter_ring_pallas(H: torch.Tensor, X: torch.Tensor, degrees,
                                 lam1, lower, upper, deg_max: int
                                 ) -> torch.Tensor:
    """Degree-masked scaled Chebyshev filter of the window ``X`` with
    every H·Y product on the ring kernel (``1 + max(deg_max − 1, 0)``
    launches).

    Args:
      H: (N, N) operator: X's dtype (f32 or c64) or X's shadow (f32 for
        f64, c64 for c128, bf16 for f32).
      X: (N, w) window; may be a column view of the search block.
      degrees: (w,) per-column degrees; 0 leaves a column untouched.
      lam1, lower, upper: filter amplification point and damped interval.
      deg_max: max(degrees), the recurrence length.

    Returns: (N, w) filtered window in X's dtype (new tensor); degree-0
    columns are bit-exact copies of X's.
    """
    return _filter_ring(H, X, degrees, lam1, lower, upper, deg_max, 1)


def chebyshev_filter_h2_ring(H: torch.Tensor, X: torch.Tensor, degrees,
                             lam1, lower, upper, deg_max: int
                             ) -> torch.Tensor:
    """The pseudo-Hermitian filter on H² (``ops/pseudo.
    chebyshev_filter_h2``) with both products of every step on the ring
    kernel: ``2·(1 + max(deg_max − 1, 0))`` launches.  Arguments as for
    :func:`chebyshev_filter_ring_pallas`, with H²-spectrum ``lam1``,
    ``lower`` and ``upper`` (the interval in either order).  On the bf16
    route each product rounds its input to bf16, as the plain H² shift
    does."""
    return _filter_ring(H, X, degrees, lam1, *_interval(lower, upper),
                        deg_max, 2)


def _refine_ring(H, V, R, degrees, alpha1_e, alphas, betas, inj, p_final, cc,
                 deg_max, products):
    carry = _carry(H, V)
    rt = numpy_scalar_type(carry)
    ccf = float(rt(cc))
    degs = torch.as_tensor(np.asarray(degrees), device=V.device)[None, :]
    injt = inj_table(inj, carry, V.device)
    rc = R.to(carry)
    W = float(rt(alpha1_e)) * rc                    # w_1 = (σ1/e)·r
    Wp = torch.zeros_like(W)
    for t in range(2, int(deg_max) + 1):
        Z = float(rt(alphas[t])) * _ring_shift(H, W, ccf, products) \
            + float(rt(betas[t])) * Wp + injt[t][None, :] * rc
        Wp, W = W, torch.where(degs >= t, Z, W)
    return refine_combine(V, W, p_final, degrees)


def chebyshev_filter_refine_ring(H: torch.Tensor, V: torch.Tensor,
                                 R: torch.Tensor, degrees, alpha1_e, alphas,
                                 betas, inj, p_final, cc, deg_max: int
                                 ) -> torch.Tensor:
    """Deviation-form refinement filter (``ops/filter.
    chebyshev_filter_refine``) with every H·w on the ring kernel: w₁ =
    (σ1/e)·r needs no product, so ``deg_max`` steps launch ``max(deg_max
    − 1, 0)`` times.  The w recurrence runs in the carry dtype, seeded by
    the residual vectors R; the combine y = p_final·v + w runs in V's.

    Args:
      H: (N, N) shadow of the problem (f32, c64 or bf16) or its own dtype.
      V, R: (N, w) Ritz window and its residual vectors, problem dtype.
      degrees, alpha1_e, alphas, betas, inj, p_final, cc, deg_max: as for
        ``chebyshev_filter_refine`` (tables from ``refine_tables``).

    Returns: (N, w) filtered window in V's dtype; degree-0 columns are V's.
    """
    return _refine_ring(H, V, R, degrees, alpha1_e, alphas, betas, inj,
                        p_final, cc, deg_max, 1)


def chebyshev_filter_refine_h2_ring(H: torch.Tensor, V: torch.Tensor,
                                    R2: torch.Tensor, degrees, alpha1_e,
                                    alphas, betas, inj, p_final, cc,
                                    deg_max: int) -> torch.Tensor:
    """The deviation-form filter on H² (``ops/pseudo.
    chebyshev_filter_refine_h2``) with both products of every step on the
    ring kernel: ``2·max(deg_max − 1, 0)`` launches.  R2 holds the
    H²-residuals (``ops/pseudo.h2_residual``), the tables come from
    ``refine_tables`` on the H²-space quantities; otherwise as
    :func:`chebyshev_filter_refine_ring`."""
    return _refine_ring(H, V, R2, degrees, alpha1_e, alphas, betas, inj,
                        p_final, cc, deg_max, 2)
