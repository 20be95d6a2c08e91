"""The ring HEMM and the Chebyshev filters built on it.

Port of ``chase_tpu/parallel/ring.py``'s 1-D rings: ``ring_hemm``,
``chebyshev_filter_ring``, ``chebyshev_filter_ring_pallas`` and
``chebyshev_filter_refine_ring``, and of the pseudo-Hermitian (BSE)
``chebyshev_filter_h2_ring`` and ``chebyshev_filter_refine_h2_ring`` on
one device.

The ring (K-D).  On a (p, 1) grid rank i holds the stripe H_i (N/p × N)
and its chunk V_i (b = N/p rows) of the multivector.  :func:`ring_steps`
computes ``H_i·V`` in p steps: at step s the rank multiplies the chunk it
holds, which rank ``src = (i + s) mod p`` owns, into ``W (=|+=)
H_i[:, src·b:(src+1)·b]·chunk``, while the exchange passes chunks one
rank down the ring (send to i−1, receive from i+1 — the JAX ring's
``ppermute``).  The exchange of step s is posted before step s's product
and completed before step s+1 reads its buffer; two buffers alternate, so
nothing is received into the chunk a product is reading.  The exchange is
an argument: ``Grid2D.exchange`` (NCCL ``batch_isend_irecv`` on the card,
gloo on the CPU) in a solve, an in-memory rotation in ``chip_smoke.py``.
The chunk product is the ``ring_hemm`` kernel (the TPU kernel's ``col0``
/ ``accumulate`` step; its chunk RDMA becomes the exchange outside the
kernel) or, for dtypes the kernel does not take and for
``ring_backend="xla"``, :func:`matmul_step` (the JAX package's XLA ring).
On one device (p = 1) a product is one call with ``col0=0`` and nothing
is exchanged.

The filters run the recurrence with that product as each step's H·Y: the
shift ``c·Y``, the three-term update, the injection and the degree mask
are plain torch.  H may be the precision ladder's shadow, narrower than
the window: the carry follows ``types.filter_carry_dtype`` as in the JAX
package's ``chebyshev_filter_ring``, so a c64 shadow with a c128 window
runs the kernel's c64 route, an f32 shadow with an f64 window its f32
route, and a bf16 shadow with an f32 window its bf16 route.  The H²
filters (two products per step, ``ring_hemm(H, ring_hemm(H, v))``; the
kernel reads no symmetry, so a BSE H, whose halves differ, is fine) run
on one device; their p > 1 rings wait for BSE on grids (ROADMAP queue 1
item 5, part 2).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops import ring_hemm as rh
from ..ops.filter import inj_table, refine_combine
from ..ops.pseudo import _interval
from ..types import filter_carry_dtype, low_precision_dtype, \
    numpy_scalar_type
from .dist import local_product

__all__ = ["ring_hemm", "ring_steps", "matmul_step",
           "chebyshev_filter_ring", "chebyshev_filter_ring_pallas",
           "chebyshev_filter_refine_ring", "chebyshev_filter_h2_ring",
           "chebyshev_filter_refine_h2_ring"]


def matmul_step(H: torch.Tensor, V: torch.Tensor, *, col0: int = 0,
                out: Optional[torch.Tensor] = None,
                accumulate: bool = False) -> torch.Tensor:
    """One ring step as ``torch.matmul``: ``out (=|+=) H[:, col0:col0+b]
    @ V`` (``dist.local_product``) — the JAX package's XLA ring step, with
    ``ring_hemm``'s signature."""
    prod = local_product(H[:, col0:col0 + V.shape[0]], V)
    if out is None:
        return prod
    return out.add_(prod) if accumulate else out.copy_(prod)


def ring_steps(H: torch.Tensor, V: torch.Tensor, *, me: int, p: int,
               exchange: Optional[Callable],
               step: Optional[Callable] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = H·V_all`` for rank ``me`` of a p-rank ring: H is its stripe
    (m × p·b), V its chunk (b × k) of the multivector; p calls of
    ``step`` (the kernel, ``ops.ring_hemm.ring_hemm``, when None; or
    :func:`matmul_step`) with ``col0 = src·b`` and ``accumulate = s > 0``,
    the chunks passed on by ``exchange(send, recv)`` (a handle with
    ``wait()``).  Returns ``out`` (allocated when None)."""
    if step is None:
        step = rh.ring_hemm
    b = V.shape[0]
    if H.shape[1] != p * b:
        raise ValueError(f"ring of {p} chunks of {b} rows needs an H of "
                         f"{p * b} columns, got {H.shape[1]} (pad N to a "
                         f"multiple of p: DenseOperator does)")
    if p == 1:
        return step(H, V, col0=0, out=out)
    # two private buffers: this rank's chunk (never the caller's V, which
    # a later receive would overwrite) and the one the next chunk lands in
    bufs = (V.clone(memory_format=torch.contiguous_format),
            torch.empty((b, V.shape[1]), dtype=V.dtype, device=V.device))
    for s in range(p):
        cur, nxt = bufs[s % 2], bufs[(s + 1) % 2]
        work = exchange(cur, nxt) if s + 1 < p else None
        out = step(H, cur, col0=((me + s) % p) * b, out=out,
                   accumulate=s > 0)
        if work is not None:
            work.wait()
    return out


def _ring_axis(grid, axis: str = "r") -> tuple:
    """(me, p, exchange) of the 1-D ring along ``axis``; ValueError when
    another axis of the grid has more than one member."""
    if grid is None:
        return 0, 1, None
    for name, size in grid.shape.items():
        if name != axis and size != 1:
            raise ValueError(f"the ring needs a 1-D grid along '{axis}'; "
                             f"axis '{name}' has size {size}")
    p = grid.size(axis)
    return grid.index(axis), p, (grid.exchange(axis) if p > 1 else None)


def _product(H: torch.Tensor, grid, kernel: bool,
             axis: str = "r") -> Callable:
    """v ↦ H·v for this rank's rows: the ring over ``grid`` (one call on
    one device) with the kernel or :func:`matmul_step` as its step."""
    me, p, exchange = _ring_axis(grid, axis)
    step = None if kernel else matmul_step
    return lambda v: ring_steps(H, v, me=me, p=p, exchange=exchange,
                                step=step)


def ring_hemm(grid, H: torch.Tensor, V: torch.Tensor, *, axis: str = "r",
              precision="highest") -> torch.Tensor:
    """The JAX package's ``ring_hemm``: W = H·V on the 1-D ring along
    ``axis``, H this rank's stripe (N/p × N), V its chunk (N/p × k);
    returns its rows of W.  The chunk product is the ``ring_hemm`` kernel
    for the dtypes it takes (f32, c64, a bf16 H with f32 V), else
    ``torch.matmul``; ``precision`` is accepted for the JAX signature."""
    del precision
    kernel = H.dtype in rh.KERNEL_DTYPES and V.dtype == rh._v_dtype(H.dtype)
    return _product(H, grid, kernel, axis)(V)


def _carry(H: torch.Tensor, X: torch.Tensor) -> torch.dtype:
    """The recurrence carry of an (H, X) pair; raises TypeError unless H
    has X's dtype or is X's ladder shadow (``low_precision_dtype``)."""
    if H.dtype not in (X.dtype, low_precision_dtype(X.dtype)):
        raise TypeError(f"ring filter needs H of the window's dtype or its "
                        f"reduced-precision shadow, got H={H.dtype} "
                        f"X={X.dtype}")
    return filter_carry_dtype(H.dtype, X.dtype)


def _ring_shift(hemm, v, c, products: int):
    """(Hᵖ − c·I)·v, p = ``products``, each product one ring product."""
    w = v
    for _ in range(products):
        w = hemm(w)
    return w - c * v


def _filter_ring(H, X, degrees, lam1, lower, upper, deg_max, products,
                 hemm):
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
        return _ring_shift(hemm, v, float(c), products)

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
                                 lam1, lower, upper, deg_max: int, *,
                                 grid=None) -> torch.Tensor:
    """Degree-masked scaled Chebyshev filter of the window ``X`` with
    every H·Y product on the ring kernel: ``p·(1 + max(deg_max − 1, 0))``
    launches per rank on a (p, 1) grid (p = 1 on one device).

    Args:
      H: X's dtype (f32 or c64) or X's shadow (f32 for f64, c64 for c128,
        bf16 for f32): the whole (N, N) operator, or this rank's stripe
        (N/p × N) on ``grid``.
      X: (N, w) window — this rank's (N/p, w) rows on a grid; may be a
        column view of the search block.
      degrees: (w,) per-column degrees; 0 leaves a column untouched.
      lam1, lower, upper: filter amplification point and damped interval.
      deg_max: max(degrees), the recurrence length.
      grid: a (p, 1) Grid2D, or None for one device.

    Returns: the filtered window (X's rows) in X's dtype (new tensor);
    degree-0 columns are bit-exact copies of X's.
    """
    return _filter_ring(H, X, degrees, lam1, lower, upper, deg_max, 1,
                        _product(H, grid, True))


def chebyshev_filter_ring(grid, H: torch.Tensor, X: torch.Tensor, degrees,
                          lam1, lower, upper, deg_max: int, *,
                          axis: str = "r", precision="highest"
                          ) -> torch.Tensor:
    """The same filter with ``torch.matmul`` as each ring step's product
    (the JAX package's XLA ring, ``chebyshev_filter_ring``): the route
    for f64 and c128 operators and for ``ring_backend="xla"``.  Arguments
    as for :func:`chebyshev_filter_ring_pallas` (the JAX signature:
    ``grid`` first; ``precision`` accepted, the products run at the
    solve's ``matmul_precision``)."""
    del precision
    if axis != "r":
        raise ValueError("the port's rings run along 'r'")
    return _filter_ring(H, X, degrees, lam1, lower, upper, deg_max, 1,
                        _product(H, grid, False))


def chebyshev_filter_h2_ring(H: torch.Tensor, X: torch.Tensor, degrees,
                             lam1, lower, upper, deg_max: int
                             ) -> torch.Tensor:
    """The pseudo-Hermitian filter on H² (``ops/pseudo.
    chebyshev_filter_h2``) with both products of every step on the ring
    kernel on one device: ``2·(1 + max(deg_max − 1, 0))`` launches.
    Arguments as for :func:`chebyshev_filter_ring_pallas`, with
    H²-spectrum ``lam1``, ``lower`` and ``upper`` (the interval in either
    order).  On the bf16 route each product rounds its input to bf16, as
    the plain H² shift does."""
    return _filter_ring(H, X, degrees, lam1, *_interval(lower, upper),
                        deg_max, 2, _product(H, None, True))


def _refine_ring(H, V, R, degrees, alpha1_e, alphas, betas, inj, p_final, cc,
                 deg_max, products, hemm):
    carry = _carry(H, V)
    rt = numpy_scalar_type(carry)
    ccf = float(rt(cc))
    degs = torch.as_tensor(np.asarray(degrees), device=V.device)[None, :]
    injt = inj_table(inj, carry, V.device)
    rc = R.to(carry)
    W = float(rt(alpha1_e)) * rc                    # w_1 = (σ1/e)·r
    Wp = torch.zeros_like(W)
    for t in range(2, int(deg_max) + 1):
        Z = float(rt(alphas[t])) * _ring_shift(hemm, W, ccf, products) \
            + float(rt(betas[t])) * Wp + injt[t][None, :] * rc
        Wp, W = W, torch.where(degs >= t, Z, W)
    return refine_combine(V, W, p_final, degrees)


def chebyshev_filter_refine_ring(H: torch.Tensor, V: torch.Tensor,
                                 R: torch.Tensor, degrees, alpha1_e, alphas,
                                 betas, inj, p_final, cc, deg_max: int, *,
                                 grid=None, kernel: bool = True
                                 ) -> torch.Tensor:
    """Deviation-form refinement filter (``ops/filter.
    chebyshev_filter_refine``) with every H·w a ring product: w₁ =
    (σ1/e)·r needs no product, so ``deg_max`` steps take ``max(deg_max −
    1, 0)`` products, p launches each on a (p, 1) grid.  The w recurrence
    runs in the carry dtype, seeded by the residual vectors R; the
    combine y = p_final·v + w runs in V's.

    Args:
      H: shadow of the problem (f32, c64 or bf16) or its own dtype —
        whole, or this rank's stripe on ``grid``.
      V, R: (N, w) Ritz window and its residual vectors, problem dtype
        (this rank's rows on a grid).
      degrees, alpha1_e, alphas, betas, inj, p_final, cc, deg_max: as for
        ``chebyshev_filter_refine`` (tables from ``refine_tables``).
      grid: a (p, 1) Grid2D, or None for one device.
      kernel: the chunk product on the ``ring_hemm`` kernel (True) or on
        ``torch.matmul`` (the JAX package's XLA refine ring).

    Returns: the filtered window in V's dtype; degree-0 columns are V's.
    """
    return _refine_ring(H, V, R, degrees, alpha1_e, alphas, betas, inj,
                        p_final, cc, deg_max, 1, _product(H, grid, kernel))


def chebyshev_filter_refine_h2_ring(H: torch.Tensor, V: torch.Tensor,
                                    R2: torch.Tensor, degrees, alpha1_e,
                                    alphas, betas, inj, p_final, cc,
                                    deg_max: int) -> torch.Tensor:
    """The deviation-form filter on H² (``ops/pseudo.
    chebyshev_filter_refine_h2``) with both products of every step on the
    ring kernel on one device: ``2·max(deg_max − 1, 0)`` launches.  R2
    holds the H²-residuals (``ops/pseudo.h2_residual``), the tables come
    from ``refine_tables`` on the H²-space quantities; otherwise as
    :func:`chebyshev_filter_refine_ring`."""
    return _refine_ring(H, V, R2, degrees, alpha1_e, alphas, betas, inj,
                        p_final, cc, deg_max, 2, _product(H, None, True))
