"""The ring HEMM and the Chebyshev filters built on it.

Port of ``chase_tpu/parallel/ring.py``'s 1-D rings: ``ring_hemm``,
``chebyshev_filter_ring``, ``chebyshev_filter_ring_pallas`` and
``chebyshev_filter_refine_ring``, and the pseudo-Hermitian (BSE)
``chebyshev_filter_h2_ring`` and ``chebyshev_filter_refine_h2_ring``.

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
/ ``accumulate`` step) or, for dtypes the kernel does not take and for
``ring_backend="xla"``, :func:`matmul_step` (the JAX package's XLA ring).
On one device (p = 1) a product is one call with ``col0=0`` and nothing
is exchanged.

The peer route (:func:`uses_peers`): on CUDA with the kernel, a (p, 1)
product is one ``ops.ring_hemm.ring_hemm_peers`` call instead — the TPU
kernel's chunk RDMA and barrier in device code (``csrc/ring_peers.cu``):
the rank publishes its chunk into its exported slot, pulls every chunk
from its owner's memory (``Grid2D.peers``: CUDA IPC between processes)
into the main kernel's B and multiplies the whole stripe in one main
launch, with no NCCL call.  A product whose peers cannot be mapped
raises, naming ``ring_backend="xla"``.  The CPU (gloo) and "xla" keep
:func:`ring_steps`; so do the 2-D rings (:class:`Ring2D`).

The filters run the recurrence with that product as each step's H·Y: the
shift ``c·Y``, the three-term update, the injection and the degree mask
are plain torch.  H may be the precision ladder's shadow, narrower than
the window: the carry follows ``types.filter_carry_dtype`` as in the JAX
package's ``chebyshev_filter_ring``, so a c64 shadow with a c128 window
runs the kernel's c64 route, an f32 shadow with an f64 window its f32
route, and a bf16 shadow with an f32 window its bf16 route.  The H²
filters take two ring products per step, ``ring(H, ring(H, v))``: on a
(p, 1) grid the first product's rows are exactly this rank's chunk of the
second's input, so the rings chain as they stand, 2·p kernel launches per
H² step and rank on the chunk ring, 2 on the peer route (the kernel
reads no symmetry, so a BSE H, whose halves differ, is fine; the JAX
package's H² ring multiplies with XLA).  The filter applies no S, so the
S-preserving pad needs nothing here.

The 2-D rings (the JAX package's ``_ring2d_pair`` and its four filters,
``chebyshev_filter_ring2d``, ``chebyshev_filter_refine_ring2d``,
``chebyshev_filter_h2_ring2d`` and ``chebyshev_filter_refine_h2_ring2d``).
On an r×c grid rank (i, j) holds the block h = H[row block i, column
block j] (N/r × N/c) and the multivectors' rows of block i.  The
recurrence runs on chunks of nch = N/(r·c) rows in two orders, the
parities (``Grid2D.parity_chunk``): chunk ``j·r + i`` in A, ``i·c + j``
in B.  Two passes (:class:`Ring2D`):

* ``ring_A`` (A → B), H·w: the chunk ring along 'r' (:func:`ring_steps`,
  r steps of ``h[:, sub]·cur``), then ``Grid2D.reduce_scatter`` over 'c';
* ``ring_B`` (B → A), Hᴴ·w: the chunk ring along 'c' (c steps of
  ``h[sub, :]ᴴ·cur``), then the reduce-scatter over 'r'.  Each step reads
  the block itself: on the kernel ``ring_hemm(h, cur, col0=sub0,
  trans=True)``, its conjugate-transposed A route, and with
  ``torch.matmul`` ``h[sub, :].mH`` as it lies — no copy of the block
  either way.

Parity B's chunk is a slice of the rank's own rows, so a block enters in
B with no communication and leaves B by one ``all_gather`` over 'c'.
The Hermitian filters' steps alternate parity: each pass lands in the
other parity, and the shift ``c·Y``, the previous iterate and the frozen
columns follow it by a parity flip (``Grid2D.flip``, point to point).
The entry parity is chosen so that the last step lands in B: A for an
odd number of steps (one flip on entry).  The JAX package enters in A
and pays a trailing all-frozen step and a flip home instead.  The H²
filters need no flip: from B one H² step is ``ring_A(S·ring_B(S·v))`` —
ring_B computes Hᴴ·w, and Hᴴ = S·H·S for a BSE H, so ``S·ring_B(S·v)`` =
H·v, with S by global row — and every step starts and ends in B.
``ring_hemm`` launches per rank and filter on the kernel, d = deg_max:
the Hermitian filter ⌈n/2⌉·r + ⌊n/2⌋·c with n = max(d, 1), the refine
filter the same with n = max(d − 1, 0), the H² filter n·(r + c) with
n = max(d, 1), the refine H² filter max(d − 1, 0)·(r + c).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops import ring_hemm as rh
from ..ops.filter import inj_table, refine_combine
from ..ops.pseudo import _interval
from ..perf import to_device
from ..types import filter_carry_dtype, low_precision_dtype, \
    numpy_scalar_type
from .dist import local_product

__all__ = ["ring_hemm", "ring_steps", "matmul_step", "uses_peers",
           "chebyshev_filter_ring", "chebyshev_filter_ring_pallas",
           "chebyshev_filter_refine_ring", "chebyshev_filter_h2_ring",
           "chebyshev_filter_refine_h2_ring", "Ring2D",
           "chebyshev_filter_ring2d", "chebyshev_filter_refine_ring2d",
           "chebyshev_filter_h2_ring2d",
           "chebyshev_filter_refine_h2_ring2d"]


def matmul_step(H: torch.Tensor, V: torch.Tensor, *, col0: int = 0,
                out: Optional[torch.Tensor] = None,
                accumulate: bool = False,
                trans: bool = False) -> torch.Tensor:
    """One ring step as ``torch.matmul``: ``out (=|+=) H[:, col0:col0+b]
    @ V``, or with ``trans`` ``H[col0:col0+b, :].mH @ V``
    (``dist.local_product``) — the JAX package's XLA ring step, with
    ``ring_hemm``'s signature."""
    b = V.shape[0]
    prod = local_product(H[col0:col0 + b, :].mH if trans
                         else H[:, col0:col0 + b], V)
    if out is None:
        return prod
    return out.add_(prod) if accumulate else out.copy_(prod)


def ring_steps(H: torch.Tensor, V: torch.Tensor, *, me: int, p: int,
               exchange: Optional[Callable],
               step: Optional[Callable] = None,
               out: Optional[torch.Tensor] = None,
               trans: bool = False) -> torch.Tensor:
    """``out = H·V_all`` for rank ``me`` of a p-rank ring: H is its stripe
    (m × p·b), V its chunk (b × k) of the multivector; p calls of
    ``step`` (the kernel, ``ops.ring_hemm.ring_hemm``, when None; or
    :func:`matmul_step`) with ``col0 = src·b`` and ``accumulate = s > 0``,
    the chunks passed on by ``exchange(send, recv)`` (a handle with
    ``wait()``).  With ``trans`` (passed to ``step``) it is ``Hᴴ·V_all``
    for H of p·b rows, each step on H's rows ``src·b`` onwards.  Returns
    ``out`` (allocated when None)."""
    if step is None:
        step = rh.ring_hemm
    b = V.shape[0]
    dim, what = (0, "rows") if trans else (1, "columns")
    if H.shape[dim] != p * b:
        raise ValueError(f"ring of {p} chunks of {b} rows needs an H of "
                         f"{p * b} {what}, got {H.shape[dim]} (pad N to a "
                         f"multiple of p: DenseOperator does)")
    if p == 1:
        return step(H, V, col0=0, out=out, trans=trans)
    # two private buffers: this rank's chunk (never the caller's V, which
    # a later receive would overwrite) and the one the next chunk lands in
    bufs = (V.clone(memory_format=torch.contiguous_format),
            torch.empty((b, V.shape[1]), dtype=V.dtype, device=V.device))
    for s in range(p):
        cur, nxt = bufs[s % 2], bufs[(s + 1) % 2]
        work = exchange(cur, nxt) if s + 1 < p else None
        out = step(H, cur, col0=((me + s) % p) * b, out=out,
                   accumulate=s > 0, trans=trans)
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


def uses_peers(device_type: str, kernel: bool, dtype, p: int) -> bool:
    """Whether a (p, 1) ring product takes the peer route
    (``ops.ring_hemm.ring_hemm_peers``: the chunks pulled from their
    owners in device code, one main launch): on CUDA, with the kernel as
    the ring's step (``ring_backend="pallas"``), an H dtype the kernel
    takes, and p > 1.  Otherwise :func:`ring_steps` (the CPU's gloo
    exchange, ``"xla"``'s NCCL one)."""
    return (device_type == "cuda" and kernel and dtype in rh.KERNEL_DTYPES
            and p > 1)


def _product(H: torch.Tensor, grid, kernel: bool,
             axis: str = "r") -> Callable:
    """v ↦ H·v for this rank's rows: the ring over ``grid`` (one call on
    one device) with the kernel or :func:`matmul_step` as its step — on
    the peer route (:func:`uses_peers`) one ``ring_hemm_peers`` call."""
    me, p, exchange = _ring_axis(grid, axis)
    if uses_peers(H.device.type, kernel, H.dtype, p):
        peers = grid.peers(axis)
        # looked up at call time, as ring_steps looks up its step
        return lambda v: rh.ring_hemm_peers(H, v, peers)
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
                 hemm, ring2d=None):
    """The recurrence with ``hemm`` as each product, on X's rows — or,
    with ``ring2d`` (a :class:`Ring2D`), on X's parity-B chunk, gathered
    back to X's rows at the end."""
    carry = _carry(H, X)
    # scalars in the carry's real precision, like the JAX version's traced
    # scalars
    rt = numpy_scalar_type(carry)
    lam1, lower, upper = rt(lam1), rt(lower), rt(upper)
    c = (upper + lower) / rt(2)
    e = (upper - lower) / rt(2)
    sigma1 = e / (lam1 - c)
    degs = to_device(np.asarray(degrees), "ring.degrees",
                     device=X.device)[None, :]
    Xc = (X if ring2d is None else ring2d.enter(X)).to(carry)

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
    if ring2d is not None:
        Y = ring2d.leave(Y)
    # degree-0 columns bit-exact: a reduced carry must not round-trip the
    # problem-dtype columns it leaves alone
    return torch.where(degs >= 1, Y.to(X.dtype), X)


def chebyshev_filter_ring_pallas(H: torch.Tensor, X: torch.Tensor, degrees,
                                 lam1, lower, upper, deg_max: int, *,
                                 grid=None) -> torch.Tensor:
    """Degree-masked scaled Chebyshev filter of the window ``X`` with
    every H·Y product on the ring kernel: ``1 + max(deg_max − 1, 0)``
    main launches per rank (on a (p, 1) CUDA grid each a
    ``ring_hemm_peers`` product; p times as many ``ring_hemm`` steps on
    the CPU's chunk ring).

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
                             lam1, lower, upper, deg_max: int, *,
                             grid=None, kernel: bool = True
                             ) -> torch.Tensor:
    """The pseudo-Hermitian filter on H² (``ops/pseudo.
    chebyshev_filter_h2``) with both products of every step a ring
    product: ``2·(1 + max(deg_max − 1, 0))`` products per rank with
    ``kernel`` — one main launch each on one device and on a (p, 1) CUDA
    grid (``ring_hemm_peers``), p ``ring_hemm`` steps on the CPU's chunk
    ring.  Arguments as for :func:`chebyshev_filter_ring_pallas`, with
    H²-spectrum ``lam1``, ``lower`` and ``upper`` (the interval in either
    order); ``kernel`` False takes :func:`matmul_step` as the ring's
    step.  On the bf16 route
    each product rounds its input to bf16, as the plain H² shift does."""
    return _filter_ring(H, X, degrees, lam1, *_interval(lower, upper),
                        deg_max, 2, _product(H, grid, kernel))


def _refine_ring(H, V, R, degrees, alpha1_e, alphas, betas, inj, p_final, cc,
                 deg_max, products, hemm, ring2d=None):
    """The deviation recurrence with ``hemm`` as each product, on R's
    rows — or, with ``ring2d``, on R's parity-B chunk (as
    :func:`_filter_ring`)."""
    carry = _carry(H, V)
    rt = numpy_scalar_type(carry)
    ccf = float(rt(cc))
    degs = to_device(np.asarray(degrees), "ring.degrees",
                     device=V.device)[None, :]
    injt = inj_table(inj, carry, V.device)
    rc = (R if ring2d is None else ring2d.enter(R)).to(carry)
    W = float(rt(alpha1_e)) * rc                    # w_1 = (σ1/e)·r
    Wp = torch.zeros_like(W)
    for t in range(2, int(deg_max) + 1):
        Z = float(rt(alphas[t])) * _ring_shift(hemm, W, ccf, products) \
            + float(rt(betas[t])) * Wp + injt[t][None, :] * rc
        Wp, W = W, torch.where(degs >= t, Z, W)
    if ring2d is not None:
        W = ring2d.leave(W)
    return refine_combine(V, W, p_final, degrees)


def chebyshev_filter_refine_ring(H: torch.Tensor, V: torch.Tensor,
                                 R: torch.Tensor, degrees, alpha1_e, alphas,
                                 betas, inj, p_final, cc, deg_max: int, *,
                                 grid=None, kernel: bool = True
                                 ) -> torch.Tensor:
    """Deviation-form refinement filter (``ops/filter.
    chebyshev_filter_refine``) with every H·w a ring product: w₁ =
    (σ1/e)·r needs no product, so ``deg_max`` steps take ``max(deg_max −
    1, 0)`` products, one main launch each with the kernel (p
    ``ring_hemm`` steps on the CPU's chunk ring).  The w recurrence runs
    in the carry dtype, seeded by the residual vectors R; the combine y =
    p_final·v + w runs in V's.

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
                                    deg_max: int, *, grid=None,
                                    kernel: bool = True) -> torch.Tensor:
    """The deviation-form filter on H² (``ops/pseudo.
    chebyshev_filter_refine_h2``) with both products of every step a ring
    product: ``2·max(deg_max − 1, 0)`` products per rank, one main launch
    each with ``kernel`` (p ``ring_hemm`` steps on the CPU's chunk ring).
    R2 holds the H²-residuals (``ops/pseudo.h2_residual``), the tables
    come from ``refine_tables`` on the H²-space quantities; otherwise as
    :func:`chebyshev_filter_refine_ring`."""
    return _refine_ring(H, V, R2, degrees, alpha1_e, alphas, betas, inj,
                        p_final, cc, deg_max, 2, _product(H, grid, kernel))


# -- the 2-D ping-pong rings -------------------------------------------------

def _other(parity: str) -> str:
    return "B" if parity == "A" else "A"


class Ring2D:
    """The two parity passes of the 2-D ping-pong schedule on ``grid``
    (the JAX package's ``_ring2d_pair``) for this rank's block H (N/r ×
    N/c), with the chunk moves around them.

    Args:
      grid: the r×c grid (``Grid2D``, or anything with its ``size``,
        ``index``, ``exchange``, ``reduce_scatter``, ``flip`` and
        ``all_gather``).
      H: this rank's block (the operator's or its ladder shadow's).
      kernel: every step on the ``ring_hemm`` kernel (ring_B's on its
        trans route, reading H in place), else :func:`matmul_step`
        (ring_B's on ``H[sub, :].mH``).  Both passes read H itself.
    """

    def __init__(self, grid, H: torch.Tensor, kernel: bool):
        self.grid = grid
        self.r, self.c = grid.size("r"), grid.size("c")
        self.i, self.j = grid.index("r"), grid.index("c")
        self.nch = H.shape[0] // self.c
        if tuple(H.shape) != (self.c * self.nch, self.r * self.nch):
            raise ValueError(f"the 2-D ring on a ({self.r}, {self.c}) grid "
                             f"needs a block of (c·nch, r·nch) rows and "
                             f"columns, N = r·c·nch; got {tuple(H.shape)} "
                             f"(DenseOperator pads N to a multiple of r·c)")
        self.H = H
        self.N = self.r * self.c * self.nch
        self.step = None if kernel else matmul_step
        self._ex = {a: (grid.exchange(a) if grid.size(a) > 1 else None)
                    for a in ("r", "c")}

    def ring_A(self, w: torch.Tensor) -> torch.Tensor:
        """H·w: ``w`` this rank's parity-A chunk, the result its parity-B
        chunk (r steps, then the reduce-scatter over 'c')."""
        acc = ring_steps(self.H, w, me=self.i, p=self.r,
                         exchange=self._ex["r"], step=self.step)
        return self.grid.reduce_scatter(acc, "c")

    def ring_B(self, w: torch.Tensor) -> torch.Tensor:
        """Hᴴ·w: ``w`` this rank's parity-B chunk, the result its
        parity-A chunk (c steps, then the reduce-scatter over 'r')."""
        acc = ring_steps(self.H, w, me=self.j, p=self.c,
                         exchange=self._ex["c"], step=self.step, trans=True)
        return self.grid.reduce_scatter(acc, "r")

    def apply(self, w: torch.Tensor, parity: str) -> torch.Tensor:
        """The pass that reads a chunk of ``parity``: H·w (Hᴴ·w from B)
        in the other parity."""
        return self.ring_A(w) if parity == "A" else self.ring_B(w)

    def enter(self, X: torch.Tensor) -> torch.Tensor:
        """This rank's parity-B chunk of the multivector whose rows of
        block i are ``X``: a view, no communication."""
        return X[self.j * self.nch:(self.j + 1) * self.nch]

    def leave(self, Y: torch.Tensor) -> torch.Tensor:
        """The rows of block i from the parity-B chunks: one all_gather
        over 'c'."""
        return self.grid.all_gather(Y.contiguous(), "c")

    def s_flip(self, v: torch.Tensor, parity: str) -> torch.Tensor:
        """S·v for this rank's ``parity`` chunk ``v``: the rows of global
        index ≥ N/2 negated (N the padded size; the S-preserving pad keeps
        S's split there)."""
        r, c, i, j = self.r, self.c, self.i, self.j
        g0 = (j * r + i if parity == "A" else i * c + j) * self.nch
        half = self.N // 2
        if g0 + self.nch <= half:
            return v
        if g0 >= half:
            return -v
        rows = torch.arange(g0, g0 + self.nch, device=v.device)
        return torch.where((rows >= half)[:, None], -v, v)

    def h2(self, v: torch.Tensor) -> torch.Tensor:
        """H²·v from and to parity B: ``ring_A(S·ring_B(S·v))`` — ring_B
        is Hᴴ·w, and S·Hᴴ·S = H for a BSE H."""
        return self.ring_A(self.s_flip(self.ring_B(self.s_flip(v, "B")),
                                       "A"))


def chebyshev_filter_ring2d(grid, H: torch.Tensor, X: torch.Tensor, degrees,
                            lam1, lower, upper, deg_max: int, *,
                            precision="highest", kernel: bool = False
                            ) -> torch.Tensor:
    """The Chebyshev filter as the 2-D ping-pong ring on an r×c grid (the
    JAX package's ``chebyshev_filter_ring2d``).  Each step is one pass
    (:class:`Ring2D`) into the other parity; the shift term, the previous
    iterate and the frozen columns follow by a parity flip, and the entry
    parity makes the last step land in B (the module note).  With
    ``kernel`` the passes' steps are ⌈n/2⌉·r + ⌊n/2⌋·c ``ring_hemm``
    launches per rank, n = max(deg_max, 1).

    Args:
      grid: an r×c grid (r, c > 1 on the solver's "2d" route).
      H: this rank's block (N/r × N/c) of the operator or of its shadow
        (as for :func:`chebyshev_filter_ring_pallas`).
      X: this rank's rows (N/r × w) of the window, ``P('r', None)``.
      degrees, lam1, lower, upper, deg_max: as for
        :func:`chebyshev_filter_ring_pallas`.
      precision: accepted for the JAX signature.
      kernel: as for :class:`Ring2D`.

    Returns: the filtered rows in X's dtype (new tensor), the same bits on
    every rank of a grid row; degree-0 columns bit-exact copies of X's.
    """
    del precision
    carry = _carry(H, X)
    rt = numpy_scalar_type(carry)
    lam1, lower, upper = rt(lam1), rt(lower), rt(upper)
    c = (upper + lower) / rt(2)
    e = (upper - lower) / rt(2)
    sigma1 = e / (lam1 - c)
    cf = float(c)
    degs = to_device(np.asarray(degrees), "ring.degrees",
                     device=X.device)[None, :]
    ring = Ring2D(grid, H, kernel)
    n = max(int(deg_max), 1)
    par = "B" if n % 2 == 0 else "A"          # the last step lands in B
    x = ring.enter(X).to(carry)
    if par == "A":
        x = grid.flip(x.contiguous(), "A")

    def substep(Y, par):
        """(H·Y, Y flipped, their parity)."""
        out = _other(par)
        return ring.apply(Y, par), grid.flip(Y.contiguous(), out), out

    w, flipped, out = substep(x, par)
    Y = float(sigma1 / e) * (w - cf * flipped)
    Y = torch.where(degs >= 1, Y, flipped)
    Xp, par, sigma = x, out, sigma1
    for t in range(2, n + 1):
        sigma_new = rt(1) / (rt(2) / sigma1 - sigma)
        w, flipped, out = substep(Y, par)
        Z = float(rt(2) * sigma_new / e) * (w - cf * flipped) \
            - float(sigma * sigma_new) * Xp
        Xp, Y = Y, torch.where(degs >= t, Z, flipped)
        par, sigma = out, sigma_new
    Y = ring.leave(Y)
    # degree-0 columns bit-exact (a reduced carry must not round-trip them)
    return torch.where(degs >= 1, Y.to(X.dtype), X)


def chebyshev_filter_refine_ring2d(grid, H: torch.Tensor, V: torch.Tensor,
                                   R: torch.Tensor, degrees, alpha1_e,
                                   alphas, betas, inj, p_final, cc,
                                   deg_max: int, *, precision="highest",
                                   kernel: bool = False) -> torch.Tensor:
    """The deviation-form refinement filter as the 2-D ping-pong ring
    (the JAX package's ``chebyshev_filter_refine_ring2d``): the w
    recurrence alternates parity as :func:`chebyshev_filter_ring2d`'s, R
    is held in both parities (one flip), and w₁ = (σ1/e)·r is placed in
    the parity that makes the last step land in B.  Steps 2…deg_max take
    one pass each: with ``kernel`` ⌈m/2⌉·r + ⌊m/2⌋·c ``ring_hemm``
    launches per rank, m = max(deg_max − 1, 0).  V and R are this rank's
    rows (N/r × w), the rest as for :func:`chebyshev_filter_refine_ring`
    and :class:`Ring2D`; returns the filtered rows in V's dtype, degree-0
    columns V's."""
    del precision
    carry = _carry(H, V)
    rt = numpy_scalar_type(carry)
    ccf = float(rt(cc))
    degs = to_device(np.asarray(degrees), "ring.degrees",
                     device=V.device)[None, :]
    injt = inj_table(inj, carry, V.device)
    ring = Ring2D(grid, H, kernel)
    m = max(int(deg_max) - 1, 0)
    rc = {"B": ring.enter(R).to(carry)}
    if m:
        rc["A"] = grid.flip(rc["B"].contiguous(), "A")
    par = "B" if m % 2 == 0 else "A"          # the last step lands in B
    W = float(rt(alpha1_e)) * rc[par]
    Wp = torch.zeros_like(W)
    for t in range(2, m + 2):
        out = _other(par)
        flipped = grid.flip(W.contiguous(), out)
        Z = float(rt(alphas[t])) * (ring.apply(W, par) - ccf * flipped) \
            + float(rt(betas[t])) * Wp + injt[t][None, :] * rc[out]
        Wp, W = W, torch.where(degs >= t, Z, flipped)
        par = out
    return refine_combine(V, ring.leave(W), p_final, degrees)


def chebyshev_filter_h2_ring2d(grid, H: torch.Tensor, X: torch.Tensor,
                               degrees, lam1, lower, upper, deg_max: int, *,
                               precision="highest", kernel: bool = False
                               ) -> torch.Tensor:
    """The pseudo-Hermitian filter on H² as the 2-D ring (the JAX
    package's ``chebyshev_filter_h2_ring2d``): every step one H²
    application (``Ring2D.h2``) from and to parity B, no parity flip;
    with ``kernel`` n·(r + c) ``ring_hemm`` launches per rank, n = 1 +
    max(deg_max − 1, 0).  Arguments as for
    :func:`chebyshev_filter_ring2d`, with the H²-spectrum ``lam1``,
    ``lower`` and ``upper`` (in either order) of
    :func:`chebyshev_filter_h2_ring`."""
    del precision
    ring = Ring2D(grid, H, kernel)
    return _filter_ring(H, X, degrees, lam1, *_interval(lower, upper),
                        deg_max, 1, ring.h2, ring)


def chebyshev_filter_refine_h2_ring2d(grid, H: torch.Tensor, V: torch.Tensor,
                                      R2: torch.Tensor, degrees, alpha1_e,
                                      alphas, betas, inj, p_final, cc,
                                      deg_max: int, *, precision="highest",
                                      kernel: bool = False) -> torch.Tensor:
    """The deviation-form filter on H² as the 2-D ring (the JAX package's
    ``chebyshev_filter_refine_h2_ring2d``): the w recurrence in parity B,
    each step one ``Ring2D.h2``; with ``kernel`` max(deg_max − 1, 0)·(r +
    c) ``ring_hemm`` launches per rank.  Arguments as for
    :func:`chebyshev_filter_refine_h2_ring` with this rank's rows of V and
    R2, and ``kernel`` as for :class:`Ring2D`."""
    del precision
    ring = Ring2D(grid, H, kernel)
    return _refine_ring(H, V, R2, degrees, alpha1_e, alphas, betas, inj,
                        p_final, cc, deg_max, 1, ring.h2, ring)
