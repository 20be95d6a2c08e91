"""Orthonormalization: CholQR1/2, shifted CholQR2, Householder fallback.

Port of ``chase_tpu/ops/qr.py`` (the reference's cholqr1.hpp:41-215 and
the condition-driven selection of chase_cpu.hpp:590-776).  The Gram
matrix is one matmul, the k×k Cholesky is ``torch.linalg.cholesky_ex``
(its ``info`` takes the place of the JAX package's NaN signal), and a
failed chain falls back to Householder QR (``torch.linalg.qr``).  SP
problems run the QR in f64 (``qr_hi_prec``, the QR_DOUBLE_PRECISION
analogue) — the H100 multiplies f64 natively.

The pseudo-Hermitian (BSE) solver's S-aware QR (:func:`orthonormalize_pseudo`)
runs the same chain on a rearranged block with the locked columns'
lower halves negated (S's lower half by global row on a grid).

On a process grid (``grid=``; V this rank's rows of ``P('r', None)``) the
Gram and the projections against the locked columns are summed over the
grid's rows (``parallel/dist.inner``), bitwise equal on every rank, so
the Cholesky, its ``ok`` flag and the QR chosen agree everywhere; the
triangular solves are local.  The Householder rescue there is the
distributed :func:`tsqr`.

Not ported: the host-factorized and wide-slice CholQR variants (TPU and
relay workarounds).
"""

from __future__ import annotations

import numpy as np
import torch

from ..logger import get_logger
from .blocks import permute_cols, slice_cols, update_cols
from ..parallel.dist import inner
from ..types import eps, is_double_base

__all__ = ["cholqr", "householder_qr", "tsqr", "mgs_cholqr",
           "restore_locked", "orthonormalize", "orthonormalize_window",
           "orthonormalize_pseudo"]


def _gram(V, grid=None):
    return inner(V, V, grid)


def _rows(V, grid) -> int:
    """The multivector's global row count (V holds this rank's rows)."""
    return V.shape[0] * (1 if grid is None else grid.size("r"))


def _trsm_right(L, V):
    """V @ L^{-H} for lower-triangular L (BLAS trsm 'R','L','C')."""
    return torch.linalg.solve_triangular(L.mH, V, upper=True, left=False)


def _chol_usable(L: torch.Tensor) -> bool:
    """A shift-regularized, marginally-PD Gram (cond ≳ 1e14) factors
    without error, but applying its triangular inverse explodes the basis
    silently.  The diagonal ratio of L (a cond(G) lower bound) flags it,
    as in the JAX package's host-factorized chain; here it guards every
    CholQR pass, next to cholesky_ex's info."""
    dL = torch.abs(torch.diagonal(L))
    if not bool(torch.isfinite(L).all()) or float(dL.min()) <= 0:
        return False
    return float(dL.max() / dL.min()) ** 2 < 1e14


def cholqr(V: torch.Tensor, *, passes: int = 2, shifted: bool = False,
           upcast=None, grid=None):
    """``passes`` rounds of Cholesky QR; optional diagonal shift on
    round 0.  Returns (Q, ok) with ok False if any Cholesky failed.
    Mirrors cholQR1/cholQR2/shiftedcholQR2 (cpu/cholqr1.hpp:41-189)."""
    in_dtype = V.dtype
    if upcast is not None:
        V = V.to(upcast)
    m = _rows(V, grid)
    ok = True
    for p in range(passes):
        G = _gram(V, grid)
        # Column equilibration (Jacobi scaling): factor D⁻¹GD⁻¹ with
        # D = √diag(G) and fold D⁻¹ into the trsm — removes the column-norm
        # spread from the Gram's condition number.
        d = torch.sqrt(torch.abs(torch.diagonal(G).real))
        d = torch.where(d > 0, d, torch.ones_like(d))
        G = G / (d[:, None] * d[None, :]).to(G.dtype)
        if p == 0 and shifted:
            # shift = sqrt(m)·Σ|diag(G)|·eps (DP) / 10·Σ|diag(G)|·eps (SP)
            nrmf = torch.sum(torch.abs(torch.diagonal(G).real))
            coef = np.sqrt(m) if is_double_base(V.dtype) else 10.0
            shift = (coef * eps(V.dtype)) * nrmf
            G = G + shift * torch.eye(G.shape[0], dtype=G.dtype,
                                      device=G.device)
        L, info = torch.linalg.cholesky_ex(G)
        pass_ok = bool(info == 0) and _chol_usable(L)
        ok = ok and pass_ok
        if not pass_ok:
            # the caller discards the result; keep the trsm finite
            L = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
        V = _trsm_right(L, V / d[None, :].to(V.dtype))
    return V.to(in_dtype), ok


def householder_qr(V: torch.Tensor, *, upcast=None) -> torch.Tensor:
    """Dense Householder QR (reference houseHoulderQR: geqrf + gqr)."""
    in_dtype = V.dtype
    if upcast is not None:
        V = V.to(upcast)
    Q, _ = torch.linalg.qr(V, mode="reduced")
    return Q.to(in_dtype)


def tsqr(V: torch.Tensor, *, grid=None, axis: str = "r",
         upcast=None) -> torch.Tensor:
    """Distributed tall-skinny Householder QR (TSQR), the JAX package's
    ``tsqr`` (the reference's distributed Householder QR): each rank
    factors its (N/p, k) rows, the p small R factors are gathered over
    ``axis`` (the only communication), every rank factors the (p·k, k)
    stack alike, and multiplies its Q by its k rows of that factor.
    Backward stable whatever cond(V): the rescue when the CholQR chain
    breaks down.  With no grid, a 1-member axis or shards shorter than k
    it is the dense QR (of the gathered rows, of which each rank keeps
    its own).  Returns this rank's rows of Q."""
    in_dtype = V.dtype
    if upcast is not None:
        V = V.to(upcast)
    n, k = V.shape
    p = 1 if grid is None else grid.size(axis)
    if p == 1:
        Q, _ = torch.linalg.qr(V, mode="reduced")
    elif n < k:
        Q, _ = torch.linalg.qr(grid.all_gather(V, axis), mode="reduced")
        Q = Q[grid.index(axis) * n:(grid.index(axis) + 1) * n]
    else:
        q1, r1 = torch.linalg.qr(V, mode="reduced")
        q2, _ = torch.linalg.qr(grid.all_gather(r1, axis), mode="reduced")
        me = grid.index(axis)
        Q = q1 @ q2[me * k:(me + 1) * k]
    return Q.to(in_dtype)


def _householder(V, grid, upcast):
    """The Householder QR of the solver: :func:`tsqr` on a grid."""
    if grid is None:
        return householder_qr(V, upcast=upcast)
    return tsqr(V, grid=grid, upcast=upcast)


def mgs_cholqr(V: torch.Tensor, *, n_panels: int = 6, upcast=None,
               grid=None):
    """Panelized block-Gram-Schmidt CholQR (BCGS2 shape), the reference's
    modifiedGramSchmidtCholQR (auto-invoked at N ≥ 1e5): panel 0 gets
    CholQR2; every later panel is projected against the previous panel,
    CholQR1'd, re-projected against all previous columns and CholQR1'd
    again.  Returns (Q, ok)."""
    in_dtype = V.dtype
    if upcast is not None:
        V = V.to(upcast)
    k = V.shape[1]
    ps = -(-k // n_panels)
    bounds = [(i * ps, min((i + 1) * ps, k))
              for i in range(n_panels) if i * ps < k]
    Q0, ok = cholqr(V[:, :bounds[0][1]], passes=2, grid=grid)
    cols = [Q0]
    for (a, b) in bounds[1:]:
        Pnl = V[:, a:b]
        prev = cols[-1]
        Pnl = Pnl - prev @ inner(prev, Pnl, grid)
        Pnl, ok1 = cholqr(Pnl, passes=1, grid=grid)
        Qall = torch.cat(cols, dim=1)
        Pnl = Pnl - Qall @ inner(Qall, Pnl, grid)
        Pnl, ok2 = cholqr(Pnl, passes=1, grid=grid)
        ok = ok and ok1 and ok2
        cols.append(Pnl)
    return torch.cat(cols, dim=1).to(in_dtype), ok


def restore_locked(V_new: torch.Tensor, V_old: torch.Tensor,
                   locked: int) -> torch.Tensor:
    """Keep columns [0, locked) from V_old (reference lacpy restore), in
    place in V_new."""
    if locked > 0:
        V_new[:, :locked] = V_old[:, :locked]
    return V_new


def _upcast(rcfg, V):
    """QR_DOUBLE_PRECISION analogue: SP problems factor in f64."""
    if rcfg.qr_hi_prec and not is_double_base(V.dtype):
        return torch.complex128 if V.is_complex() else torch.float64
    return None


def _variant(rcfg, cond):
    if cond > rcfg.cholqr_shift_threshold:
        return 3, True, "shiftedCholQR2"
    if cond < rcfg.cholqr1_threshold:
        return 1, False, "cholQR1"
    return 2, False, "cholQR2"


def _check_ortho(rcfg, Q, what, grid=None):
    if not rcfg.qr_check_ortho:
        return
    eye = torch.eye(Q.shape[1], dtype=Q.dtype, device=Q.device)
    err = float(torch.max(torch.abs(_gram(Q, grid) - eye)))
    thr = 100 * eps(Q.dtype)
    if err > thr:
        get_logger().warn(f"{what} orthogonality check: ||Q^H Q - I|| = "
                          f"{err:.2e} > {thr:.2e}", "linalg")


def _project_out(V_full, W, start, grid=None):
    """W ← (I − L·Lᴴ)·W with L = the locked columns [0, start) of V_full
    (block classical Gram–Schmidt step)."""
    L = V_full[:, :start]
    return W - L @ inner(L, W, grid)


def orthonormalize_window(V: torch.Tensor, start: int, w_pad: int,
                          locked: int, cond: float, rcfg,
                          grid=None) -> torch.Tensor:
    """Width-bucketed QR of the padded active window [start, nevex).

      1. BCGS projection of the window against the locked columns
         [0, start),
      2. cond-selected CholQR chain on the (N, w) window,
      3. a second projection + CholQR1 (BCGS2 reorthogonalization),
      4. locked padding columns restored, window written back into V.

    Falls back to the full-block :func:`orthonormalize` when the window
    Cholesky chain breaks down.
    """
    log = get_logger()
    upcast = _upcast(rcfg, V)
    Vw0 = slice_cols(V, start, w_pad)
    lw = locked - start
    W = _project_out(V, Vw0, start, grid)

    if (not rcfg.cholqr) and cond != 1.0:
        Q = _householder(W, grid, upcast)
        ok = True
        variant = "Householder(window)"
    else:
        passes, shifted, variant = _variant(rcfg, cond)
        variant += "(window)"
        if (not shifted and _rows(V, grid) >= rcfg.mgs_qr_min_n
                and w_pad >= 12):
            Q, ok = mgs_cholqr(W, upcast=upcast, grid=grid)
            variant = "MGS-CholQR(window)"
        else:
            Q, ok = cholqr(W, passes=passes, shifted=shifted, upcast=upcast,
                           grid=grid)
    if ok:
        # BCGS2 second sweep: re-project + re-orthonormalize, honoring the
        # CholQR opt-out
        Q = _project_out(V, Q, start, grid)
        if (not rcfg.cholqr) and cond != 1.0:
            Q = _householder(Q, grid, upcast)
        else:
            Q, ok = cholqr(Q, passes=1, upcast=upcast, grid=grid)
    if not ok:
        log.warn(f"{variant} failed (non-PD Gram), falling back to "
                 f"full-block QR", "linalg")
        return orthonormalize(V, locked, cond, rcfg, grid)
    log.debug(f"QR: {variant}, cond(V) ≈ {cond:.2e}", "linalg")
    _check_ortho(rcfg, Q, "QR(window)", grid)
    Q = restore_locked(Q, Vw0, lw)
    return update_cols(V, Q, start)


def orthonormalize(V: torch.Tensor, locked: int, cond: float,
                   rcfg, grid=None) -> torch.Tensor:
    """Condition-number-driven QR of the full block, locked cols kept.

    Mirrors Impl/chase_cpu/chase_cpu.hpp:629-776: cond > upper threshold →
    shiftedCholQR2; cond < lower threshold → CholQR1; otherwise CholQR2;
    Householder on Cholesky failure or when CholQR is disabled (and
    cond != 1.0; :func:`tsqr` on a grid).  Returns a new (N, nevex) block
    (this rank's rows on ``grid``).
    """
    log = get_logger()
    upcast = _upcast(rcfg, V)
    if (not rcfg.cholqr) and cond != 1.0:
        return restore_locked(_householder(V, grid, upcast), V, locked)

    passes, shifted, variant = _variant(rcfg, cond)
    if (not shifted and _rows(V, grid) >= rcfg.mgs_qr_min_n
            and V.shape[1] >= 12):
        # very tall blocks: panelized Gram-Schmidt CholQR bounds the Gram
        # accumulation error (reference: N >= 1e5, Impl/config/config.hpp:9)
        Q, ok = mgs_cholqr(V, upcast=upcast, grid=grid)
        variant = "MGS-CholQR"
    else:
        Q, ok = cholqr(V, passes=passes, shifted=shifted, upcast=upcast,
                       grid=grid)
    if not ok:
        log.warn(f"{variant} failed (non-PD Gram), falling back to "
                 f"Householder QR", "linalg")
        Q = _householder(V, grid, upcast)
    else:
        log.debug(f"QR: {variant}, cond(V) ≈ {cond:.2e}", "linalg")
    _check_ortho(rcfg, Q, "QR", grid)
    return restore_locked(Q, V, locked)


def orthonormalize_pseudo(V: torch.Tensor, locked: int, cond: float,
                          rcfg, grid=None) -> torch.Tensor:
    """S-aware QR of the pseudo-Hermitian block (the pseudo branch of
    chase_cpu.hpp:597-626 and 754-775): rearrange [L | active | R] →
    [L | R | active], negate the lower half of the 2·locked locked
    columns (so CholQR S-orthogonalizes the active block against them),
    orthonormalize, restore the locked columns, undo the rearrangement.
    Returns a new (N, K2) block (this rank's rows on ``grid``, the lower
    half S's global one)."""
    from .pseudo import flip_locked_cols, row_span
    if locked == 0:
        return orthonormalize(V, 0, cond, rcfg, grid)
    K2 = V.shape[1]
    perm_to = np.concatenate([np.arange(locked), np.arange(K2 - locked, K2),
                              np.arange(locked, K2 - locked)])
    Vp = permute_cols(V, perm_to)
    Q = orthonormalize(flip_locked_cols(Vp, 2 * locked, *row_span(V, grid)),
                       0, cond, rcfg, grid)
    Q = restore_locked(Q, Vp, 2 * locked)
    return permute_cols(Q, np.argsort(perm_to))
