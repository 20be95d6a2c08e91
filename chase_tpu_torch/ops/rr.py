"""Rayleigh–Ritz projection fused with residual computation.

Port of the device branch of ``chase_tpu/ops/rr.py`` (the reference's RR
+ Resd pair, rayleighRitz.hpp:60-112 and residuals.hpp:56-83):

* the full block is projected with the locked columns zeroed and their
  projected diagonal pinned above the active spectrum (``2·‖A‖_F + 1``),
  so the small eigenproblem decouples exactly and locked slots sort to
  the tail;
* residuals reuse ``(H·Q)·Z = H·(Q·Z)`` — one N×N×k product per iteration;
* the projected eigensolve is ``torch.linalg.eigh`` (cuSOLVER on CUDA),
  optionally polished by Ogita–Aishima passes (DP default 2).

The rotated block is rolled right by ``locked`` so the caller merges it
into V with a column mask.  On a process grid (``grid=``) H·Q is the
grid's product, QᴴHQ and the residual norms are summed over the grid's
rows (``parallel/dist.py``), and every rank solves the same replicated
k×k problem; the rotations are local.  The split-sync host eigh and the wide-slice
variants are TPU workarounds and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.dist import col_norms, hemm, inner
from ..perf import host_sync
from ..types import is_double_base, real_dtype

__all__ = ["rayleigh_ritz_residuals", "eigh_polished"]


def eigh_polished(A: torch.Tensor, *, passes: int = 2, pin_cut=None):
    """``torch.linalg.eigh`` + Ogita–Aishima eigenvector refinement.

    With R = I − ZᴴZ and S = ZᴴAZ each pass sets λ̃_i = S_ii / (1 − R_ii),
    E_ij = (S_ij + λ̃_j R_ij) / (λ̃_j − λ̃_i) across resolved gaps (R_ij / 2
    inside clusters) and Z ← Z (I + E).  ``pin_cut`` (big / 2 of
    :func:`_pin_locked`) keeps pinned slots out of the gap-floor scale.
    A is symmetrized first, as ``jnp.linalg.eigh`` does.
    Returns (w, Z) ascending.
    """
    A = (A + A.mH) / 2
    host_sync("rr.eigh")          # eigh reads cuSOLVER's info on the host
    w, Z = torch.linalg.eigh(A)
    if passes <= 0:
        return w, Z
    rt = w.dtype
    k = A.shape[0]
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    gap_eps = float(np.sqrt(torch.finfo(rt).eps))
    for _ in range(passes):
        R = eye - Z.mH @ Z
        S = Z.mH @ (A @ Z)
        lam = (torch.diagonal(S).real / (1 - torch.diagonal(R).real)).to(rt)
        num = S + lam[None, :].to(A.dtype) * R
        d = (lam[None, :] - lam[:, None]).to(A.dtype)
        # rotate only across gaps above the first-order validity bound and
        # a sqrt(eps)-relative floor; tighter pairs get the R/2 half-update
        if pin_cut is None:
            lam_scale = torch.max(torch.abs(lam))
        else:
            lam_scale = torch.max(torch.where(lam < pin_cut, torch.abs(lam),
                                              torch.zeros_like(lam)))
        gap_floor = gap_eps * lam_scale
        ok = (torch.abs(d) > 2 * torch.abs(num)) & (torch.abs(d) > gap_floor)
        E = torch.where(ok, num / torch.where(ok, d, torch.ones_like(d)),
                        R / 2)
        E = E - torch.diag(torch.diagonal(E)) + torch.diag(torch.diagonal(R) / 2)
        Z = Z + Z @ E
        w = lam
    order = torch.argsort(w)   # polish can reorder near-degenerate pairs
    return w[order], Z[:, order]


def _pin_locked(A: torch.Tensor, active: torch.Tensor, rt):
    """Decouple the locked slots: eigh(A + big·diag(1-active)) has
    eigenpairs (big, e_j) there, strictly above the active spectrum.
    Returns (A_pinned, big)."""
    big = 2 * torch.linalg.matrix_norm(A).to(rt) + 1
    pin = torch.where(active, torch.zeros((), dtype=rt, device=A.device), big)
    return A + torch.diag(pin).to(A.dtype), big


def _rr_project(H: torch.Tensor, V: torch.Tensor, locked: int, grid=None):
    """Masked block, H·Q, pinned projected matrix.  DP problems
    renormalize the active columns first (a column with ‖q‖² = 1 − η
    biases its Rayleigh quotient by λ·η); SP problems skip it (the norm's
    own rounding sits above the f32 floor)."""
    k = V.shape[1]
    rt = real_dtype(V.dtype)
    active = torch.arange(k, device=V.device) >= locked
    Q = torch.where(active[None, :], V, torch.zeros((), dtype=V.dtype,
                                                    device=V.device))
    if is_double_base(V.dtype):
        nrm = col_norms(Q, grid).to(rt)
        Q = Q / torch.where(nrm > 0, nrm, torch.ones_like(nrm))[None, :] \
            .to(Q.dtype)
    W = hemm(H, Q, grid)            # H·Q (one big HEMM)
    A = inner(Q, W, grid)           # QᴴHQ, k×k
    A, big = _pin_locked(A, active, rt)
    return Q, W, A, big, active


def _rr_finish(Q, W, V, ritz, Z, locked: int, active,
               want_vectors: bool = False, grid=None):
    """Rotate, residuals, roll, merge; with ``want_vectors`` also the
    residual vectors, rolled like the rest."""
    Vrot = Q @ Z                    # Ritz vectors
    Wrot = W @ Z                    # = H · Vrot
    R = Wrot - Vrot * ritz[None, :].to(V.dtype)
    resid = col_norms(R, grid).to(real_dtype(V.dtype))
    # active results live at positions [0, k-locked); roll to [locked, k)
    Vrot = torch.roll(Vrot, locked, dims=1)
    ritz = torch.roll(ritz, locked)
    resid = torch.roll(resid, locked)
    V_out = torch.where(active[None, :], Vrot, V)
    if want_vectors:
        # residual VECTORS feed the deviation-form refinement filter
        # (ops/filter.chebyshev_filter_refine)
        return V_out, ritz, resid, torch.roll(R, locked, dims=1)
    return V_out, ritz, resid


def rayleigh_ritz_residuals(H: torch.Tensor, V: torch.Tensor, locked: int, *,
                            polish: int = 2, want_vectors: bool = False,
                            grid=None):
    """Project H on the active columns of V, solve, rotate, and compute
    residuals.

    Args:
      H: (N, N) Hermitian operator.
      V: (N, k) orthonormal block; columns [0, locked) are converged and
        excluded from the projection.
      locked: number of leading locked columns.
      polish: Ogita–Aishima passes of the projected eigensolve.
      want_vectors: also return the residual vectors.
      grid: the process grid (H its block, V its rows), or None.

    Returns:
      V_out: (N, k) — V with columns [locked, k) replaced by the rotated
             Ritz vectors (ascending Ritz value); [0, locked) untouched.
      ritzv: (k,) real — positions [locked, k) hold the active Ritz values.
      resid: (k,) real — ‖H v_j − θ_j v_j‖₂, same layout.
      R: (N, k) residual vectors H v_j − θ_j v_j in V's dtype, same
         layout — only with ``want_vectors=True`` (they seed the
         precision ladder's refinement filter).
    """
    rt = real_dtype(V.dtype)
    Q, W, A, big, active = _rr_project(H, V, locked, grid)
    # The k×k eigensolve runs in f64 whatever the problem precision (the
    # reference's RR_DOUBLE_PRECISION): cuSOLVER's f32 eigh leaves
    # eigenvector residuals that stalled the f32 N=30000 Clement solve at
    # residual ~4.5 (15 iterations, most pairs early-locked); with the
    # f64 eigh it converged in 5 (H100, PERF.md).  O(k³) next to the
    # N²·k products, which stay in the problem precision.
    wide = torch.complex128 if A.is_complex() else torch.float64
    ritz, Z = eigh_polished(A.to(wide), passes=polish, pin_cut=big / 2)
    return _rr_finish(Q, W, V, ritz.real.to(rt), Z.to(V.dtype), locked,
                      active, want_vectors, grid)
