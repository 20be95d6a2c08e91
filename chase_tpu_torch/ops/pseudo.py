"""Pseudo-Hermitian (BSE) ops: the S metric, the H² filter, K-conjugation,
the S-Lanczos and the pencil Rayleigh–Ritz.

Port of ``chase_tpu/ops/pseudo.py`` on torch (one device, or a rank of a
process grid: below):

* ``flipLowerHalfMatrixSign`` (applying S = diag(I_{N/2}, −I_{N/2})) is a
  sign flip of the lower rows (:func:`apply_s`, :func:`flip_locked_cols`);
* ``HEMM_H2`` is two products and an axpy (:func:`_h2_shift`): the
  plain H² filters are ``ops/filter.py``'s recurrences with this shift
  (whole and deviation form);
* ``ApplyKconjugate`` maps the eigenvector of λ to the one of −λ,
  K x = conj([x_lower; x_upper]) (:func:`k_conjugate_cols`), materialized
  — never a lazy conj view, which the ring kernel would read unconjugated;
* the S-Lanczos runs in the M = S·H inner product, batched over probes
  (:func:`lanczos_scan_pseudo`);
* ``rayleighRitz_v2``: the Hermitianized pencil QᴴSHQ y = θ QᴴSQ y by
  Cholesky and two triangular solves, locked slots padded (A ← +1,
  B ← −1) so one routine serves every ``locked``, fused with residuals
  (:func:`rayleigh_ritz_residuals_pseudo`).  The K2×K2 pencil runs in
  f64/c128 for every problem (the N×K2 products stay in the problem
  dtype), for the reason the Hermitian RR's projected eigensolve does.

On a process grid (``grid=``; multivectors this rank's rows of ``P('r',
None)``, H its block of ``P('r', 'c')``) S acts on the global rows: the
S-ops take the block's first global row and the padded N (defaults: the
whole block, so one device computes what it always did), K-conjugation
rotates the selected columns' rows by N/2 across ranks
(``Grid2D.rotate_rows``), the products are ``parallel/dist.hemm`` and the
S-weighted dots, the pencil's QᴴS· products and the residual norms are
summed over the grid's rows (``dist.inner``, ``col_dots``,
``col_norms``), bitwise equal on every rank; the pencil is replicated.

The split-sync host pencil (``host_pencil_factor``) and the wide-slice
variants (``_prr_project_wide``, ``h2_residual_wide``) are TPU
workarounds and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.dist import col_dots, col_norms, hemm, inner, rotate_rows
from ..perf import item, to_device
from ..types import real_dtype
from . import filter as filt
from .qr import _rows
from .rr import eigh_polished

__all__ = [
    "apply_s", "flip_locked_cols", "k_conjugate_cols", "row_span",
    "chebyshev_filter_h2",
    "chebyshev_filter_refine_h2",
    "h2_residual", "lanczos_scan_pseudo", "rayleigh_ritz_residuals_pseudo",
    "pencil_rayleigh_ritz", "rayleigh_ritz_pseudo_geev", "residuals_pseudo",
]


def _lower_start(X: torch.Tensor, row0: int, N) -> int:
    """The first of X's rows in S's lower half: X holds the global rows
    [row0, row0 + X.shape[0]) of an N-row block (N None: X is the whole
    block)."""
    N = X.shape[0] if N is None else N
    return min(max(N // 2 - row0, 0), X.shape[0])


def row_span(X: torch.Tensor, grid=None) -> tuple:
    """(first global row, N) of ``X``, this rank's rows of an N-row
    multivector cut over the grid's 'r' axis; (0, None) off a grid."""
    if grid is None:
        return 0, None
    return grid.index("r") * X.shape[0], X.shape[0] * grid.size("r")


def apply_s(X: torch.Tensor, row0: int = 0, N=None) -> torch.Tensor:
    """S·X, S = diag(I_{N/2}, −I_{N/2}): a new tensor, lower rows negated.
    X holds the global rows [row0, row0 + X.shape[0]) of an N-row block
    (default: the whole block)."""
    n2 = _lower_start(X, row0, N)
    return torch.cat([X[:n2], -X[n2:]])


def flip_locked_cols(V: torch.Tensor, nflip: int, row0: int = 0,
                     N=None) -> torch.Tensor:
    """A copy of V with the lower half of its first ``nflip`` columns
    negated: CholQR of the result S-orthogonalizes the rest of the block
    against the locked eigenvectors (chase_cpu.hpp:597-626).  ``row0`` and
    ``N`` as for :func:`apply_s`."""
    n2 = _lower_start(V, row0, N)
    out = V.clone()
    out[n2:, :nflip] = -out[n2:, :nflip]
    return out


def k_conjugate_cols(V: torch.Tensor, src_idx, write_mask,
                     grid=None) -> torch.Tensor:
    """out[:, j] = K(V[:, src_idx[j]]) where ``write_mask[j]``, else
    V[:, j]; K x = conj([x_lower; x_upper]) maps the eigenvector of λ to
    the one of −λ (BSE symmetry).  A new tensor with no conj bit.  On
    ``grid`` (V this rank's rows) the swap of the halves is a rotation of
    the source columns' rows by N/2 (``Grid2D.rotate_rows``)."""
    dst = np.flatnonzero(np.asarray(write_mask))
    out = V.clone()
    if dst.size == 0:
        return out
    src = V[:, to_device(np.asarray(src_idx)[dst], "pseudo.k_conjugate",
                         device=V.device)]
    Ks = rotate_rows(src, _rows(V, grid) // 2, grid)
    out[:, to_device(dst, "pseudo.k_conjugate", device=V.device)] = \
        torch.conj_physical(Ks)
    return out


def _h2_shift(H: torch.Tensor, X: torch.Tensor, c) -> torch.Tensor:
    """(H² − c·I)·X as two products (HEMM_H2).  An H narrower than X (the
    bf16 rung) multiplies X rounded to H's dtype and rounds the
    intermediate H·X to it again before the second product, with sums in
    X's dtype (``filter.narrow_matmul``), as the JAX package does."""
    if H.dtype != X.dtype:
        HX = filt.narrow_matmul(H, filt.narrow_matmul(H, X))
    else:
        HX = H @ (H @ X)
    return HX - float(c) * X


def _interval(lower, upper):
    return min(float(lower), float(upper)), max(float(lower), float(upper))


def chebyshev_filter_h2(H: torch.Tensor, X: torch.Tensor, degrees, lam1,
                        lower, upper, deg_max: int) -> torch.Tensor:
    """Degree-masked Chebyshev filter on H² (algorithm.inc:1012-1064):
    ``filter.chebyshev_filter`` with the H² shift.  ``lam1/lower/upper``
    are H²-spectrum quantities (μ₁, μ_nev+nex, b_sup), the interval taken
    in either order; H may be the ladder's shadow (the carry follows
    ``filter_carry_dtype``).  Degree-0 columns come back bit-exact."""
    lo, up = _interval(lower, upper)
    return filt.chebyshev_filter(H, X, degrees, lam1, lo, up, deg_max,
                                 shift=_h2_shift)


# The solver's H² filters (the JAX package's h2_carry_init/h2_steps,
# h2_seg_* and refine_h2_seg_steps) are parallel/ring's recurrences with
# two products a step, driven by solver._filter_ring and
# solver._filter_refine_windowed.

# -- deviation-form refinement filter on H² (the BSE ladder) -----------------
#
# ops/filter's deviation algebra applied to G = H²: with μ_j = θ_j² (the
# pencil RR's Ritz value squared) the injection needs the H²-residual
# r2_j = (G − θ_j²)v_j = (H + θ_j)·r_j, ONE problem-precision product on
# the H-residual vectors the pencil RR already returns (h2_residual).
# The tables are filter.refine_tables on the H²-space quantities.

def chebyshev_filter_refine_h2(H, V, R2, degrees, alpha1_e, alphas, betas,
                               inj, p_final, cc, deg_max) -> torch.Tensor:
    """Deviation-form Chebyshev filter on H²: y_j = p_final_j·v_j + w_j
    with the w recurrence in ``filter_carry_dtype(H, V)``, seeded by the
    H²-residuals R2 (:func:`h2_residual`); tables from
    ``filter.refine_tables`` for (θ², degrees, μ₁, lower, b_sup)."""
    return filt.chebyshev_filter_refine(H, V, R2, degrees, alpha1_e, alphas,
                                        betas, inj, p_final, cc, deg_max,
                                        shift=_h2_shift)


def h2_residual(H: torch.Tensor, R: torch.Tensor, theta,
                grid=None) -> torch.Tensor:
    """H²-residuals from the pencil RR's H-residuals: r2_j = (H + θ_j)·r_j.
    Runs on the problem's own H in its dtype (the refinement's floor is
    this product's accuracy), never on the shadow; on ``grid`` the
    product is ``dist.hemm``."""
    th = to_device(theta, "pseudo.h2_residual",
                   device=R.device).to(real_dtype(R.dtype))
    return hemm(H, R, grid) + th[None, :].to(R.dtype) * R


def lanczos_scan_pseudo(H: torch.Tensor, V0: torch.Tensor, *, m: int,
                        want_basis: bool = True, grid=None):
    """Batched Lanczos of the pseudo-Hermitian H in the M = S·H inner
    product (HPD for BSE), cpu/lanczos.hpp:330-510 in scaled form:
    β²_k = Re(v₁ᴴ S H v₁), α_k = Re(wᴴ S w) with w = H v₁.  On ``grid``
    H·v is ``dist.hemm`` and the S-weighted dots are summed over the
    grid's rows, so α and β are the same bits on every rank.

    Returns (alphas (m, nv), betas (m, nv), basis (m, N) of the last probe
    — this rank's rows on a grid — or None); the Ritz values of (alphas,
    betas[:-1]) approximate H's signed spectrum."""
    rt = real_dtype(H.dtype)
    one = torch.ones((), dtype=rt, device=H.device)
    row0, N = row_span(V0, grid)

    def s_dot(a, b):
        return col_dots(a, apply_s(b, row0, N), grid).real.to(rt)

    def scale(x, s):
        return x / s[None, :].to(x.dtype)

    v1 = V0.to(H.dtype)
    w = hemm(H, v1, grid)
    b = torch.sqrt(torch.abs(s_dot(v1, w)))
    safe = torch.where(b > 0, b, one)
    v1, w = scale(v1, safe), scale(w, safe)
    v0 = torch.zeros_like(v1)
    e_prev = torch.zeros((v1.shape[1],), dtype=rt, device=H.device)
    alphas, betas, basis = [], [], []
    for _ in range(m):
        alpha = s_dot(w, w)
        w2 = w - alpha[None, :].to(w.dtype) * v1 \
            - e_prev[None, :].to(w.dtype) * v0
        Hw = hemm(H, w2, grid)
        e_k = torch.sqrt(torch.abs(s_dot(w2, Hw)))
        safe = torch.where(e_k > 0, e_k, one)
        alphas.append(alpha)
        betas.append(e_k)
        if want_basis:
            basis.append(v1[:, -1])
        v0, v1, w, e_prev = v1, scale(w2, safe), scale(Hw, safe), e_k
    basis = torch.stack(basis) if want_basis else None
    return torch.stack(alphas), torch.stack(betas), basis


# -- pencil Rayleigh–Ritz ----------------------------------------------------

def _prr_project(H: torch.Tensor, V: torch.Tensor, locked: int,
                 grid=None):
    """Masked block Q (active columns [locked, K2 − locked)), W = H·Q and
    the pencil A = QᴴSHQ (+1 on padded slots), B = QᴴSQ (−1 there)."""
    K2 = V.shape[1]
    rt = real_dtype(V.dtype)
    row0, N = row_span(V, grid)
    cols = torch.arange(K2, device=V.device)
    active = (cols >= locked) & (cols < K2 - locked)
    Q = torch.where(active[None, :], V, torch.zeros((), dtype=V.dtype,
                                                    device=V.device))
    W = hemm(H, Q, grid)                       # H·Q (reused for residuals)
    pad = torch.where(active, torch.zeros((), dtype=rt, device=V.device),
                      torch.ones((), dtype=rt, device=V.device))
    A = inner(Q, apply_s(W, row0, N), grid) + torch.diag(pad).to(V.dtype)
    B = inner(Q, apply_s(Q, row0, N), grid) - torch.diag(pad).to(V.dtype)
    return Q, W, A, B


def _prr_finish(Q, W, V, theta, X, locked: int, want_vectors: bool = False,
                grid=None):
    """Rotate, residuals, roll the u = K2/2 − locked wanted pairs from
    [0, u) to [locked, locked + u), merge into V; with ``want_vectors``
    also the H-residual vectors, rolled alike (the H² ladder's seed)."""
    K2 = V.shape[1]
    u = K2 // 2 - locked
    Vrot = Q @ X
    Wrot = W @ X                               # = H·Vrot
    R = Wrot - Vrot * theta[None, :].to(V.dtype)
    resid = col_norms(R, grid).to(real_dtype(V.dtype))
    Vrot = torch.roll(Vrot, locked, dims=1)
    theta = torch.roll(theta, locked)
    resid = torch.roll(resid, locked)
    cols = torch.arange(K2, device=V.device)
    write = (cols >= locked) & (cols < locked + u)
    V_out = torch.where(write[None, :], Vrot, V)
    if want_vectors:
        return V_out, theta, resid, torch.roll(R, locked, dims=1)
    return V_out, theta, resid


def rayleigh_ritz_residuals_pseudo(H: torch.Tensor, V: torch.Tensor,
                                   locked: int, *, polish: int = 0,
                                   want_vectors: bool = False, grid=None):
    """Pseudo-Hermitian Rayleigh–Ritz (v2, Hermitianized pencil) fused
    with residuals, at the block's full width.

    V: (N, K2) block laid out [locked_L | active 2u | locked_R] with
    u = K2/2 − locked.  The pencil factorization — Cholesky of QᴴSHQ
    (``cholesky_ex``; ``ok`` from its info), M = −L⁻¹BL⁻ᴴ, eigh with
    ``polish`` Ogita–Aishima passes, the back-solve — runs in f64/c128.

    Returns (V_out, theta, resid, [R,] ok): V with columns [locked,
    locked + u) replaced by the positive Ritz vectors (ascending θ); theta
    and resid (K2,) in that layout; R the H-residual vectors (only with
    ``want_vectors``); ok False when the Cholesky broke down (L is then
    the identity, as in the JAX package).  On ``grid`` V is this rank's
    rows and the pencil is the same replicated K2×K2 problem on every
    rank.
    """
    *out, ok = pencil_rayleigh_ritz(H, V, locked, polish=polish,
                                    want_vectors=want_vectors, grid=grid)
    return (*out, bool(item(ok, "pseudo.rr_ok")))


def pencil_rayleigh_ritz(H: torch.Tensor, V: torch.Tensor, locked: int, *,
                         polish: int = 0, want_vectors: bool = False,
                         grid=None):
    """:func:`rayleigh_ritz_residuals_pseudo` with ``ok`` left on the
    device as a 0-d bool tensor (the fused solver reads no flag here)."""
    rt = real_dtype(V.dtype)
    Q, W, A, B = _prr_project(H, V, locked, grid)
    wide = torch.complex128 if A.is_complex() else torch.float64
    A, B = A.to(wide), B.to(wide)
    L, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0) & torch.isfinite(L).all()
    L = torch.where(ok, L, torch.eye(A.shape[0], dtype=wide,
                                     device=A.device))
    C = torch.linalg.solve_triangular(L, B, upper=False)
    C = torch.linalg.solve_triangular(L.mH, C, upper=True, left=False)
    M = -(C + C.mH) / 2                        # Hermitized −L⁻¹BL⁻ᴴ
    w, Z = eigh_polished(M, passes=polish)     # ascending
    w = w.real
    theta = -1.0 / torch.where(torch.abs(w) > 0, w, torch.ones_like(w))
    X = torch.linalg.solve_triangular(L.mH, Z, upper=True)
    nrm = torch.linalg.vector_norm(X, dim=0)
    X = X / torch.where(nrm > 0, nrm, torch.ones_like(nrm))[None, :].to(wide)
    out = _prr_finish(Q, W, V, theta.to(rt), X.to(V.dtype), locked,
                      want_vectors, grid)
    return (*out, ok)


def rayleigh_ritz_pseudo_geev(H, Q):
    """Reference pseudo Rayleigh–Ritz through the non-Hermitian quotient
    (the reference's v1 XGEEV path, cpu/rayleighRitz.hpp:146-250), in
    numpy: the independent cross-check of the pencil path.  Returns (theta
    ascending, Ritz vectors)."""
    Qn = Q.cpu().numpy() if isinstance(Q, torch.Tensor) else np.asarray(Q)
    Hn = H.cpu().numpy() if isinstance(H, torch.Tensor) else np.asarray(H)
    k = Hn.shape[0] // 2
    T = Hn @ Qn                                   # A·Q
    W = Qn.conj().T @ T                           # Qᴴ A Q
    M = -2.0 * (Qn[k:].conj().T @ Qn[k:])         # -2 Q₂ᴴQ₂
    diag = 1.0 / (1.0 + np.diagonal(M).copy())    # (Qᴴ S Q)⁻¹ diagonal
    np.fill_diagonal(M, 0.0)
    A = -(M @ W)                                  # (Diag - M)·W off-diag part
    Tf = T.copy()
    Tf[k:] *= -1                                  # S·A·Q
    A = A + Qn.conj().T @ Tf
    A = diag[:, None] * A                         # row-rescale by (QᴴSQ)⁻¹
    w, Z = np.linalg.eig(A)
    order = np.argsort(w.real)
    return w.real[order], Qn @ Z[:, order]


def residuals_pseudo(H: torch.Tensor, V: torch.Tensor, theta,
                     grid=None) -> torch.Tensor:
    """‖H v_j − θ_j v_j‖₂ per column (on ``grid``: V this rank's rows, the
    norms the same on every rank)."""
    th = torch.as_tensor(theta, device=V.device).to(V.dtype)
    R = hemm(H, V, grid) - V * th[None, :]
    return col_norms(R, grid).to(real_dtype(V.dtype))
