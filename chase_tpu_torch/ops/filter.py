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
  shrinks whenever a whole bucket of columns has retired;
* the deviation-form refinement filter of the precision ladder —
  :func:`refine_tables`, :func:`chebyshev_filter_refine`,
  :func:`refine_steps`, :func:`refine_combine` and the segmented
  :func:`refine_seg_init` / :func:`refine_seg_steps`.

H may be the ladder's reduced-precision shadow (``DenseOperator.H_low``):
the recurrence carry follows ``types.filter_carry_dtype`` (f32/c64 for an
f32/c64 shadow of an f64/c128 problem; X's own f32 for a bf16 shadow),
X is cast to it on entry and the result cast back.  Products are
``torch.matmul`` (cuBLAS on CUDA, at the precision
``config.set_matmul_precision`` selected); a bf16 H multiplies X rounded
to bf16 with f32 products and sums (:func:`_hemm_shift`).  Scalars (c, e,
σ) are computed with numpy in the carry's precision, mirroring the JAX
package's traced scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from ..perf import to_device
from ..types import filter_carry_dtype, numpy_scalar_type, real_dtype

__all__ = ["chebyshev_filter", "filter_seg_init", "filter_seg_steps",
           "refine_tables", "chebyshev_filter_refine", "refine_steps",
           "refine_combine", "refine_seg_init", "refine_seg_steps",
           "narrow_matmul"]


def narrow_matmul(H: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``H @ X`` for an H narrower than X (the bf16 rung: bf16 H, f32 X):
    X is rounded to H's dtype, the products (exact in f32) are summed in
    X's dtype — the JAX package's ``jnp.matmul(H, X.astype(H.dtype),
    preferred_element_type=X.dtype)``.  On CUDA one cuBLAS call
    (``torch.mm(..., out_dtype=)``; this product is XLA code in the JAX
    package, not a Pallas kernel); on the CPU the plain
    ``H.float() @ X.bfloat16().float()``."""
    Xn = X.to(H.dtype)
    if H.device.type == "cuda":
        return torch.mm(H, Xn, out_dtype=X.dtype)
    return H.to(X.dtype) @ Xn.to(X.dtype)


def _hemm_shift(H, X, c):
    """(H − c·I) @ X without touching H's diagonal; an H narrower than X
    goes through :func:`narrow_matmul`."""
    HX = narrow_matmul(H, X) if H.dtype != X.dtype else H @ X
    return HX - float(c) * X


def _mask(deg, device):
    return to_device(np.asarray(deg), "filter.mask", device=device)[None, :]


def _cheb_steps(H, Xp, Yc, deg, sigma, sigma1, c, e, t0: int, t1: int,
                shift):
    """Three-term steps t in [t0, t1) of the scaled recurrence; ``deg`` is
    the (1, w) degree mask, scalars are numpy scalars of the carry's real
    precision.  Returns (Xp, Yc, sigma)."""
    rt = type(sigma1)
    for t in range(int(t0), int(t1)):
        sigma_new = rt(1) / (rt(2) / sigma1 - sigma)
        Z = float(rt(2) * sigma_new / e) * shift(H, Yc, c) \
            + float(-sigma * sigma_new) * Xp
        Xp, Yc = Yc, torch.where(deg >= t, Z, Yc)
        sigma = sigma_new
    return Xp, Yc, sigma


def chebyshev_filter(H: torch.Tensor, X: torch.Tensor, degrees, lam1, lower,
                     upper, deg_max: int, *, shift=_hemm_shift
                     ) -> torch.Tensor:
    """Apply the degree-masked scaled Chebyshev filter to the window ``X``.

    Args:
      H: (N, N) operator, possibly the ladder's reduced-precision shadow;
        the recurrence runs in ``filter_carry_dtype(H, X)``.
      X: (N, w) window of the search subspace (problem dtype).
      degrees: (w,) per-column polynomial degrees; 0 = leave untouched.
      lam1: estimate of the smallest eigenvalue (amplification point).
      lower, upper: interval of the spectrum to damp.
      deg_max: max(degrees); loop trip count.
      shift: ``shift(H, X, c)`` = (op − c·I)·X for the filter's operator
        (H itself; ``ops/pseudo._h2_shift`` filters on H²).

    Returns: (N, w) filtered window in X's dtype (a new tensor).
    """
    carry = filter_carry_dtype(H.dtype, X.dtype)
    rt = numpy_scalar_type(carry)
    Xc = X.to(carry)
    lam1, lower, upper = rt(lam1), rt(lower), rt(upper)
    c = (upper + lower) / rt(2)
    e = (upper - lower) / rt(2)
    sigma1 = e / (lam1 - c)
    deg = _mask(degrees, X.device)

    # step 1: Y = (sigma1/e) (H - cI) X  (algorithm.inc:962-975)
    Y = float(sigma1 / e) * shift(H, Xc, c)
    Y = torch.where(deg >= 1, Y, Xc)
    _, Y, _ = _cheb_steps(H, Xc, Y, deg, sigma1, sigma1, c, e, 2,
                          int(deg_max) + 1, shift)
    # degree-0 (locked/padding) columns bit-exact: a reduced carry must
    # not round-trip untouched problem-dtype columns through it
    return torch.where(deg >= 1, Y.to(X.dtype), X)


def filter_seg_init(H: torch.Tensor, V: torch.Tensor, start: int, deg_win,
                    c, e, sigma1, *, w_pad: int, shift=_hemm_shift):
    """Copy the window [start, start + w_pad) out of V and run step 1.

    Returns (X0, Xp, Yc, sigma): the window's original columns, the two
    recurrence carries (``filter_carry_dtype(H, V)``) and σ1."""
    X0 = V[:, start:start + w_pad].clone()
    Xc = X0.to(filter_carry_dtype(H.dtype, V.dtype))
    Y = float(sigma1 / e) * shift(H, Xc, c)
    Y = torch.where(_mask(deg_win, V.device) >= 1, Y, Xc)
    return X0, Xc, Y, sigma1


def filter_seg_steps(H: torch.Tensor, V: torch.Tensor, X0, Xp, Yc, deg_win,
                     sigma, sigma1, c, e, off: int, start_new: int,
                     t0: int, t1: int, *, w_new: int, shift=_hemm_shift):
    """One segment: shrink the carries by ``off`` columns (0 = no
    shrink), run steps t in [t0, t1), write the masked window back into
    V's columns [start_new, start_new + w_new) in place.

    Returns (V, X0, Xp, Yc, sigma) at the new width."""
    if w_new != Xp.shape[1]:
        X0 = X0[:, off:off + w_new]
        Xp = Xp[:, off:off + w_new]
        Yc = Yc[:, off:off + w_new]
    deg = _mask(deg_win, V.device)
    Xp, Yc, sigma = _cheb_steps(H, Xp, Yc, deg, sigma, sigma1, c, e, t0, t1,
                                shift)
    # degree-0 (locked pad) columns bit-exact from the original window
    V[:, start_new:start_new + w_new] = torch.where(deg >= 1,
                                                    Yc.to(V.dtype), X0)
    return V, X0, Xp, Yc, sigma


# -- deviation-form refinement filter (the precision ladder) ----------------
#
# For any per-column scalar shift λ_j the deviation w_t = p_t(Hs)v_j −
# p_t(λs_j)v_j obeys the SAME three-term recurrence as p_t plus an additive
# injection a_t·p_{t−1}(λs_j)·(Hs−λs_j)v_j — exact algebra for any λ_j.
# With λ_j the column's Ritz value, (H−λ_j)v_j is the RR residual vector
# r_j, which RR computes in the problem precision.  Every intermediate of
# the w recurrence is then O(|p|·‖e_j‖) (e_j the eigenvector's current
# error), so running it in f32/c64 (or on a bf16 operator) adds noise
# proportional to the current error, not eps_low·‖H‖: the filter keeps
# contracting past the low-precision floor down to the problem
# precision's RR/QR floor.  The reference switches its filter back to DP
# once resid < 1e-3 (Impl/chase_cpu/chase_cpu.hpp:384-447); the ladder
# never leaves the fast dtype, and only RR's H·Q runs in the problem's.


def refine_tables(ritzv_act, degrees_act, lam1, lower, upper, max_deg):
    """Host-side (numpy, f64) coefficient tables for the deviation filter.

    Mirrors the scaled σ-recurrence of :func:`chebyshev_filter` exactly, so
    the refined filter applies the IDENTICAL polynomial — only the arithmetic
    decomposition differs.

    Returns:
      alpha1_e: σ1/e — scale of the w_1 = (σ1/e)·r init.
      alphas:  (max_deg+1,) per-step 2σ_t/e HEMM coefficients (rows < 2 unused).
      betas:   (max_deg+1,) per-step −σ_{t−1}σ_t coefficients.
      inj:     (max_deg+1, w) per-step injection 2σ_t·p_{t−1}(λs_j)/e applied
               to the UNSCALED residual r_j = (H−λ_j)v_j.
      p_final: (w,) f64 — p_{deg_j}(λs_j), the exact scalar multiplying v_j
               in the combine y_j = p_final_j·v_j + w_j.
    """
    ritzv_act = np.asarray(ritzv_act, np.float64)
    degrees_act = np.asarray(degrees_act)
    w = ritzv_act.shape[0]
    c = (upper + lower) / 2.0
    e = (upper - lower) / 2.0
    sigma1 = e / (lam1 - c)
    lams = (ritzv_act - c) / e
    alphas = np.zeros(max_deg + 1, np.float64)
    betas = np.zeros(max_deg + 1, np.float64)
    inj = np.zeros((max_deg + 1, w), np.float64)
    p_prev = np.ones(w, np.float64)            # p_0(λs) = 1
    p_cur = sigma1 * lams                      # p_1(λs) = σ1·λs
    p_final = np.where(degrees_act >= 1, p_cur, 1.0)
    sigma = sigma1
    # p_t keeps growing to max_deg for EVERY column (only steps t ≤ deg_j
    # are ever applied); deep-outside λ at high t can overflow f64 to inf —
    # those rows are degree-masked in the recurrence, so silence the noise
    with np.errstate(over="ignore", invalid="ignore"):
        for t in range(2, max_deg + 1):
            sigma_new = 1.0 / (2.0 / sigma1 - sigma)
            alphas[t] = 2.0 * sigma_new / e
            betas[t] = -sigma * sigma_new
            inj[t] = (2.0 * sigma_new / e) * p_cur
            p_new = 2.0 * sigma_new * lams * p_cur \
                - sigma * sigma_new * p_prev
            p_prev, p_cur = p_cur, p_new
            sigma = sigma_new
            p_final = np.where(degrees_act >= t, p_new, p_final)
    return sigma1 / e, alphas, betas, inj, p_final


def inj_table(inj, carry, device) -> torch.Tensor:
    """The injection table on ``device`` in the carry's real precision
    (entries past a column's degree may overflow to inf there; they are
    degree-masked)."""
    with np.errstate(over="ignore"):
        arr = np.asarray(inj, numpy_scalar_type(carry))
    return to_device(arr, "filter.inj_table", device=device)


def refine_steps(H, Wp, Wc, Rc, degrees, alphas, betas, inj, cc, t0, t1, *,
                 shift=_hemm_shift):
    """Deviation-recurrence steps t in [t0, t1) on a (possibly shrunk)
    window — the refine analogue of :func:`filter_seg_steps`.  ``alphas``
    and ``betas`` are the host tables, ``inj`` the device table of
    :func:`inj_table`, all sliced to the window's columns.  Returns (Wp,
    Wc)."""
    rt = numpy_scalar_type(Wc.dtype)
    ccf = float(rt(cc))
    deg = _mask(degrees, Wc.device)
    for t in range(int(t0), int(t1)):
        Z = float(rt(alphas[t])) * shift(H, Wc, ccf) \
            + float(rt(betas[t])) * Wp + inj[t][None, :] * Rc
        Wp, Wc = Wc, torch.where(deg >= t, Z, Wc)
    return Wp, Wc


def refine_combine(V, W, p_final, degrees):
    """y_j = p_final_j·v_j + w_j in the problem precision (deg-0 columns
    untouched) — the refine filter's epilogue, split out so the segmented
    path can write retired buckets back early."""
    pf = to_device(np.asarray(p_final), "filter.refine_combine",
                   dtype=real_dtype(V.dtype), device=V.device)
    Y = pf[None, :] * V + W.to(V.dtype)
    return torch.where(_mask(degrees, V.device) >= 1, Y, V)


def chebyshev_filter_refine(H, V, R, degrees, alpha1_e, alphas, betas, inj,
                            p_final, cc, deg_max, *, shift=_hemm_shift
                            ) -> torch.Tensor:
    """Deviation-form Chebyshev filter: y_j = p_final_j·v_j + w_j with the
    w recurrence in ``filter_carry_dtype(H, V)`` (see the note above).

    Args:
      H: (N, N) operator in the fast dtype (the problem's shadow).
      V: (N, w) current (post-RR) Ritz block in the problem dtype.
      R: (N, w) residual vectors H·v_j − λ_j·v_j, problem dtype.
      degrees: (w,) per-column degrees; 0 = untouched.
      alpha1_e, alphas, betas, inj, p_final: host tables (refine_tables).
      cc: filter interval center.
      deg_max: loop trip count.
      shift: the operator's shifted product, as for chebyshev_filter.

    Returns: (N, w) filtered block, problem dtype.
    """
    carry = filter_carry_dtype(H.dtype, V.dtype)
    rt = numpy_scalar_type(carry)
    Rc = R.to(carry)
    Wc = float(rt(alpha1_e)) * Rc                    # w_1 = (σ1/e)·r
    _, Wc = refine_steps(H, torch.zeros_like(Rc), Wc, Rc, degrees, alphas,
                         betas, inj_table(inj, carry, V.device), cc, 2,
                         int(deg_max) + 1, shift=shift)
    return refine_combine(V, Wc, p_final, degrees)


def refine_seg_init(H, V, R_win, start: int, alpha1_e):
    """Copy the V window [start, start + w) out, take its residual window
    ``R_win`` (N, w) in the carry dtype and seed w₁ = (σ1/e)·r.  ``H``
    only supplies the carry dtype.  Returns (X0, Wp, Wc, Rc)."""
    carry = filter_carry_dtype(H.dtype, V.dtype)
    X0 = V[:, start:start + R_win.shape[1]].clone()
    Rc = R_win.to(carry)
    Wc = float(numpy_scalar_type(carry)(alpha1_e)) * Rc
    return X0, torch.zeros_like(Wc), Wc, Rc


def refine_seg_steps(H, V, X0, Wp, Wc, Rc, deg_win, alphas, betas, inj,
                     p_final, cc, off: int, start_new: int, t0: int, t1: int,
                     *, w_new: int, shift=_hemm_shift):
    """One refine segment: shrink the carries by ``off`` columns, run the
    deviation steps [t0, t1), combine y = p_final·v + w and write it back
    into V's columns [start_new, start_new + w_new) in place.  ``inj`` and
    ``p_final`` arrive sliced to the window.  Returns (V, X0, Wp, Wc,
    Rc)."""
    if w_new != Wc.shape[1]:
        X0 = X0[:, off:off + w_new]
        Wp = Wp[:, off:off + w_new]
        Wc = Wc[:, off:off + w_new]
        Rc = Rc[:, off:off + w_new]
    Wp, Wc = refine_steps(H, Wp, Wc, Rc, deg_win, alphas, betas,
                          inj_table(inj, Wc.dtype, V.device), cc, t0, t1,
                          shift=shift)
    V[:, start_new:start_new + w_new] = refine_combine(X0, Wc, p_final,
                                                       deg_win)
    return V, X0, Wp, Wc, Rc
