"""Device-resident fused pseudo-Hermitian (BSE) solver.

Port of ``chase_tpu/fused_pseudo.py::solve_pseudo_fused``: the S-metric
Lanczos, the H² DoS bounds and the filter_H2 → K-conjugation → S-QR →
pencil RR → locking-v3 loop with every piece of solver state a tensor on
the device, read by the host as :mod:`.fused` says (one packed control
tensor, the CholQR ``ok`` flag, the pencil ``eigh``'s own check).

The block is laid out [L | positives | mirrors | R]: its first half (k =
nev + nex columns) holds exactly the locked-left and positive-candidate
columns, so the H² filter runs at half the width, and the mirrors are
regenerated by K-conjugation after the filter and after locking — without
that the pencil turns indefinite.  The filter runs on a degree-sorted
two-window view that is undone right after; the cluster-aware degrees are
vectorised.

As in the port's host driver, the K2×K2 pencil (Cholesky, solves,
``eigh``, back-solve) runs in f64/c128 for every problem (``ops/pseudo``;
the JAX fused version factors in the problem precision), SP problems
factor their S-QR in f64/c128 with ``qr_hi_prec``, and where ``chunk``
routes an f32, c64 or bf16 operator to the kernel both products of every
H² step run on ``ring_hemm``.  ``small_dense="host"`` is not ported.

On a process grid everything :mod:`.fused` says holds, and S acts on
global rows: the S-QR's flip takes the block's first global row, the
mirrors come from a rotation of the candidate columns' rows by N/2 across
ranks (``Grid2D.rotate_rows``), the S-Lanczos and the pencil sum over the
grid's rows (``ops/pseudo``), and the H²-residual's product is
``dist.hemm``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fused import (FilterProducts, cheb_rho, control, eigh_tridiag_batched,
                    gather0, gram_qr, deviation_filter, two_window_filter)
from .ops import pseudo as ps
from .ops.qr import _rows
from .parallel.dist import hemm, rotate_rows
from .types import is_double_base, low_precision_dtype, real_dtype

__all__ = ["solve_pseudo_fused"]


def _k_conj(V, locked: int, count, cols2, width: int, grid=None):
    """Mirror columns [locked, locked + count) into [K2 − locked − count,
    K2 − locked) as K x = conj([x_lower; x_upper]), materialised;
    ``count`` ≤ ``width`` may be an int or a 0-d device tensor.  The rows
    of the ``width`` columns from ``locked`` rotate by N/2 (across ranks
    on ``grid``)."""
    K2 = V.shape[1]
    wmask = (cols2 >= K2 - locked - count) & (cols2 < K2 - locked)
    src_col = torch.where(wmask, cols2 - (K2 - 2 * locked - count), cols2)
    R = rotate_rows(V[:, locked:locked + width], _rows(V, grid) // 2, grid)
    Ks = torch.conj_physical(R.index_select(1, torch.clamp(
        src_col - locked, 0, width - 1)))
    return torch.where(wmask[None, :], Ks, V)


def _h2_dos(theta, tau, N, nev, nex):
    """The Ritz value where the S-Lanczos's broadened DoS crosses (N/2 −
    nev − nex − 1)/N (0-d tensor)."""
    nv, m = theta.shape
    tf = theta.reshape(-1)
    wf = tau.reshape(-1)
    ts = torch.sort(tf).values
    sigma = 0.25
    thresh = 2 * sigma * sigma / 10
    search = min(max((N / 2 - nev - nex - 1) / N, 0.0), 1.0)
    x = ts[:, None] - tf[None, :]
    g = 0.5 * (1 + torch.special.erf(x / np.sqrt(2 * sigma * sigma)))
    contrib = torch.where(x > thresh, torch.ones_like(x),
                          torch.where(x < -thresh, torch.zeros_like(x), g))
    cdf = (contrib * wf[None, :]).sum(dim=1) / nv
    crossed = cdf > search
    i = torch.argmax(crossed.to(torch.int8))
    im1 = torch.clamp(i - 1, min=0)
    prev = torch.where(i > 0, gather0(cdf, im1), torch.zeros_like(ts[0]))
    take_i = (gather0(cdf, i) - search).abs() < (prev - search).abs()
    lam_nn = torch.where(take_i, gather0(ts, i), gather0(ts, im1))
    return torch.where(crossed.any(), lam_nn, ts[-1])


def _degrees_h2(ritzv, resid, resid_last, active, colsk, locked, nex,
                b_sup, lower, tol, max_deg, deg_extra, is_sp, cluster_aware):
    """Vectorised calc_degrees_pseudo_H2 over the first half: λ²-based
    degrees with the cluster, stagnation and near-zero bonuses on the
    examined columns only (the nex tail keeps factor 1)."""
    k = ritzv.shape[0]
    c_h2 = (b_sup + lower) / 2
    e_h2 = (b_sup - lower) / 2
    rho = cheb_rho((ritzv ** 2 - c_h2)
                   / torch.where(e_h2 > 0, e_h2, torch.ones_like(e_h2)))
    val = torch.clamp(torch.abs(torch.log(resid / tol) / torch.log(rho)),
                      max=float(max_deg))
    d = torch.where(torch.isfinite(val) & (rho > 1), torch.ceil(val),
                    float(max_deg)).to(torch.int64)
    if cluster_aware:
        r = resid
        nexam = torch.clamp(k - locked - nex, min=1)
        exam = active & (colsk < locked + nexam)
        mean_r = torch.where(exam, r, 0.0).sum() / nexam
        wgt = torch.clamp(1.0 + torch.log(1.0 + r / (mean_r + 1e-14)),
                          max=2.5)
        dist = (ritzv[:, None] - ritzv[None, :]).abs()
        near = (dist < (b_sup - lower).abs() * 1e-6) & exam[None, :] \
            & exam[:, None] & ~torch.eye(k, dtype=torch.bool,
                                         device=ritzv.device)
        dens = torch.where(near, wgt[None, :] / (dist + 1e-14), 0.0).sum(1)
        nn = near.sum(1)
        spatial = torch.where(nn > 0, 1.0 + torch.log(1.0 + dens * 0.1),
                              torch.ones_like(dens))
        fac = spatial * wgt
        fac = torch.where((nn > 2) & (r > 2.0 * mean_r), fac * 1.2, fac)
        fac = torch.where(r > 10.0 * tol, fac * 1.15, fac)
        fac = torch.where(exam, torch.clamp(fac, 0.5, 3.0), 1.0)
        d = (d * fac).to(torch.int64)
        stag = (r <= 10.0 * tol) & ((r - resid_last).abs() / (r + 1e-14)
                                    < 0.1)
        d = torch.where(stag, d + 6, d)
        d = torch.where(ritzv.abs() < (b_sup - lower).abs() * 0.1, d + 2, d)
    d = torch.clamp(d + deg_extra, max=max_deg)
    if is_sp:
        d = torch.clamp(d, min=8)
    d = d + d % 2
    return torch.where(active, d, 0)


def solve_pseudo_fused(H, V0, *, nev, nex, tol, deg0, max_deg, deg_extra=2,
                       max_iter=25, lanczos_iter=25, num_lanczos=4,
                       optimization=True, cluster_aware=True,
                       cholqr_passes=3, cond_shift_threshold=1e8,
                       inject_dos=True, probes=None, eigh_polish=0,
                       bf16_filter=False, bf16_threshold=1e-2,
                       refine_filter=False, qr_hi_prec=True, H_low=None,
                       chunk=None, grid=None) -> dict:
    """Device-resident BSE solve.

    Args:
      H: (N, N) pseudo-Hermitian (BSE-structured) tensor, N even; on
        ``grid`` this rank's block.
      V0: (N, 2·(nev+nex)) starting block (lower rows damped by the
        caller, or a warm start); on ``grid`` this rank's rows.
      bf16_filter: real f32 problems — far from convergence both products
        of each H² step run on the bf16 shadow (f32 carry and sums).
      refine_filter: the BSE DP ladder — from iteration 1 the H² filter
        runs the deviation-form recurrence on the shadow seeded by the
        H²-residuals (H + θ)·r of the pencil RR's residual vectors;
        iteration 0 multiplies on the shadow with the carry in the
        problem dtype.
      H_low, chunk, qr_hi_prec, probes, grid: as for
        ``fused.solve_fused``.

    Returns a dict: V (N, 2k), ritzv (2k,), resid (2k,), locked,
    iterations, lowerb, upperb, filtered_vecs, filtered_low (the part
    filtered on the shadow), block_history, resid_history, early_history
    and hemm_steps (both products of every
    H² step counted).
    """
    N = _rows(H, grid)
    row0 = ps.row_span(V0, grid)[0]
    k = nev + nex
    K2 = 2 * k
    pdt = H.dtype
    rt = real_dtype(pdt)
    is_sp = not is_double_base(pdt)
    dev = H.device
    tol = float(tol)
    cols2 = torch.arange(K2, device=dev)
    colsk = cols2[:k]
    big = float(torch.finfo(rt).max) / 4
    use_bf16_rung = bool(bf16_filter) and is_sp and not pdt.is_complex
    use_refine = bool(refine_filter) and not is_sp
    low_dt = low_precision_dtype(pdt)
    if (use_bf16_rung or use_refine) and H_low is None:
        H_low = H.to(low_dt)
    prod = FilterProducts(chunk, grid)
    upcast = None
    if qr_hi_prec and is_sp:
        upcast = torch.complex128 if pdt.is_complex else torch.float64

    def gram(V, shift_on):
        return gram_qr(V, shift_on, passes=cholqr_passes, upcast=upcast,
                       equilibrate=False, grid=grid)[0]

    # ---- init + S-Lanczos + H² bounds ---------------------------------------
    V = gram(V0.to(pdt), None)
    mm = min(k, N // 2, lanczos_iter)
    m = max(2, mm - mm % 2)
    nv = probes.shape[1] if probes is not None else min(num_lanczos, k)
    P = V[:, :nv] if probes is None else probes.to(pdt)
    alphas, betas, basis = ps.lanczos_scan_pseudo(H, P, m=m, want_basis=True,
                                                  grid=grid)
    theta, tvecs = eigh_tridiag_batched(alphas, betas[:-1])
    tau = tvecs[:, 0, :].abs() ** 2
    abs_t = theta.abs()
    b_sup = abs_t.max() ** 2
    mu_1 = abs_t.min() ** 2
    lam_nn = _h2_dos(theta, tau, N, nev, nex)
    mu_nevnex = lam_nn ** 2

    if inject_dos:
        theta_last = theta[-1]
        exceeds = theta_last > lam_nn
        first = torch.argmax(exceeds.to(torch.int8))
        idx = torch.where(exceeds.any(), torch.clamp(first - 1, min=0),
                          torch.full_like(first, m))
        idx = torch.clamp(idx, max=k - 1)
        dmask = torch.arange(m, device=dev) < idx
        Vd = basis.T @ (tvecs[-1] * dmask[None, :]).to(pdt)
        V[:, :m] = torch.where(dmask[None, :], Vd, V[:, :m])

    lambda_1 = mu_1
    lower = mu_nevnex
    ritzv = torch.sqrt(mu_1).expand(K2).clone()
    resid = torch.full((K2,), big, dtype=rt, device=dev)
    resid_last = resid.clone()
    degrees = torch.full((K2,), min(deg0 + deg0 % 2, max_deg),
                         dtype=torch.int64, device=dev)
    Rv = torch.zeros_like(V) if use_refine else None
    locked = torch.zeros((), dtype=torch.int64, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    new_mu = torch.sqrt(mu_nevnex)
    filtered = torch.zeros((), dtype=torch.int64, device=dev)
    filtered_low = torch.zeros((), dtype=torch.int64, device=dev)
    blk_hist = torch.zeros(max_iter, dtype=torch.int64, device=dev)
    r_hist = torch.full((max_iter, k), -1.0, dtype=rt, device=dev)
    e_hist = torch.full((max_iter, k), -1.0, dtype=rt, device=dev)
    khalf = k // 2

    # ---- main loop ----------------------------------------------------------
    while True:
        active_k = colsk >= locked
        nm2 = new_mu * new_mu
        lower_n = torch.where((it > 0) & (nm2 < lower) & (nm2 > lambda_1),
                              nm2, lower)
        kept = torch.where(active_k, degrees[:k], 0)
        if optimization:
            deg_k = torch.where(it > 0, _degrees_h2(
                ritzv[:k], resid[:k], resid_last[:k], active_k, colsk,
                locked, nex, b_sup, lower_n, tol, max_deg, deg_extra, is_sp,
                cluster_aware), kept)
        else:
            deg_k = kept
        dmax = deg_k.max()
        dmid = torch.minimum(torch.clamp(
            torch.sort(deg_k).values[khalf - 1], min=1), dmax)
        low_phase = torch.zeros((), dtype=torch.bool, device=dev)
        if use_bf16_rung:
            min_wanted = torch.where(active_k & (colsk < nev), resid[:k],
                                     big).min()
            spec = torch.sqrt(torch.clamp(b_sup, min=0))
            low_phase = min_wanted > bf16_threshold * spec
        cont = (locked < nev) & (it < max_iter)
        # host read 1: the loop condition and the filter's bounds
        cont_h, it_h, locked_h, dmax_h, dmid_h, low_h = control(
            cont, it, locked, dmax, dmid, low_phase)
        if grid is not None:
            grid.check_peers()
        if not cont_h:
            break
        lower = lower_n
        u = k - locked_h
        filtered = filtered + 2 * deg_k.sum()   # two products per H² step
        if (use_bf16_rung and low_h) or use_refine:   # filtered on H_low
            filtered_low = filtered_low + 2 * deg_k.sum()
        blk_hist[it_h] = k - locked     # a tensor: a Python int is a copy

        # -- H² filter on the first half (static half width) --
        c = (b_sup + lower) / 2
        e = (b_sup - lower) / 2
        e = torch.where(e > 0, e, (b_sup - lower).abs() / 2 + 1e-30)
        sigma1 = e / (lambda_1 - c)
        Vh = V[:, :k]

        def run_filter(h2):
            return two_window_filter(h2, Vh, deg_k, khalf, dmid_h, dmax_h,
                                     sigma1, e)

        if use_bf16_rung and low_h:
            Yf = run_filter(lambda X: prod(H_low, prod(H_low, X)) - c * X)
        elif use_refine and it_h > 0:
            # ONE problem-precision product turns the pencil RR's
            # H-residuals into H²-residuals r2 = (H + θ)·r
            Rh = Rv[:, :k]
            R2 = hemm(H, Rh, grid) + ritzv[:k][None, :].to(pdt) * Rh
            cl = c.to(real_dtype(low_dt))
            Yf = deviation_filter(
                lambda W: prod(H_low, prod(H_low, W)) - cl * W, Vh,
                R2.to(low_dt), (ritzv[:k] ** 2 - c) / e, deg_k, dmax_h,
                sigma1, e)
        elif use_refine:
            # iteration 0: the plain H² recurrence with both products on
            # the shadow, the carry in the problem dtype
            Yf = run_filter(lambda X: prod(
                H_low, prod(H_low, X.to(low_dt))).to(pdt) - c * X)
        else:
            Yf = run_filter(lambda X: prod(H, prod(H, X)) - c * X)
        V[:, :k] = Yf
        V = _k_conj(V, locked_h, u, cols2, u, grid)  # regenerate mirrors

        # -- cond → QR shift flag (squared space) --
        t_1 = (lambda_1 - c) / e
        t_k = (ritzv[locked_h] ** 2 - c) / e if it_h > 0 else t_1
        dmin = torch.where(active_k, deg_k, max_deg + 2).min()
        logcond = dmin * torch.log(cheb_rho(t_k)) \
            + (dmax - dmin) * torch.log(cheb_rho(t_1))
        shift_on = logcond > math.log(cond_shift_threshold)

        # -- S-QR: [L | act | R] → [L | R | act], the locked columns'
        # lower halves negated, CholQR, locked columns restored, undone --
        L2 = 2 * locked_h
        perm_to = torch.cat([torch.arange(locked_h, device=dev),
                             torch.arange(K2 - locked_h, K2, device=dev),
                             torch.arange(locked_h, K2 - locked_h,
                                          device=dev)])
        Vp = V.index_select(1, perm_to)
        Q = gram(ps.flip_locked_cols(Vp, L2, row0, N), shift_on)
        Q[:, :L2] = Vp[:, :L2]
        V = Q.index_select(1, torch.argsort(perm_to))

        # -- pencil RR + residuals (host read 3: the pencil's eigh) --
        V, th, rs, *Rnew, _ok = ps.pencil_rayleigh_ritz(
            H, V, locked_h, polish=eigh_polish, want_vectors=use_refine,
            grid=grid)
        active2 = (cols2 >= locked_h) & (cols2 < k)
        if use_refine:
            Rv = torch.where(active2[None, :], Rnew[0], Rv)
        ritzv = torch.where(active2, th, ritzv)
        resid = torch.where(active2, rs, resid)
        r_hist[it_h] = torch.where(active_k, resid[:k], -1.0)

        # -- bound refresh from the sorted active θ --
        srt = torch.sort(torch.where(active_k, ritzv[:k], big)).values
        new_mu = srt[max((u * 95) // 100 - 1, 0)]

        # -- locking v3 (index order, stable group sort) --
        exam = active_k & (colsk < k - nex)
        r_k = resid[:k]
        stag = (r_k > tol) & (r_k >= resid_last[:k]) & (r_k <= 1000.0 * tol)
        if it_h < 4:
            stag = torch.zeros_like(stag)
        conv = exam & ((r_k <= tol) | stag)
        e_hist[it_h] = torch.where(exam & stag & (r_k > tol), r_k, -1.0)
        group = torch.where(colsk < locked_h, 0, torch.where(conv, 1, 2))
        perm_k = torch.argsort(group, stable=True)
        V = V.index_select(1, torch.cat([perm_k, cols2[k:]]))
        if use_refine:
            Rv = Rv.index_select(1, torch.cat([perm_k, cols2[k:]]))
        rp = r_k[perm_k]
        ritzv = torch.cat([ritzv[:k][perm_k], ritzv[k:]])
        resid = torch.cat([rp, resid[k:]])
        resid_last = torch.cat([rp, resid_last[k:]])     # v3 semantics
        degrees = torch.cat([deg_k[perm_k], degrees[k:]])
        nc = conv.sum()
        # mirror the newly locked pairs into the right-end locked region
        V = _k_conj(V, locked_h, nc, cols2, u, grid)
        locked = locked_h + nc
        it = it + 1

    # ---- final: positive ascending first over the first k entries ----------
    vals = ritzv[:k]
    by_val = torch.argsort(vals, stable=True)
    order = by_val[torch.argsort((vals[by_val] <= 0).to(torch.int8),
                                 stable=True)]
    order2 = torch.cat([order, cols2[k:]])
    return {"V": V.index_select(1, order2),
            "ritzv": torch.cat([vals[order], ritzv[k:]]),
            "resid": torch.cat([resid[:k][order], resid[k:]]),
            "locked": locked, "iterations": it, "lowerb": lower,
            "upperb": b_sup, "filtered_vecs": filtered,
            "filtered_low": filtered_low, "block_history": blk_hist, "resid_history": r_hist,
            "early_history": e_hist, "hemm_steps": prod.steps}
