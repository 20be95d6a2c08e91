"""Device-resident fused Hermitian solver.

Port of ``chase_tpu/fused.py::solve_fused``.  The JAX version runs the
whole solve — Lanczos, the DoS bounds, the degrees → filter → QR → RR →
locking loop and the final sort — as one XLA program under
``lax.while_loop``.  PyTorch runs eagerly, so here the loop is a Python
loop, but every piece of solver state (V, the residual block, the Ritz
values, residuals, degrees, ``locked``, the iteration count, ``lowerb``,
the counters and histories) stays a tensor on the device and the
bookkeeping is tensor code: vectorised degrees, the stable group-sort
locking, the degree-sorted two-window filter.  The host reads, per
iteration, exactly:

1. one packed control tensor (the loop condition, the iteration count,
   ``locked``, ``dmax``, the bf16 rung's ``low_phase`` and each phase
   tier's ``dmid``), which gives the filter's loop bounds and branch;
2. the CholQR ``ok`` flag before the Householder rescue;
3. the sync ``torch.linalg.eigh`` does itself to check cuSOLVER's info.

The documented deltas against the host driver are the JAX package's
(``fused.py:13-25``): locking by a stable converged-first group sort, the
DoS start vectors without interspersing, shifted CholQR with a Householder
rescue in place of the three-way selection, the two-window filter on a
degree-sorted view undone on exit.

The port's own rules hold here too: the projected k×k eigensolve runs in
f64/c128 (``ops/rr``), SP problems factor their QR in f64/c128 with
``qr_hi_prec``, and every filter product that ``chunk`` routes to the
kernel (f32, c64 or bf16 operators) runs on ``ring_hemm``
(:class:`FilterProducts`) where the JAX version calls ``jnp.matmul`` with
the same polynomial.  The
ladder's shadow is the caller's ``H_low`` (``DenseOperator.H_low``).  Not
ported: the ``wide_rr`` mode and ``small_dense="host"`` (TPU workarounds).

On a process grid (``grid=``: H this rank's block of ``P('r', 'c')``, V
its rows of ``P('r', None)``) the products are ``parallel/dist.hemm`` —
on a (p, 1) grid, where ``chunk`` routes them to the kernel, the p-step
chunk ring on it — and
every Gram, projection, Lanczos dot and residual norm is summed over the
grid's rows bitwise equal on every rank (``dist.inner``, ``col_norms``),
so the k×k problems, the degrees, the control tensor, the CholQR ``ok``
and ``eigh``'s info are the same bits everywhere: the host still reads
three times per iteration and every rank takes the same branch.  The
Householder rescue is the distributed ``ops/qr.tsqr``; column
permutations need no collective.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops import lanczos as lz
from .ops import rr as rrops
from .ops.qr import _rows, tsqr
from .parallel.dist import hemm, inner
from .perf import QR_FALLBACK, count, host_sync, item, to_host
from .types import eps, is_double_base, low_precision_dtype, real_dtype

__all__ = ["solve_fused", "FilterProducts", "gram_qr", "cheb_rho",
           "eigh_tridiag_batched", "two_window_filter", "deviation_filter",
           "control", "gather0"]


def gather0(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 1-D x and a 0-d device index, without the host read
    that indexing with a 0-d tensor does."""
    return x.gather(0, i.reshape(1)).reshape(())


def control(*values) -> list:
    """Host read: one packed transfer of the loop's scalar tensors (bools
    and ints), returned as Python ints."""
    return to_host(torch.stack([v.to(torch.int64) for v in values]),
                   "fused.control").tolist()


def eigh_tridiag_batched(alphas, betas_off):
    """Batched eigh of the (m×m) Lanczos tridiagonals. alphas: (m, nv),
    betas_off: (m − 1, nv).  Returns (w (nv, m), Q (nv, m, m))."""
    T = torch.diag_embed(alphas.T)
    if alphas.shape[0] > 1:
        T = T + torch.diag_embed(betas_off.T, offset=1) \
            + torch.diag_embed(betas_off.T, offset=-1)
    host_sync("fused.eigh_tridiag")   # eigh reads cuSOLVER's info
    return torch.linalg.eigh(T)


def _dos_bounds(theta, tau, betas_last, nevex, N):
    """Gaussian-broadened DoS quantile on the device (algorithm.inc:
    1096-1145): (λ_min, lowerb, upperb) as 0-d tensors."""
    nv, m = theta.shape
    n = nv * m
    tf = theta.reshape(-1)
    wf = tau.reshape(-1)
    ts = torch.sort(tf).values
    lam = ts[0]
    sigma = 0.25
    thresh = 2 * sigma * sigma / 10
    search = nevex / N
    x = ts[:, None] - tf[None, :]
    g = 0.5 * (1 + torch.special.erf(x / np.sqrt(2 * sigma * sigma)))
    contrib = torch.where(x > thresh, torch.ones_like(x),
                          torch.where(x < -thresh, torch.zeros_like(x), g))
    cdf = (contrib * wf[None, :]).sum(dim=1) / nv
    crossed = cdf > search
    i = torch.argmax(crossed.to(torch.int8))          # first crossing
    prev = torch.where(i > 0, gather0(cdf, torch.clamp(i - 1, min=0)),
                       torch.zeros_like(lam))
    take_next = ((gather0(cdf, i) - search).abs() < (prev - search).abs()) \
        & (i + 1 < n)
    lowerb = torch.where(take_next,
                         gather0(ts, torch.clamp(i + 1, max=n - 1)),
                         gather0(ts, i))
    lowerb = torch.where(crossed.any(), lowerb, ts[-1])
    upperb = (torch.maximum(theta[:, 0].abs(), theta[:, -1].abs())
              + betas_last.abs()).max()
    return lam, lowerb, upperb


def cheb_rho(t: torch.Tensor) -> torch.Tensor:
    """Chebyshev ellipse radius max|t ± √(t² − 1)| (complex-safe)."""
    z = t.to(torch.complex64 if t.dtype == torch.float32
             else torch.complex128)
    s = torch.sqrt(z * z - 1)
    return torch.maximum((z - s).abs(), (z + s).abs())


def _tier_offsets(k: int, tiers: int):
    """Static phase-window tiers: right-aligned windows [off, k) that the
    loop runs filter, QR and RR on once ``locked ≥ off`` (the in-graph
    analogue of the host driver's window shrink).  Offsets are aligned to
    64 columns (k ≥ 512) or 8.  The same integers as the JAX version."""
    if tiers <= 1:
        return [0]
    fr = {2: (0.5,), 3: (0.5, 0.75)}.get(tiers, (0.25, 0.5, 0.75))
    align = 64 if k >= 512 else 8
    offs = [0]
    for f in fr:
        o = (int(k * f) // align) * align
        if o > offs[-1] and k - o >= align:
            offs.append(o)
    return offs


class FilterProducts:
    """The fused filters' products H·X.  ``chunk(H, grid)`` is the host
    solvers' product of a filter step (``parallel/ring.filter_product``
    bound to the solve's route and backend).  The fused solvers have no
    ring of their own, as the JAX package's have none: they take that
    product only where it is the ``ring_hemm`` kernel's v ↦ H·v — one
    call on one device, one ``ring_hemm_peers`` call on a (p, 1) CUDA
    grid, the p-step chunk ring with the grid's exchange on a (p, 1) CPU
    grid — and never on an r×c grid; every other product (``chunk``
    None too) is ``dist.hemm``: the local product (``narrow_matmul`` for
    the bf16 shadow) with the grid's collectives.  ``steps`` counts every
    call: the solver's HEMM-step counter, which equals the kernel's main
    launches per rank on the card when every filter operator takes the
    kernel (``ring_hemm`` on one device, ``ring_hemm_peers`` on a (p, 1)
    grid), and p times as many ``ring_hemm`` steps on a CPU grid."""

    def __init__(self, chunk=None, grid=None):
        two_d = grid is not None and grid.size("r") > 1 \
            and grid.size("c") > 1
        self.chunk = None if two_d else chunk
        self.grid = grid
        self.steps = 0

    def __call__(self, H: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        self.steps += 1
        prod = self.chunk(H, self.grid) if self.chunk is not None else None
        if prod is not None and prod.kernel:
            # the kernel reads row-major windows; torch.linalg may hand
            # back column-major blocks
            return prod.hemm(X if X.stride(1) == 1 else X.contiguous())
        return hemm(H, X, self.grid)


def _cholqr_pass(Q, shift_on, *, equilibrate: bool, grid=None):
    """One CholQR round: Gram (column-equilibrated when ``equilibrate``),
    a diagonal shift where the device bool ``shift_on`` is set (None: no
    shift), ``cholesky_ex`` with ``ok`` kept on the device, and the
    triangular solve (identity factor where the Cholesky failed, so the
    result stays finite).  Returns (Q, ok)."""
    G = inner(Q, Q, grid)
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    d = None
    if equilibrate:
        d = torch.sqrt(torch.abs(torch.diagonal(G).real))
        d = torch.where(d > 0, d, torch.ones_like(d))
        G = G / (d[:, None] * d[None, :]).to(G.dtype)
    if shift_on is not None:
        nrmf = torch.sum(torch.abs(torch.diagonal(G).real))
        coef = (math.sqrt(_rows(Q, grid)) if is_double_base(G.dtype)
                else 10.0)
        shift = torch.where(shift_on, coef * eps(G.dtype) * nrmf,
                            torch.zeros_like(nrmf))
        G = G + shift.to(G.dtype) * eye
    L, info = torch.linalg.cholesky_ex(G)
    ok = (info == 0) & torch.isfinite(L).all()
    L = torch.where(ok, L, eye)
    if d is not None:
        Q = Q / d[None, :].to(Q.dtype)
    return torch.linalg.solve_triangular(L.mH, Q, upper=True,
                                         left=False), ok


def gram_qr(V, shift_on, *, passes: int = 3, upcast=None,
            equilibrate: bool = True, rescue: bool = True, grid=None):
    """``passes`` CholQR rounds (the shift only on round 0), computed in
    ``upcast`` when given, then — with ``rescue`` — Householder QR where
    any round failed (``tsqr`` on ``grid``).  Returns (Q in V's dtype,
    ok)."""
    Q = V if upcast is None else V.to(upcast)
    ok = None
    for p in range(max(int(passes), 1)):
        Q, o = _cholqr_pass(Q, shift_on if p == 0 else None,
                            equilibrate=equilibrate, grid=grid)
        ok = o if ok is None else ok & o
    # host read 2: the CholQR ok flag before the Householder rescue
    if rescue:
        if not bool(item(ok, "fused.gram_qr")):
            count(QR_FALLBACK + "householder")
            Q = tsqr(Q, grid=grid)
    return Q.to(V.dtype), ok


def _degrees(ritzv, resid, active, cols, upperb, lowerb, tol, nex, max_deg,
             deg_extra, is_sp):
    """Vectorised calc_degrees (no sort): per-column degrees, the nex tail
    copying the last examined column's, even, 0 on locked columns."""
    k = ritzv.shape[0]
    c = (upperb + lowerb) / 2
    e = (upperb - lowerb) / 2
    rho = cheb_rho((ritzv - c) / e)
    val = torch.abs(torch.log(resid / tol) / torch.log(rho))
    # cap in float before the int cast: a finite val past 2^31 (rho ~ 1)
    # would wrap to a negative degree
    val = torch.clamp(val, max=float(max_deg))
    d = torch.where(torch.isfinite(val), torch.ceil(val),
                    float(max_deg)).to(torch.int64)
    if is_sp:
        d = torch.clamp(d, min=8)
    d = torch.clamp(d + deg_extra, max=max_deg)
    d = torch.where(cols >= k - nex, d[k - nex - 1], d)
    d = d + d % 2
    return torch.where(active, d, 0)


def two_window_filter(shift, V, degrees, khalf: int, dmid: int, dmax: int,
                      sigma1, e):
    """The scaled Chebyshev recurrence with per-column degrees on the
    window V viewed ascending by degree (stable: degree-0 columns stay in
    front): after the left half's largest degree ``dmid`` the steps run
    on the right half (from column ``khalf``) only, up to ``dmax``.  The
    view is undone on exit, because locking pairs resid and resid_last by
    position.  ``shift(X)`` is (op − c)·X; σ1 and e are 0-d tensors."""
    dperm = torch.argsort(degrees, stable=True)
    deg_sorted = degrees[dperm]
    Vin = V.index_select(1, dperm)

    def steps(Xp, Yc, sig, degs, t0, t1):
        for t in range(t0, t1):
            sig_new = 1.0 / (2.0 / sigma1 - sig)
            Z = (2.0 * sig_new / e) * shift(Yc) - (sig * sig_new) * Xp
            Xp, Yc, sig = Yc, torch.where(degs[None, :] >= t, Z, Yc), sig_new
        return Xp, Yc, sig

    Y = torch.where(deg_sorted[None, :] >= 1, (sigma1 / e) * shift(Vin), Vin)
    Xp, Yc, sig = steps(Vin, Y, sigma1, deg_sorted, 2, dmid + 1)
    _, Yr, _ = steps(Xp[:, khalf:], Yc[:, khalf:], sig, deg_sorted[khalf:],
                     dmid + 1, dmax + 1)
    return torch.cat([Yc[:, :khalf], Yr], dim=1) \
        .index_select(1, torch.argsort(dperm))


def deviation_filter(shift_low, V, Rc, lams, degrees, dmax: int, sigma1, e):
    """The deviation-form filter y = p(λ)·v + w: the w recurrence runs in
    Rc's (the shadow's) precision, ``shift_low(W)`` = (op_low − c)·W, seeded
    by the residual block Rc; the coefficient tables (2σ/e, −σσ', the
    injection 2σ'·p_{t−1}(λ)/e and p_deg(λ)) are built step by step in the
    problem precision at the expansion points ``lams`` (scaled)."""
    low_rt = real_dtype(Rc.dtype)
    p_prev = torch.ones_like(lams)
    p_cur = sigma1 * lams
    p_fin = torch.where(degrees >= 1, p_cur, p_prev)
    Wc = (sigma1 / e).to(low_rt) * Rc
    Wp = torch.zeros_like(Wc)
    sig = sigma1
    for t in range(2, dmax + 1):
        sig_new = 1.0 / (2.0 / sigma1 - sig)
        al = (2.0 * sig_new / e).to(low_rt)
        be = (-sig * sig_new).to(low_rt)
        inj = ((2.0 * sig_new / e) * p_cur).to(low_rt)
        p_new = 2.0 * sig_new * lams * p_cur - sig * sig_new * p_prev
        p_fin = torch.where(degrees >= t, p_new, p_fin)
        p_prev, p_cur, sig = p_cur, p_new, sig_new
        Z = al * shift_low(Wc) + be * Wp + inj[None, :] * Rc
        Wp, Wc = Wc, torch.where(degrees[None, :] >= t, Z, Wc)
    Y = p_fin[None, :].to(V.dtype) * V + Wc.to(V.dtype)
    return torch.where(degrees[None, :] >= 1, Y, V)


def solve_fused(H, V0, *, nev, nex, tol, deg0, max_deg, deg_extra=2,
                max_iter=25, lanczos_iter=25, num_lanczos=4,
                optimization=True, cholqr_passes=3,
                cond_shift_threshold=1e8, inject_dos=True,
                bf16_filter=False, bf16_threshold=1e-2, probes=None,
                eigh_polish=2, refine_filter=False, phase_tiers=3,
                qr_hi_prec=True, H_low=None, chunk=None, grid=None) -> dict:
    """Device-resident Hermitian solve.

    Args:
      H: (N, N) Hermitian tensor (f32, f64, c64, c128); on ``grid`` this
        rank's block.
      V0: (N, nev+nex) starting block (random, or a warm start); on
        ``grid`` this rank's rows, as are ``probes``.
      refine_filter: the DP ladder — from iteration 1 the filter runs the
        deviation-form recurrence on the f32/c64 shadow seeded by the RR
        residual vectors; iteration 0 multiplies on the shadow with the
        carry in the problem dtype.
      bf16_filter: real f32 problems — while the wanted residuals exceed
        ``bf16_threshold`` of the spectral radius the filter multiplies
        on the bf16 shadow (f32 carry and sums).
      probes: Lanczos probes (a warm start's fresh ones); None takes V's
        first columns after the initial QR.
      qr_hi_prec: SP problems factor their QR in f64/c128.
      H_low: the shadow (``DenseOperator.H_low``) for either rung; None
        casts H.
      chunk: the filter products' routing (:class:`FilterProducts`);
        None: every product ``dist.hemm``.
      grid: the process grid, or None for one device.

    Returns a dict: V (N, k) converged-first sorted, ritzv (k,), resid
    (k,), locked, iterations, lowerb, upperb, filtered_vecs,
    filtered_low (the part of filtered_vecs filtered on the shadow),
    block_history, resid_history, early_history (tensors on H's device)
    and hemm_steps (int, the filter's products).
    """
    N = _rows(H, grid)
    k = nev + nex
    pdt = H.dtype
    rt = real_dtype(pdt)
    is_sp = not is_double_base(pdt)
    dev = H.device
    tol = float(tol)
    cols = torch.arange(k, device=dev)
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
                       grid=grid)[0]

    # ---- init: orthonormalise V0 ------------------------------------------
    V = gram(V0.to(pdt), None)

    # ---- Lanczos + DoS ------------------------------------------------------
    mm = min(k, N // 2, lanczos_iter)
    m = max(2, mm - mm % 2)
    nv = probes.shape[1] if probes is not None else min(num_lanczos, k)
    P = V[:, :nv] if probes is None else probes.to(pdt)
    alphas, betas, basis = lz.lanczos_scan(H, P, m=m, want_basis=True,
                                           grid=grid)
    theta, tvecs = eigh_tridiag_batched(alphas, betas[:-1])
    tau = tvecs[:, 0, :].abs() ** 2
    lam, lowerb0, upperb = _dos_bounds(theta, tau, betas[-1], k, N)

    if inject_dos:
        # DoS start vectors from the last probe (no interspersing); warm
        # starts skip this so the caller's subspace survives
        theta_last = theta[-1]
        exceeds = theta_last > lowerb0
        first = torch.argmax(exceeds.to(torch.int8))
        idx = torch.where(exceeds.any(), torch.clamp(first - 1, min=0),
                          torch.zeros_like(first))
        idx = torch.clamp(idx, max=k - 1)
        dmask = torch.arange(m, device=dev) < idx
        Vd = basis.T @ (tvecs[-1] * dmask[None, :]).to(pdt)
        V[:, :m] = torch.where(dmask[None, :], Vd, V[:, :m])
        tl_pad = theta_last.index_select(0, torch.clamp(cols, max=m - 1))
        ritzv = torch.where(cols < idx, tl_pad, lam).to(rt)
    else:
        ritzv = lam.to(rt).expand(k).clone()
    ritzv[k - 1] = lowerb0

    lowerb = ritzv.max()
    resid = torch.full((k,), big, dtype=rt, device=dev)
    resid_last = resid.clone()
    degrees = torch.full((k,), min(deg0 + deg0 % 2, max_deg),
                         dtype=torch.int64, device=dev)
    Rv = torch.zeros_like(V) if use_refine else None
    locked = torch.zeros((), dtype=torch.int64, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    filtered = torch.zeros((), dtype=torch.int64, device=dev)
    filtered_low = torch.zeros((), dtype=torch.int64, device=dev)
    blk_hist = torch.zeros(max_iter, dtype=torch.int64, device=dev)
    r_hist = torch.full((max_iter, k), -1.0, dtype=rt, device=dev)
    e_hist = torch.full((max_iter, k), -1.0, dtype=rt, device=dev)
    offs = _tier_offsets(k, phase_tiers)

    # ---- main loop ----------------------------------------------------------
    while True:
        active = cols >= locked
        all_small = torch.where(active, resid, 0.0).max() <= 0.5
        lowerb_n = torch.minimum(torch.where(all_small, ritzv[k - 1], lowerb),
                                 upperb)
        resid_last_n = torch.where(active, torch.minimum(resid_last, resid),
                                   resid_last)
        kept = torch.where(active, degrees, 0)
        if optimization:
            degrees_n = torch.where(
                it > 0, _degrees(ritzv, resid, active, cols, upperb,
                                 lowerb_n, tol, nex, max_deg, deg_extra,
                                 is_sp), kept)
        else:
            degrees_n = kept
        c = (upperb + lowerb_n) / 2
        e = (upperb - lowerb_n) / 2
        sigma1 = e / (lam - c)
        dmax = degrees_n.max()

        # QR shift decision (shared by every tier)
        rho1 = cheb_rho((ritzv[0] - c) / e)
        rhok = cheb_rho((gather0(ritzv, torch.clamp(locked, max=k - 1)) - c)
                        / e)
        dmin = torch.where(active, degrees_n, max_deg + 2).min()
        logcond = dmin * torch.log(rhok) + (dmax - dmin) * torch.log(rho1)
        shift_on = logcond > math.log(cond_shift_threshold)

        low_phase = torch.zeros((), dtype=torch.bool, device=dev)
        if use_bf16_rung:
            min_wanted = torch.where(active & (cols < nev), resid, big).min()
            # spectral-radius magnitude (a signed upperb would never
            # disengage)
            spec = torch.maximum(lam.abs(), upperb.abs())
            low_phase = min_wanted > bf16_threshold * spec
        # (a tensor bound in torch.clamp would be read on the host)
        dmids = [torch.minimum(torch.clamp(torch.sort(degrees_n[o:]).values[
            max(1, (k - o) // 2) - 1], min=1), dmax) for o in offs]
        cont = (k - locked > nex) & (it < max_iter)
        # host read 1: the loop condition and the filter's bounds
        cont_h, it_h, locked_h, dmax_h, low_h, *dmid_h = control(
            cont, it, locked, dmax, low_phase, *dmids)
        if grid is not None:
            grid.check_peers()
        if not cont_h:
            break
        lowerb, resid_last, degrees = lowerb_n, resid_last_n, degrees_n
        filtered = filtered + degrees.sum()
        if (use_bf16_rung and low_h) or use_refine:   # filtered on H_low
            filtered_low = filtered_low + degrees.sum()
        blk_hist[it_h] = k - locked     # a tensor: a Python int is a copy

        # -- filter → QR → RR on the static tier window [off, k) --
        tier = max(i for i, o in enumerate(offs) if o <= locked_h)
        off = offs[tier]
        w = k - off
        khalf = max(1, w // 2)
        Vw = V[:, off:]
        deg_w = degrees[off:]
        active_w = cols[off:] >= locked_h

        def run_filter(matvec):
            return two_window_filter(lambda X: matvec(X) - c * X, Vw, deg_w,
                                     khalf, dmid_h[tier], dmax_h, sigma1, e)

        if use_bf16_rung and low_h:
            Vf = run_filter(lambda X: prod(H_low, X))
        elif use_refine and it_h > 0:
            cl = c.to(real_dtype(low_dt))
            Vf = deviation_filter(lambda W: prod(H_low, W) - cl * W, Vw,
                               Rv[:, off:].to(low_dt), (ritzv[off:] - c) / e,
                               deg_w, dmax_h, sigma1, e)
        elif use_refine:
            # iteration 0 (no residual vectors yet): the plain recurrence
            # with each product on the shadow, the carry in the problem
            # dtype
            Vf = run_filter(lambda X: prod(H_low, X.to(low_dt)).to(pdt))
        else:
            Vf = run_filter(lambda X: prod(H, X))

        # -- QR on the window: BCGS against the locked left block in the
        # upper tiers, the CholQR chain, then BCGS2 + CholQR1 --
        if off:
            Lk = V[:, :off]
            Vf = Vf - Lk @ inner(Lk, Vf, grid)
        Q = gram(Vf, shift_on)
        if off:
            Q = Q - Lk @ inner(Lk, Q, grid)
            Q = gram_qr(Q, None, passes=1, upcast=upcast, rescue=False,
                        grid=grid)[0]
        Vw2 = torch.where(active_w[None, :], Q, Vw)

        # -- RR + residuals at the window width (host read 3: eigh) --
        lw = locked_h - off
        Vw3, w_eig, r_new, *Rw = rrops.rayleigh_ritz_residuals(
            H, Vw2, lw, polish=eigh_polish, want_vectors=use_refine,
            grid=grid)
        V[:, off:] = Vw3
        ritzv[off:] = torch.where(active_w, w_eig, ritzv[off:])
        resid[off:] = torch.where(active_w, r_new, resid[off:])
        if use_refine:
            Rv[:, off:] = torch.where(active_w[None, :], Rw[0], Rv[:, off:])
        r_hist[it_h] = torch.where(active, resid, -1.0)

        # -- locking: stable converged-first group sort --
        examined = active & (cols < k - nex)
        stag = (resid >= resid_last) & (resid < 100.0 * tol)
        conv = examined & ((resid <= tol) | stag)
        e_hist[it_h] = torch.where(examined & stag & (resid > tol), resid,
                                   -1.0)
        group = torch.where(cols < locked_h, 0, torch.where(conv, 1, 2))
        perm = torch.argsort(group, stable=True)
        V = V.index_select(1, perm)
        if use_refine:
            Rv = Rv.index_select(1, perm)
        ritzv, resid = ritzv[perm], resid[perm]
        resid_last, degrees = resid_last[perm], degrees[perm]
        locked = locked + conv.sum()
        it = it + 1

    # ---- final sort of the first nev by Ritz value -------------------------
    order = torch.argsort(ritzv[:nev], stable=True)
    order = torch.cat([order, torch.arange(nev, k, device=dev)])
    return {"V": V.index_select(1, order), "ritzv": ritzv[order],
            "resid": resid[order], "locked": locked, "iterations": it,
            "lowerb": lowerb, "upperb": upperb, "filtered_vecs": filtered,
            "filtered_low": filtered_low, "block_history": blk_hist, "resid_history": r_hist,
            "early_history": e_hist, "hemm_steps": prod.steps}
