"""Pseudo-Hermitian (BSE) subspace iteration.

Port of ``chase_tpu/solver_pseudo.py::solve_pseudo`` (the reference's
``Algorithm<T>::solve_pseudo``, algorithm/algorithm.inc:1834-2220) on a
torch device or a process grid (below): a subspace of 2·(nev+nex)
columns laid out [locked_L | positive candidates u | K-mirrors u |
locked_R], the Chebyshev filter on H², the S-orthogonalizing QR, the
Hermitianized-pencil Rayleigh–Ritz keeping the positive half,
index-order locking (v3) with mirror regeneration by K-conjugation.  The
host bookkeeping (degrees, clusters, locking, the DoS quantile, the
iteration-0 degree cap) is the JAX package's, copied with its quirks.

The precision ladder is the JAX package's: ``mixed_precision`` filters an
f64/c128 problem on its f32/c64 shadow, ``bf16_filter`` a real f32 one on
its bf16 shadow (complex BSE never takes bf16); from iteration 1
(``refine_filter``) the deviation-form filter on H², seeded by
H²-residuals (H + θ)·r computed on the problem's own H, keeps every
filter product on the shadow.

Routing, as in the Hermitian solver (``solver._ring_route``): with
``ring_backend="pallas"`` every filter whose operator is a dtype the
kernel takes (f32, c64, bf16) runs as the p = 1 ring, both products of
each H² step on the ring_hemm kernel (``parallel/ring.py``); otherwise
the segmented windowed filter on ``torch.matmul``.  The JAX package has no
ring on one device; both apply the same polynomial, so the converged
spectra agree.

On a process grid (``DenseOperator(H, grid=grid, pseudo_hermitian=True)``,
the S-preserving pad) the loop runs on every rank with its blocks, as
``solver.solve`` does: a 1×1 grid as one device; a (p, 1) grid the p-step
chunk ring in every filter (:func:`h2_form`: both products of each H²
step on the kernel with "pallas" and a kernel operator — on the card one
``ring_hemm_peers`` launch each, p ring_hemm steps on the CPU —, else
``matmul_step``); an r×c grid with r, c > 1 the 2-D H² rings
(``parallel/ring.chebyshev_filter_h2_ring2d`` and its refine twin: each
H² step a pass along 'c' on the block conjugate-transposed, read in
place, and one along 'r' on the block, r + c launches per rank with the
kernel), as in the JAX
package.  S acts on global rows, K-conjugation rotates rows across
ranks (``ops/pseudo``), the S-Lanczos dots, the pencil and the residuals
are summed over the grid's rows bitwise equal on every rank, and the
start block and probes are drawn whole, damped and cut to each rank's
rows, so every host decision agrees.

Not ported: the wide-f64 and transient-shadow modes (``engage_wide``,
``H_filter``, ``drop_shadow``), the host pencil factorization and the
real-pair embedding of complex BSE (complex runs natively).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .config import ChaseConfig, set_matmul_precision
from .logger import get_logger
from .perf import PerfData, phase_clock, span, to_device
from .types import is_double_base
from .parallel.operator import DenseOperator
from .parallel import dist as pdist
from .parallel import ring as pring
from .ops import lanczos as lz
from .ops import pseudo as ps
from .ops.blocks import permute_cols, set_head_cols
from .ops.qr import orthonormalize, orthonormalize_pseudo
from .solver import (FilterForm, SolveResult, _chunk_product, _col_block,
                     _draw, _filter_refine_windowed, _filter_ring,
                     _filter_windowed, _host, _rho, _ring_route, is_2d)

__all__ = ["solve_pseudo", "detect_eigenvalue_clusters",
           "calc_degrees_pseudo_h2_host", "locking_pseudo_v3_host"]


# --------------------------------------------------------------------------
# host-side bookkeeping (copied from chase_tpu/solver_pseudo.py)
# --------------------------------------------------------------------------

def detect_eigenvalue_clusters(ritzv, resid, tol, n, upperb, lowerb):
    """Residual-weighted spatial clustering → per-vector degree factors in
    [0.5, 3.0], 1-2-1 smoothed.  Port of algorithm.inc:19-133."""
    if n <= 0:
        return np.ones(0)
    factors = np.ones(n)
    cluster_threshold = abs(upperb - lowerb) * 1e-6
    mean_res = float(np.mean(resid[:n]))
    rel = resid[:n] / (mean_res + 1e-14)
    weights = np.minimum(1.0 + np.log(1.0 + rel), 2.5)
    for i in range(n):
        d = np.abs(ritzv[i] - ritzv[:n])
        near = (d < cluster_threshold)
        near[i] = False
        neighbors = int(np.sum(near))
        spatial = 1.0
        if neighbors > 0:
            local_density = float(np.sum(weights[near] / (d[near] + 1e-14)))
            spatial = 1.0 + np.log(1.0 + local_density * 0.1)
        combined = spatial * weights[i]
        if neighbors > 2 and resid[i] > 2.0 * mean_res:
            combined *= 1.2
        if resid[i] > 10.0 * tol:
            combined *= 1.15
        factors[i] = min(3.0, max(0.5, combined))
    smoothed = factors.copy()
    for i in range(1, n - 1):
        smoothed[i] = 0.25 * factors[i - 1] + 0.5 * factors[i] \
            + 0.25 * factors[i + 1]
    return np.minimum(3.0, np.maximum(0.5, smoothed))


def calc_degrees_pseudo_h2_host(u, nex, b_sup, lower, tol, ritzv_a, resid_a,
                                resid_last_a, degrees_a, rcfg, is_sp):
    """λ²-based optimal degrees with cluster/stagnation/near-zero bonuses.

    In-place on the active views; port of calc_degrees_pseudo_H2
    (algorithm.inc:196-317).  Returns (deg_max_active, perm_over_active).
    """
    max_deg = rcfg.max_deg
    cluster = rcfg.cluster_aware_degrees
    factors = (detect_eigenvalue_clusters(ritzv_a, resid_a, tol, u - nex,
                                          b_sup, lower)
               if cluster else None)
    c_h2 = (b_sup + lower) / 2
    e_h2 = (b_sup - lower) / 2
    if e_h2 <= 0:
        degrees_a[:u] = max_deg + max_deg % 2
        return max_deg + max_deg % 2, np.arange(u)
    for i in range(u):
        lam2 = float(ritzv_a[i]) ** 2
        r = float(resid_a[i])
        t = (lam2 - c_h2) / e_h2
        z = complex(t) ** 2 - 1.0
        s = np.sqrt(z)
        rho = max(abs(complex(t) - s), abs(complex(t) + s))
        if not np.isfinite(rho) or rho <= 1.0:
            deg = max_deg
        else:
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                lr = np.log(r / tol) / np.log(rho)
            if not np.isfinite(lr):
                deg = max_deg
            else:
                deg = int(np.ceil(abs(float(lr))))
                if cluster:
                    f = factors[i] if i < len(factors) else 1.0
                    deg = int(deg * f)
                    if r <= 10.0 * tol:
                        rel_change = abs(r - float(resid_last_a[i])) / (r + 1e-14)
                        if rel_change < 0.1:
                            deg += 6     # stagnation bonus
                    if abs(float(ritzv_a[i])) < abs(b_sup - lower) * 0.1:
                        deg += 2         # near-zero-λ bonus
                deg = min(deg + rcfg.deg_extra, max_deg)
        if is_sp:
            deg = max(deg, 8)
        degrees_a[i] = deg + deg % 2
    perm = np.argsort(degrees_a[:u], kind="stable")
    degrees_a[:u] = degrees_a[:u][perm]
    ritzv_a[:u] = ritzv_a[:u][perm]
    resid_a[:u] = resid_a[:u][perm]
    return int(np.max(degrees_a[:u])), perm


def locking_pseudo_v3_host(ritzv_a, resid_a, resid_last_a, u, nex, tol,
                           iteration):
    """Index-order locking with 1000·tol stagnation early-lock after
    iteration ≥ 4.  Port of locking_pseudo_v3 (algorithm.inc:730-816)
    including its residLast reshuffle.  In-place; returns
    (new_converged, perm_over_u, early_locked)."""
    resid_last_unconv = resid_a[:u].copy()
    perm = np.arange(u)
    converged = 0
    early = []
    index_unconverged = []
    for k in range(u - nex):
        j = k
        rj = float(resid_a[j])
        stag = (rj > tol and rj >= float(resid_last_a[k])
                and rj <= 1000.0 * tol and iteration >= 4)
        if rj <= tol or stag:
            if stag:
                early.append(rj)
            if j != converged:
                for arr in (resid_a, ritzv_a):
                    arr[j], arr[converged] = arr[converged], arr[j]
                perm[j], perm[converged] = perm[converged], perm[j]
            converged += 1
        else:
            index_unconverged.append(j)
    for k in range(u - nex, u):
        index_unconverged.append(k)
    for i in range(converged, u):
        resid_last_a[i] = resid_last_unconv[index_unconverged[i - converged]]
    return converged, perm, early


def _iter0_degree_cap(lambda_1, lower, b_sup, deg0,
                      dyn_range: float = 1e6) -> int:
    """Iteration-0 H² filter degree cap for reduced-precision filters.

    The first filter has no residuals and runs at a uniform degree; its
    amplification between the wanted edge μ₁ = ``lambda_1`` and the damped
    interval [``lower``, ``b_sup``] is ~rho₁^deg.  Past ~``dyn_range`` the
    damped directions sink below the reduced precision's noise floor, the
    filtered columns become numerically dependent and the S-QR Gram
    collapses (the JAX package measured eig_min ~1e-19·‖G‖ at N=8192).
    Capping the degree keeps the block inside CholQR's range.  Returns an
    even cap in [8, deg0].
    """
    if not (lower > lambda_1 and b_sup > lower):
        return deg0
    cc0 = (b_sup + lower) / 2.0
    ee0 = (b_sup - lower) / 2.0
    rho1 = _rho((lambda_1 - cc0) / ee0)
    if not np.isfinite(rho1) or rho1 <= 1.0 + 1e-9:
        return deg0
    cap = int(np.log(dyn_range) / np.log(rho1))
    cap = max(8, cap - (cap % 2))
    return min(cap, deg0)


# --------------------------------------------------------------------------
# the filter on H²: solver's drivers with the H² shift and rings
# --------------------------------------------------------------------------

H2 = FilterForm(ps._h2_shift, pring.chebyshev_filter_h2_ring,
                pring.chebyshev_filter_refine_h2_ring, 2)


def h2_form(grid, kernel: bool = True) -> FilterForm:
    """The H² filter's form on ``grid`` (``solver.hermitian_form``'s
    counterpart): the windowed H² shift with the grid's product
    (``parallel/dist.grid_h2_shift``) and the H² rings — the chunk rings
    on a (p, 1) grid, the 2-D rings on an r×c one — with the ring_hemm
    kernel (``kernel``) or ``torch.matmul`` as their step.  :data:`H2`
    for one device."""
    if grid is None:
        return H2
    if is_2d(grid):
        return FilterForm(
            pdist.grid_h2_shift(grid),
            functools.partial(pring.chebyshev_filter_h2_ring2d, grid,
                              kernel=kernel),
            functools.partial(pring.chebyshev_filter_refine_h2_ring2d, grid,
                              kernel=kernel), 2)
    return FilterForm(
        pdist.grid_h2_shift(grid),
        functools.partial(pring.chebyshev_filter_h2_ring, grid=grid,
                          kernel=kernel),
        functools.partial(pring.chebyshev_filter_refine_h2_ring, grid=grid,
                          kernel=kernel), 2)


# --------------------------------------------------------------------------
# DoS quantile in H-space (solver_pseudo.py:442-476 of the JAX package)
# --------------------------------------------------------------------------

def _dos_quantile(theta, tau, numvec, m, N, nev, nex):
    """The Ritz value where the τ-weighted, Gaussian-broadened cumulative
    DoS of the S-Lanczos crosses (N/2 − nev − nex − 1)/N."""
    from scipy.special import erf
    search_hi = min(max((N / 2 - nev - nex - 1) / N, 0.0), 1.0)
    theta_flat = theta.reshape(-1)
    tau_flat = tau.reshape(-1)
    theta_sorted = theta_flat[np.argsort(theta_flat)]
    sigma = 0.25
    thresh = 2 * sigma * sigma / 10

    def G(x):
        return 0.5 * (1 + erf(x / np.sqrt(2 * sigma * sigma)))

    lam_nevnex = float(theta_sorted[-1])
    prev = 0.0
    for i in range(numvec * m):
        x = theta_sorted[i]
        lo = x < (theta_flat - thresh)
        hi = x > (theta_flat + thresh)
        mid = ~(lo | hi)
        curr = float(np.sum(tau_flat[hi])
                     + np.sum(tau_flat[mid] * G(x - theta_flat[mid])))
        curr /= numvec
        if curr > search_hi:
            if abs(curr - search_hi) < abs(prev - search_hi):
                lam_nevnex = float(theta_sorted[i])
            else:
                lam_nevnex = float(theta_sorted[i - 1] if i > 0
                                   else theta_sorted[i])
            break
        prev = curr
        lam_nevnex = float(theta_sorted[i])
    return lam_nevnex


def _mirror(V, K2, locked, n, grid=None):
    """Write K(V[:, locked + j]) into column K2 − locked − n + j for
    j < n: the mirrors of the n pairs after the locked ones."""
    src_idx = np.arange(K2)
    wmask = np.zeros(K2, bool)
    dst = np.arange(K2 - locked - n, K2 - locked)
    src_idx[dst] = np.arange(locked, locked + n)
    wmask[dst] = True
    return ps.k_conjugate_cols(V, src_idx, wmask, grid)


# --------------------------------------------------------------------------
# the solve
# --------------------------------------------------------------------------

def solve_pseudo(op: DenseOperator, nev: int, nex: int,
                 config: Optional[ChaseConfig] = None,
                 V0=None, ritzv0=None, perf: Optional[PerfData] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> SolveResult:
    """Compute the nev smallest-positive eigenpairs of the pseudo-Hermitian
    (BSE) operator H = S·M (spectrum real, symmetric about 0).

    Args as for ``solver.solve``; ``V0`` is an (N, 2·(nev+nex)) block
    (with ``config.approx`` it is used without the initial QR);
    ``ritzv0`` is accepted and unused, as in the JAX package.  On the
    operator's grid every rank calls with the same arguments.
    """
    del ritzv0
    with phase_clock(perf, op.device):
        return _solve_pseudo(op, nev, nex, config, V0, perf, generator)


def _solve_pseudo(op: DenseOperator, nev: int, nex: int, config, V0,
                  perf: Optional[PerfData], generator) -> SolveResult:
    cfg = config or ChaseConfig()
    rcfg = cfg.resolve(op.dtype, op.device)
    log = get_logger()
    N, nevex = op.N, nev + nex
    K2 = 2 * nevex
    if N % 2:
        raise ValueError("pseudo-Hermitian problems need even N")
    if nevex > N // 2:
        raise ValueError(f"nev+nex = {nevex} exceeds N/2 = {N // 2}")
    if rcfg.small_dense_backend not in ("auto", "device"):
        log.info(f"small_dense_backend={rcfg.small_dense_backend!r} is a "
                 f"no-op in the PyTorch port (projected problems stay on "
                 f"the device)", "linalg")
    set_matmul_precision(rcfg.matmul_precision)
    is_sp = not is_double_base(op.dtype)
    is_complex = op.dtype.is_complex
    device = op.device
    grid = op.grid
    # the deviation-form H² filter (the ladder's refinement) from
    # iteration 1: DP problems with mixed_precision keep the recurrence on
    # the f32/c64 shadow, real f32 problems with the bf16 rung on bf16
    refine_capable = rcfg.refine_filter and (
        (not is_sp and rcfg.mixed_precision)
        or (is_sp and rcfg.bf16_filter and not is_complex))
    R_prev = None              # (N, K2) pencil-RR H-residual vectors
    tol = rcfg.tol
    if perf is not None:
        perf.matrix_type = 1

    # ---- initVecs: random 2·nevex block, lower rows ×0.001, QR ------------
    with span("chase.init_vecs"):
        if rcfg.sym_check:
            from .ops.checks import check_pseudo_hermitian
            if not check_pseudo_hermitian(op.H, grid=grid):
                log.warn("input matrix failed the randomized "
                         "pseudo-hermiticity probe (checkPseudoHermicityEasy "
                         "analogue)")

        approx = rcfg.approx and V0 is not None
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(rcfg.seed)

        if V0 is not None and V0.shape[1] != K2:
            raise ValueError(f"v0 has {V0.shape[1]} columns; the pseudo "
                             f"solver takes 2·(nev+nex) = {K2}")
        V = (op.place_block(V0) if V0 is not None
             else _draw(op, K2, generator, damped=True))
        if not approx:
            V = orthonormalize(V, 0, 1.0, rcfg, grid)

    deg0 = min(rcfg.deg + rcfg.deg % 2, rcfg.max_deg)
    degrees = np.full(K2, deg0, dtype=np.int64)
    resid = np.full(K2, np.finfo(np.float64).max)
    resid_last = np.full(K2, np.finfo(np.float64).max)
    ritzv = np.zeros(K2, np.float64)

    # ---- S-Lanczos on H → H² bounds (algorithm.inc:1217-1373) --------------
    m = min(nevex, N // 2, rcfg.lanczos_iter)
    m -= m % 2
    m = max(m, 2)
    numvec = min(rcfg.num_lanczos, K2)
    # a caller's basis is probed with FRESH random vectors: a Krylov space
    # seeded with (near-)converged eigenvectors breaks down at once and
    # the DoS quantile collapses (solver.py's approx branch, same reason)
    with span("chase.lanczos"):
        probes = (_draw(op, numvec, generator, damped=True)
                  if V0 is not None else V[:, :numvec])
        alphas, betas, basis = ps.lanczos_scan_pseudo(
            op.H, probes, m=m, want_basis=True, grid=grid)
        a_np = _host(alphas, "solver_pseudo.lanczos")
        b_np = _host(betas, "solver_pseudo.lanczos")
        theta, tau, ritzV_last = lz.lanczos_tridiag_host(a_np, b_np)

        abs_t = np.abs(theta)
        upperb = float(abs_t.max()) ** 2
        mu_1 = float(abs_t.min()) ** 2
        lam_nevnex = _dos_quantile(theta, tau, numvec, m, N, nev, nex)
        mu_nevnex = lam_nevnex ** 2

        # DoS starting vectors from the last probe's basis
        theta_last = theta[-1]
        idx = 0
        for i in range(m):
            if theta_last[i] > lam_nevnex:
                idx = i - 1
                break
            idx = i + 1
        idx = max(idx, 0)
        idx = min(idx, nevex - 1)
        if V0 is not None:
            # keep the caller's warm subspace intact — no DoS vectors
            idx = 0
        if idx > 0:
            mask = np.arange(m) < idx
            Vd = lz.lanczos_dos_vectors(basis, ritzV_last, mask)
            V = set_head_cols(V, Vd, mask)
        ritzv[:idx] = theta_last[:idx] ** 2
        ritzv[idx:nevex - 1] = mu_1
        ritzv[nevex - 1] = mu_nevnex
        if idx > 1:
            perm = np.arange(K2)
            for i in range(1, idx):
                j = i * (nevex // idx)
                perm[i], perm[j] = perm[j], perm[i]
                ritzv[i], ritzv[j] = ritzv[j], ritzv[i]
            V = permute_cols(V, perm)
        basis = probes = None

        mu_1 = (float(np.min(ritzv[:nevex - 1])) if nevex > 1
                else float(ritzv[0]))
        mu_nevnex = float(ritzv[nevex - 1])
        upperb = upperb * rcfg.upperb_scale if upperb > 0 \
            else upperb / rcfg.upperb_scale
        lambda_1 = mu_1
        lower = mu_nevnex
        new_mu_nevex = lower
        b_sup = upperb
        lower = lower * rcfg.decaying_rate
        log.info(f"solve_pseudo H² bounds: lambda_1={lambda_1:.6e} "
                 f"lower={lower:.6e} b_sup={b_sup:.6e} (DoS idx={idx})")

    # iteration-0 degree cap: a reduced-precision first filter past ~1e6
    # amplification collapses the S-QR Gram (see _iter0_degree_cap)
    reduced_iter0 = (refine_capable
                     or (rcfg.mixed_precision and not is_sp)
                     or (rcfg.bf16_filter and is_sp))
    if reduced_iter0:
        cap = _iter0_degree_cap(lambda_1, lower, b_sup, deg0)
        if cap < deg0:
            log.info(f"iteration-0 H² degree capped {deg0} -> {cap} (keeps "
                     f"the reduced-precision filtered basis CholQR-able)",
                     "algorithm")
            deg0 = cap
            degrees[:] = deg0

    locked = 0
    unconverged = nevex
    iteration = 0
    early_all: list = []
    route = _ring_route(rcfg, op, log)
    polish = rcfg.polish_passes()

    resid_file = None
    if rcfg.save_residuals:
        resid_file = open(rcfg.save_residuals, "w")
        resid_file.write("iteration,residual\n")

    try:
        # ---- main loop (algorithm.inc:1963-2170) ---------------------------
        while locked < nev and unconverged > 0 and iteration < rcfg.max_iter:
            with span("chase.iteration"):
                u = unconverged
                act = slice(locked, locked + u)

                if iteration > 0:
                    nm2 = new_mu_nevex * new_mu_nevex
                    if lambda_1 < nm2 < lower:
                        lower = nm2
                log.info(f"pseudo iteration {iteration}: lambda_1="
                         f"{lambda_1:.6e} lower={lower:.6e} b_sup={b_sup:.6e} "
                         f"unconverged={u}")

                # -- degrees --
                with span("chase.degrees"):
                    if rcfg.optimization and iteration != 0:
                        _, perm = calc_degrees_pseudo_h2_host(
                            u, nex, b_sup, lower, tol, ritzv[act], resid[act],
                            resid_last[act], degrees[act], rcfg, is_sp)
                        if not np.array_equal(perm, np.arange(u)):
                            full_perm = np.arange(K2)
                            full_perm[act] = locked + perm
                            V = permute_cols(V, full_perm)
                            if R_prev is not None:
                                R_prev = permute_cols(R_prev, full_perm)

                # -- filter on H² over the positive-candidate window, which
                # is right-aligned at locked + u = nevex --
                with span("chase.filter"):
                    B = _col_block(rcfg.col_block, nevex)
                    # the ladder's gates (residuals are H-space, so the bf16
                    # relative gate scales by |λ|_max ≈ √b_sup)
                    min_resid = (float(np.min(resid[locked:nev]))
                                 if locked < nev else 0.0)
                    spec_scale = float(np.sqrt(max(b_sup, 0.0)))
                    use_bf16 = (rcfg.bf16_filter and is_sp and locked < nev
                                and not is_complex
                                and min_resid > rcfg.bf16_filter_threshold
                                * spec_scale)
                    use_low = (not use_bf16 and rcfg.mixed_precision
                               and not is_sp and locked < nev
                               and min_resid > rcfg.mixed_precision_threshold)
                    use_refine = refine_capable and R_prev is not None
                    if use_refine:
                        # the deviation-form H² ladder: no threshold, never
                        # hands back to the problem's H
                        use_low = use_bf16 = False
                    H_f = (op.H_low if (use_refine or use_bf16 or use_low)
                           else op.H)
                    ring, kernel = _chunk_product(route, rcfg.ring_backend,
                                                  H_f.dtype)
                    form = h2_form(grid, kernel)
                    if use_refine:
                        # H²-space tables: expansion points θ², interval
                        # [lower, b_sup], amplification point μ₁ = lambda_1;
                        # ONE problem-precision product turns the pencil-RR
                        # H-residuals into H²-residuals: r2 = (H + θ)·r
                        V, f_executed, f_hemms = _filter_refine_windowed(
                            H_f, V, R_prev, ritzv[act], degrees[act], locked,
                            nevex, B, lambda_1, lower, b_sup, rcfg.max_deg,
                            ring, form=form,
                            seed=lambda Rw, th: (
                                ps.h2_residual(op.H, Rw, th, grid), th ** 2))
                    else:
                        V, f_executed, f_hemms = (
                            _filter_ring if ring else _filter_windowed)(
                            H_f, V, degrees[act], locked, nevex, B, lambda_1,
                            *ps._interval(lower, b_sup), form=form)
                    H_f = None
                    if perf is not None:
                        # H² = 2 matvecs per recurrence step
                        perf.add_filtered_vecs(
                            H2.products * int(np.sum(degrees[act])),
                            low=use_refine or use_bf16 or use_low,
                            executed=f_executed)
                        perf.filter_hemm_steps += f_hemms
                        perf.add_iter_blocksize(u)
                # -- K-conjugation: mirror [locked, locked+u) → right of
                # active --
                with span("chase.kconj"):
                    V = _mirror(V, K2, locked, u, grid)
                with span("chase.qr"):
                    # -- cond estimate (squared space,
                    # algorithm.inc:2034-2060) --
                    cc = (b_sup + lower) / 2
                    ee = (b_sup - lower) / 2
                    if ee <= 0:
                        ee = abs(lower - b_sup) / 2 or 1.0
                    t_1 = (lambda_1 - cc) / ee
                    t_k = ((float(ritzv[locked]) ** 2 - cc) / ee
                           if iteration > 0 else t_1)
                    rho_1, rho_k = _rho(t_1), _rho(t_k)
                    dmax = int(np.max(degrees[act]))
                    with np.errstate(over="ignore"):
                        cond = float(rho_k ** degrees[locked]
                                     * rho_1 ** (dmax - degrees[locked]))
                    if not np.isfinite(cond):
                        cond = np.finfo(np.float64).max

                    # -- QR (S-orthogonalizing against locked) --
                    V = orthonormalize_pseudo(V, locked, cond, rcfg, grid)
                # -- pseudo RR + residuals (fused) --
                with span("chase.rr"):
                    V, th_dev, rs_dev, *Rv, ok = \
                        ps.rayleigh_ritz_residuals_pseudo(
                            op.H, V, locked, polish=polish,
                            want_vectors=refine_capable, grid=grid)
                    if refine_capable:
                        R_prev = Rv[0]
                    if not ok:
                        log.warn("pseudo-RR Cholesky of QᴴSHQ failed — "
                                 "subspace drifted; results this iteration "
                                 "may be poor", "linalg")
                    ritzv[act] = _host(th_dev, "solver_pseudo.rr")[act]
                    resid[act] = _host(rs_dev, "solver_pseudo.rr")[act]
                    if grid is not None:
                        grid.check_peers()
                with span("chase.locking"):
                    # -- phantom ± pair purge (the reference keeps it
                    # disabled) --
                    if rcfg.phantom_purge:
                        rv = ritzv[act]
                        n_neg = int(np.sum(rv < 0))
                        n_pos = u - n_neg
                        reinit = []
                        for kk in range(min(nex, n_neg, n_pos)):
                            i, j = n_neg - 1 - kk, n_neg + kk
                            la, lb = abs(rv[i]), abs(rv[j])
                            ratio = lb / (la + 1e-30) if la < lb \
                                else la / (lb + 1e-30)
                            if ratio > 1.5:
                                reinit += [i, j]
                        if reinit:
                            log.debug(f"[purge] reinitializing {len(reinit)} "
                                      f"outlier ± pair column(s)")
                            cols = to_device(locked + np.asarray(reinit),
                                             "solver_pseudo.purge",
                                             device=device)
                            V[:, cols] = op.local_rows(torch.randn(
                                (N, len(reinit)), generator=generator,
                                device=device, dtype=op.dtype))

                    if resid_file is not None:
                        for _ in range(locked):
                            resid_file.write(f"{iteration},-1.0\n")
                        for rr_ in resid[act][np.argsort(ritzv[act],
                                                         kind="stable")]:
                            resid_file.write(f"{iteration},{rr_}\n")

                    # -- bound refresh from the sorted active Ritz values --
                    srt = np.argsort(ritzv[act], kind="stable")
                    q95 = max(int(u * 0.95) - 1, 0)
                    new_mu_nevex = (float(ritzv[act][srt[q95]])
                                    * rcfg.decaying_rate)

                    # -- locking (v3) --
                    new_converged, perm, early = locking_pseudo_v3_host(
                        ritzv[act], resid[act], resid_last[act], u, nex, tol,
                        iteration)
                    early_all.extend(early)
                    if new_converged:
                        if not np.array_equal(perm, np.arange(u)):
                            full_perm = np.arange(K2)
                            full_perm[act] = locked + perm
                            V = permute_cols(V, full_perm)
                            if R_prev is not None:
                                R_prev = permute_cols(R_prev, full_perm)
                        # mirror the newly locked pairs into the right-end
                        # locked region
                        V = _mirror(V, K2, locked, new_converged, grid)
                    locked += new_converged
                    unconverged -= new_converged
                    iteration += 1
                log.info(f"  -> new_converged={new_converged} locked={locked}")
    finally:
        if resid_file is not None:
            resid_file.close()

    # ---- final reorder: positive ascending first (algorithm.inc:2175-2216)
    n_reorder = max(locked + unconverged, 1)
    vals = ritzv[:n_reorder]
    keys = np.where(vals > 0, 0, 1)
    order = np.lexsort((vals, keys))
    if not np.array_equal(order, np.arange(n_reorder)):
        full_perm = np.arange(K2)
        full_perm[:n_reorder] = order
        V = permute_cols(V, full_perm)
        ritzv[:n_reorder] = vals[order]
        resid[:n_reorder] = resid[:n_reorder][order]

    return SolveResult(
        ritzv=ritzv[:nev].copy(), V=V, resid=resid[:nev].copy(),
        iterations=iteration, locked=locked,
        converged=bool(locked >= nev),
        upperb=float(b_sup), lowerb=float(lower), perf=perf,
        ritzv_full=ritzv.copy(), early_locked=early_all)
