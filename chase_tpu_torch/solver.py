"""Chebyshev-accelerated subspace iteration driver (Hermitian path).

Port of ``chase_tpu/solver.py::solve`` on one torch device: Lanczos
bounds, then degrees → filter → QR → RR with residuals → locking until
``unconverged ≤ nex`` (the reference's algorithm.inc:1376-1788).  The
host-side bookkeeping (calc_degrees, locking, the DoS quantile) is the JAX
package's, copied with its quirks; the device phases are plain torch plus
the ring HEMM kernel.

One routing difference from the JAX package: with
``ring_backend="pallas"`` on an f32 problem the filter runs as the p = 1
ring (``parallel/ring.chebyshev_filter_ring_pallas``), every H·Y product
on the hand-written CUDA kernel.  The JAX package has no ring on one
device and warns, using its windowed filter; both compute the same
filter, so the converged spectra agree.

Not ported here: the precision ladder (mixed_precision / bf16_filter
raise NotImplementedError), the wide-f64 and transient-shadow modes and
the multi-device rings.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .config import ChaseConfig, set_matmul_precision
from .logger import get_logger
from .perf import PerfData
from .types import is_double_base, numpy_scalar_type
from .parallel.operator import DenseOperator
from .ops import filter as filt
from .ops import lanczos as lz
from .ops import qr as qrops
from .ops import rr as rrops
from .ops.blocks import (permute_cols, set_head_cols, slice_cols,
                         update_cols)

__all__ = ["solve", "SolveResult", "calc_degrees_host", "locking_host"]


def _ring_mode(rcfg, op: DenseOperator, log) -> Optional[str]:
    """'1d' (the p = 1 ring, HEMM on the ring_hemm kernel) when the
    config asks for the kernel ring on an f32 problem; else None (the
    windowed filter).  The JAX package needs a grid with r > 1 for any
    ring and would warn here; the port runs the degenerate ring so the
    kernel carries the filter on one card."""
    if rcfg.ring_filter is False:
        return None
    eligible = (rcfg.ring_backend == "pallas"
                and op.dtype == torch.float32)
    if rcfg.ring_backend == "pallas" and not eligible:
        log.warn(f"ring_backend='pallas' needs an f32 problem (dtype="
                 f"{op.dtype}) — using the windowed filter", "linalg")
    elif rcfg.ring_filter is True and not eligible:
        log.warn("ring_filter requested but no ring schedule fits one "
                 "device without ring_backend='pallas' — using the "
                 "windowed filter", "linalg")
    if not eligible:
        return None
    log.info("ring filter on one device: p=1 ring with the ring_hemm "
             "kernel (the JAX package would use its windowed filter here)",
             "linalg")
    return "1d"


def _col_block(cfg_block, nevex: int) -> int:
    """Filter-window bucket width.  `None` auto-sizes to a multiple of 64
    that bounds a solve at ~8 distinct widths no matter how large
    nev+nex is."""
    if cfg_block is None:
        cfg_block = max(64, 64 * (-(-nevex // (8 * 64))))
    return max(1, min(int(cfg_block), nevex))


def _window_pad(nevex: int, locked: int, B: int):
    """Right-aligned active window padded up to a whole B bucket:
    returns (w_pad, start).  ONE definition shared by the filter and the
    QR/RR shrink."""
    w_pad = min(nevex, -(-(nevex - locked) // B) * B)
    return w_pad, nevex - w_pad


def _shrink_plan(deg_win, B, w_pad):
    """Bucket-retirement plan over a degree-ascending window: list of
    (complete_through_step, retired_left_offset) pairs, ending with
    (deg_max, w_pad)."""
    plan = []
    deg_max = int(deg_win.max())
    for p in range(B, w_pad, B):
        if deg_win[p - 1] < deg_win[p]:
            step = int(deg_win[p - 1])
            if step < 1:
                continue
            if plan and step == plan[-1][0]:
                plan[-1][1] = p
            elif not plan or step > plan[-1][0]:
                plan.append([step, p])
    plan.append([deg_max, w_pad])
    return plan


def _filter_windowed(H, V, degrees_act, locked, nevex, B, lam, lo, up):
    """Degree-retiring segmented filter.

    The active columns are sorted ascending by degree, so retirement
    happens from the left: the recurrence runs on a right-aligned window
    that shrinks whenever a whole B-column bucket has retired; per-column
    degree masks handle sub-bucket retirement.  Writes the filtered
    window into V in place.  Returns (V, executed column-steps, HEMM
    calls)."""
    w_pad, start = _window_pad(nevex, locked, B)
    offset = locked - start
    deg_win = np.zeros(w_pad, np.int32)
    deg_win[offset:] = degrees_act
    plan = _shrink_plan(deg_win, B, w_pad)

    rt = numpy_scalar_type(H.dtype)   # scalars follow the recurrence carry
    lam, lo_, up_ = rt(lam), rt(lo), rt(up)
    c = (up_ + lo_) / rt(2)
    e = (up_ - lo_) / rt(2)
    sigma1 = e / (lam - c)

    X0, Xp, Yc, sigma = filt.filter_seg_init(
        H, V, start, deg_win, c, e, sigma1, w_pad=w_pad)
    executed = w_pad                      # init step runs the full window
    hemms = 1
    t_done = 1
    start0 = start             # V-column of the initial window's left edge
    pend_off = 0               # shrink offset staged for the next segment
    for (t_end, plan_off) in plan:
        if t_end > t_done:
            V, X0, Xp, Yc, sigma = filt.filter_seg_steps(
                H, V, X0, Xp, Yc, deg_win, sigma, sigma1, c, e, pend_off,
                start, t_done + 1, t_end + 1, w_new=w_pad)
            pend_off = 0
            executed += w_pad * (t_end - t_done)
            hemms += t_end - t_done
            t_done = t_end
        # plan offsets are positions in the INITIAL window; shrink relative
        # to the CURRENT window (right edge pinned at nevex), applied at
        # the start of the next segment
        retire_to = start0 + plan_off
        if retire_to < nevex:
            new_w = nevex - retire_to
            new_w_pad = min(-(-new_w // B) * B, w_pad)
            new_start = nevex - new_w_pad
            off2 = new_start - start
            if off2 > 0:
                deg_win = deg_win[off2:]
                start, w_pad = new_start, new_w_pad
                pend_off += off2
    return V, executed, hemms


def _filter_ring(H, V, degrees_act, locked, nevex, B, lam, lo, up):
    """The p = 1 ring filter on the padded window (no bucket shrink, like
    the JAX ring path).  Returns (V, executed column-steps, HEMM calls)."""
    from .parallel.ring import chebyshev_filter_ring_pallas
    w_pad, start = _window_pad(nevex, locked, B)
    deg_win = np.zeros(w_pad, np.int32)
    deg_win[locked - start:] = degrees_act
    deg_max = int(deg_win.max())
    if V.stride(1) != 1:
        # torch.linalg may hand back column-major blocks; the kernel
        # reads row-major windows
        V = V.contiguous()
    Y = chebyshev_filter_ring_pallas(H, slice_cols(V, start, w_pad),
                                     deg_win, lam, lo, up, deg_max)
    V = update_cols(V, Y, start)
    return V, w_pad * deg_max, 1 + max(deg_max - 1, 0)


# --------------------------------------------------------------------------
# host-side algorithm bookkeeping (copied from chase_tpu/solver.py)
# --------------------------------------------------------------------------

def _rho(t: float) -> float:
    """Chebyshev ellipse radius max|t ± sqrt(t²-1)| (complex-safe)."""
    z = complex(t) ** 2 - 1.0
    s = np.sqrt(z)
    return float(max(abs(complex(t) - s), abs(complex(t) + s)))


def calc_degrees_host(unconverged, nex, upperb, lowerb, tol,
                      ritzv_a, resid_a, degrees_a, rcfg, is_sp):
    """Per-vector optimal filter degrees + sort-by-degree permutation.

    In-place on the active views; mirrors algorithm.inc:136-193.
    Returns (deg_of_last_column, perm_over_active).
    """
    c = (upperb + lowerb) / 2
    e = (upperb - lowerb) / 2
    n_opt = unconverged - nex
    max_deg = rcfg.max_deg
    for i in range(n_opt):
        t = (ritzv_a[i] - c) / e
        rho = max(abs(t - np.sqrt(abs(t * t - 1))),
                  abs(t + np.sqrt(abs(t * t - 1))))
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            val = abs(np.log(resid_a[i] / tol) / np.log(rho))
        deg = max_deg if not np.isfinite(val) else int(np.ceil(val))
        if is_sp:
            deg = max(deg, 8)
        degrees_a[i] = min(deg + rcfg.deg_extra, max_deg)
    degrees_a[n_opt:unconverged] = degrees_a[max(n_opt - 1, 0)]
    for i in range(unconverged):
        degrees_a[i] += degrees_a[i] % 2
    perm = np.argsort(degrees_a[:unconverged], kind="stable")
    degrees_a[:unconverged] = degrees_a[:unconverged][perm]
    ritzv_a[:unconverged] = ritzv_a[:unconverged][perm]
    resid_a[:unconverged] = resid_a[:unconverged][perm]
    # NOTE: residLast intentionally NOT permuted — mirrors the commented-out
    # swap at algorithm.inc:188.
    return int(degrees_a[unconverged - 1]), perm


def locking_host(ritzv_a, resid_a, resid_last_a, n_examine, tol,
                 is_sym=True):
    """Residual-based locking with early-lock of stagnating pairs.

    In-place on the active views; literal functional mirror of
    algorithm.inc:519-578 including its walk-while-swapping aliasing.
    Returns (new_converged, perm_over_active, early_locked_residuals).
    """
    w = len(ritzv_a)
    index = np.argsort(ritzv_a[:n_examine], kind="stable")
    perm = np.arange(w)
    converged = 0
    early = []
    for k in range(n_examine):
        j = int(index[k])
        rj = resid_a[j]
        stagnating = (is_sym and rj >= resid_last_a[j] and rj < 100.0 * tol)
        if rj <= tol or stagnating:
            if is_sym and rj > tol and stagnating:
                early.append(float(rj))
            if j != converged:
                for arr in (resid_a, resid_last_a, ritzv_a):
                    arr[j], arr[converged] = arr[converged], arr[j]
                perm[j], perm[converged] = perm[converged], perm[j]
            converged += 1
    return converged, perm, early


# --------------------------------------------------------------------------
# result container
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SolveResult:
    ritzv: np.ndarray          # (nev,) converged eigenvalues, ascending
    V: torch.Tensor            # (N, nev+nex) device block; first nev = evecs
    resid: np.ndarray          # (nev,) residual norms
    iterations: int
    locked: int
    converged: bool
    upperb: float
    lowerb: float
    perf: Optional[PerfData] = None
    ritzv_full: Optional[np.ndarray] = None   # all nev+nex Ritz values
    early_locked: Optional[list] = None


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


# --------------------------------------------------------------------------
# main driver
# --------------------------------------------------------------------------

def solve(op: DenseOperator, nev: int, nex: int,
          config: Optional[ChaseConfig] = None,
          V0=None, ritzv0=None, perf: Optional[PerfData] = None,
          generator: Optional[torch.Generator] = None) -> SolveResult:
    """Compute the nev lowest eigenpairs of the Hermitian operator `op`.

    Args:
      op: DenseOperator on its device.
      nev, nex: wanted eigenpairs / extra search directions.
      config: ChaseConfig (defaults per dtype).
      V0: optional (N, nev+nex) starting subspace (numpy or tensor).  With
          ``config.approx=True`` this is the warm start of a problem
          sequence and ``ritzv0`` must hold the previous Ritz values.
      perf: optional PerfData to fill with phase timings/FLOPs.
      generator: torch.Generator on op's device for the start block and
          the Lanczos probes (default: seeded from ``config.seed``).

    Returns: SolveResult.
    """
    cfg = config or ChaseConfig()
    rcfg = cfg.resolve(op.dtype)
    log = get_logger()
    N, nevex = op.N, nev + nex
    if nevex > N:
        raise ValueError(f"nev+nex = {nevex} exceeds N = {N}")
    if rcfg.mixed_precision or rcfg.bf16_filter:
        raise NotImplementedError(
            "mixed_precision / bf16_filter need the precision ladder, which "
            "is not ported yet (ROADMAP queue 1: the ladder and K-B)")
    if rcfg.small_dense_backend not in ("auto", "device"):
        log.info(f"small_dense_backend={rcfg.small_dense_backend!r} is a "
                 f"no-op in the PyTorch port (projected problems stay on "
                 f"the device)", "linalg")
    set_matmul_precision(rcfg.matmul_precision)
    is_sp = not is_double_base(op.dtype)
    tol = rcfg.tol
    polish = rcfg.polish_passes()
    device = op.device
    H = op.H
    timing = perf is not None

    def toc(phase, t0):
        if timing:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            perf.add_time(phase, time.perf_counter() - t0)
        return time.perf_counter()

    t_all0 = time.perf_counter()

    if rcfg.sym_check:
        from .ops.checks import check_hermitian
        if not check_hermitian(H):
            log.warn("input matrix failed the randomized hermiticity probe "
                     "(checkSymmetryEasy analogue) — results may be invalid")

    # ---- initVecs (chase_cpu.hpp:296-327) --------------------------------
    t0 = time.perf_counter()
    approx = rcfg.approx and V0 is not None
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(rcfg.seed)
    if V0 is not None:
        V = op.place_block(V0)
    else:
        V = torch.randn((N, nevex), generator=generator, device=device,
                        dtype=op.dtype)
    if not approx:
        V = qrops.orthonormalize(V, 0, 1.0, rcfg)
    t0 = toc("InitVecs", t0)

    deg0 = min(rcfg.deg + rcfg.deg % 2, rcfg.max_deg)
    degrees = np.full(nevex, deg0, dtype=np.int64)
    resid = np.full(nevex, np.finfo(np.float64).max)
    resid_last = np.full(nevex, np.finfo(np.float64).max)

    # ---- Lanczos spectral estimation (algorithm.inc:1438-1446) ------------
    m = min(nevex, N // 2, rcfg.lanczos_iter)
    m -= m % 2
    m = max(m, 2)
    numvec = min(rcfg.num_lanczos, nevex)
    if not approx:
        if V0 is not None:
            # user-provided basis: probe with FRESH random vectors — a
            # Krylov space seeded with (near-)converged eigenvectors breaks
            # down immediately and the DoS bounds collapse
            probes = torch.randn((N, numvec), generator=generator,
                                 device=device, dtype=op.dtype)
        else:
            probes = V[:, :numvec]
        alphas, betas, basis = lz.lanczos_scan(H, probes, m=m,
                                               want_basis=True)
        a_np, b_np = _host(alphas), _host(betas)
        t0 = toc("Lanczos", t0)
        theta, tau, ritzV_last = lz.lanczos_tridiag_host(a_np, b_np)
        upperb = lz.upper_bound(theta, b_np[-1])
        lam, lowerb = lz.dos_lower_bound(theta, tau, nevex, N)
        # extract DoS vectors below lowerb (algorithm.inc:1160-1189)
        theta_last = theta[-1]
        idx = 0
        for i in range(m):
            if theta_last[i] > lowerb:
                idx = i - 1
                break
        idx = max(idx, 0)
        idx = min(idx, nevex - 1)
        if V0 is not None:
            # keep the caller's warm subspace intact — no DoS injection
            idx = 0
        if idx > 0:
            mask = np.arange(m) < idx
            Vd = lz.lanczos_dos_vectors(basis, ritzV_last, mask)
            V = set_head_cols(V, Vd, mask)
        ritzv = np.empty(nevex, np.float64)
        ritzv[:idx] = theta_last[:idx]
        ritzv[idx:nevex - 1] = lam
        ritzv[nevex - 1] = lowerb
        if idx > 1:
            perm = np.arange(nevex)
            for i in range(1, idx):
                j = i * (nevex // idx)
                perm[i], perm[j] = perm[j], perm[i]
                ritzv[i], ritzv[j] = ritzv[j], ritzv[i]
            V = permute_cols(V, perm)
        log.debug(f"Lanczos: m={m} numvec={numvec} idx={idx} "
                  f"upperb={upperb:.6e} lowerb={lowerb:.6e}")
        basis = probes = None
    else:
        if ritzv0 is None:
            raise ValueError("approx mode needs ritzv0 from a previous solve")
        # bounds-only Lanczos from a FRESH random probe: a Krylov space
        # seeded with a converged eigenvector of the previous problem
        # underestimates lambda_max
        probe = torch.randn((N, 1), generator=generator, device=device,
                            dtype=op.dtype)
        alphas, betas, _ = lz.lanczos_scan(H, probe, m=m, want_basis=False)
        a_np, b_np = _host(alphas), _host(betas)
        t0 = toc("Lanczos", t0)
        theta, _, _ = lz.lanczos_tridiag_host(a_np, b_np, want_vectors=False)
        upperb = lz.upper_bound(theta, b_np[-1])
        ritzv = np.asarray(ritzv0, np.float64).copy()

    # sign-aware scaling: push a negative upperb toward zero correctly
    upperb = upperb * rcfg.upperb_scale if upperb > 0 \
        else upperb / rcfg.upperb_scale

    lowerb = float(np.max(ritzv)) * rcfg.decaying_rate
    lam_filter = float(np.min(ritzv))

    locked = 0
    unconverged = nevex
    iteration = 0
    early_all: list = []
    filter_fn = (_filter_ring if _ring_mode(rcfg, op, log) == "1d"
                 else _filter_windowed)

    resid_file = None
    if rcfg.save_residuals:
        # per-iteration residual history CSV (CHASE_SAVE_RESIDUALS,
        # algorithm.inc:1467-1488): locked slots logged as -1.0
        resid_file = open(rcfg.save_residuals, "w")
        resid_file.write("iteration,residual\n")

    try:
        # ---- main loop (algorithm.inc:1491-1722) --------------------------
        while unconverged > nex and iteration < rcfg.max_iter:
            act = slice(locked, nevex)

            # lowerb refresh once everything is somewhat converged
            if np.all(resid[act] <= 0.5):
                lowerb = float(ritzv[nevex - 1])
            log.info(f"iteration {iteration}: lambda={lam_filter:.6e} "
                     f"lowerb={lowerb:.6e} upperb={upperb:.6e} "
                     f"unconverged={unconverged}")
            if lowerb > upperb:
                log.warn("lowerb > upperb — clamping (algorithm.inc:1524)")
                lowerb = upperb

            resid_last[act] = np.minimum(resid_last[act], resid[act])

            # -- degrees (algorithm.inc:1540) --
            if rcfg.optimization and iteration != 0:
                _, perm = calc_degrees_host(
                    unconverged, nex, upperb, lowerb, tol,
                    ritzv[act], resid[act], degrees[act], rcfg, is_sp)
                if not np.array_equal(perm, np.arange(unconverged)):
                    full_perm = np.concatenate(
                        [np.arange(locked), locked + perm])
                    V = permute_cols(V, full_perm)

            # -- filter (algorithm.inc:1546) --
            B = _col_block(rcfg.col_block, nevex)
            V, f_executed, f_hemms = filter_fn(
                H, V, degrees[act], locked, nevex, B, lam_filter, lowerb,
                upperb)
            if perf is not None:
                perf.add_filtered_vecs(int(np.sum(degrees[act])),
                                       executed=f_executed)
                perf.filter_hemm_steps += f_hemms
                perf.add_iter_blocksize(unconverged)
            t0 = toc("Filter", t0)

            # -- condition estimate for QR selection (algorithm.inc:1549) --
            cc = (upperb + lowerb) / 2
            ee = (upperb - lowerb) / 2
            rho_1 = _rho((float(ritzv[0]) - cc) / ee)
            rho_k = _rho((float(ritzv[locked]) - cc) / ee)
            with np.errstate(over="ignore"):
                cond = float(rho_k ** degrees[locked]
                             * rho_1 ** (int(np.max(degrees[act]))
                                         - degrees[locked]))
            if not np.isfinite(cond):
                cond = np.finfo(np.float64).max

            # -- QR + RR, shrunk to the padded active window once columns
            # lock (algorithm.inc:1712-18) --
            w_pad_rr, win_start = _window_pad(nevex, locked, B)
            use_window = rcfg.shrink_subspace and win_start > 0
            if use_window:
                V = qrops.orthonormalize_window(V, win_start, w_pad_rr,
                                                locked, cond, rcfg)
            else:
                V = qrops.orthonormalize(V, locked, cond, rcfg)
            t0 = toc("Qr", t0)

            # -- RR + residuals (fused) --
            if use_window:
                lw = locked - win_start
                Vw, ritz_dev, resid_dev = rrops.rayleigh_ritz_residuals(
                    H, slice_cols(V, win_start, w_pad_rr), lw,
                    polish=polish)
                V = update_cols(V, Vw, win_start)
                ritzv[act] = _host(ritz_dev)[lw:]
                resid[act] = _host(resid_dev)[lw:]
            else:
                V, ritz_dev, resid_dev = rrops.rayleigh_ritz_residuals(
                    H, V, locked, polish=polish)
                ritzv[act] = _host(ritz_dev)[act]
                resid[act] = _host(resid_dev)[act]
            t0 = toc("Rr", t0)

            if resid_file is not None:
                for _ in range(locked):
                    resid_file.write(f"{iteration},-1.0\n")
                for rr_ in resid[act][np.argsort(ritzv[act], kind="stable")]:
                    resid_file.write(f"{iteration},{rr_}\n")

            # -- locking (algorithm.inc:1692-1718) --
            n_examine = unconverged - nex
            new_converged, perm, early = locking_host(
                ritzv[act], resid[act], resid_last[act], n_examine, tol,
                is_sym=True)
            early_all.extend(early)
            if new_converged and not np.array_equal(perm,
                                                    np.arange(unconverged)):
                full_perm = np.concatenate([np.arange(locked), locked + perm])
                V = permute_cols(V, full_perm)
            locked += new_converged
            unconverged -= new_converged
            iteration += 1
            t0 = toc("Resids_Locking", t0)
            log.info(f"  -> new_converged={new_converged} locked={locked}")
    finally:
        if resid_file is not None:
            resid_file.close()

    # ---- final eigenvalue sort (algorithm.inc:1726-1774) -------------------
    order = np.argsort(ritzv[:nev], kind="stable")
    if not np.array_equal(order, np.arange(nev)):
        full_perm = np.concatenate([order, np.arange(nev, nevex)])
        V = permute_cols(V, full_perm)
        ritzv[:nev] = ritzv[order]
        resid[:nev] = resid[order]

    if timing:
        toc("All", t_all0)

    return SolveResult(
        ritzv=ritzv[:nev].copy(), V=V, resid=resid[:nev].copy(),
        iterations=iteration, locked=locked,
        converged=bool(unconverged <= nex),
        upperb=float(upperb), lowerb=float(lowerb), perf=perf,
        ritzv_full=ritzv.copy(), early_locked=early_all)
