"""Chebyshev-accelerated subspace iteration driver (Hermitian path).

Port of ``chase_tpu/solver.py::solve`` on torch devices: Lanczos
bounds, then degrees → filter → QR → RR with residuals → locking until
``unconverged ≤ nex`` (the reference's algorithm.inc:1376-1788).  The
host-side bookkeeping (calc_degrees, locking, the DoS quantile) is the JAX
package's, copied with its quirks; the device phases are plain torch plus
the ring HEMM kernel.

Problems are f32, f64, c64 or c128, all native: complex Hermitian H runs
the same loop in complex arithmetic (the JAX package embeds it as a 2N
real problem off the CPU, ``ops/realpair.py``; the port does not).

The precision ladder is the JAX package's (``solver.py:721-891``):
``mixed_precision`` filters an f64/c128 problem on its f32/c64 shadow
``DenseOperator.H_low``, ``bf16_filter`` an f32 problem on its bf16
shadow.  Iteration 0 runs the classic filter on the shadow; from
iteration 1 (``refine_filter``) the deviation-form refinement filter
(``ops/filter.chebyshev_filter_refine``), seeded by RR's residual vectors
in the problem dtype, keeps every filter FLOP on the shadow while RR and
QR stay in the problem precision.  Complex problems never take bf16.

One routing difference from the JAX package: with
``ring_backend="pallas"`` every filter whose operator is a dtype the
kernel takes (f32 or c64 problems, and the ladder's f32, c64 and bf16
shadows) runs as the p = 1 ring (``parallel/ring.py``), every H·Y
product on the hand-written CUDA kernel.  The JAX package has no ring on
one device and warns, using its windowed filter (on the real-pair
embedding, for a complex problem); both compute the same filter, so the
converged spectra agree.

On a process grid (``DenseOperator(H, grid=grid)``, ``parallel/mesh.py``)
the same loop runs on every rank with this rank's blocks: H's block of
``P('r', 'c')``, the multivectors' rows of ``P('r', None)``, the k×k
problems replicated.  The products and reductions are explicit
(``parallel/dist.py``), and every host decision — degrees, locking, the
convergence count, the QR choice and the CholQR flag — reads numbers that
are bitwise equal on every rank (all-reduced and broadcast from grid
column 0, or computed from such), so no rank leaves a collective
another waits in.  The start block and the Lanczos probes are drawn
whole on every rank from identically seeded generators and cut to each
rank's rows, so a grid solve starts from ``grid=None``'s numbers.  The
filter's route (``_ring_route``): a 1×1 grid as one device; a (p, 1) grid
the p-step chunk ring (``parallel/ring.py``; with the kernel on the card
its peer route, one ``ring_hemm_peers`` launch per product); an r×c grid
with r, c > 1 the 2-D ping-pong ring (``parallel/ring.
chebyshev_filter_ring2d`` and its refine twin), as in the JAX package —
each ring step on the ring_hemm kernel with ``ring_backend="pallas"``
and an operator of a dtype it takes (the 2-D ring's second pass on the
kernel's conjugate-transposed A route, reading the rank's block in
place), else on ``torch.matmul`` (the JAX package's XLA ring).  With no
ring (``ring_filter=False``, a (1, c) grid, or one device off the
kernel) the filter is windowed: the grid's product ``dist.hemm``, or
``torch.matmul`` on one device.

Every route runs one recurrence per filter kind, ``parallel/ring.
_filter_ring`` and ``_refine_ring``, each step on the padded window's
live suffix; ``parallel/ring.filter_product`` picks each step's product
from the route.  The JAX package's windowed filter retires whole
``col_block`` buckets instead; the live suffix is never wider.

Not ported here: the wide-f64 and transient-shadow modes (TPU
workarounds).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import ChaseConfig, set_matmul_precision
from .logger import get_logger
from .perf import (FILTER_COLS, WARM_START, PerfData, count, phase_clock,
                   span, to_host)
from .types import as_torch_dtype, is_double_base, low_precision_dtype
from .parallel.operator import DenseOperator
from .parallel import ring as pring
from .ops.ring_hemm import KERNEL_DTYPES
from .ops import filter as filt
from .ops import lanczos as lz
from .ops import qr as qrops
from .ops import rr as rrops
from .ops.blocks import (permute_cols, scale_lower_rows, set_head_cols,
                         slice_cols, update_cols)

__all__ = ["solve", "SolveResult", "calc_degrees_host", "locking_host",
           "uses_ring_kernel"]


def _shadow_filters(rcfg, dtype) -> bool:
    """Whether the precision ladder may filter a ``dtype`` problem on its
    shadow ``low_precision_dtype(dtype)``: f64/c128 with
    ``mixed_precision``, real f32 with ``bf16_filter`` (an f32 problem's
    ``mixed_precision`` alone runs its own H at TF32)."""
    if is_double_base(dtype):
        return bool(rcfg.mixed_precision)
    return bool(rcfg.bf16_filter) and not dtype.is_complex


def uses_ring_kernel(rcfg, dtype) -> bool:
    """Whether a solve with the resolved config ``rcfg`` on a ``dtype``
    problem filters on the ring_hemm kernel in some iteration (on a CUDA
    device; on the CPU the same path takes the kernel's plain version):
    ``ring_backend="pallas"``, and the problem's dtype or, with the
    ladder on, its shadow's is one the kernel takes."""
    dtype = as_torch_dtype(dtype)
    if rcfg.ring_filter is False or rcfg.ring_backend != "pallas":
        return False
    return dtype in KERNEL_DTYPES or (
        _shadow_filters(rcfg, dtype)
        and low_precision_dtype(dtype) in KERNEL_DTYPES)


def _ring_allowed(rcfg, op: DenseOperator, log) -> bool:
    """Whether filters may run as the p = 1 ring (HEMM on the ring_hemm
    kernel): the config asks for the kernel ring and some filter of this
    solve has an operator the kernel takes; each filter then takes the
    ring when its own operator's dtype is one of them.  The JAX package
    needs a grid with r > 1 for any ring and would warn here; the port
    runs the degenerate ring so the kernel carries the filter on one
    card."""
    if rcfg.ring_filter is False:
        return False
    eligible = uses_ring_kernel(rcfg, op.dtype)
    if rcfg.ring_backend == "pallas" and not eligible:
        log.warn(f"ring_backend='pallas' needs an f32 or c64 problem or the "
                 f"precision ladder's f32, c64 or bf16 shadow "
                 f"(dtype={op.dtype}) — using the windowed filter", "linalg")
    elif rcfg.ring_filter is True and not eligible:
        log.warn("ring_filter requested but no ring schedule fits one "
                 "device without ring_backend='pallas' — using the "
                 "windowed filter", "linalg")
    if not eligible:
        return False
    jax_route = ("its windowed filter on the 2N real-pair embedding"
                 if op.dtype.is_complex else "its windowed filter")
    log.info(f"ring filter on one device: p=1 ring with the ring_hemm "
             f"kernel (the JAX package would use {jax_route} here)",
             "linalg")
    return True


def _ring_route(rcfg, op: DenseOperator, log) -> Optional[str]:
    """The filter's ring schedule for this solve — the JAX package's
    ``_ring_mode`` with the port's p = 1 rule: "p1" (one device or a 1×1
    grid, :func:`_ring_allowed`), "1d" (a (p, 1) grid, p > 1: the chunk
    ring), "2d" (an r×c grid, r, c > 1: the ping-pong ring; the port
    pads N to a multiple of r·c, so it always fits), both on by default as
    in the JAX package, or None (the windowed filter: ``ring_filter=
    False``, or a (1, c) grid)."""
    grid = op.grid
    if grid is None or grid.nprocs == 1:
        return "p1" if _ring_allowed(rcfg, op, log) else None
    r, c = grid.size("r"), grid.size("c")
    if r == 1:
        if rcfg.ring_filter is True:
            log.warn(f"ring_filter requested but no ring schedule fits the "
                     f"grid {grid.shape} (it needs r > 1) — using the "
                     f"windowed filter", "linalg")
        return None
    if rcfg.ring_filter is False:
        return None
    mode = "1d" if c == 1 else "2d"
    step = ("the ring_hemm kernel where the filter's operator is f32, c64 "
            "or bf16" if rcfg.ring_backend == "pallas" else "torch.matmul")
    what = (f"a {r}-step chunk ring" if mode == "1d" else
            f"the ping-pong ring, {r}-step passes along 'r' and {c}-step "
            f"passes along 'c'")
    log.info(f"ring filter auto-enabled ({mode} schedule, grid {grid.shape}"
             f"): {what}, each step on {step}; opt out with "
             f"ring_filter=False", "linalg")
    if rcfg.ring_backend == "pallas" and not uses_ring_kernel(rcfg,
                                                              op.dtype):
        log.warn(f"ring_backend='pallas' needs an f32 or c64 problem or the "
                 f"precision ladder's f32, c64 or bf16 shadow "
                 f"(dtype={op.dtype}) — the ring's steps run on "
                 f"torch.matmul", "linalg")
    return mode


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


def _ring_work(tile: int, deg_win, first: int, products: int) -> tuple:
    """(executed column-steps, HEMM calls) of a filter from step
    ``first`` on: each step on the window's live suffix in whole ``tile``
    columns (``parallel/ring.live_suffixes``), × ``products``.  Counted
    in ``perf.COUNTS``: "filter_cols:executed" the executed column-steps,
    "filter_cols:useful" the columns live at each step (degree ≥ the
    step), × ``products``."""
    w = len(deg_win)
    starts = pring.live_suffixes(deg_win, first, int(np.max(deg_win)), tile)
    executed = sum(w - s for s in starts) * products
    live = np.maximum(np.asarray(deg_win, np.int64) - (first - 1), 0)
    count(FILTER_COLS + "executed", int(executed))
    count(FILTER_COLS + "useful", int(live.sum()) * products)
    return executed, len(starts) * products


def _row_major(V):
    """torch.linalg may hand back column-major blocks; the kernel reads
    row-major windows."""
    return V if V.stride(1) == 1 else V.contiguous()


def _filter_ring(H, V, degrees_act, locked, nevex, B, lam, lo, up, prod,
                 products: int = 1):
    """The Chebyshev filter of H (``products`` 1) or H² (2) on the padded
    active window (``parallel/ring._filter_ring``), each step on the
    window's live suffix with ``prod``'s product
    (``parallel/ring.filter_product``; the JAX package's ring path runs
    every step on the whole window, its windowed filter retires whole
    ``B`` buckets); H may be the ladder's shadow.  Writes the window into
    V; returns (V, executed column-steps, HEMM calls)."""
    w_pad, start = _window_pad(nevex, locked, B)
    deg_win = np.zeros(w_pad, np.int32)
    deg_win[locked - start:] = degrees_act
    V = _row_major(V)
    Y = pring._filter_ring(H, slice_cols(V, start, w_pad), deg_win, lam, lo,
                           up, int(deg_win.max()), products, prod)
    return (update_cols(V, Y, start),
            *_ring_work(prod.tile, deg_win, 1, products))


def _filter_refine_windowed(H_f, V, R, ritzv_act, degrees_act, locked,
                            nevex, B, lam, lo, up, max_deg, prod,
                            products: int = 1, seed=None):
    """Deviation-form refinement filter on the padded active window.

    Applies the SAME polynomial as :func:`_filter_ring`, factored as
    y = p(λ_j)v_j + [p(Hs) − p(λs_j)]v_j with the bracket recurrence
    running in H_f's fast dtype, seeded by the RR residual vectors R of
    the problem dtype (``parallel/ring._refine_ring``, each step on the
    window's live suffix with ``prod``'s product).  ``seed(R_w, ritz_w)``
    maps the window's residuals and padded Ritz values into the filter
    operator's space — (seed residuals, expansion points); None keeps
    them (the H² filter passes (H + θ)·r and θ²).  Returns (V, executed
    column-steps, HEMM calls)."""
    w_pad, start = _window_pad(nevex, locked, B)
    offset = locked - start
    deg_win = np.zeros(w_pad, np.int32)
    deg_win[offset:] = degrees_act
    ritz_win = np.zeros(w_pad, np.float64)
    ritz_win[offset:] = ritzv_act
    R_win = slice_cols(R, start, w_pad)
    if seed is not None:
        R_win, ritz_win = seed(R_win, ritz_win)
    tables = filt.refine_tables(ritz_win, deg_win, lam, lo, up, max_deg)
    V = _row_major(V)
    Y = pring._refine_ring(H_f, slice_cols(V, start, w_pad), R_win, deg_win,
                           *tables, (up + lo) / 2.0, int(deg_win.max()),
                           products, prod)
    return (update_cols(V, Y, start),
            *_ring_work(prod.tile, deg_win, 2, products))


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


def _draw(op: DenseOperator, k: int, generator,
          damped: bool = False) -> torch.Tensor:
    """An (N, k) standard normal block from ``generator`` (its lower rows
    × 0.001 with ``damped``: the BSE initVecs' damping), drawn whole and
    cut to this rank's rows on a grid (every rank's generator is seeded
    alike, so the ranks hold the rows of one block — the block a
    ``grid=None`` solve draws)."""
    V = torch.randn((op.N, k), generator=generator, device=op.device,
                    dtype=op.dtype)
    if damped:
        V = scale_lower_rows(V, 0.001)
    return V if op.grid is None else op.local_rows(V).clone()


def _host(t: torch.Tensor, site: str) -> np.ndarray:
    """A device tensor's values on the host: one host sync at ``site``."""
    return to_host(t, site).astype(np.float64)


def _lanczos_dos(op: DenseOperator, V, V0, m: int, numvec: int,
                 nevex: int, generator, log):
    """Lanczos spectral estimation and the DoS start (algorithm.inc:
    1438-1446, 1160-1189): (V with the DoS vectors below the DoS lower
    bound set in, the initial Ritz value estimates, upperb)."""
    H, N = op.H, op.N
    if V0 is not None:
        # user-provided basis: probe with FRESH random vectors — a Krylov
        # space seeded with (near-)converged eigenvectors breaks down
        # immediately and the DoS bounds collapse
        probes = _draw(op, numvec, generator)
    else:
        probes = V[:, :numvec]
    alphas, betas, basis = lz.lanczos_scan(H, probes, m=m, want_basis=True,
                                           grid=op.grid)
    a_np = _host(alphas, "solver.lanczos")
    b_np = _host(betas, "solver.lanczos")
    theta, tau, ritzV_last = lz.lanczos_tridiag_host(a_np, b_np)
    upperb = lz.upper_bound(theta, b_np[-1])
    lam, lowerb = lz.dos_lower_bound(theta, tau, nevex, N)
    # extract DoS vectors below lowerb
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
    return V, ritzv, upperb


def _warm_bounds(op: DenseOperator, ritzv0, m: int, numvec: int,
                 nevex: int, generator, log):
    """The warm start's bounds: (the Ritz value estimates, upperb, the
    damped interval's lower edge before ``decaying_rate``).

    The bounds-only Lanczos runs on ``numvec`` FRESH random probes (a
    Krylov space seeded with a converged eigenvector of the previous
    problem underestimates lambda_max); the first, drawn alone, sets
    upperb as the reference's one probe does.  The edge is the previous
    solve's largest Ritz value, as in the reference, unless it lies above
    the probes' DoS quantile of 2·nevex: where a cold solve's DoS edge
    fell below lambda_nevex, its last extra columns held only the damped
    interval's components, kept Ritz values deep in the spectrum and a
    large residual, and the solve still converged its nev pairs.  A filter
    damping from such a value separates nothing, so the edge becomes the
    largest previous Ritz value at or below the DoS quantile of nevex (the
    cold start's edge), or the quantile where none is.  A port decision:
    the JAX package takes max(ritzv0) whatever it is."""
    N = op.N
    probes = torch.cat([_draw(op, 1, generator),
                        _draw(op, numvec - 1, generator)], dim=1)
    alphas, betas, _ = lz.lanczos_scan(op.H, probes, m=m, want_basis=False,
                                       grid=op.grid)
    a_np = _host(alphas, "solver.lanczos")
    b_np = _host(betas, "solver.lanczos")
    theta, tau, _ = lz.lanczos_tridiag_host(a_np, b_np, want_vectors=False)
    upperb = lz.upper_bound(theta[:1], b_np[-1, :1])
    ritzv = np.asarray(ritzv0, np.float64).copy()
    edge = float(np.max(ritzv))
    _, ceiling = lz.dos_lower_bound(theta, tau, 2 * nevex, N)
    if edge > ceiling:
        _, dos = lz.dos_lower_bound(theta, tau, nevex, N)
        log.info(f"warm start: max(ritzv0)={edge:.6e} lies above the DoS "
                 f"quantile of 2·nevex {ceiling:.6e}; lower edge capped by "
                 f"the DoS quantile of nevex {dos:.6e}")
        count(WARM_START + "dos_lowered")
        # the quantile is a quadrature node of the probes' Lanczos, coarse
        # by the nodes' spacing; the previous values below it estimate the
        # eigenvalues the block's sound columns hold
        below = ritzv[ritzv <= dos]
        edge = float(np.max(below)) if below.size else dos
    return ritzv, upperb, edge


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
      perf: optional PerfData to fill with phase timings/FLOPs (the
          phases' ends are the spans', timed by ``perf.PhaseClock``).
      generator: torch.Generator on op's device for the start block and
          the Lanczos probes (default: seeded from ``config.seed``).

    Returns: SolveResult.
    """
    with phase_clock(perf, op.device):
        return _solve(op, nev, nex, config, V0, ritzv0, perf, generator)


def _solve(op: DenseOperator, nev: int, nex: int, config, V0, ritzv0,
           perf: Optional[PerfData], generator) -> SolveResult:
    cfg = config or ChaseConfig()
    rcfg = cfg.resolve(op.dtype, op.device)
    log = get_logger()
    N, nevex = op.N, nev + nex
    if nevex > N:
        raise ValueError(f"nev+nex = {nevex} exceeds N = {N}")
    if rcfg.small_dense_backend not in ("auto", "device"):
        log.info(f"small_dense_backend={rcfg.small_dense_backend!r} is a "
                 f"no-op in the PyTorch port (projected problems stay on "
                 f"the device)", "linalg")
    set_matmul_precision(rcfg.matmul_precision)
    is_sp = not is_double_base(op.dtype)
    is_complex = op.dtype.is_complex
    tol = rcfg.tol
    polish = rcfg.polish_passes()
    device = op.device
    H = op.H

    # ---- initVecs (chase_cpu.hpp:296-327) --------------------------------
    approx = rcfg.approx and V0 is not None
    if approx and ritzv0 is None:
        raise ValueError("approx mode needs ritzv0 from a previous solve")
    with span("chase.init_vecs"):
        if rcfg.sym_check:
            from .ops.checks import check_hermitian
            if not check_hermitian(H, grid=op.grid):
                log.warn("input matrix failed the randomized hermiticity "
                         "probe (checkSymmetryEasy analogue) — results may "
                         "be invalid")
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(rcfg.seed)
        if not approx:
            V = (op.place_block(V0) if V0 is not None
                 else _draw(op, nevex, generator))
            V = qrops.orthonormalize(V, 0, 1.0, rcfg, op.grid)

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
        with span("chase.lanczos"):
            V, ritzv, upperb = _lanczos_dos(op, V, V0, m, numvec, nevex,
                                            generator, log)
        edge = float(np.max(ritzv))
    else:
        # the warm start: the caller's block placed, the bounds-only
        # Lanczos and the damped interval's lower edge
        with span("chase.warm_start"):
            count(WARM_START + "members")
            V = op.place_block(V0)
            with span("chase.lanczos"):
                ritzv, upperb, edge = _warm_bounds(op, ritzv0, m, numvec,
                                                   nevex, generator, log)

    # sign-aware scaling: push a negative upperb toward zero correctly
    upperb = upperb * rcfg.upperb_scale if upperb > 0 \
        else upperb / rcfg.upperb_scale

    lowerb = edge * rcfg.decaying_rate
    lam_filter = float(np.min(ritzv))

    locked = 0
    unconverged = nevex
    iteration = 0
    early_all: list = []
    route = _ring_route(rcfg, op, log)

    # Deviation-form refinement eligibility (the precision ladder): DP
    # problems with mixed_precision keep the filter FLOPs in f32/c64
    # forever; real f32 problems with the bf16 rung keep them on the bf16
    # shadow.  It needs Ritz values and residual vectors, so it engages
    # from iteration 1.
    refine_capable = rcfg.refine_filter and (
        (not is_sp and rcfg.mixed_precision)
        or (is_sp and rcfg.bf16_filter and not is_complex))
    R_prev = None        # (N, nevex) RR residual vectors, problem dtype
    if is_sp and rcfg.mixed_precision and route is not None \
            and rcfg.ring_backend == "pallas":
        log.info("mixed_precision on an f32/c64 problem asks for TF32 filter "
                 "products while residuals are large; the ring kernel "
                 "multiplies in 3xTF32 whatever matmul_precision says",
                 "linalg")

    resid_file = None
    if rcfg.save_residuals:
        # per-iteration residual history CSV (CHASE_SAVE_RESIDUALS,
        # algorithm.inc:1467-1488): locked slots logged as -1.0
        resid_file = open(rcfg.save_residuals, "w")
        resid_file.write("iteration,residual\n")

    try:
        # ---- main loop (algorithm.inc:1491-1722) --------------------------
        while unconverged > nex and iteration < rcfg.max_iter:
            with span("chase.iteration"):
                act = slice(locked, nevex)

                # lowerb refresh once everything is somewhat converged
                if np.all(resid[act] <= 0.5):
                    lowerb = float(ritzv[nevex - 1])
                log.info(f"iteration {iteration}: lambda={lam_filter:.6e} "
                         f"lowerb={lowerb:.6e} upperb={upperb:.6e} "
                         f"unconverged={unconverged}")
                if lowerb > upperb:
                    log.warn("lowerb > upperb — clamping "
                             "(algorithm.inc:1524)")
                    lowerb = upperb

                resid_last[act] = np.minimum(resid_last[act], resid[act])

                # -- degrees (algorithm.inc:1540) --
                with span("chase.degrees"):
                    if rcfg.optimization and iteration != 0:
                        _, perm = calc_degrees_host(
                            unconverged, nex, upperb, lowerb, tol,
                            ritzv[act], resid[act], degrees[act], rcfg, is_sp)
                        if not np.array_equal(perm, np.arange(unconverged)):
                            full_perm = np.concatenate(
                                [np.arange(locked), locked + perm])
                            V = permute_cols(V, full_perm)
                            if R_prev is not None:
                                R_prev = permute_cols(R_prev, full_perm)

                # -- filter (algorithm.inc:1546) --
                with span("chase.filter"):
                    B = _col_block(rcfg.col_block, nevex)
                    # precision ladder (the reference's DP→SP filter switch):
                    # while the wanted pairs are far from converged, filter in
                    # reduced precision — 64-bit problems on their f32/c64
                    # shadow, 32-bit problems with mixed_precision on their own
                    # H at TF32
                    min_resid = (float(np.min(resid[locked:nev]))
                                 if locked < nev else 0.0)
                    use_low = (rcfg.mixed_precision and locked < nev
                               and min_resid > rcfg.mixed_precision_threshold)
                    # bf16 rung (real f32 problems): bf16 operator, f32 carry
                    # and sums.  Gated on the spectral radius's MAGNITUDE: a
                    # signed upperb (negative-definite spectrum) would make the
                    # gate negative and the rung would never disengage
                    spec_scale = max(abs(lam_filter), abs(upperb))
                    use_bf16 = (rcfg.bf16_filter and is_sp and not is_complex
                                and locked < nev
                                and min_resid > rcfg.bf16_filter_threshold
                                * spec_scale)
                    use_refine = refine_capable and R_prev is not None
                    if use_refine:
                        # fast-dtype recurrence seeded by the problem-precision
                        # residuals: no threshold, never hands back
                        use_low = use_bf16 = False
                        H_f = op.H_low
                    elif use_bf16 or (use_low and not is_sp):
                        H_f = op.H_low
                    else:
                        H_f = H
                    prod = pring.filter_product(
                        route, H_f, op.grid, rcfg.ring_backend == "pallas")
                    # the SP ladder's low phase: TF32 products off the kernel
                    tf32 = use_low and is_sp and not prod.kernel
                    if tf32:
                        set_matmul_precision("high")
                    try:
                        if use_refine:
                            V, f_executed, f_hemms = _filter_refine_windowed(
                                H_f, V, R_prev, ritzv[act], degrees[act],
                                locked, nevex, B, lam_filter, lowerb,
                                upperb, rcfg.max_deg, prod)
                        else:
                            V, f_executed, f_hemms = _filter_ring(
                                H_f, V, degrees[act], locked, nevex, B,
                                lam_filter, lowerb, upperb, prod)
                    finally:
                        if tf32:
                            set_matmul_precision(rcfg.matmul_precision)
                    H_f = prod = None
                    if perf is not None:
                        perf.add_filtered_vecs(
                            int(np.sum(degrees[act])),
                            low=use_refine or use_bf16 or use_low,
                            executed=f_executed)
                        perf.filter_hemm_steps += f_hemms
                        perf.add_iter_blocksize(unconverged)

                with span("chase.qr"):
                    # -- condition estimate for QR selection
                    # (algorithm.inc:1549) --
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

                    # -- QR + RR, shrunk to the padded active window once
                    # columns lock (algorithm.inc:1712-18) --
                    w_pad_rr, win_start = _window_pad(nevex, locked, B)
                    use_window = rcfg.shrink_subspace and win_start > 0
                    if use_window:
                        V = qrops.orthonormalize_window(V, win_start, w_pad_rr,
                                                        locked, cond, rcfg,
                                                        op.grid)
                    else:
                        V = qrops.orthonormalize(V, locked, cond, rcfg,
                                                 op.grid)

                # -- RR + residuals (fused) --
                with span("chase.rr"):
                    if use_window:
                        lw = locked - win_start
                        Vw, ritz_dev, resid_dev, *Rw = \
                            rrops.rayleigh_ritz_residuals(
                                H, slice_cols(V, win_start, w_pad_rr), lw,
                                polish=polish, want_vectors=refine_capable,
                                grid=op.grid)
                        V = update_cols(V, Vw, win_start)
                        if refine_capable:
                            if R_prev is None:
                                R_prev = torch.zeros_like(V)
                            R_prev = update_cols(R_prev, Rw[0], win_start)
                        ritzv[act] = _host(ritz_dev, "solver.rr")[lw:]
                        resid[act] = _host(resid_dev, "solver.rr")[lw:]
                    else:
                        V, ritz_dev, resid_dev, *Rv = \
                            rrops.rayleigh_ritz_residuals(
                                H, V, locked, polish=polish,
                                want_vectors=refine_capable, grid=op.grid)
                        if refine_capable:
                            R_prev = Rv[0]
                        ritzv[act] = _host(ritz_dev, "solver.rr")[act]
                        resid[act] = _host(resid_dev, "solver.rr")[act]
                    if op.grid is not None:
                        op.grid.check_peers()

                # -- locking (algorithm.inc:1692-1718) --
                with span("chase.locking"):
                    if resid_file is not None:
                        for _ in range(locked):
                            resid_file.write(f"{iteration},-1.0\n")
                        for rr_ in resid[act][np.argsort(ritzv[act],
                                                         kind="stable")]:
                            resid_file.write(f"{iteration},{rr_}\n")
                    n_examine = unconverged - nex
                    new_converged, perm, early = locking_host(
                        ritzv[act], resid[act], resid_last[act], n_examine,
                        tol, is_sym=True)
                    early_all.extend(early)
                    if new_converged and not np.array_equal(
                            perm, np.arange(unconverged)):
                        full_perm = np.concatenate([np.arange(locked),
                                                    locked + perm])
                        V = permute_cols(V, full_perm)
                        if R_prev is not None:
                            R_prev = permute_cols(R_prev, full_perm)
                    locked += new_converged
                    unconverged -= new_converged
                    iteration += 1
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

    return SolveResult(
        ritzv=ritzv[:nev].copy(), V=V, resid=resid[:nev].copy(),
        iterations=iteration, locked=locked,
        converged=bool(unconverged <= nex),
        upperb=float(upperb), lowerb=float(lowerb), perf=perf,
        ritzv_full=ritzv.copy(), early_locked=early_all)
