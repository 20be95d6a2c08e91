"""User-facing API.

Port of ``chase_tpu/api.py``'s ``eigsh``, ``eigsh_sequence``,
``eigsh_pseudo`` and ``estimate_spectral_bounds`` on torch devices, for
real symmetric (f32/f64) and complex Hermitian (c64/c128) H, and for
pseudo-Hermitian (Bethe–Salpeter) H of the same dtypes:

    res = chase_tpu_torch.eigsh(H, nev=100, nex=40, device="cuda")
    res.ritzv, res.V[:, :100], res.resid, res.converged

Sequences of correlated problems (the reference's mode='A' warm start):

    for res in eigsh_sequence(matrices, nev, nex):   # any iterable
        ...
    # by hand: eigsh(H2, nev, nex, v0=r1.V, ritzv0=r1.ritzv_full,
    #                approx=True)

BSE problems H = [[A, B], [−conj(B), −conj(A)]] (spectrum real and
symmetric about 0) take ``eigsh_pseudo``, which returns the ``nev``
smallest positive eigenpairs:

    res = chase_tpu_torch.eigsh_pseudo(H, nev=100, nex=40, device="cuda")

The precision ladder is a config away, as in the JAX package:
``ChaseConfig(mixed_precision=True)`` filters an f64/c128 problem on its
f32/c64 shadow (the deviation-form refinement keeps tol 1e-10 reachable),
``ChaseConfig(bf16_filter=True)`` a real f32 problem on its bf16 shadow;
``res.perf.low_flop_fraction(...)`` says how much of the work ran there.

The device-resident solvers ``eigsh_fused`` and ``eigsh_pseudo_fused``
keep all of the loop's bookkeeping on the device (``fused.py``,
``fused_pseudo.py``) — the serving path for small and repeated problems:

    res = chase_tpu_torch.eigsh_fused(H, nev=100, device="cuda")

On a process grid (``parallel/mesh.py``; ``multihost.init_grid()`` under
``torchrun``) every rank calls the same entry point with the same
arguments and the grid:

    grid = chase_tpu_torch.parallel.multihost.init_grid()
    res = chase_tpu_torch.eigsh(H, nev=100, nex=40, grid=grid)

H is whole on every rank (numpy or tensor) or a DTensor sharded
``(Shard(0), Shard(1))``; ``res.V`` is a DTensor ``(Shard(0),
Replicate())`` on the grid's mesh, ``res.ritzv`` and ``res.resid`` are
the same numpy arrays on every rank.  Every entry point here and
``warmup`` take any grid; a BSE H is padded S-preservingly on it
(``parallel/operator.py``).

``device`` is explicit (default "cuda", or the grid's device) and never
falls back: without a card, ``device="cuda"`` raises RuntimeError, and a
fused solve that fails raises (the JAX package retreats to its host
driver; the port does not).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from .config import ChaseConfig, set_matmul_precision
from .logger import get_logger
from .parallel.operator import DenseOperator
from .perf import PerfData, item, span, to_device, to_host
from . import solver_pseudo
from .solver import (solve, SolveResult, _chunk_product, _draw,
                     _ring_route)

__all__ = ["eigsh", "eigsh_fused", "eigsh_sequence", "eigsh_pseudo",
           "eigsh_pseudo_fused", "estimate_spectral_bounds"]


def _nex_and_config(nev, nex, tol, v0, approx, config):
    """The default nex (max(nev//4, 8)) and the config with ``tol`` and
    ``approx`` applied; ValueError for ``approx`` without ``v0``."""
    if nex is None:
        nex = max(nev // 4, 8)
    if approx and v0 is None:
        raise ValueError("approx=True (warm start) needs v0 (and ritzv0) "
                         "from a previous solve")
    cfg = config or ChaseConfig()
    updates = {}
    if tol is not None:
        updates["tol"] = tol
    if approx:
        updates["approx"] = True
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
    return nex, cfg


def _operator(H, device, grid, pseudo_hermitian: bool = False
              ) -> DenseOperator:
    """H as a DenseOperator (an operator is used as it is); its placement
    is the span ``chase.operator``."""
    if isinstance(H, DenseOperator):
        return H
    with span("chase.operator"):
        return DenseOperator(H, device, grid=grid,
                             pseudo_hermitian=pseudo_hermitian)


def _unpad(res: SolveResult, op: DenseOperator) -> SolveResult:
    """On a grid, ``res.V`` (this rank's rows of the padded block) becomes
    a DTensor ``(Shard(0), Replicate())`` of the unpadded (N_orig, k)
    block on the grid's mesh; where padding makes this rank's rows differ
    from DTensor's even split of H's rows (always under the S-preserving
    pad, which splits them in halves), the rows are gathered over 'r' and
    re-cut once."""
    grid = op.grid
    if grid is None:
        return res
    from torch.distributed.tensor import DTensor, Replicate, Shard
    k = res.V.shape[1]
    r = grid.size("r")
    local = op.unpad_block(res.V)
    if -(-op.N_orig // r) != op.rows[1] or op.half is not None:
        full = op.unpad_whole(grid.all_gather(res.V, "r"))
        chunks = torch.chunk(full, r)
        i = grid.index("r")
        local = chunks[i] if i < len(chunks) else full[:0]
    res.V = DTensor.from_local(local, grid.mesh, (Shard(0), Replicate()),
                               run_check=False,
                               shape=torch.Size((op.N_orig, k)),
                               stride=(k, 1))
    return res


def _take_cols(V, idx):
    """V's columns ``idx`` (numpy), on a DTensor by its local rows."""
    from torch.distributed.tensor import DTensor
    if isinstance(V, DTensor):
        loc = V.to_local()
        sel = loc[:, to_device(idx, "api.take_cols", device=loc.device)]
        return DTensor.from_local(sel, V.device_mesh, V.placements,
                                  run_check=False, shape=V.shape,
                                  stride=V.stride())
    return V[:, to_device(idx, "api.take_cols", device=V.device)]


def eigsh(H, nev: int, nex: Optional[int] = None, *,
          tol: Optional[float] = None,
          v0=None, ritzv0=None, approx: bool = False,
          largest: bool = False,
          config: Optional[ChaseConfig] = None,
          grid=None,
          device=None,
          collect_perf: bool = False,
          generator: Optional[torch.Generator] = None) -> SolveResult:
    """Compute the ``nev`` lowest eigenpairs of a dense Hermitian H.

    Args:
      H: (N, N) real symmetric (f32/f64) or complex Hermitian (c64/c128)
         array (numpy or torch; on a grid whole on every rank, or a
         DTensor ``(Shard(0), Shard(1))``), or a DenseOperator (which
         carries its own device and grid).
      nev: number of wanted eigenpairs.
      nex: extra search-space size (default: max(nev//4, 8)).
      tol: residual tolerance (default per dtype: 1e-10 DP / 1e-5 SP).
      v0: optional (N, nev+nex) starting subspace.
      ritzv0: previous Ritz values (required with approx=True).
      approx: warm-start mode ('A' in the reference C interface).
      largest: the top end of the spectrum instead (solved as -H).
      config: full ChaseConfig for everything else.
      grid: a Grid2D (``make_grid``) to solve on a process grid; every
         rank calls with the same arguments.
      device: torch device to solve on ("cuda", "cuda:1", "cpu", ...;
         default "cuda", or the grid's).
      collect_perf: attach a PerfData with phase timings to the result.
      generator: torch.Generator on ``device`` (default: config.seed;
         seeded alike on every rank of a grid).

    Returns:
      SolveResult with .ritzv (nev,), .V (N, nev+nex) tensor on ``device``
      in H's dtype — on a grid a DTensor (Shard(0), Replicate()) — whose
      first nev columns are the eigenvectors, .resid, .converged, ...
    """
    nex, cfg = _nex_and_config(nev, nex, tol, v0, approx, config)

    if largest:
        # the lowest end of -H is the top end of H
        if isinstance(H, DenseOperator):
            raise ValueError("largest=True needs a raw matrix, not an "
                             "operator — pass -H yourself instead")
        res = eigsh(-H, nev, nex, tol=tol, v0=v0,
                    ritzv0=None if ritzv0 is None else -np.asarray(ritzv0),
                    approx=approx, config=config, grid=grid, device=device,
                    collect_perf=collect_perf, generator=generator)
        order = np.arange(len(res.ritzv))[::-1].copy()
        res.ritzv = (-res.ritzv)[order]
        res.resid = res.resid[order]
        full = np.concatenate([order, np.arange(nev, res.V.shape[1])])
        res.V = _take_cols(res.V, full)
        if res.ritzv_full is not None:
            res.ritzv_full = (-res.ritzv_full)[full[:len(res.ritzv_full)]]
        return res

    with span("chase.solve"):
        op = _operator(H, device, grid)
        perf = PerfData() if collect_perf else None
        res = solve(op, nev, nex, config=cfg, V0=v0, ritzv0=ritzv0,
                    perf=perf, generator=generator)
        return _unpad(res, op)


def eigsh_pseudo(H, nev: int, nex: Optional[int] = None, *,
                 tol: Optional[float] = None,
                 v0=None, ritzv0=None, approx: bool = False,
                 config: Optional[ChaseConfig] = None,
                 grid=None,
                 device=None,
                 collect_perf: bool = False,
                 generator: Optional[torch.Generator] = None) -> SolveResult:
    """Compute the ``nev`` smallest-*positive* eigenpairs of a
    pseudo-Hermitian (BSE) matrix H = S·M, S = diag(I, −I) (spectrum real,
    symmetric about 0) — the reference's Solve_pseudo / ``*chase_pseudo_``.

    Args as for :func:`eigsh`; H (N, N) with N even, f32/f64/c64/c128, or
    a DenseOperator.  The search subspace holds 2·(nev+nex) vectors (the
    negative mirrors ride along by K-conjugation), so ``v0`` is (N,
    2·(nev+nex)) and nev+nex ≤ N/2.  ``ritzv0`` is accepted and unused, as
    in the JAX package.

    Returns:
      SolveResult with .ritzv (nev,) ascending positive eigenvalues, .V
      (N, 2·(nev+nex)) whose first nev columns are their eigenvectors,
      .resid, .converged, ...

    On ``grid`` H is padded S-preservingly when its halves do not divide
    by r·c, and ``res.V`` is a DTensor of the unpadded block, as for
    :func:`eigsh`.

    Raises ValueError on odd N, on nev+nex > N/2 and on ``approx``
    without ``v0``; RuntimeError for ``device="cuda"`` without a card.
    """
    nex, cfg = _nex_and_config(nev, nex, tol, v0, approx, config)
    with span("chase.solve"):
        op = _operator(H, device, grid, pseudo_hermitian=True)
        perf = PerfData() if collect_perf else None
        return _unpad(solver_pseudo.solve_pseudo(
            op, nev, nex, config=cfg, V0=v0, ritzv0=ritzv0, perf=perf,
            generator=generator), op)


def _collect_fused_perf(out, iters: int, t_all: float,
                        matrix_type: int = 0) -> PerfData:
    """PerfData from the fused solvers' device counters: the filtered
    vectors (those filtered on the ladder's or the bf16 rung's shadow
    apart, for ``low_flop_fraction``), the block sizes and the filter's
    HEMM steps; only 'All' is timed (the loop has no synchronised phase
    boundaries)."""
    perf = PerfData()
    perf.matrix_type = matrix_type
    perf.add_time("All", t_all)
    perf.filtered_vecs = int(item(out["filtered_vecs"], "api.fused_perf"))
    perf.filtered_vecs_low = int(item(out["filtered_low"], "api.fused_perf"))
    for b in to_host(out["block_history"][:iters], "api.fused_perf").tolist():
        perf.add_iter_blocksize(b)
    perf.filter_hemm_steps = out["hemm_steps"]
    return perf


def _write_resid_history(path: str, out, iters: int):
    """The CHASE_SAVE_RESIDUALS CSV from the fused solvers' residual
    history (locked slots as -1.0)."""
    hist = to_host(out["resid_history"][:iters], "api.resid_history")
    with open(path, "w") as f:
        f.write("iteration,residual\n")
        for i, row in enumerate(hist.tolist()):
            for r in row:
                f.write(f"{i},{r}\n")


def _fused_result(out, nev: int, t0: float, rcfg, collect_perf: bool,
                  matrix_type: int) -> SolveResult:
    """SolveResult of a fused solve: the host reads of its results, the
    perf counters, the residual CSV and the early-locked residuals."""
    ritzv = to_host(out["ritzv"].double(), "api.fused_result")
    resid = to_host(out["resid"].double(), "api.fused_result")
    locked = int(item(out["locked"], "api.fused_result"))
    iters = int(item(out["iterations"], "api.fused_result"))
    t_all = time.perf_counter() - t0
    perf = (_collect_fused_perf(out, iters, t_all, matrix_type)
            if collect_perf else None)
    if rcfg.save_residuals:
        _write_resid_history(rcfg.save_residuals, out, iters)
    eh = to_host(out["early_history"][:iters].double(), "api.fused_result")
    return SolveResult(
        ritzv=ritzv[:nev], V=out["V"], resid=resid[:nev], iterations=iters,
        locked=locked, converged=bool(locked >= nev),
        upperb=float(item(out["upperb"], "api.fused_result")),
        lowerb=float(item(out["lowerb"], "api.fused_result")),
        perf=perf, ritzv_full=ritzv,
        early_locked=[float(x) for x in eh[eh >= 0]])


def _fused_setup(op: DenseOperator, cfg: ChaseConfig, generator):
    """The resolved config, the solve's generator and the solver keywords
    every fused solve shares (the ladder's shadow, the grid, and the
    filter products' routing: ``solver._chunk_product`` on the route of
    ``solver._ring_route``, with ``fused``: on an r×c grid the fused
    solvers take ``dist.hemm``, as the JAX package's, which have no
    ring)."""
    rcfg = cfg.resolve(op.dtype, op.device)
    if rcfg.small_dense_backend not in ("auto", "device"):
        get_logger().info(f"small_dense_backend="
                          f"{rcfg.small_dense_backend!r} is a no-op in the "
                          f"PyTorch port (projected problems stay on the "
                          f"device)", "linalg")
    set_matmul_precision(rcfg.matmul_precision)
    if generator is None:
        generator = torch.Generator(device=op.device).manual_seed(rcfg.seed)
    route = _ring_route(rcfg, op, get_logger())
    if route == "2d":
        get_logger().info("the fused solvers have no 2-D ring: their filter "
                          "products take dist.hemm on this grid", "linalg")
    refine = bool(rcfg.refine_filter and rcfg.mixed_precision
                  and rcfg.is_double)
    bf16 = bool(rcfg.bf16_filter and not rcfg.is_double
                and not op.dtype.is_complex)
    kw = dict(tol=rcfg.tol, deg0=rcfg.deg, max_deg=rcfg.max_deg,
              deg_extra=rcfg.deg_extra, max_iter=rcfg.max_iter,
              lanczos_iter=rcfg.lanczos_iter, num_lanczos=rcfg.num_lanczos,
              optimization=rcfg.optimization, eigh_polish=rcfg.polish_passes(),
              bf16_filter=rcfg.bf16_filter,
              bf16_threshold=rcfg.bf16_filter_threshold,
              refine_filter=refine, qr_hi_prec=rcfg.qr_hi_prec,
              H_low=op.H_low if (refine or bf16) else None,
              chunk=functools.partial(_chunk_product, route,
                                      rcfg.ring_backend, fused=True),
              grid=op.grid)
    return rcfg, generator, kw


def eigsh_fused(H, nev: int, nex: Optional[int] = None, *,
                tol: Optional[float] = None, v0=None,
                largest: bool = False,
                config: Optional[ChaseConfig] = None,
                grid=None,
                device=None,
                collect_perf: bool = False,
                generator: Optional[torch.Generator] = None) -> SolveResult:
    """Device-resident Hermitian solve (``fused.solve_fused``): every
    piece of the loop's state stays on the device and the host reads one
    packed control tensor, the CholQR flag and ``eigh``'s own check per
    iteration.  Equivalent to :func:`eigsh` up to the JAX package's
    documented deltas (locking tie order, DoS vectors, the QR choice).

    Args as for :func:`eigsh`; ``v0`` (N, nev+nex) is a warm start — its
    subspace is kept (no DoS vectors) and the bounds come from fresh
    Lanczos probes drawn from ``generator``.  With ``collect_perf`` the
    PerfData carries the device counters (filtered vectors, block sizes,
    the filter's HEMM steps) and the 'All' time; ``save_residuals``
    writes the residual history CSV.  A solve that fails raises: there is
    no retreat to the host driver.  On ``grid`` the start block and the
    probes are drawn whole on every rank and cut to its rows.
    """
    nex, cfg = _nex_and_config(nev, nex, tol, None, False, config)
    if largest:
        if isinstance(H, DenseOperator):
            raise ValueError("largest=True needs a raw matrix, not an "
                             "operator — pass -H yourself instead")
        res = eigsh_fused(-H, nev, nex, tol=tol, v0=v0, config=config,
                          grid=grid, device=device,
                          collect_perf=collect_perf, generator=generator)
        order = np.arange(len(res.ritzv))[::-1].copy()
        res.ritzv = (-res.ritzv)[order]
        res.resid = res.resid[order]
        full = np.concatenate([order, np.arange(nev, res.V.shape[1])])
        res.V = _take_cols(res.V, full)
        res.ritzv_full = (-res.ritzv_full)[full[:len(res.ritzv_full)]]
        return res
    with span("chase.solve"):
        op = _operator(H, device, grid)
        k = nev + nex
        if k > op.N:
            raise ValueError(f"nev+nex = {k} exceeds N = {op.N}")
        rcfg, generator, kw = _fused_setup(op, cfg, generator)
        from .fused import solve_fused
        probes = None
        if v0 is None:
            V0 = _draw(op, k, generator)
        else:
            V0 = op.place_block(v0)
            probes = _draw(op, min(rcfg.num_lanczos, k), generator)
        t0 = time.perf_counter()
        out = solve_fused(op.H, V0, nev=nev, nex=nex, probes=probes,
                          inject_dos=v0 is None, phase_tiers=rcfg.fused_tiers,
                          **kw)
        return _unpad(_fused_result(out, nev, t0, rcfg, collect_perf, 0), op)


def eigsh_pseudo_fused(H, nev: int, nex: Optional[int] = None, *,
                       tol: Optional[float] = None, v0=None,
                       config: Optional[ChaseConfig] = None,
                       grid=None,
                       device=None,
                       collect_perf: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> SolveResult:
    """Device-resident BSE solve (``fused_pseudo.solve_pseudo_fused``):
    the nev smallest positive eigenpairs of a pseudo-Hermitian H, with the
    loop's state on the device as in :func:`eigsh_fused`.

    Args as for :func:`eigsh_pseudo`; ``v0`` (N, 2·(nev+nex)) is a warm
    start (fresh probes with the 0.001 lower-row damping).  The cold start
    block is random with its lower rows damped by 0.001 (drawn whole on
    every rank of a grid and cut to its rows).  A solve that fails
    raises.
    """
    nex, cfg = _nex_and_config(nev, nex, tol, None, False, config)
    with span("chase.solve"):
        op = _operator(H, device, grid, pseudo_hermitian=True)
        N, k = op.N, nev + nex
        if N % 2:
            raise ValueError("pseudo-Hermitian problems need even N")
        if k > N // 2:
            raise ValueError(f"nev+nex = {k} exceeds N/2 = {N // 2}")
        if v0 is not None and v0.shape[1] != 2 * k:
            raise ValueError(f"v0 has {v0.shape[1]} columns; the pseudo "
                             f"solver takes 2·(nev+nex) = {2 * k}")
        rcfg, generator, kw = _fused_setup(op, cfg, generator)
        from .fused_pseudo import solve_pseudo_fused

        probes = None
        if v0 is None:
            V0 = _draw(op, 2 * k, generator, damped=True)
        else:
            V0 = op.place_block(v0)
            probes = _draw(op, min(rcfg.num_lanczos, k), generator,
                           damped=True)
        t0 = time.perf_counter()
        out = solve_pseudo_fused(op.H, V0, nev=nev, nex=nex, probes=probes,
                                 inject_dos=v0 is None,
                                 cluster_aware=rcfg.cluster_aware_degrees,
                                 **kw)
        return _unpad(_fused_result(out, nev, t0, rcfg, collect_perf, 1), op)


def eigsh_sequence(matrices, nev: int, nex: Optional[int] = None, *,
                   tol: Optional[float] = None,
                   config: Optional[ChaseConfig] = None,
                   grid=None,
                   device=None,
                   collect_perf: bool = False,
                   warmup: bool = True):
    """Solve a sequence of correlated Hermitian problems with automatic
    warm-starting — the reference's flagship use case (the SCF iterations
    of DFT codes).

    ``matrices`` is an iterable of (N, N) arrays, tensors or
    DenseOperators; a generator keeps the whole sequence out of memory.
    Yields one SolveResult per member.  Every member after the first
    starts from the previous result (``v0=res.V``,
    ``ritzv0=res.ritzv_full``, ``approx=True``); the block stays on the
    device (on a grid, each rank keeps its rows).  The ladder's residual
    vectors live inside one solve: a warm start carries V and the Ritz
    values only, as in the JAX package.

    ``warmup=True`` runs :func:`chase_tpu_torch.warmup` on member 0's
    operator before solving it, as the JAX package does: it builds (on a
    fresh checkout) and loads the CUDA kernels' library when the solve
    will filter on the ring kernel, and does nothing otherwise.
    """
    v0 = ritzv0 = None
    for H in matrices:
        if v0 is None and warmup:
            from .warmup import warmup as _warmup
            H = _operator(H, device, grid)
            _warmup(H, nev, nex if nex is not None else max(nev // 4, 8),
                    config=config)
        res = eigsh(H, nev, nex, tol=tol, config=config, grid=grid,
                    device=device, collect_perf=collect_perf, v0=v0,
                    ritzv0=ritzv0, approx=v0 is not None)
        v0, ritzv0 = res.V, res.ritzv_full
        yield res


def estimate_spectral_bounds(H, *, num_lanczos: int = 4,
                             lanczos_iter: int = 25, nev: int = 0,
                             grid=None,
                             config: Optional[ChaseConfig] = None,
                             device=None,
                             generator: Optional[torch.Generator] = None
                             ) -> dict:
    """Standalone stochastic Lanczos + DoS spectral estimator.

    The bounds machinery the solver uses internally (the reference's
    algorithm.inc:1067-1214): a spectral upper bound, the smallest Ritz
    value, and — when ``nev > 0`` — the DoS quantile locating the damping
    interval's lower edge for a nev-sized subspace.  ``num_lanczos``
    probes from ``generator`` (default: seeded from ``config.seed``) run
    ``lanczos_iter`` steps, rounded down to an even count as in the
    solver.  On ``grid`` the probes are drawn whole on every rank and each
    keeps its rows; the result is the same dict on every rank.

    Returns {"upperb", "lambda_min", "lowerb"} (lowerb = lambda_min when
    nev == 0).
    """
    from .ops import lanczos as lz
    op = _operator(H, device, grid)
    rcfg = (config or ChaseConfig()).resolve(op.dtype, op.device)
    set_matmul_precision(rcfg.matmul_precision)
    N = op.N
    if generator is None:
        generator = torch.Generator(device=op.device).manual_seed(rcfg.seed)
    m = min(N // 2, lanczos_iter)
    m -= m % 2
    m = max(m, 2)
    probes = op.local_rows(torch.randn((N, num_lanczos), generator=generator,
                                       device=op.device, dtype=op.dtype))
    alphas, betas, _ = lz.lanczos_scan(op.H, probes, m=m, want_basis=False,
                                       grid=op.grid)
    a_np, b_np = alphas.double().cpu().numpy(), betas.double().cpu().numpy()
    theta, tau, _ = lz.lanczos_tridiag_host(a_np, b_np)
    upperb = lz.upper_bound(theta, b_np[-1])
    lam_min = float(theta.min())
    lowerb = lam_min
    if nev > 0:
        _, lowerb = lz.dos_lower_bound(theta, tau, nev, N)
    return {"upperb": float(upperb), "lambda_min": lam_min,
            "lowerb": float(lowerb)}
