"""User-facing API.

Port of ``chase_tpu/api.py``'s ``eigsh``, ``eigsh_sequence``,
``eigsh_pseudo`` and ``estimate_spectral_bounds`` on one torch device, for
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

``device`` is explicit (default "cuda") and never falls back: without a
card, ``device="cuda"`` raises RuntimeError.  Fused solves are the fused
solver's slice (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import ChaseConfig, set_matmul_precision
from .parallel.operator import DenseOperator, resolve_device
from .perf import PerfData
from . import solver_pseudo
from .solver import solve, SolveResult, uses_ring_kernel
from .types import as_torch_dtype

__all__ = ["eigsh", "eigsh_sequence", "eigsh_pseudo",
           "estimate_spectral_bounds"]


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


def eigsh(H, nev: int, nex: Optional[int] = None, *,
          tol: Optional[float] = None,
          v0=None, ritzv0=None, approx: bool = False,
          largest: bool = False,
          config: Optional[ChaseConfig] = None,
          device="cuda",
          collect_perf: bool = False,
          generator: Optional[torch.Generator] = None) -> SolveResult:
    """Compute the ``nev`` lowest eigenpairs of a dense Hermitian H.

    Args:
      H: (N, N) real symmetric (f32/f64) or complex Hermitian (c64/c128)
         array (numpy or torch), or a DenseOperator (which carries its own
         device).
      nev: number of wanted eigenpairs.
      nex: extra search-space size (default: max(nev//4, 8)).
      tol: residual tolerance (default per dtype: 1e-10 DP / 1e-5 SP).
      v0: optional (N, nev+nex) starting subspace.
      ritzv0: previous Ritz values (required with approx=True).
      approx: warm-start mode ('A' in the reference C interface).
      largest: the top end of the spectrum instead (solved as -H).
      config: full ChaseConfig for everything else.
      device: torch device to solve on ("cuda", "cuda:1", "cpu", ...).
      collect_perf: attach a PerfData with phase timings to the result.
      generator: torch.Generator on ``device`` (default: config.seed).

    Returns:
      SolveResult with .ritzv (nev,), .V (N, nev+nex) tensor on ``device``
      in H's dtype whose first nev columns are the eigenvectors, .resid,
      .converged, ...
    """
    nex, cfg = _nex_and_config(nev, nex, tol, v0, approx, config)

    if largest:
        # the lowest end of -H is the top end of H
        if isinstance(H, DenseOperator):
            raise ValueError("largest=True needs a raw matrix, not an "
                             "operator — pass -H yourself instead")
        res = eigsh(-H, nev, nex, tol=tol, v0=v0,
                    ritzv0=None if ritzv0 is None else -np.asarray(ritzv0),
                    approx=approx, config=config, device=device,
                    collect_perf=collect_perf, generator=generator)
        order = np.arange(len(res.ritzv))[::-1].copy()
        res.ritzv = (-res.ritzv)[order]
        res.resid = res.resid[order]
        full = np.concatenate([order, np.arange(nev, res.V.shape[1])])
        res.V = res.V[:, torch.as_tensor(full, device=res.V.device)]
        if res.ritzv_full is not None:
            res.ritzv_full = (-res.ritzv_full)[full[:len(res.ritzv_full)]]
        return res

    op = H if isinstance(H, DenseOperator) else DenseOperator(H, device)
    perf = PerfData() if collect_perf else None
    return solve(op, nev, nex, config=cfg, V0=v0, ritzv0=ritzv0, perf=perf,
                 generator=generator)


def eigsh_pseudo(H, nev: int, nex: Optional[int] = None, *,
                 tol: Optional[float] = None,
                 v0=None, ritzv0=None, approx: bool = False,
                 config: Optional[ChaseConfig] = None,
                 device="cuda",
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

    Raises ValueError on odd N, on nev+nex > N/2 and on ``approx``
    without ``v0``; RuntimeError for ``device="cuda"`` without a card.
    """
    nex, cfg = _nex_and_config(nev, nex, tol, v0, approx, config)
    op = H if isinstance(H, DenseOperator) else DenseOperator(
        H, device, pseudo_hermitian=True)
    perf = PerfData() if collect_perf else None
    return solver_pseudo.solve_pseudo(op, nev, nex, config=cfg, V0=v0,
                                      ritzv0=ritzv0, perf=perf,
                                      generator=generator)


def eigsh_sequence(matrices, nev: int, nex: Optional[int] = None, *,
                   tol: Optional[float] = None,
                   config: Optional[ChaseConfig] = None,
                   device="cuda",
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
    device.  The ladder's residual vectors live inside one solve: a warm
    start carries V and the Ritz values only, as in the JAX package.

    ``warmup=True`` is the JAX package's precompile: here it builds (on a
    fresh checkout) and loads the CUDA kernels' library — every route of
    the kernel, the bf16 one included — before member 0 when the solve
    will filter on the ring kernel (a CUDA device, ``ring_backend=
    "pallas"``, an f32 or c64 problem or the ladder's f32, c64 or bf16
    shadow), and does nothing otherwise — PyTorch runs eagerly and has
    nothing else to compile.
    """
    v0 = ritzv0 = None
    for H in matrices:
        if v0 is None and warmup:
            dev = H.device if isinstance(H, DenseOperator) \
                else resolve_device(device)
            dtype = as_torch_dtype(H.dtype)
            rcfg = (config or ChaseConfig()).resolve(dtype, dev)
            if dev.type == "cuda" and uses_ring_kernel(rcfg, dtype):
                from .ops.ring_hemm import load_kernels
                load_kernels()
        res = eigsh(H, nev, nex, tol=tol, config=config, device=device,
                    collect_perf=collect_perf, v0=v0, ritzv0=ritzv0,
                    approx=v0 is not None)
        v0, ritzv0 = res.V, res.ritzv_full
        yield res


def estimate_spectral_bounds(H, *, num_lanczos: int = 4,
                             lanczos_iter: int = 25, nev: int = 0,
                             config: Optional[ChaseConfig] = None,
                             device="cuda",
                             generator: Optional[torch.Generator] = None
                             ) -> dict:
    """Standalone stochastic Lanczos + DoS spectral estimator.

    The bounds machinery the solver uses internally (the reference's
    algorithm.inc:1067-1214): a spectral upper bound, the smallest Ritz
    value, and — when ``nev > 0`` — the DoS quantile locating the damping
    interval's lower edge for a nev-sized subspace.  ``num_lanczos``
    probes from ``generator`` (default: seeded from ``config.seed``) run
    ``lanczos_iter`` steps, rounded down to an even count as in the
    solver.

    Returns {"upperb", "lambda_min", "lowerb"} (lowerb = lambda_min when
    nev == 0).
    """
    from .ops import lanczos as lz
    op = H if isinstance(H, DenseOperator) else DenseOperator(H, device)
    rcfg = (config or ChaseConfig()).resolve(op.dtype, op.device)
    set_matmul_precision(rcfg.matmul_precision)
    N = op.N
    if generator is None:
        generator = torch.Generator(device=op.device).manual_seed(rcfg.seed)
    m = min(N // 2, lanczos_iter)
    m -= m % 2
    m = max(m, 2)
    probes = torch.randn((N, num_lanczos), generator=generator,
                         device=op.device, dtype=op.dtype)
    alphas, betas, _ = lz.lanczos_scan(op.H, probes, m=m, want_basis=False)
    a_np, b_np = alphas.double().cpu().numpy(), betas.double().cpu().numpy()
    theta, tau, _ = lz.lanczos_tridiag_host(a_np, b_np)
    upperb = lz.upper_bound(theta, b_np[-1])
    lam_min = float(theta.min())
    lowerb = lam_min
    if nev > 0:
        _, lowerb = lz.dos_lower_bound(theta, tau, nev, N)
    return {"upperb": float(upperb), "lambda_min": lam_min,
            "lowerb": float(lowerb)}
