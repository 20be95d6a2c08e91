"""Warm a solve's one-time costs up front.

Port of ``chase_tpu/warmup.py::warmup``.  The JAX version compiles every
phase program a solve can visit from a thread pool, because XLA compiles
at the first call of each shape.  PyTorch runs eagerly and compiles
nothing but this package's CUDA kernels, so here warming up means:

* building (nvcc, on a fresh checkout) and loading the kernels' library
  when the solve will filter on the ring kernel — a CUDA operator with
  ``ring_backend="pallas"`` and a problem, or a ladder shadow, of a dtype
  the kernel takes;
* with ``fused=True``, running the cold and the warm-start fused solve
  once on the operator with a tolerance met at once, so that the caching
  allocator holds the solve's blocks and cuSOLVER's handles exist.

On a process grid (``grid=``) every rank builds and loads the library on
its own card; the fused jobs wait for fused solvers on grids (ROADMAP
queue 1 item 5, part 2) and raise NotImplementedError on a grid larger
than 1×1.  There is no thread-pool precompile, so ``max_workers`` is
accepted and unused.  Usage::

    op = chase_tpu_torch.DenseOperator(H, "cuda")
    chase_tpu_torch.warmup(op, nev, nex, config=cfg, fused=True)
    res = chase_tpu_torch.eigsh_fused(op, nev, nex, config=cfg)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import ChaseConfig
from .logger import get_logger
from .parallel.operator import PART2, DenseOperator
from .solver import _col_block, _window_pad, uses_ring_kernel

__all__ = ["warmup"]


def _bucket_widths(nevex: int, B: int, pseudo: bool):
    """Every filter window width a host-driver solve can visit: the
    padded active windows (``solver._window_pad``), or for BSE the
    positive-candidate widths rounded up to B — the JAX package's list."""
    if pseudo:
        widths = {min(nevex, -(-u // B) * B) for u in range(1, nevex + 1)}
    else:
        widths = {_window_pad(nevex, locked, B)[0]
                  for locked in range(nevex + 1)} - {0}
    return sorted(widths, reverse=True)


def warmup(H, nev: int, nex: Optional[int] = None, *, config=None,
           grid=None, max_workers: int = 8, fused: bool = False,
           device=None) -> dict:
    """Do a solve's one-time work before the solve.

    Args:
      H: a DenseOperator (pass the same one to the solve) or an (N, N)
         array, placed on ``device`` (or ``grid``) here.  A BSE problem
         is warmed as a ``DenseOperator(H, pseudo_hermitian=True)``.
      nev, nex: the solve's block (nex default max(1, int(0.4·nev)), as in
         the JAX package).
      config: the ChaseConfig the solve will use.
      grid: the process grid of the solve (every rank calls warmup).
      max_workers: accepted for the JAX signature; unused.
      fused: also run ``eigsh_fused`` (``eigsh_pseudo_fused`` for a BSE
         operator) once cold and once from a warm start, with a tolerance
         met in the first iteration.

    Returns {"programs": jobs run, "failed": jobs that raised (logged),
    "widths": the filter window widths}.
    """
    del max_workers
    cfg = config or ChaseConfig()
    if nex is None:
        nex = max(1, int(0.4 * nev))
    op = H if isinstance(H, DenseOperator) else DenseOperator(
        H, device, grid=grid)
    if fused and op.grid is not None and op.grid.nprocs > 1:
        raise NotImplementedError(f"warmup(fused=True) on the grid "
                                  f"{op.grid.shape} waits for {PART2}")
    rcfg = cfg.resolve(op.dtype, op.device)
    nevex = nev + nex
    log = get_logger()
    widths = _bucket_widths(nevex, _col_block(rcfg.col_block, nevex),
                            op.pseudo_hermitian)
    jobs = []
    if op.device.type == "cuda" and uses_ring_kernel(rcfg, op.dtype):
        from .ops.ring_hemm import load_kernels
        jobs.append(("kernels", load_kernels))
    if fused:
        from .api import eigsh_fused, eigsh_pseudo_fused
        solve = eigsh_pseudo_fused if op.pseudo_hermitian else eigsh_fused
        width = (2 if op.pseudo_hermitian else 1) * nevex
        tol = float(np.finfo(np.float32).max)
        jobs.append(("fused-cold",
                     lambda: solve(op, nev, nex, tol=tol, config=cfg)))
        jobs.append(("fused-warm", lambda: solve(
            op, nev, nex, tol=tol, config=cfg,
            v0=torch.eye(op.N, width, dtype=op.dtype, device=op.device))))
    failed = 0
    for name, fn in jobs:
        try:
            fn()
        except Exception as e:   # best effort, as in the JAX package: the
            failed += 1          # solve itself raises on the same fault
            log.warn(f"warmup job '{name}' failed ({type(e).__name__}): "
                     f"{str(e).splitlines()[0][:100] if str(e) else ''}",
                     "perf")
    log.info(f"warmup: {len(jobs) - failed}/{len(jobs)} jobs ran (widths "
             f"{widths})", "perf")
    return {"programs": len(jobs), "failed": failed, "widths": widths}
