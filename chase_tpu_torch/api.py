"""User-facing API.

Port of ``chase_tpu/api.py::eigsh`` on one torch device:

    res = chase_tpu_torch.eigsh(H, nev=100, nex=40, device="cuda")
    res.ritzv, res.V[:, :100], res.resid, res.converged

Sequences of correlated problems (the reference's mode='A' warm start):

    r2 = eigsh(H2, nev, nex, v0=r1.V, ritzv0=r1.ritzv_full, approx=True)

``device`` is explicit (default "cuda") and never falls back: without a
card, ``device="cuda"`` raises RuntimeError.  Complex problems, fused
solves and problem sequences are later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import ChaseConfig
from .parallel.operator import DenseOperator
from .perf import PerfData
from .solver import solve, SolveResult

__all__ = ["eigsh"]


def eigsh(H, nev: int, nex: Optional[int] = None, *,
          tol: Optional[float] = None,
          v0=None, ritzv0=None, approx: bool = False,
          largest: bool = False,
          config: Optional[ChaseConfig] = None,
          device="cuda",
          collect_perf: bool = False,
          generator: Optional[torch.Generator] = None) -> SolveResult:
    """Compute the ``nev`` lowest eigenpairs of a dense real symmetric H.

    Args:
      H: (N, N) symmetric f32/f64 array (numpy or torch), or a
         DenseOperator (which carries its own device).
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
      whose first nev columns are the eigenvectors, .resid, .converged, ...
    """
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
