"""One solver iteration as a single function.

Port of ``chase_tpu/step.py::iteration_step``: Chebyshev filter →
CholQR2 → Rayleigh–Ritz with residuals on the whole block, the unit that
the JAX package jits and benchmarks on its own (the solvers call the
phases separately, because degrees and locking live in their loops).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import set_matmul_precision
from .ops.filter import chebyshev_filter
from .ops.qr import cholqr
from .ops.rr import rayleigh_ritz_residuals

__all__ = ["iteration_step"]


def iteration_step(H: torch.Tensor, V: torch.Tensor, degrees, lam1, lower,
                   upper, locked: int, *, precision: str = "highest"):
    """One full subspace-iteration step on the complete block: ``degrees``
    (per column, numpy or tensor) drive the filter, then two CholQR
    rounds and RR on the columns from ``locked`` on.

    Returns (V_next, ritz values, residuals)."""
    set_matmul_precision(precision)
    deg = np.asarray(degrees.cpu() if isinstance(degrees, torch.Tensor)
                     else degrees)
    V = chebyshev_filter(H, V, deg, lam1, lower, upper, int(deg.max()))
    V, _ok = cholqr(V, passes=2)
    return rayleigh_ritz_residuals(H, V, int(locked))
