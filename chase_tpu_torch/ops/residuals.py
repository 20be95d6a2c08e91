"""Standalone residual norms ‖H v − θ v‖₂ per column.

Port of ``chase_tpu/ops/residuals.py`` (the reference's
linalg/internal/cpu/residuals.hpp:56-83).  Used for final verification
and tests; the solver's per-iteration residuals come fused from
:func:`chase_tpu_torch.ops.rr.rayleigh_ritz_residuals`.
"""

from __future__ import annotations

import torch

from ..types import real_dtype

__all__ = ["residuals"]


def residuals(H: torch.Tensor, V: torch.Tensor, ritzv) -> torch.Tensor:
    """(k,) residual 2-norms, in V's real dtype, of the eigenpair
    approximations (V[:, j], ritzv[j]); ``ritzv`` may be numpy."""
    lam = torch.as_tensor(ritzv, device=V.device).to(V.dtype)
    R = H @ V - V * lam[None, :]
    return torch.linalg.vector_norm(R, dim=0).to(real_dtype(V.dtype))
