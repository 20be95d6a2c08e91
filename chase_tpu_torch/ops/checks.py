"""Randomized hermiticity probe.

Port of ``chase_tpu/ops/checks.py::check_hermitian`` (the reference's
checkSymmetryEasy, linalg/internal/cpu/symOrHerm.hpp:44-140): compare
u = H·v with Hᴴ·v for one random v, tol = 10·N·ε·‖u‖.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..types import eps

__all__ = ["check_hermitian"]


def check_hermitian(H: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> bool:
    """Randomized Hermitian check: ‖Hv − Hᴴv‖ ≤ 10·N·ε·‖Hv‖.  The probe
    comes from ``generator`` (default: a fresh one seeded 0 on H's
    device)."""
    if generator is None:
        generator = torch.Generator(device=H.device).manual_seed(0)
    N = H.shape[0]
    v = torch.randn((N, 1), generator=generator, device=H.device,
                    dtype=H.dtype)
    u = H @ v
    ut = H.mH @ v
    diff = float(torch.linalg.vector_norm(u - ut))
    scale = float(torch.linalg.vector_norm(u))
    return diff <= 10.0 * N * eps(H.dtype) * max(scale, 1e-300)
