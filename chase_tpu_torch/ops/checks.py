"""Structure checks: randomized hermiticity probe, triangle mirror.

Port of ``chase_tpu/ops/checks.py::check_hermitian`` and
``force_hermitian`` (the reference's checkSymmetryEasy and
symOrHermMatrix, linalg/internal/cpu/symOrHerm.hpp:44-140): compare
u = H·v with Hᴴ·v for one random v, tol = 10·N·ε·‖u‖; mirror one triangle
onto the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..types import eps

__all__ = ["check_hermitian", "force_hermitian"]


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


def force_hermitian(H: torch.Tensor, *, upper: bool = True) -> torch.Tensor:
    """A new Hermitian matrix from one triangle of H: the strict upper
    (``upper=True``) or lower triangle, its conjugate transpose, and the
    real part of H's diagonal."""
    T = torch.triu(H, 1) if upper else torch.tril(H, -1)
    d = torch.diag(torch.diagonal(H).real.to(H.dtype))
    return T + T.mH + d
