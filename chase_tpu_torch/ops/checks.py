"""Structure checks: randomized (pseudo-)hermiticity probe, triangle mirror.

Port of ``chase_tpu/ops/checks.py`` (the reference's checkSymmetryEasy,
checkPseudoHermicityEasy and symOrHermMatrix,
linalg/internal/cpu/symOrHerm.hpp:44-140, chase_cpu.hpp:272-285): compare
u = H·v with Hᴴ·v for one random v, tol = 10·N·ε·‖u‖ (for the pseudo
probe, S·H in place of H); mirror one triangle onto the other.  On a
process grid :func:`check_hermitian` probes the distributed H with one
vector drawn whole on every rank: H·v gathered over the grid's rows, Hᴴ·v
over its columns, so every rank reaches the same verdict; the pseudo
probe flips by global row.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..perf import to_host
from ..types import eps

__all__ = ["check_hermitian", "check_pseudo_hermitian", "force_hermitian"]


def _norms(u, ut):
    """(‖u − ut‖, ‖u‖) on the host, in one read."""
    return to_host(torch.stack([torch.linalg.vector_norm(u - ut),
                                torch.linalg.vector_norm(u)]),
                   "checks.probe").tolist()


def _probe(H: torch.Tensor, generator, flip) -> bool:
    """‖flip(H·v) − Hᴴ·flip(v)‖ ≤ 10·N·ε·‖flip(H·v)‖ for one random v from
    ``generator`` (default: a fresh one seeded 0 on H's device)."""
    if generator is None:
        generator = torch.Generator(device=H.device).manual_seed(0)
    N = H.shape[0]
    v = torch.randn((N, 1), generator=generator, device=H.device,
                    dtype=H.dtype)
    u = flip(H @ v)
    ut = H.mH @ flip(v)
    diff, scale = _norms(u, ut)
    return diff <= 10.0 * N * eps(H.dtype) * max(scale, 1e-300)


def check_hermitian(H: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    grid=None, pseudo: bool = False) -> bool:
    """Randomized Hermitian check: ‖Hv − Hᴴv‖ ≤ 10·N·ε·‖Hv‖ (with
    ``pseudo``, of S·H: ‖S·(H·v) − Hᴴ·(S·v)‖).  On ``grid``, H is this
    rank's block of ``P('r', 'c')``."""
    from .pseudo import apply_s
    if grid is None:
        return _probe(H, generator, apply_s if pseudo else lambda x: x)
    if generator is None:
        generator = torch.Generator(device=H.device).manual_seed(0)
    N = H.shape[0] * grid.size("r")
    v = torch.randn((N, 1), generator=generator, device=H.device,
                    dtype=H.dtype)
    i0, nr = grid.block(N, "r")
    j0, nc = grid.block(N, "c")
    u = grid.all_reduce(H @ v[j0:j0 + nc], "c")        # rows i of H·v
    if pseudo:
        u, v = apply_s(u, i0, N), apply_s(v)
    ut = grid.all_reduce(H.mH @ v[i0:i0 + nr], "r")    # rows j of Hᴴ·v
    u, ut = grid.all_gather(u, "r"), grid.all_gather(ut, "c")
    diff, scale = _norms(u, ut)
    return diff <= 10.0 * N * eps(H.dtype) * max(scale, 1e-300)


def check_pseudo_hermitian(H: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           grid=None) -> bool:
    """Randomized S-pseudo-hermiticity check: S·H must be Hermitian, i.e.
    ‖S·(H·v) − Hᴴ·(S·v)‖ ≤ 10·N·ε·‖S·H·v‖ — the JAX package's
    ``check_hermitian(apply_s(H))`` without its N×N copy of S·H.  On
    ``grid`` as :func:`check_hermitian`, S by global row."""
    return check_hermitian(H, generator, grid, pseudo=True)


def force_hermitian(H: torch.Tensor, *, upper: bool = True) -> torch.Tensor:
    """A new Hermitian matrix from one triangle of H: the strict upper
    (``upper=True``) or lower triangle, its conjugate transpose, and the
    real part of H's diagonal."""
    T = torch.triu(H, 1) if upper else torch.tril(H, -1)
    d = torch.diag(torch.diagonal(H).real.to(H.dtype))
    return T + T.mH + d
