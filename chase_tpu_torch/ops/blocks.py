"""Column-block glue ops shared by the solver.

Port of ``chase_tpu/ops/blocks.py``.  JAX's functional gathers and
dynamic slices become torch indexing: :func:`slice_cols` returns a VIEW
(no copy of the window), and :func:`update_cols` / :func:`set_head_cols`
write into ``V`` in place — the solver owns its blocks, and skipping the
functional copy saves an (N, nev+nex) buffer per update.
"""

from __future__ import annotations

import torch

__all__ = ["permute_cols", "slice_cols", "update_cols", "set_head_cols",
           "scale_lower_rows"]


def permute_cols(V: torch.Tensor, perm) -> torch.Tensor:
    """New block with columns ``V[:, perm]``."""
    idx = torch.as_tensor(perm, dtype=torch.long, device=V.device)
    return V.index_select(1, idx)


def slice_cols(V: torch.Tensor, start: int, w: int) -> torch.Tensor:
    """View of columns [start, start + w)."""
    return V[:, int(start):int(start) + w]


def update_cols(V: torch.Tensor, X: torch.Tensor, start: int) -> torch.Tensor:
    """Write X into columns [start, start + X.shape[1]) of V, in place."""
    V[:, int(start):int(start) + X.shape[1]].copy_(X)
    return V


def set_head_cols(V: torch.Tensor, Vd: torch.Tensor, mask) -> torch.Tensor:
    """Replace the leading columns j < Vd.shape[1] where ``mask[j]`` with
    Vd's, in place."""
    m = Vd.shape[1]
    mask = torch.as_tensor(mask, dtype=torch.bool, device=V.device)
    head = V[:, :m]
    head.copy_(torch.where(mask[None, :], Vd.to(V.dtype), head))
    return V


def scale_lower_rows(V: torch.Tensor, scale: float) -> torch.Tensor:
    """New block with rows [N/2, N) scaled by ``scale`` — the pseudo
    initVecs' 0.001 lower-half damping (chase_cpu.hpp:310-321)."""
    n2 = V.shape[0] // 2
    return torch.cat([V[:n2], V[n2:] * scale])
