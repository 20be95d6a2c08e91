"""The grid's products: GSPMD's implicit collectives made explicit.

The JAX package writes ``H @ V``, ``V.conj().T @ W`` and column norms on
sharded arrays and lets GSPMD insert the collectives.  The port holds
local blocks (``parallel/mesh.py``: H in ``P('r', 'c')``, multivectors in
``P('r', None)``, small matrices replicated) and calls them here:

* :func:`hemm` — ``H·X`` for this rank's rows: ``all_gather`` X over 'r',
  the local block times the rows of its columns, ``all_reduce`` over 'c'
  (on a (p, 1) grid the gather and the local product);
* :func:`inner`, :func:`col_dots`, :func:`col_norms` — ``Aᴴ·B``, per-column
  ``aᴴb`` and ‖x‖: the local partial, summed over 'r' bitwise equal on
  every rank (``Grid2D.sum_rows``), so the host decisions that read them
  agree everywhere;
* :func:`rotate_rows` — the rows of a multivector rotated across the
  'r' axis (``Grid2D.rotate_rows``), the BSE's K-conjugation.

With ``grid=None`` every function is the plain single-device expression,
and on a grid whose 'r' axis has one member the reductions are too, so a
1×1 grid computes the bits ``grid=None`` does.  ``V·M`` with M replicated
needs no collective and stays a local ``@``.
"""

from __future__ import annotations

import torch

from ..ops.filter import narrow_matmul

__all__ = ["hemm", "inner", "col_dots", "col_norms", "rotate_rows",
           "local_product"]


def local_product(H: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``H @ X``; an H narrower than X (the bf16 shadow) through
    ``narrow_matmul``."""
    return H @ X if H.dtype == X.dtype else narrow_matmul(H, X)


def hemm(H: torch.Tensor, X: torch.Tensor, grid=None) -> torch.Tensor:
    """``H·X`` for this rank's rows: H is the local block (N/r × N/c), X
    this rank's rows (N/r × k) of the multivector."""
    if grid is None:
        return local_product(H, X)
    Xf = grid.all_gather(X, "r")
    j0, nc = grid.block(Xf.shape[0], "c")
    return grid.all_reduce(local_product(H, Xf[j0:j0 + nc]), "c")


def _sum_rows(t: torch.Tensor, grid) -> torch.Tensor:
    if grid is None or grid.size("r") == 1:
        return t
    return grid.sum_rows(t.contiguous())


def inner(A: torch.Tensor, B: torch.Tensor, grid=None) -> torch.Tensor:
    """``Aᴴ·B`` of two multivectors (k₁ × k₂, replicated)."""
    return _sum_rows(A.mH @ B, grid)


def col_dots(A: torch.Tensor, B: torch.Tensor, grid=None) -> torch.Tensor:
    """Per-column ``aⱼᴴ·bⱼ`` (k, replicated)."""
    return _sum_rows(torch.sum(A.conj() * B, dim=0), grid)


def col_norms(X: torch.Tensor, grid=None) -> torch.Tensor:
    """Per-column 2-norms (k, real, replicated): ``vector_norm`` where
    one rank holds every row, else the square root of the summed squares
    of each rank's rows."""
    if grid is None or grid.size("r") == 1:
        return torch.linalg.vector_norm(X, dim=0)
    sq = torch.sum(torch.abs(X) ** 2, dim=0)
    return torch.sqrt(grid.sum_rows(sq))


def rotate_rows(t: torch.Tensor, shift: int, grid=None) -> torch.Tensor:
    """This rank's rows of the multivector rotated by ``shift`` global
    rows, ``out[j] = x[(j + shift) mod N]`` (a new tensor): t is this
    rank's rows of x — pass only the columns that must move."""
    if grid is None:
        return torch.cat([t[shift:], t[:shift]])
    return grid.rotate_rows(t, shift)
