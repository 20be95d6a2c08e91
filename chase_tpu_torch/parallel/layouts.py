"""Block-cyclic layouts as ownership permutations.

Port of ``chase_tpu/parallel/layouts.py``.  The reference offers
ScaLAPACK-style mb×nb block-cyclic distribution
(linalg/distMatrix/distMatrix.hpp:2867 BlockCyclicMatrix,
DistMultiVectorBlockCyclic1D) for load balance of trapezoidal work.  The
filter's work is uniform across a grid's blocks, so block-cyclic brings no
speed here; it is kept for parity, and for matrices whose natural order is
the ScaLAPACK ownership order, as a *similarity transform*: a row/column
permutation after which the grid's contiguous blocks
(``DenseOperator(grid=…)``) own exactly the indices that an (mb, p)
block-cyclic distribution gives each process.  Eigenvalues are invariant;
eigenvector rows are un-permuted on the way out (``restore_rows``).

The permutations are numpy index arrays.  The row gathers keep the
caller's type: numpy in, numpy out; a tensor in, a tensor on the same
device out (``index_select``).  A DTensor is gathered whole with
``full_tensor()`` first — a collective, so every rank of its mesh must
make the same call.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["block_cyclic_perm", "BlockCyclicLayout",
           "PseudoBlockCyclicLayout", "BlockCyclicVector1D"]


def _as_tensor(X):
    """X itself, or the whole tensor of a DTensor (a collective)."""
    from torch.distributed.tensor import DTensor
    return X.full_tensor() if isinstance(X, DTensor) else X


def _take(X, idx: np.ndarray, dim: int):
    """X's rows (dim 0) or columns (dim 1) ``idx``, in X's library."""
    if isinstance(X, torch.Tensor):
        X = _as_tensor(X)
        return X.index_select(dim, torch.as_tensor(idx, device=X.device))
    return np.take(np.asarray(X), idx, axis=dim)


def _take_rows(X, idx: np.ndarray):
    """Row gather that keeps the input's library: numpy stays numpy, a
    tensor stays a tensor on its device (a DTensor becomes its whole
    tensor first, a collective)."""
    return _take(X, idx, 0)


def block_cyclic_perm(n: int, nb: int, p: int) -> np.ndarray:
    """Ownership-ordered global indices: perm[i] = the global index that a
    contiguous p-way block layout should place at position i so that part q
    holds exactly the indices block-cyclically owned by process q
    (owner(g) = (g // nb) % p, ScaLAPACK descriptor convention)."""
    owner = (np.arange(n) // nb) % p
    return np.argsort(owner, kind="stable")


class BlockCyclicLayout:
    """Symmetric block-cyclic reindexing of an N×N operator over a
    p_r × p_c grid (p_c defaults to p_r)."""

    def __init__(self, N: int, mb: int, p_r: int, p_c: int = None):
        p_c = p_c if p_c is not None else p_r
        self.N = N
        self.mb = mb
        self.row_perm = block_cyclic_perm(N, mb, p_r)
        self.col_perm = block_cyclic_perm(N, mb, p_c)
        self._row_inv = np.argsort(self.row_perm)

    def apply(self, H):
        """Reorder H so block sharding == block-cyclic ownership.

        For Hermitian solves the row and column permutations must agree
        (similarity transform); the row permutation is used on both
        sides."""
        return _take(_take_rows(H, self.row_perm), self.row_perm, 1)

    def restore_rows(self, V):
        """Un-permute eigenvector rows back to the user's global ordering."""
        return _take_rows(V, self._row_inv)

    def apply_rows(self, V):
        """Permute multivector rows INTO the ownership ordering (the
        DistMultiVector1D redistribution analogue for warm starts / v0)."""
        return _take_rows(V, self.row_perm)


class PseudoBlockCyclicLayout(BlockCyclicLayout):
    """Block-cyclic reindexing that preserves the BSE S-metric.

    Analogue of ``PseudoHermitianBlockCyclicMatrix``
    (linalg/distMatrix/distMatrix.hpp:3936).  A global block-cyclic row
    permutation would mix the two S = diag(I, −I) halves and break both the
    metric and the K-conjugation row pairing (i ↔ i+N/2).  Instead the same
    block-cyclic permutation is applied within each half:

      perm = [bc_perm(N/2) | bc_perm(N/2) + N/2]

    S is invariant (the permutation never crosses halves), so the permuted
    operator is pseudo-Hermitian for the same metric and every S-aware
    step (flipSign, S-QR, pencil RR, K-conjugation) works unchanged; each
    process owns the block-cyclically assigned rows of each half."""

    def __init__(self, N: int, mb: int, p_r: int, p_c: int = None):
        if N % 2 != 0:
            raise ValueError(f"pseudo-Hermitian N={N} must be even")
        p_c = p_c if p_c is not None else p_r
        self.N = N
        self.mb = mb
        half = block_cyclic_perm(N // 2, mb, p_r)
        self.row_perm = np.concatenate([half, half + N // 2])
        half_c = block_cyclic_perm(N // 2, mb, p_c)
        self.col_perm = np.concatenate([half_c, half_c + N // 2])
        self._row_inv = np.argsort(self.row_perm)


class BlockCyclicVector1D:
    """1D block-cyclic multivector layout (DistMultiVectorBlockCyclic1D,
    linalg/distMatrix/distMultiVector.hpp:2931).

    The row layout of an (N, k) multivector distributed block-cyclically
    over ``p`` parts of one grid axis, independent of any matrix layout:
    ``to_owner_order`` reorders rows so a contiguous p-way row split owns
    exactly the block-cyclically assigned rows; ``from_owner_order``
    restores the user's order.  Used with a (Pseudo)BlockCyclicLayout the
    vector must follow the matrix's row permutation (``like=layout``)."""

    def __init__(self, N: int, mb: int, p: int, like=None):
        self.N = N
        self.mb = mb
        self.perm = (np.asarray(like.row_perm) if like is not None
                     else block_cyclic_perm(N, mb, p))
        self._inv = np.argsort(self.perm)

    def to_owner_order(self, V):
        return _take_rows(V, self.perm)

    def from_owner_order(self, V):
        return _take_rows(V, self._inv)
