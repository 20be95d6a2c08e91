"""Model problem generators (plain numpy, copied from chase_tpu.models).

The Clement matrix of the reference's hello-world example and a dense
random Hermitian matrix.  Both packages' tests build their inputs here so
the two solvers see the same numbers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["clement", "random_hermitian", "clement_eigenvalues"]


def clement(N: int, dtype=np.float64) -> np.ndarray:
    """Clement(-Kac) matrix: zero diagonal, H[i,i+1] = sqrt((i+1)(N-i-1)).

    Exact eigenvalues: ±(N-1), ±(N-3), ... — a standard eigensolver test
    with uniformly spread spectrum.
    """
    H = np.zeros((N, N), dtype=dtype)
    i = np.arange(N - 1, dtype=np.float64)
    off = np.sqrt((i + 1) * (N - i - 1))
    H[np.arange(N - 1), np.arange(1, N)] = off
    H[np.arange(1, N), np.arange(N - 1)] = off
    return H


def clement_eigenvalues(N: int) -> np.ndarray:
    """The exact spectrum of the N×N Clement matrix, ascending."""
    return np.arange(-(N - 1), N, 2, dtype=np.float64)


def random_hermitian(N: int, dtype=np.complex128, seed: int = 0,
                     decay: float = 0.0) -> np.ndarray:
    """Dense random Hermitian matrix; optional eigenvalue decay profile.

    With ``decay > 0`` the spectrum is exp-spaced (harder extremal
    clustering); otherwise a GUE/GOE-like matrix.
    """
    rng = np.random.default_rng(seed)
    cplx = np.issubdtype(np.dtype(dtype), np.complexfloating)
    A = rng.standard_normal((N, N))
    if cplx:
        A = A + 1j * rng.standard_normal((N, N))
    H = (A + A.conj().T) / 2
    if decay > 0:
        w, Q = np.linalg.eigh(H)
        w = np.sort(-np.exp(-decay * np.arange(N) / N))
        H = (Q * w) @ Q.conj().T
        H = (H + H.conj().T) / 2
    return H.astype(dtype)
