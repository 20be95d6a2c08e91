"""Model problem generators (plain numpy, copied from chase_tpu.models).

The Clement matrix of the reference's hello-world example, a dense random
Hermitian matrix, a sequence of correlated ones, and the Bethe–Salpeter
(pseudo-Hermitian) test matrices.  Both packages' tests build their inputs
here so the two solvers see the same numbers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["clement", "random_hermitian", "clement_eigenvalues",
           "hermitian_sequence", "random_pseudo_hermitian",
           "structured_pseudo_hermitian"]


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


def hermitian_sequence(N: int, count: int, dtype=np.complex128, seed: int = 0,
                       drift: float = 0.01):
    """A sequence of correlated Hermitian problems (warm-start feature).

    Mirrors the reference's "sequence of eigenproblems" use case
    (examples/2_input_output --sequence): each matrix is the previous plus
    a small Hermitian perturbation of norm ~drift·‖H‖.
    """
    rng = np.random.default_rng(seed)
    H = random_hermitian(N, dtype=dtype, seed=seed)
    scale = np.linalg.norm(H, ord="fro") / N
    out = [H]
    for _ in range(count - 1):
        cplx = np.issubdtype(np.dtype(dtype), np.complexfloating)
        E = rng.standard_normal((N, N))
        if cplx:
            E = E + 1j * rng.standard_normal((N, N))
        E = (E + E.conj().T) / 2
        H = H + (drift * scale) * E.astype(dtype)
        out.append(H.astype(dtype))
    return out


def random_pseudo_hermitian(N: int, dtype=np.complex128, seed: int = 0,
                            gap: float = 1.0, coupling: float = 0.2,
                            spread: float = 2.0) -> np.ndarray:
    """Random Bethe–Salpeter-structured pseudo-Hermitian matrix.

        H = [[A, B], [-conj(B), -conj(A)]],  A = Aᴴ,  B = Bᵀ

    This is the full BSE structure the reference's solve_pseudo exploits:
    Sᴴ H S = Hᴴ (S = diag(I, −I)), the spectrum is real and symmetric about
    0 (eigenpair (λ, x) ↔ (−λ, Kx) with K x = conj([x₂; x₁]) — the
    K-conjugation of chase_cpu.hpp:557-588), and M = S·H is Hermitian
    positive definite (the beyond-Tamm-Dancoff stability condition) as long
    as ``coupling`` keeps ‖B‖ below A's smallest eigenvalue.

    ``gap`` shifts A's spectrum away from 0; ``spread`` scales the width of
    A's spectrum (well-separated positive eigenvalues for solver tests).
    """
    if N % 2:
        raise ValueError("pseudo-Hermitian test matrices need even N")
    n = N // 2
    rng = np.random.default_rng(seed)
    cplx = np.issubdtype(np.dtype(dtype), np.complexfloating)
    C = rng.standard_normal((n, n))
    if cplx:
        C = C + 1j * rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(C)
    w = gap + spread * (np.arange(n) + rng.random(n)) / n
    A = (Q * w) @ Q.conj().T
    A = (A + A.conj().T) / 2
    B = rng.standard_normal((n, n))
    if cplx:
        B = B + 1j * rng.standard_normal((n, n))
    B = coupling * gap * (B + B.T) / (2 * np.sqrt(n))   # complex-symmetric
    H = np.zeros((N, N), dtype=np.complex128 if cplx else np.float64)
    H[:n, :n] = A
    H[:n, n:] = B
    H[n:, :n] = -np.conj(B)
    H[n:, n:] = -np.conj(A)
    return H.astype(dtype)


def structured_pseudo_hermitian(N: int, dtype=np.float64, seed: int = 0,
                                gap: float = 1.0, coupling: float = 0.5,
                                spread: float = 2.0):
    """BSE-structured pseudo-Hermitian matrix with an EXACT known spectrum
    (the scale-benchmark analogue of the Clement matrix: at N where a direct
    eigendecomposition is impractical, correctness is still checkable).

        H = [[A, B], [-B, -A]],   A = Q diag(a) Qᵀ,  B = Q diag(b) Qᵀ

    with one shared orthogonal eigenbasis Q, so (A−B)(A+B) = Q diag(a²−b²) Qᵀ
    and H's spectrum is EXACTLY ±√(a²−b²) (the standard BSE product-form
    reduction; the reference checks its BSE fixtures against a stored direct
    spectrum the same way, tests/chase_serial_solve_pseudo_bse_test.cpp:56-80).
    ``a = gap + spread·(i+u_i)/n`` keeps M = S·H positive definite
    (beyond-Tamm-Dancoff stable) as long as |b| < a, which
    ``b = coupling·gap·u`` with coupling < 1 guarantees.

    Real dtypes only (complex coverage uses :func:`random_pseudo_hermitian`,
    or a diagonal unitary similarity of this H, which keeps the spectrum).

    Returns (H, lam) — lam the exact positive eigenvalues, ascending.
    """
    if N % 2:
        raise ValueError("pseudo-Hermitian test matrices need even N")
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        raise ValueError("structured_pseudo_hermitian is real-only")
    if not 0 <= coupling < 1:
        raise ValueError("need 0 <= coupling < 1 for a stable (HPD S·H) BSE")
    n = N // 2
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = gap + spread * (np.arange(n) + rng.random(n)) / n
    b = coupling * gap * (2.0 * rng.random(n) - 1.0)
    A = (Q * a) @ Q.T
    A = (A + A.T) / 2
    B = (Q * b) @ Q.T
    B = (B + B.T) / 2
    H = np.zeros((N, N), np.float64)
    H[:n, :n] = A
    H[:n, n:] = B
    H[n:, :n] = -B
    H[n:, n:] = -A
    lam = np.sort(np.sqrt(a * a - b * b))
    return H.astype(dtype), lam
