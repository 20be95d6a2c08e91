"""Result-validation helpers (plain numpy, copied from chase_tpu.utils).

Quick assertions a user (or a test) runs on a SolveResult against the
original matrix.  Tensors on any device are copied to host numpy first.
"""

from __future__ import annotations

import numpy as np

__all__ = ["orthonormality_error", "residual_norms", "validate_result"]


def _np(a) -> np.ndarray:
    """Host numpy view of a numpy array or a torch tensor on any device."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def orthonormality_error(V) -> float:
    """max |VᴴV − I| of the eigenvector block."""
    V = _np(V)
    G = V.conj().T @ V
    return float(np.abs(G - np.eye(V.shape[1])).max())


def residual_norms(H, V, evals) -> np.ndarray:
    """‖H v − λ v‖₂ per column, computed independently in numpy."""
    H = _np(H)
    V = _np(V)
    R = H @ V - V * np.asarray(evals)[None, :].astype(V.dtype)
    return np.linalg.norm(R, axis=0)


def validate_result(H, res, *, tol_factor: float = 100.0) -> dict:
    """Independent check of a SolveResult: recomputed residuals,
    orthonormality, and eigenvalue ordering.  Returns a report dict and
    raises AssertionError on violations.
    """
    nev = len(res.ritzv)
    V = _np(res.V)[:, :nev]
    r = residual_norms(H, V, res.ritzv)
    oerr = orthonormality_error(V)
    report = {
        "max_residual": float(r.max()),
        "max_reported_residual": float(np.asarray(res.resid).max()),
        "orthonormality_error": oerr,
        "sorted": bool(np.all(np.diff(res.ritzv) >= -1e-12)),
    }
    scale = max(1.0, float(np.abs(res.ritzv).max()))
    assert report["sorted"], "eigenvalues not ascending"
    assert oerr < 1e-5 * np.sqrt(V.shape[0]), f"orthonormality {oerr}"
    if res.converged:
        assert r.max() <= tol_factor * max(res.resid.max(), 1e-300) + \
            1e-12 * scale, \
            f"recomputed residual {r.max()} disagrees with reported " \
            f"{res.resid.max()}"
    return report
