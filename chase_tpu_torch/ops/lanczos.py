"""Stochastic block Lanczos for spectral-bound estimation + DoS.

Port of ``chase_tpu/ops/lanczos.py`` (the reference's batched Lanczos,
linalg/internal/cpu/lanczos.hpp:46-209, driven by
algorithm/algorithm.inc:1067-1214).  The ``numvec`` probe vectors run
together as one (N, numvec) block, so each step is one N×N×numvec matmul;
the JAX ``lax.scan`` becomes a Python loop of m steps.  The tridiagonal
eigensolves and the DoS quantile walk are the JAX package's numpy
helpers, copied verbatim.  On a process grid (``grid=``) each rank runs
the steps on its rows of the probes: ``H·v`` is the grid's product and
the dots and norms are summed over the grid's rows
(``parallel/dist.py``), so α and β — and everything the host derives
from them — are the same on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.dist import col_dots, col_norms, hemm
from ..perf import to_device
from ..types import real_dtype

__all__ = ["lanczos_scan", "lanczos_tridiag_host", "dos_lower_bound",
           "upper_bound", "lanczos_dos_vectors"]


def lanczos_scan(H: torch.Tensor, V0: torch.Tensor, *, m: int,
                 want_basis: bool = True, grid=None):
    """Run m Lanczos steps on each column of V0 simultaneously (on
    ``grid``: H this rank's block, V0 its rows).

    Returns:
      alphas: (m, numvec) real — tridiagonal diagonal d.
      betas:  (m, numvec) real — ‖residual‖ per step; betas[:-1] is the
              off-diagonal e, betas[-1] feeds the upper-bound estimate.
      basis:  (m, N) — Lanczos basis vectors of the LAST probe column
              (this rank's rows on a grid; None if want_basis=False).
    """
    rt = real_dtype(H.dtype)
    v1 = V0.to(H.dtype)
    nrm = col_norms(v1, grid)
    v1 = v1 / nrm[None, :].to(v1.dtype)
    v0 = torch.zeros_like(v1)
    beta_prev = torch.zeros((v1.shape[1],), dtype=rt, device=H.device)
    alphas, betas, basis = [], [], []
    for _ in range(m):
        w = hemm(H, v1, grid)
        alpha = col_dots(v1, w, grid).real.to(rt)
        w = w - alpha[None, :].to(w.dtype) * v1 \
            - beta_prev[None, :].to(w.dtype) * v0
        beta = col_norms(w, grid).to(rt)
        safe = torch.where(beta > 0, beta, torch.ones((), dtype=rt,
                                                      device=H.device))
        v2 = w / safe[None, :].to(w.dtype)
        alphas.append(alpha)
        betas.append(beta)
        if want_basis:
            basis.append(v1[:, -1])
        v0, v1, beta_prev = v1, v2, beta
    basis = torch.stack(basis) if want_basis else None
    return torch.stack(alphas), torch.stack(betas), basis


# -- host helpers: copied verbatim from chase_tpu/ops/lanczos.py ------------

def lanczos_tridiag_host(alphas, betas, want_vectors=True):
    """Eigendecompose each probe's tridiagonal on host.

    Args:
      alphas, betas: (m, numvec) numpy arrays from :func:`lanczos_scan`.

    Returns:
      theta: (numvec, m) Ritz values ascending per probe.
      tau:   (numvec, m) |first eigenvector component|² weights (DoS).
      ritzV_last: (m, m) eigenvectors of the last probe's tridiagonal
                  (columns), or None.
    """
    m, numvec = alphas.shape
    theta = np.empty((numvec, m), dtype=np.float64)
    tau = np.empty((numvec, m), dtype=np.float64)
    ritzV_last = None
    for i in range(numvec):
        T = np.diag(alphas[:, i].astype(np.float64))
        if m > 1:
            off = betas[:-1, i].astype(np.float64)
            T += np.diag(off, 1) + np.diag(off, -1)
        evals, evecs = np.linalg.eigh(T)
        theta[i] = evals
        tau[i] = np.abs(evecs[0, :]) ** 2
        if want_vectors and i == numvec - 1:
            ritzV_last = evecs
    return theta, tau, ritzV_last


def dos_lower_bound(theta, tau, nevex, N, is_pseudo=False):
    """Gaussian-broadened cumulative DoS quantile → lowerb.

    Mirrors the quantile walk in algorithm/algorithm.inc:1096-1145:
    a Gaussian-smoothed (σ=0.25) CDF built from the τ-weighted Ritz values
    is scanned until it crosses nevex/N; the crossing Ritz value is the
    lower end of the damping interval.
    """
    numvec, m = theta.shape
    theta_flat = theta.reshape(-1)      # probe-major, like the reference
    tau_flat = tau.reshape(-1)
    order = np.argsort(theta_flat)
    theta_sorted = theta_flat[order]

    lam = theta_sorted[0]
    sigma = 0.25
    threshold = 2 * sigma * sigma / 10
    search = float(nevex) / float(N)
    bound = m // 2 if is_pseudo else m
    n = numvec * bound

    def G(x):
        return 0.5 * (1 + _erf(x / np.sqrt(2 * sigma * sigma)))

    lowerb = theta_sorted[min(n, len(theta_sorted)) - 1]
    prev = 0.0
    tf = theta_flat[:n]
    wf = tau_flat[:n]
    for i in range(n - 1):
        x = theta_sorted[i]
        lo = x < (tf - threshold)
        hi = x > (tf + threshold)
        mid = ~(lo | hi)
        curr = float(np.sum(wf[hi]) + np.sum(wf[mid] * G(x - tf[mid])))
        curr /= numvec
        if curr > search:
            if abs(curr - search) < abs(prev - search) and i + 1 < n:
                lowerb = theta_sorted[i + 1]
            else:
                lowerb = theta_sorted[i]
            break
        prev = curr
    return float(lam), float(lowerb)


def _erf(x):
    from scipy.special import erf as _scipy_erf
    return _scipy_erf(x)


def upper_bound(theta, betas_last):
    """upperb = max_i ( max(|θ_i,first|, |θ_i,last|) + |β_i,last| ).

    Mirrors cpu/lanczos.hpp:196-209.
    """
    numvec = theta.shape[0]
    ub = -np.inf
    for i in range(numvec):
        ub = max(ub, max(abs(theta[i, 0]), abs(theta[i, -1])) + abs(betas_last[i]))
    return float(ub)


def lanczos_dos_vectors(basis: torch.Tensor, ritzV, idx_mask) -> torch.Tensor:
    """DoS starting vectors: basis (m, N) → (N, m) @ ritzV, masked columns.

    Columns j with idx_mask[j]==False return zeros (caller keeps its random
    vectors there).  Mirrors LanczosDos (chase_cpu.hpp:358-374).
    """
    ritzV = to_device(ritzV, "lanczos.dos_vectors",
                      device=basis.device).to(basis.dtype)
    mask = to_device(idx_mask, "lanczos.dos_vectors", device=basis.device)
    Vd = basis.T @ ritzV
    return Vd * mask[None, :].to(Vd.dtype)
