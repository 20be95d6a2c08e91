"""The comparisons that decide ``correct``, in plain PyTorch; a judge
(``judges/<name>.py``, named by the configuration) picks the ones its
family needs.  Each reads the matrix the benchmark made (H, in the
configuration's dtype) and the eigenvalues and eigenvectors one timed
solve returned:

* ``resid``: max_j ‖H·v_j − λ_j·v_j‖₂ / ‖v_j‖₂, computed in H's dtype in
  blocks of columns (absolute, as the solver's tolerance);
* ``orth`` (Hermitian): max |VᴴV − I| over the returned eigenvectors;
* ``jorth`` (BSE): max |Ĝ − I| with Ĝ = D·VᴴJV·D, J = diag(I, −I) the
  pseudo-Hermitian metric and D = diag(VᴴJV)^(−1/2): eigenvectors of
  distinct eigenvalues are J-orthogonal and those of positive ones have
  vᴴJv > 0, so a vector returned twice reads 1 and a non-positive
  vᴴJv reads NaN (past every limit);
* ``eig_err`` (a family with an exact spectrum): max |λ_j − λ_exact,j|
  over the nev lowest (Hermitian) or smallest positive (BSE) eigenvalues;
* ``missed`` (Hermitian without an exact spectrum): 1 when H has an
  eigenvalue below σ = λ_nev − margin that V's span misses, else 0 —
  the Cholesky factorization of H − σI + c·VVᴴ (c = 3·‖H‖_∞ lifts V's
  span above σ) succeeds exactly when no such eigenvalue exists.
"""

from __future__ import annotations

import torch

BLOCK = 512            # columns (or rows) per block product


def _plain_matmul() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resid(H: torch.Tensor, lam, V: torch.Tensor) -> float:
    _plain_matmul()
    lam = torch.as_tensor(lam, dtype=torch.float64, device=H.device)
    worst = []
    for j0 in range(0, V.shape[1], BLOCK):
        Vb = V[:, j0:j0 + BLOCK].to(device=H.device, dtype=H.dtype)
        R = H @ Vb - Vb * lam[j0:j0 + BLOCK].to(H.dtype)[None, :]
        worst.append((torch.linalg.vector_norm(R, dim=0)
                      / torch.linalg.vector_norm(Vb, dim=0)).max())
        del Vb, R
    return float(torch.stack(worst).max())    # a NaN stays NaN: it fails


def orth(V: torch.Tensor, dtype) -> float:
    _plain_matmul()
    V = V.to(dtype)
    G = V.mH @ V
    G.diagonal().sub_(1)
    return float(G.abs().max())


def jorth(V: torch.Tensor, dtype) -> float:
    _plain_matmul()
    V = V.to(dtype)
    n = V.shape[0] // 2
    W = V[:n].mH @ V[:n] - V[n:].mH @ V[n:]
    d = W.diagonal().real.clone()
    d[d <= 0] = float("nan")
    s = d.rsqrt().to(dtype)
    G = W * s[:, None] * s[None, :]
    G.diagonal().sub_(1)
    return float(G.abs().max())


def eig_err(lam, exact: torch.Tensor) -> float:
    lam = torch.as_tensor(lam, dtype=torch.float64).cpu()
    return float((lam - exact[:lam.shape[0]]).abs().max())


def missed(H: torch.Tensor, lam, V: torch.Tensor, margin: float) -> int:
    _plain_matmul()
    hnorm = max(float(H[i0:i0 + BLOCK].abs().sum(dim=1).max())
                for i0 in range(0, H.shape[0], BLOCK))
    sigma = float(max(lam)) - margin
    V = V.to(device=H.device, dtype=H.dtype)
    M = H.clone()
    M.diagonal().sub_(sigma)
    for i0 in range(0, H.shape[0], BLOCK):
        M[i0:i0 + BLOCK].addmm_(V[i0:i0 + BLOCK], V.mH, alpha=3.0 * hnorm)
    _, info = torch.linalg.cholesky_ex(M)
    del M
    return int(info.item() != 0)
