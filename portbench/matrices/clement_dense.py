"""A dense Hermitian matrix with Clement's spectrum: H = Q·diag(λ)·Qᴴ,
λ_i = −(N−1) + 2i (i = 0 … N−1, the spectrum of ChASE's
examples/1_hello_world Clement matrix), Q unitary from the QR of an N × N
standard Gaussian (complex for a complex dtype) drawn on the card from the
seed.  Every entry is filled, as in a Hamiltonian in a plane-wave or
Gaussian basis, and the spectrum is known exactly; ‖H‖₂ = N − 1.

H is made on ``device`` in the configuration's dtype: the Gaussian, its
Householder QR (``geqrf``) and Q (``householder_product``), each freed
once the next is made, then H's column blocks Q·(λ·Q[J]ᴴ), and last the
upper triangle's tiles mirrored onto the lower so that H is Hermitian to
the bit; about 2·N² elements are held at a time."""

from __future__ import annotations

import torch

from portbench.matrices import Problem
from portbench.seeds import generator

BLOCK = 2048           # columns per block product, rows and columns per tile


def make(cfg: dict, seed: int, device) -> Problem:
    N = int(cfg["N"])
    dtype = getattr(torch, cfg["dtype"])
    g = generator(device, seed, "clement_dense")
    X = torch.randn((N, N), generator=g, dtype=dtype, device=device)
    A, tau = torch.geqrf(X)
    del X
    Q = torch.linalg.householder_product(A, tau)
    del A, tau
    lam = -(N - 1) + 2.0 * torch.arange(N, dtype=torch.float64,
                                        device=device)
    lam = lam.to(Q.real.dtype if dtype.is_complex else dtype)
    H = torch.empty((N, N), dtype=dtype, device=device)
    for j0 in range(0, N, BLOCK):
        J = slice(j0, min(j0 + BLOCK, N))
        H[:, J] = Q @ (lam[:, None] * Q[J].mH)
    del Q
    for i0 in range(0, N, BLOCK):
        rows = slice(i0, min(i0 + BLOCK, N))
        T = H[rows, rows]
        T.copy_((T + T.mH) / 2)
        for j0 in range(i0 + BLOCK, N, BLOCK):
            cols = slice(j0, min(j0 + BLOCK, N))
            H[cols, rows] = H[rows, cols].mH
    return Problem(H=H, inputs={"N": N}, norm=float(N - 1))
