"""A dense complex Hermitian matrix with Clement's spectrum that each rank
of a process grid builds block by block: H = D·Pᵀ·C·P·Dᴴ, entry by
entry

    H_jk = d_j · c[(π_j − π_k) mod N] · conj(d_k),

where C is the circulant whose DFT eigenvalues are Clement's λ_i = −(N−1)
+ 2i (i = 0 … N−1, ChASE's examples/1_hello_world spectrum) given to the
Fourier modes by a seeded random permutation σ (c = ifft(λ_σ)), P the
seeded random permutation π of rows and columns and D the seeded unit
phases d_j.  A plane-wave local potential is such a V(G − G′) matrix:
every entry is filled, and H is a unitary similarity of diag(λ), so its
spectrum is Clement's; ‖H‖₂ = N − 1.

``make`` draws the O(N) inputs on the CPU from the seed (σ, π, the phases
and c in f64 / c128, the same bits on every rank and every device) and
holds no N² array (``Problem.H`` is None); :func:`block` builds one
rank's block of H on its device, in row tiles, so that no rank holds
more than its block.  c is made conjugate-symmetric to the bit (c[−m] =
conj(c[m])) and every entry is computed from real products, each
rounded once, in an order that swapping j and k only mirrors: H is
Hermitian to the bit across blocks and ranks."""

from __future__ import annotations

import math

import torch

from portbench.matrices import Problem
from portbench.seeds import generator

TILE = 512             # rows of a block built at a time


def inputs(N: int, seed: int) -> dict:
    """σ's eigenvalues by Fourier mode (``mu`` = λ_σ), π (``perm``), the
    phases d (``phase``, c128) and c (``c``, c128): the family's O(N)
    inputs, drawn on the CPU from ``seed``."""
    g = generator("cpu", seed, "clement_circulant")
    lam = -(N - 1) + 2.0 * torch.arange(N, dtype=torch.float64)
    mu = lam[torch.randperm(N, generator=g)]
    perm = torch.randperm(N, generator=g)
    theta = 2 * math.pi * torch.rand(N, generator=g, dtype=torch.float64)
    phase = torch.polar(torch.ones_like(theta), theta)
    c = torch.fft.ifft(mu.to(torch.complex128))
    c = (c + c[(-torch.arange(N)) % N].conj()) / 2
    return {"N": N, "mu": mu, "perm": perm, "phase": phase, "c": c}


def make(cfg: dict, seed: int, device) -> Problem:
    N = int(cfg["N"])
    return Problem(H=None, inputs=inputs(N, seed), norm=float(N - 1))


def block(inp: dict, rows: tuple, cols: tuple, dtype, device
          ) -> torch.Tensor:
    """H's block [r0, r0 + nr) × [c0, c0 + nc) (``rows = (r0, nr)``,
    ``cols = (c0, nc)``), contiguous in ``dtype`` on ``device``, built
    TILE rows at a time in f64: with e = d_j·conj(d_k) and c = c[m],
    Re e = Re d_j·Re d_k + Im d_j·Im d_k, Im e = Im d_j·Re d_k − Re d_j·
    Im d_k, Re H = Re c·Re e − Im c·Im e, Im H = Re c·Im e + Im c·Re e,
    each product and sum its own rounding."""
    (r0, nr), (c0, nc) = rows, cols
    N = int(inp["N"])
    perm = inp["perm"].to(device)
    dr = inp["phase"].real.to(device)
    di = inp["phase"].imag.to(device)
    cr = inp["c"].real.to(device)
    ci = inp["c"].imag.to(device)
    kc = slice(c0, c0 + nc)
    out = torch.empty((nr, nc), dtype=dtype, device=device)
    parts = torch.view_as_real(out)
    for t0 in range(0, nr, TILE):
        jr = slice(r0 + t0, r0 + min(t0 + TILE, nr))
        m = (perm[jr, None] - perm[None, kc]) % N
        er = torch.outer(dr[jr], dr[kc]) + torch.outer(di[jr], di[kc])
        ei = torch.outer(di[jr], dr[kc]) - torch.outer(dr[jr], di[kc])
        a, b = cr[m], ci[m]
        del m
        tile = parts[t0:t0 + TILE]
        tile[..., 0].copy_(a * er - b * ei)
        tile[..., 1].copy_(a * ei + b * er)
        del a, b, er, ei
    return out
