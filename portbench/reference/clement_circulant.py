"""The circulant family's plain reference: Clement's exact spectrum
(``exact``), and H applied to a block of columns by FFT (``operator``),
from the family's O(N) inputs — λ_σ by Fourier mode, the permutation π
and the phases d — and not from its blocks:

    H·v = D·Pᵀ·C·P·Dᴴ·v:  u = conj(d)⊙v,  w[π] = u,
                          y = ifft(λ_σ ⊙ fft(w)),  (H·v) = d⊙y[π],

O(N log N) a column, in c128, a few columns at a time.  The operator has
the ``dtype``, ``device`` and ``@`` that ``compare.resid`` reads of a
dense H, so the Hermitian judge reads it unchanged."""

from __future__ import annotations

import torch

from portbench.reference import clement_dense

COLUMNS = 256          # columns transformed at a time


def exact(inputs: dict) -> torch.Tensor:
    return clement_dense.exact(inputs)


class Operator:
    """H of the circulant family, applied by FFT on ``device``."""

    dtype = torch.complex128

    def __init__(self, inputs: dict, device):
        self.device = torch.device(device)
        self.N = int(inputs["N"])
        self.shape = (self.N, self.N)
        self.mu = inputs["mu"].to(self.device, torch.complex128)[:, None]
        self.perm = inputs["perm"].to(self.device)
        self.phase = inputs["phase"].to(self.device, torch.complex128)[:, None]

    def __matmul__(self, V: torch.Tensor) -> torch.Tensor:
        torch.backends.cuda.matmul.allow_tf32 = False
        V = V.to(self.device, self.dtype)
        out = torch.empty_like(V)
        for j0 in range(0, V.shape[1], COLUMNS):
            J = slice(j0, j0 + COLUMNS)
            w = torch.empty_like(V[:, J])
            w[self.perm] = self.phase.conj() * V[:, J]
            y = torch.fft.ifft(self.mu * torch.fft.fft(w, dim=0), dim=0)
            out[:, J] = self.phase * y[self.perm]
        return out


def operator(inputs: dict, device) -> Operator:
    return Operator(inputs, device)
