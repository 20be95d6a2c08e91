"""Clement's exact spectrum: λ_i = −(N−1) + 2i, i = 0 … N−1 (the dense
family is a unitary similarity of diag(λ))."""

from __future__ import annotations

import torch


def exact(inputs: dict) -> torch.Tensor:
    N = int(inputs["N"])
    return -(N - 1) + 2.0 * torch.arange(N, dtype=torch.float64)
