"""The structured BSE matrix's exact positive spectrum: √(a² − b²),
ascending (A and B share the eigenbasis Q, so H splits into 2 × 2 blocks
[[a, b], [−b, −a]] with eigenvalues ±√(a² − b²))."""

from __future__ import annotations

import torch


def exact(inputs: dict) -> torch.Tensor:
    a = inputs["a"].to(torch.float64).cpu()
    b = inputs["b"].to(torch.float64).cpu()
    return torch.sort(torch.sqrt(a * a - b * b)).values
