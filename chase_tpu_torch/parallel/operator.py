"""Dense operator on one device.

Single-device subset of ``chase_tpu/parallel/operator.py``: the Hermitian
operator H pinned on an explicit torch device, with its dtype checked.
Grid padding and the reduced-precision shadows belong to later slices
(multi-GPU, the precision ladder).

Placement never falls back: asking for a CUDA device on a machine without
one raises RuntimeError instead of solving on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import as_torch_dtype, require_real

__all__ = ["DenseOperator", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is visible;
    a bare "cuda" becomes the current card ("cuda:0"), so a tensor already
    there is recognized and not copied."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; chase_tpu_torch does not fall back to the CPU — pass "
            f"device='cpu' to solve there")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Copy a numpy array or tensor onto ``device`` (never aliasing the
    caller's host buffer — the solver updates its blocks in place)."""
    if isinstance(a, torch.Tensor):
        t = a.to(device=device, dtype=dtype or a.dtype)
        return t.clone() if t is a else t
    arr = np.asarray(a)
    dt = dtype if dtype is not None else as_torch_dtype(arr.dtype)
    return torch.tensor(arr, dtype=dt, device=device)


class DenseOperator:
    """Dense Hermitian operator resident on one torch device."""

    def __init__(self, H, device="cuda"):
        self.device = resolve_device(device)
        if H.ndim != 2 or H.shape[0] != H.shape[1]:
            raise ValueError(f"H must be square, got {tuple(H.shape)}")
        dtype = as_torch_dtype(H.dtype)
        require_real(dtype)
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"unsupported dtype for eigensolver: {dtype}")
        if isinstance(H, torch.Tensor) and H.device == self.device:
            # a device-resident operator is used as is (no N² copy)
            self.H = H if H.is_contiguous() else H.contiguous()
        else:
            self.H = to_device(H, self.device)

    @property
    def N(self) -> int:
        return int(self.H.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.H.dtype

    def place_block(self, V) -> torch.Tensor:
        """A private (N, k) copy of a multivector on the operator's device
        in the operator's dtype."""
        if V.shape[0] != self.N:
            raise ValueError(f"block has {V.shape[0]} rows, operator N = "
                             f"{self.N}")
        return to_device(V, self.device, self.dtype)
