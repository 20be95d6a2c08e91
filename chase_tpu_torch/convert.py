"""Carry state between the JAX package and the port.

The JAX package consumes and produces numpy-convertible arrays; these
helpers turn them into the port's tensors on an explicit device, so the
same H, start block or previous solution feeds both solvers.  Nothing
here imports JAX: a JAX array converts through ``np.asarray``.  Like the
solver's entry points they place on the card unless the caller asks for
the CPU, and without a card ``device="cuda"`` raises RuntimeError.
"""

from __future__ import annotations

import numpy as np
import torch

from .parallel.operator import resolve_device, to_device
from .types import as_torch_dtype

__all__ = ["array_to_torch", "warm_start_from"]


def array_to_torch(a, device="cuda", dtype=None) -> torch.Tensor:
    """A matrix H or a start block V0 (numpy or JAX array; real or
    complex) as a new tensor on ``device``, in ``dtype`` (default: the
    array's own)."""
    arr = np.asarray(a)
    return to_device(arr, resolve_device(device),
                     as_torch_dtype(dtype or arr.dtype))


def warm_start_from(result, device="cuda", dtype=None):
    """(v0, ritzv0) for the port's ``eigsh(..., approx=True)`` from a JAX
    ``SolveResult``: its full (N, nev+nex) block ``V`` as a tensor on
    ``device`` and its ``ritzv_full`` as a float64 numpy array."""
    v0 = array_to_torch(result.V, device, dtype)
    return v0, np.asarray(result.ritzv_full, np.float64).copy()
