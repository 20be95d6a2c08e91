"""Dtype traits and type-dependent algorithm defaults.

Port of ``chase_tpu/types.py``: the reference's Base<T>/SP/DP traits and
the per-precision defaults of ``algorithm/configuration.hpp:34-129``
(deg/maxDeg/lanczosIter/tol), keyed off the torch dtype of the problem
matrix.  numpy dtypes are accepted wherever a dtype is taken.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "as_torch_dtype",
    "numpy_scalar_type",
    "real_dtype",
    "is_complex_dtype",
    "is_double_base",
    "require_real",
    "default_tol",
    "default_deg",
    "default_max_deg",
    "default_lanczos_iter",
    "eps",
]

_FROM_NUMPY = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}

_REAL = {
    torch.float32: torch.float32,
    torch.float64: torch.float64,
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for a torch or numpy dtype (or anything
    ``np.dtype`` accepts)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _FROM_NUMPY[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"unsupported dtype for eigensolver: {dtype}") \
            from None


def numpy_scalar_type(dtype):
    """The numpy scalar type of a real f32/f64 torch dtype — host-side
    filter scalars are computed in the problem precision with it."""
    return {torch.float32: np.float32,
            torch.float64: np.float64}[as_torch_dtype(dtype)]


def real_dtype(dtype) -> torch.dtype:
    """Base<T> analogue: the real scalar type underlying ``dtype``."""
    dtype = as_torch_dtype(dtype)
    try:
        return _REAL[dtype]
    except KeyError:
        raise TypeError(f"unsupported dtype for eigensolver: {dtype}") \
            from None


def is_complex_dtype(dtype) -> bool:
    return as_torch_dtype(dtype).is_complex


def is_double_base(dtype) -> bool:
    """True for float64 / complex128 problems ("DP" in the reference)."""
    return real_dtype(dtype).itemsize == 8


def require_real(dtype) -> None:
    """This port solves real f32/f64 problems; complex Hermitian problems
    are a later slice (ROADMAP queue 1, "complex")."""
    if is_complex_dtype(dtype):
        raise NotImplementedError(
            f"complex dtype {as_torch_dtype(dtype)} is not ported yet "
            f"(ROADMAP queue 1: complex Hermitian problems)")


def eps(dtype) -> float:
    return float(torch.finfo(real_dtype(dtype)).eps)


def default_tol(dtype) -> float:
    # configuration.hpp:53-62 — 1e-10 DP / 1e-5 SP
    return 1e-10 if is_double_base(dtype) else 1e-5


def default_deg(dtype) -> int:
    # configuration.hpp — deg 20 DP / 10 SP
    return 20 if is_double_base(dtype) else 10


def default_max_deg(dtype) -> int:
    # configuration.hpp — maxDeg 36 DP / 18 SP
    return 36 if is_double_base(dtype) else 18


def default_lanczos_iter(dtype) -> int:
    # configuration.hpp — 25 DP / 12 SP
    return 25 if is_double_base(dtype) else 12
