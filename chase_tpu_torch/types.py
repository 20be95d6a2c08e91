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
    "low_precision_dtype",
    "filter_carry_dtype",
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
    """The numpy scalar type of ``dtype``'s real base (c64 → float32, c128
    → float64) — host-side filter scalars are computed in the problem
    precision with it."""
    return {torch.float32: np.float32,
            torch.float64: np.float64}[real_dtype(dtype)]


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


_LOW = {
    torch.float64: torch.float32,
    torch.complex128: torch.complex64,
    torch.float32: torch.bfloat16,
}


def low_precision_dtype(dtype) -> torch.dtype:
    """The reduced-precision dtype of the ladder's filter operator (the
    shadow ``DenseOperator.H_low``): f64 → f32 and c128 → c64 (the
    reference's DP → SP filter, chase_cpu.hpp:384-447), f32 → bf16 (the
    bf16 rung, taken by f32 problems only when asked for).  A problem is
    never bf16; c64 has no lower rung and maps to itself."""
    dtype = as_torch_dtype(dtype)
    return _LOW.get(dtype, dtype)


def filter_carry_dtype(h_dtype, x_dtype) -> torch.dtype:
    """Dtype of the Chebyshev recurrence carry for an (H, X) pair.

    The f64 → f32 / c128 → c64 rung runs the whole recurrence in H's
    reduced dtype.  A bf16 H (the bf16 storage rung) keeps the carry in
    X's precision, capped at 32 bits (only the products take bf16 inputs,
    with f32 sums): a three-term recurrence carried in 8 mantissa bits
    degrades too fast, and a 64-bit carry buys nothing over a bf16
    operator's ~1e-2 relative fidelity."""
    h_dtype, x_dtype = as_torch_dtype(h_dtype), as_torch_dtype(x_dtype)
    if h_dtype == torch.bfloat16:
        return {torch.float64: torch.float32,
                torch.complex128: torch.complex64}.get(x_dtype, x_dtype)
    return h_dtype


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
