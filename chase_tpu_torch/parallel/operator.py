"""Dense operator on one device.

Single-device subset of ``chase_tpu/parallel/operator.py``: the Hermitian
or pseudo-Hermitian (BSE, ``pseudo_hermitian=True``: even N, its S-halves
unpadded) operator H (f32, f64, c64 or c128) pinned on an explicit torch
device, with its dtype checked, and its reduced-precision shadow ``H_low``
for the precision ladder.  ``free_low`` drops the cached shadow.  Grid padding belongs to the multi-GPU
slice; the transient and bf16-rebuilt shadows of the JAX package's wide-f64 mode
(``H_filter``, ``drop_shadow``, ``engage_wide``) are TPU workarounds and
are not ported.

A CUDA H of a dtype the ring kernel reads (f32, c64, and bf16 for the f32
problem's shadow) is kept where the kernel's TMA loads can read it without
a copy: 16-byte aligned, with a row stride of a whole number of 16 bytes —
4 f32 elements, 2 c64 elements (its float view's rows are twice as long)
or 8 bf16 elements.  When N is not a multiple of that it is the first N
columns of a wider allocation (``padded_empty``).  f64 and c128 operators
never reach the kernel and are stored contiguous, as given.  A tensor
with torch's lazy conjugate or negative bit (``H.conj()``) is copied, never
kept as is: it shares the data of the unconjugated matrix, which is what
the kernel would read.

Placement never falls back: asking for a CUDA device on a machine without
one raises RuntimeError instead of solving on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.ring_hemm import KERNEL_DTYPES, tma_ld, tma_row_stride
from ..types import as_torch_dtype, low_precision_dtype, real_dtype

__all__ = ["DenseOperator", "resolve_device", "padded_empty"]


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


def _numpy_to(arr: np.ndarray, device: torch.device, dtype) -> torch.Tensor:
    """A copy of ``arr`` on ``device`` in the array's own strides: a
    Fortran-ordered array (``io.load_matrix``'s) is copied as it lies, not
    transposed on the host."""
    if any(s < 0 for s in arr.strides):       # torch takes no negative stride
        arr = arr.copy()
    return torch.tensor(arr, dtype=dtype, device=device)


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Copy a numpy array or tensor onto ``device`` (never aliasing the
    caller's host buffer — the solver updates its blocks in place).  A
    numpy array lands row-major whatever its order, transposed where it
    lands (the ring kernel's plain version takes unit column stride
    only)."""
    if isinstance(a, torch.Tensor):
        t = a.to(device=device, dtype=dtype or a.dtype)
        if t.is_conj() or t.is_neg():
            return t.resolve_conj().resolve_neg()
        return t.clone() if t is a else t
    arr = np.asarray(a)
    dt = dtype if dtype is not None else as_torch_dtype(arr.dtype)
    return _numpy_to(arr, device, dt).contiguous()


def padded_empty(N: int, dtype, device) -> torch.Tensor:
    """An uninitialised (N, N) tensor laid out as a CUDA operator is
    stored: for the kernel's dtypes a view whose row is rounded up to a
    whole number of 16 bytes (``tma_ld``): N rounded up to a multiple of 4
    for float32, to an even number for complex64, to a multiple of 8 for
    bfloat16.  Otherwise contiguous."""
    ld = N
    if dtype in KERNEL_DTYPES:
        w = 2 if dtype.is_complex else 1        # TMA units per element
        ld = tma_ld(w * N, dtype.itemsize // w) // w
    return torch.empty((N, ld), dtype=dtype, device=device)[:, :N]


def _has_operator_layout(H: torch.Tensor) -> bool:
    """Whether H already has a layout :func:`padded_empty`'s rule accepts
    (and no lazy conjugate or negative bit)."""
    if H.is_conj() or H.is_neg():
        return False
    if H.dtype in KERNEL_DTYPES:
        return H.stride(1) == 1 and tma_row_stride(H) is not None
    return H.is_contiguous()


class DenseOperator:
    """Dense Hermitian (or, with ``pseudo_hermitian``, BSE) operator
    resident on one torch device."""

    def __init__(self, H, device="cuda", *, pseudo_hermitian: bool = False):
        self.device = resolve_device(device)
        if H.ndim != 2 or H.shape[0] != H.shape[1]:
            raise ValueError(f"H must be square, got {tuple(H.shape)}")
        if pseudo_hermitian and H.shape[0] % 2:
            raise ValueError(f"a pseudo-Hermitian operator needs even N "
                             f"(the metric S splits it in halves), got N = "
                             f"{H.shape[0]}")
        self.pseudo_hermitian = bool(pseudo_hermitian)
        dtype = as_torch_dtype(H.dtype)
        real_dtype(dtype)         # TypeError for a dtype the solver lacks
        self._H_low = None
        resident = isinstance(H, torch.Tensor) and H.device == self.device
        if self.device.type == "cuda":
            if resident and _has_operator_layout(H):
                self.H = H        # used as is (no N² copy)
            else:
                self.H = padded_empty(H.shape[0], dtype, self.device)
                self.H.copy_(H if isinstance(H, torch.Tensor)
                             else _numpy_to(np.asarray(H), self.device, dtype))
        elif resident:
            # a device-resident operator is used as is (no N² copy),
            # unless it is a lazy conjugate or negative view
            lazy = H.is_conj() or H.is_neg()
            self.H = H if H.is_contiguous() and not lazy \
                else H.resolve_conj().resolve_neg().contiguous()
        else:
            self.H = to_device(H, self.device)

    @property
    def N(self) -> int:
        return int(self.H.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.H.dtype

    @property
    def real_dtype(self) -> torch.dtype:
        """The real scalar type of H's dtype (f32 for c64, f64 for c128)."""
        return real_dtype(self.dtype)

    def free_low(self) -> None:
        """Drop the cached shadow ``H_low`` — N² elements of device memory
        between solves (7.2 GB for the c128 north star's c64 shadow); the
        next ``H_low`` rebuilds it."""
        self._H_low = None

    @property
    def H_low(self) -> torch.Tensor:
        """H in ``low_precision_dtype`` (f64 → f32, c128 → c64, f32 →
        bf16): the precision ladder's filter operator, built on first use
        and cached (the JAX package's ``H_low`` without its transient
        mode).  On CUDA it is laid out as ``padded_empty`` lays out an
        operator, so the ring kernel reads it without a copy."""
        if self._H_low is None:
            lp = low_precision_dtype(self.dtype)
            if self.device.type == "cuda":
                self._H_low = padded_empty(self.N, lp, self.device)
                self._H_low.copy_(self.H)
            else:
                self._H_low = self.H.to(lp)
        return self._H_low

    def place_block(self, V) -> torch.Tensor:
        """A private (N, k) copy of a multivector on the operator's device
        in the operator's dtype."""
        if V.shape[0] != self.N:
            raise ValueError(f"block has {V.shape[0]} rows, operator N = "
                             f"{self.N}")
        return to_device(V, self.device, self.dtype)
