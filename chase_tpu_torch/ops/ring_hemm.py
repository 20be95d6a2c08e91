"""The filter's ring HEMM: ``W (=|+=) H[:, col0:col0+b] · V``.

Port of ``chase_tpu/ops/pallas_ring.py`` (the Pallas RDMA ring kernel,
``_ring_kernel``).  One call is one ring step: ``accumulate=False`` is the
TPU kernel's step-0 store, ``accumulate=True`` its later-step add, so the
multi-GPU ring can feed the V chunks it receives into the same kernel.  On
one card (p = 1) a filter step is a single call with ``col0=0``.

On a CUDA tensor one call is two launches of ``csrc/ring_hemm.cu`` (built
on first use, see ``_build``): the pre-pass :func:`tf32_split`, which
writes V's chunk transposed and split into TF32 ``hi`` and ``lo`` parts,
then the main kernel, which multiplies with TMA + wgmma in 3xTF32 (f32-class
accuracy on the tensor cores; the error scheme is in the source's note).

* :func:`ring_hemm` — the wrapper.  It validates its arguments, then
  launches the kernels for CUDA tensors and raises if a launch fails.
  Only a tensor on the CPU takes the plain version; a CUDA tensor never
  does.  ``ring_hemm.launches`` counts main-kernel launches and nothing
  else.  H is read through TMA: on the card it must be 16-byte aligned
  with a row stride that is a multiple of 4 floats (``DenseOperator``
  allocates it so), or the wrapper raises ValueError.
* :func:`tf32_split` — the pre-pass's wrapper (``tf32_split.launches``).
* :func:`ring_hemm_reference`, :func:`tf32_split_reference` — the plain
  PyTorch versions: one ``torch.matmul`` with the same accumulate
  semantics, and the TF32 split by bit arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import Optional

import torch

__all__ = ["ring_hemm", "ring_hemm_reference", "tf32_split",
           "tf32_split_reference", "split_shape", "tma_ld",
           "tma_row_stride"]

BK, BN = 32, 128          # csrc/ring_hemm.cu's K tile and W column tile


def ring_hemm_reference(H: torch.Tensor, V: torch.Tensor, *, col0: int = 0,
                        out: Optional[torch.Tensor] = None,
                        accumulate: bool = False) -> torch.Tensor:
    """Plain version: ``out (=|+=) H[:, col0:col0 + V.shape[0]] @ V``."""
    prod = H[:, col0:col0 + V.shape[0]] @ V
    if out is None:
        return prod
    if accumulate:
        return out.add_(prod)
    return out.copy_(prod)


def split_shape(b: int, k: int, off: int = 0) -> tuple:
    """(b_pad, w_pad): the pre-pass output's K extent (``off + b`` rounded
    up to the K tile, at least one tile) and column extent (a multiple of
    the W column tile, at least one)."""
    return BK * max(1, -(-(b + off) // BK)), BN * max(1, -(-k // BN))


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 → TF32 (10-bit mantissa), nearest with ties away from zero, as
    ``cvt.rna.tf32.f32``: add half an ulp of TF32 to the magnitude bits and
    clear the 13 bits TF32 drops."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split_reference(V: torch.Tensor, off: int = 0) -> torch.Tensor:
    """Plain version of the pre-pass: ``Vt[0, :k, off:off+b] = hi(Vᵀ)``,
    ``Vt[1, :k, off:off+b] = lo(Vᵀ)``, zeros elsewhere in (2, w_pad,
    b_pad), with ``hi = tf32(x)`` and ``lo = tf32(x − hi)``."""
    b, k = V.shape
    b_pad, w_pad = split_shape(b, k, off)
    Vt = torch.zeros((2, w_pad, b_pad), dtype=torch.float32, device=V.device)
    hi = _tf32_rna(V)
    Vt[0, :k, off:off + b] = hi.T
    Vt[1, :k, off:off + b] = _tf32_rna(V - hi).T
    return Vt


def _check(H, V, col0, out, accumulate):
    """Raise on anything the kernel does not take: f32 only in this
    port slice, 2-D operands on one device, unit column stride."""
    for name, t in (("H", H), ("V", V), ("out", out)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"ring_hemm takes float32 tensors; {name} is "
                            f"{t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"ring_hemm takes 2-D tensors; {name} has shape "
                             f"{tuple(t.shape)}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"ring_hemm needs unit column stride; {name} "
                             f"has strides {t.stride()}")
        if t.shape[0] > 1 and t.stride(0) < max(t.shape[1], 1):
            raise ValueError(f"ring_hemm needs row stride >= width; {name} "
                             f"has strides {t.stride()}")
        if t.device != H.device:
            raise ValueError(f"ring_hemm operands must share a device; "
                             f"{name} is on {t.device}, H on {H.device}")
    m, b, k = H.shape[0], V.shape[0], V.shape[1]
    if col0 < 0 or col0 + b > H.shape[1]:
        raise ValueError(f"column block [{col0}, {col0 + b}) outside H's "
                         f"{H.shape[1]} columns")
    if out is None:
        if accumulate:
            raise ValueError("accumulate=True needs out")
    elif tuple(out.shape) != (m, k):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected "
                         f"{(m, k)}")


def tma_ld(n: int) -> int:
    """``n`` rounded up to a multiple of 4: the smallest row stride, in
    floats, that TMA can describe for rows of ``n`` floats."""
    return -(-n // 4) * 4


def tma_row_stride(H: torch.Tensor) -> Optional[int]:
    """H's row stride as the kernel's TMA loads read it, or None where TMA
    cannot describe H: it needs a 16-byte-aligned base and a row stride
    that is a multiple of 4 elements (a single row may have any)."""
    ld = H.stride(0) if H.shape[0] > 1 else tma_ld(H.shape[1])
    return None if H.data_ptr() % 16 or ld % 4 else ld


def _check_split_input(V: torch.Tensor):
    if V.dtype != torch.float32 or V.ndim != 2:
        raise TypeError(f"tf32_split takes a 2-D float32 tensor, got "
                        f"{V.dtype} of shape {tuple(V.shape)}")
    if V.shape[1] > 1 and V.stride(1) != 1:
        raise ValueError(f"tf32_split needs unit column stride; V has "
                         f"strides {V.stride()}")


@functools.lru_cache(maxsize=None)
def _lib():
    from .. import _build
    lib = _build.load_library("ring_hemm")
    split = lib.ring_hemm_split_f32
    split.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p]
    split.restype = ctypes.c_int
    main = lib.ring_hemm_f32
    main.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]
    main.restype = ctypes.c_int
    return types.SimpleNamespace(split=split, main=main)


def _raise_on(err: int, what: str):
    if err == 0:
        return
    if err >= 2000:
        why = f"TMA descriptor encoding failed (CUresult {err - 2000})"
    elif err == 1000:
        why = "cuTensorMapEncodeTiled not found in the CUDA driver"
    else:
        why = f"CUDA error {err}"
    raise RuntimeError(f"{what} launch failed: {why}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def tf32_split(V: torch.Tensor, off: int = 0) -> torch.Tensor:
    """The pre-pass: V (b, k) → Vt (2, w_pad, b_pad) with Vt[0] the TF32
    ``hi`` part of Vᵀ, Vt[1] the ``lo`` part, starting at column ``off``
    (0–3; ring_hemm passes col0 % 4 so that H's TMA boxes start on 16
    bytes), zero-padded (K-major, the layout wgmma takes for 32-bit B
    operands).  CPU tensors run :func:`tf32_split_reference`; CUDA
    tensors launch the kernel."""
    _check_split_input(V)
    if not 0 <= off < 4:
        raise ValueError(f"tf32_split offset must be 0..3, got {off}")
    if V.device.type == "cpu":
        return tf32_split_reference(V, off)
    if V.device.type != "cuda":
        raise RuntimeError(f"tf32_split runs on cuda or cpu tensors, not "
                           f"{V.device}")
    b, k = V.shape
    b_pad, w_pad = split_shape(b, k, off)
    Vt = torch.empty((2, w_pad, b_pad), dtype=torch.float32, device=V.device)
    with torch.cuda.device(V.device):
        err = _lib().split(V.data_ptr(), V.stride(0), Vt.data_ptr(), b, k,
                           off, b_pad, w_pad, _stream(V.device))
    _raise_on(err, f"tf32_split kernel (b={b}, k={k})")
    tf32_split.launches += 1
    return Vt


def ring_hemm(H: torch.Tensor, V: torch.Tensor, *, col0: int = 0,
              out: Optional[torch.Tensor] = None,
              accumulate: bool = False) -> torch.Tensor:
    """``out (=|+=) H[:, col0:col0+b] · V`` with b = V.shape[0].

    Args:
      H: (m, n_cols) f32 stripe, unit column stride; on the card 16-byte
        aligned with a row stride that is a multiple of 4 floats.
      V: (b, k) f32 chunk; may be a column window of a wider block.
      col0: first H column of the block that multiplies V.
      out: (m, k) f32 destination (a window is fine); allocated with
        ``torch.empty`` when None.
      accumulate: add into ``out`` instead of overwriting it.

    CPU tensors run :func:`ring_hemm_reference`; CUDA tensors launch the
    pre-pass and the kernel on the current stream, or raise.  The
    pre-pass's output, 2·w_pad·b_pad floats, is scratch of this call.
    """
    _check(H, V, col0, out, accumulate)
    if H.device.type == "cpu":
        return ring_hemm_reference(H, V, col0=col0, out=out,
                                   accumulate=accumulate)
    if H.device.type != "cuda":
        raise RuntimeError(f"ring_hemm runs on cuda or cpu tensors, not "
                           f"{H.device}")
    ldh = tma_row_stride(H)
    if ldh is None:
        raise ValueError(
            f"ring_hemm reads H through TMA, which needs a 16-byte-aligned "
            f"base and a row stride that is a multiple of 4 floats; H has "
            f"row stride {H.stride(0)} and base address {H.data_ptr():#x} — "
            f"allocate it with a padded row stride (DenseOperator does)")
    m, b, k = H.shape[0], V.shape[0], V.shape[1]
    if out is None:
        out = torch.empty((m, k), dtype=torch.float32, device=H.device)
    Vt = tf32_split(V, col0 % 4)
    with torch.cuda.device(H.device):
        err = _lib().main(H.data_ptr(), ldh, col0, Vt.data_ptr(),
                          Vt.shape[2], Vt.shape[1], out.data_ptr(),
                          out.stride(0), m, k, b, int(bool(accumulate)),
                          _stream(H.device))
    _raise_on(err, f"ring_hemm kernel (m={m}, k={k}, b={b}, col0={col0})")
    ring_hemm.launches += 1
    return out


ring_hemm.launches = 0
tf32_split.launches = 0
