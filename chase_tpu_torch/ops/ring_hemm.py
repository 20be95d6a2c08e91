"""The filter's ring HEMM: ``W (=|+=) H[:, col0:col0+b] · V``.

Port of ``chase_tpu/ops/pallas_ring.py`` (the Pallas RDMA ring kernel,
``_ring_kernel``).  One call is one ring step: ``accumulate=False`` is the
TPU kernel's step-0 store, ``accumulate=True`` its later-step add, so the
multi-GPU ring can feed the V chunks it receives into the same kernel.  On
one card (p = 1) a filter step is a single call with ``col0=0``.

* :func:`ring_hemm` — the wrapper.  It validates its arguments, then
  launches the CUDA kernel ``csrc/ring_hemm.cu`` for CUDA tensors (built
  on first use, see ``_build``) and raises if the launch fails.  Only a
  tensor on the CPU takes the plain version; a CUDA tensor never does.
  ``ring_hemm.launches`` counts kernel launches and nothing else.
* :func:`ring_hemm_reference` — the plain PyTorch version, one
  ``torch.matmul`` with the same accumulate semantics.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

__all__ = ["ring_hemm", "ring_hemm_reference"]


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


@functools.lru_cache(maxsize=None)
def _lib():
    from .. import _build
    lib = _build.load_library("ring_hemm")
    fn = lib.ring_hemm_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ring_hemm(H: torch.Tensor, V: torch.Tensor, *, col0: int = 0,
              out: Optional[torch.Tensor] = None,
              accumulate: bool = False) -> torch.Tensor:
    """``out (=|+=) H[:, col0:col0+b] · V`` with b = V.shape[0].

    Args:
      H: (m, n_cols) f32 stripe, unit column stride.
      V: (b, k) f32 chunk; may be a column window of a wider block.
      col0: first H column of the block that multiplies V.
      out: (m, k) f32 destination (a window is fine); allocated with
        ``torch.empty`` when None.
      accumulate: add into ``out`` instead of overwriting it.

    CPU tensors run :func:`ring_hemm_reference`; CUDA tensors launch the
    kernel on the current stream, or raise.
    """
    _check(H, V, col0, out, accumulate)
    if H.device.type == "cpu":
        return ring_hemm_reference(H, V, col0=col0, out=out,
                                   accumulate=accumulate)
    if H.device.type != "cuda":
        raise RuntimeError(f"ring_hemm runs on cuda or cpu tensors, not "
                           f"{H.device}")
    m, b, k = H.shape[0], V.shape[0], V.shape[1]
    if out is None:
        out = torch.empty((m, k), dtype=torch.float32, device=H.device)
    fn = _lib()
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = fn(H.data_ptr() + 4 * col0, H.stride(0),
                 V.data_ptr(), V.stride(0),
                 out.data_ptr(), out.stride(0),
                 m, k, b, int(bool(accumulate)), stream)
    if err != 0:
        raise RuntimeError(f"ring_hemm kernel launch failed: CUDA error "
                           f"{err} (m={m}, k={k}, b={b})")
    ring_hemm.launches += 1
    return out


ring_hemm.launches = 0
