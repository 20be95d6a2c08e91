"""Chebyshev filter whose HEMM is the ring kernel — the p = 1 ring.

Port of ``chase_tpu/parallel/ring.py::chebyshev_filter_ring_pallas`` on a
single device.  The JAX version runs the recurrence inside one shard_map
with the Pallas ring kernel as each step's H·V; with one device the ring
has one chunk, so each step is one :func:`~chase_tpu_torch.ops.ring_hemm.
ring_hemm` call that streams all of H against the filter window.  The
shift ``c·Y``, the three-term update and the degree mask are plain torch.
The multi-GPU ring (NCCL chunk exchange) is a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.ring_hemm import ring_hemm
from ..types import numpy_scalar_type

__all__ = ["chebyshev_filter_ring_pallas"]


def chebyshev_filter_ring_pallas(H: torch.Tensor, X: torch.Tensor, degrees,
                                 lam1, lower, upper, deg_max: int
                                 ) -> torch.Tensor:
    """Degree-masked scaled Chebyshev filter of the window ``X`` with
    every H·Y product on the ring kernel (``1 + max(deg_max − 1, 0)``
    launches).  Same-dtype H and X, f32 like the JAX version or c64 (the
    kernel's complex route; the JAX version reaches its kernel with
    complex data only through the real-pair embedding).

    Args:
      H: (N, N) operator.
      X: (N, w) window; may be a column view of the search block.
      degrees: (w,) per-column degrees; 0 leaves a column untouched.
      lam1, lower, upper: filter amplification point and damped interval.
      deg_max: max(degrees), the recurrence length.

    Returns: (N, w) filtered window (new tensor); degree-0 columns are
    bit-exact copies of X's.
    """
    if H.dtype != X.dtype:
        raise TypeError(f"ring filter needs matching dtypes, got "
                        f"H={H.dtype} X={X.dtype}")
    # scalars in the problem's real precision (f32 for f32 and c64), like
    # the JAX version's traced f32 scalars
    rt = numpy_scalar_type(X.dtype)
    lam1, lower, upper = rt(lam1), rt(lower), rt(upper)
    c = (upper + lower) / rt(2)
    e = (upper - lower) / rt(2)
    sigma1 = e / (lam1 - c)
    degs = torch.as_tensor(np.asarray(degrees), device=X.device)[None, :]

    def hemm_shift(v):
        return ring_hemm(H, v) - float(c) * v

    Y = float(sigma1 / e) * hemm_shift(X)
    Y = torch.where(degs >= 1, Y, X)
    Xp, sigma = X, sigma1
    for t in range(2, int(deg_max) + 1):
        sigma_new = rt(1) / (rt(2) / sigma1 - sigma)
        Z = float(rt(2) * sigma_new / e) * hemm_shift(Y) \
            - float(sigma * sigma_new) * Xp
        Xp, Y = Y, torch.where(degs >= t, Z, Y)
        sigma = sigma_new
    return torch.where(degs >= 1, Y, X)
