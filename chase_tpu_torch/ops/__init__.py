"""Numeric kernels of the port, module for module the JAX package's
``chase_tpu/ops``.  Plain products are torch; the filter's ring HEMM is
the hand-written CUDA kernel of :mod:`.ring_hemm`."""

from . import blocks, checks, filter, lanczos, qr, ring_hemm, rr  # noqa: F401
