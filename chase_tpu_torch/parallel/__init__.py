"""Device placement and the ring filter (single-device subset of
``chase_tpu/parallel``; multi-GPU meshes are a later slice)."""

from .operator import DenseOperator, resolve_device  # noqa: F401
