"""Device placement, the process grid and the ring filters: the port of
``chase_tpu/parallel`` (``mesh``, ``multihost``, the grid parts of
``operator`` and the 1-D and 2-D rings of ``ring``; ``dist`` holds the
explicit collectives that GSPMD inserts in the JAX package).
``layouts`` waits for a later part of the multi-GPU slice."""

from .mesh import Grid2D, make_grid  # noqa: F401
from .operator import DenseOperator, resolve_device  # noqa: F401
