"""Device placement, the process grid and the ring filters: the port of
``chase_tpu/parallel`` (``mesh``, ``multihost``, the grid parts of
``operator`` and the 1-D rings of ``ring``; ``dist`` holds the explicit
collectives that GSPMD inserts in the JAX package).  The 2-D rings and
``layouts`` wait for later parts of the multi-GPU slice."""

from .mesh import Grid2D, make_grid  # noqa: F401
from .operator import DenseOperator, resolve_device  # noqa: F401
