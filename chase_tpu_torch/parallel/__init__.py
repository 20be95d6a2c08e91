"""Device placement, the process grid, its layouts and the ring filters:
the port of ``chase_tpu/parallel`` (``mesh`` with its DTensor shardings,
``multihost``, ``layouts``, the grid parts of ``operator`` and the 1-D and
2-D rings of ``ring``; ``dist`` holds the explicit collectives that GSPMD
inserts in the JAX package)."""

from .mesh import (  # noqa: F401
    make_grid, matrix_sharding, colvec_sharding, rowvec_sharding,
    replicated_sharding, Grid2D,
)
from .operator import DenseOperator, resolve_device  # noqa: F401
