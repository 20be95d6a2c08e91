"""chase_tpu_torch — the PyTorch/CUDA port of chase_tpu.

The Chebyshev-accelerated subspace eigensolver of the JAX package
``chase_tpu`` on torch devices, module for module: Lanczos bounds,
degree-optimized Chebyshev filtering, CholQR, Rayleigh–Ritz with fused
residuals and locking, for real symmetric and complex Hermitian problems,
for sequences of them and for pseudo-Hermitian (Bethe–Salpeter) problems
(``eigsh_pseudo``: the filter on H², K-conjugated mirrors, the S-metric
pencil Rayleigh–Ritz), natively or on the precision ladder (f64/c128
filtered on an f32/c64 shadow, f32 on a bf16 one); ``eigsh_fused`` and
``eigsh_pseudo_fused`` keep the whole loop's state on the device, and
``warmup`` does a solve's one-time work first.  The filter's ring HEMM is
a hand-written CUDA kernel for Hopper (``csrc/ring_hemm.cu``: f32, c64,
and bf16 H with f32 V); everything else is plain torch.  ``io`` reads and
writes ChASE binary files and checkpoints, ``interface`` is the flat
init/solve/get session, ``cli`` the command line (``python -m
chase_tpu_torch``), and ``_native`` builds the threaded file reader and
the C ABI library ``libchase_tpu_torch.so``.  ``make_grid`` / ``Grid2D``
and ``parallel.multihost`` run every solver on a ``torch.distributed``
process grid (NCCL on cards, gloo on the CPU), one process per device;
``parallel.layouts`` holds the block-cyclic layouts, and ``io``,
``interface``, ``cli`` and the C ABI have their distributed forms there.
``perf`` holds the phase timers, the FLOP model and the card's peaks.
This package never imports JAX or ``chase_tpu``.
"""

from .api import (eigsh, eigsh_fused, eigsh_pseudo,  # noqa: F401
                  eigsh_pseudo_fused, eigsh_sequence,
                  estimate_spectral_bounds)
from .config import ChaseConfig  # noqa: F401
from .parallel.mesh import Grid2D, make_grid  # noqa: F401
from .parallel.operator import DenseOperator  # noqa: F401
from .perf import PerfData  # noqa: F401
from .solver import solve, SolveResult  # noqa: F401
from .solver_pseudo import solve_pseudo  # noqa: F401
from .warmup import warmup  # noqa: F401

__version__ = "0.1.0"
