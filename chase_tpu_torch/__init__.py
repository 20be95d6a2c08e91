"""chase_tpu_torch — the PyTorch/CUDA port of chase_tpu.

The Chebyshev-accelerated subspace eigensolver of the JAX package
``chase_tpu`` on one torch device, module for module: Lanczos bounds,
degree-optimized Chebyshev filtering, CholQR, Rayleigh–Ritz with fused
residuals and locking.  The filter's ring HEMM is a hand-written CUDA
kernel for Hopper (``csrc/ring_hemm.cu``); everything else is plain
torch.  This package never imports JAX or ``chase_tpu``.
"""

from .api import eigsh  # noqa: F401
from .config import ChaseConfig  # noqa: F401
from .parallel.operator import DenseOperator  # noqa: F401
from .perf import PerfData  # noqa: F401
from .solver import solve, SolveResult  # noqa: F401

__version__ = "0.1.0"
