"""Process-group initialization from a launcher's environment.

Port of ``chase_tpu/parallel/multihost.py``: the user-side MPI_Init +
MPI_Dims_create + MpiGrid2D boilerplate of the reference's distributed
examples.  The JAX version wraps ``jax.distributed.initialize``; here it
is ``torch.distributed.init_process_group`` from torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), one process per card.  Typical use, the same script on
every rank::

    torchrun --nproc-per-node=4 solve.py

    # solve.py
    import chase_tpu_torch as ct
    from chase_tpu_torch.parallel import multihost
    grid = multihost.init_grid((4, 1))      # the p-step ring; init_grid()
                                            # alone gives the near-square
                                            # (2, 2): the 2-D ring
    res = ct.eigsh(H, nev, nex, grid=grid)  # H whole on every rank, or a
                                            # DTensor (Shard(0), Shard(1))

On CUDA the process group is NCCL and each rank drives card
``LOCAL_RANK`` (``torch.cuda.set_device`` before the group is made; a
failed NCCL init raises).  ``device="cpu"`` makes a gloo group (the CPU
tests).  Without a launcher's environment a single process makes a group
of one in memory.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Grid2D, make_grid

__all__ = ["init_grid", "ensure_initialized", "is_multihost",
           "process_info"]


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def ensure_initialized(coordinator: Optional[str] = None, *,
                       device="cuda", timeout: float = 600.0) -> None:
    """Initialize the default process group if it is not (a second call
    is a no-op, as in the JAX package).

    Args:
      coordinator: "host:port" of rank 0's store, or an init URL
        ("tcp://…", "file://…"); default torchrun's ``MASTER_ADDR`` /
        ``MASTER_PORT``.
      device: "cuda" (NCCL, card ``LOCAL_RANK``) or "cpu" (gloo).
      timeout: seconds a collective may wait before the group fails it
        (a rank that raised leaves its peers blocked otherwise).

    The rank and world size come from ``RANK`` and ``WORLD_SIZE``; with
    neither set (and no ``coordinator``) a single process makes a group
    of one on an in-memory store.  RuntimeError for "cuda" without a
    card; NCCL's own errors propagate.
    """
    if dist.is_initialized():
        return
    dev_type = torch.device(device).type
    world = _env_int("WORLD_SIZE", 1)
    rank = _env_int("RANK", 0)
    kwargs = dict(rank=rank, world_size=world,
                  timeout=datetime.timedelta(seconds=timeout))
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "multihost.ensure_initialized(device='cuda') but "
                "torch.cuda.is_available() is False; chase_tpu_torch does "
                "not fall back to the CPU — pass device='cpu' for gloo")
        local = _env_int("LOCAL_RANK", 0)
        torch.cuda.set_device(local)
        backend = "nccl"
        # eager NCCL init: a failure raises here, not in the first
        # collective
        kwargs["device_id"] = torch.device("cuda", local)
    elif dev_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"multihost runs on cuda or cpu, not {device!r}")
    if coordinator:
        kwargs["init_method"] = (coordinator if "://" in coordinator
                                 else f"tcp://{coordinator}")
    elif "MASTER_ADDR" in os.environ or "RANK" in os.environ:
        kwargs["init_method"] = "env://"
    else:
        kwargs["store"] = dist.HashStore()
    dist.init_process_group(backend, **kwargs)


def init_grid(shape: Optional[tuple] = None,
              coordinator: Optional[str] = None, *, device="cuda",
              timeout: float = 600.0) -> Grid2D:
    """Initialize the process group (if needed) and build the grid over
    every rank: :func:`ensure_initialized` then ``make_grid``."""
    ensure_initialized(coordinator, device=device, timeout=timeout)
    return make_grid(shape=shape, device=device)


def is_multihost() -> bool:
    """Whether more than one process takes part."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    """The JAX package's keys: this process's index and the process
    count; one device per process."""
    init = dist.is_initialized()
    world = dist.get_world_size() if init else 1
    return {"process_index": dist.get_rank() if init else 0,
            "process_count": world,
            "local_devices": 1,
            "global_devices": world}
