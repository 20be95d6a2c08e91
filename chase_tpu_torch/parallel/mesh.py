"""2-D process grid on ``torch.distributed`` and its collectives.

Port of ``chase_tpu/parallel/mesh.py`` (the reference's MpiGrid2D,
``grid/mpiGrid2D.hpp:188``): a ``DeviceMesh`` with dimensions ``('r',
'c')``, one process per device.  The JAX package lets GSPMD place data and
emit collectives from shardings; the port holds explicit local blocks and
calls the collectives itself, as the reference does:

* the N×N operator H is cut in ``P('r', 'c')``: rank (i, j) holds rows
  ``[i·N/r, (i+1)·N/r)`` and columns ``[j·N/c, (j+1)·N/c)``;
* multivectors (V, W, R) are in ``P('r', None)``: rank (i, j) holds rows
  ``[i·N/r, (i+1)·N/r)``, the same on every rank of its row ('c');
* k×k matrices and scalars are replicated.

:class:`Grid2D` carries the mesh, this rank's coordinates and device, and
the collectives the solver uses on those layouts: a sum over a grid axis
(:meth:`Grid2D.all_reduce`), the sum of a per-row-block partial that must
come out bitwise equal on every rank (:meth:`Grid2D.sum_rows`), the rows
of a multivector gathered over 'r' (:meth:`Grid2D.all_gather`), and the
ring's chunk exchange (:meth:`Grid2D.exchange`).  Complex tensors travel
as their real views.  A collective over an axis of size 1 is the
identity and issues nothing.  ``Grid2D.stats`` counts the collectives
issued and their payload bytes.

The process group comes first (``multihost.init_grid`` makes one from a
launcher's environment): NCCL for ``device="cuda"``, gloo for
``device="cpu"``.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import math
import os
import warnings
from collections import defaultdict
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["Grid2D", "make_grid", "CollectiveStats"]

AXES = ("r", "c")


def _near_square_dims(n: int) -> tuple[int, int]:
    """MPI_Dims_create analogue: the most-square 2D factorization of n."""
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective moves: complex as its real view."""
    return torch.view_as_real(t) if t.is_complex() else t


class CollectiveStats:
    """Collectives issued through a grid: calls and payload bytes (the
    local tensor each call sends or reduces) by kind."""

    def __init__(self):
        self.calls = defaultdict(int)
        self.bytes = defaultdict(int)

    def add(self, kind: str, t: torch.Tensor) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def summary(self) -> dict:
        return {k: (self.calls[k], self.bytes[k]) for k in sorted(self.calls)}


class _Requests:
    """The ring exchange's pending sends and receives; ``wait()`` waits
    for all of them (on CUDA a wait of the current stream, not the
    host)."""

    def __init__(self, reqs):
        self.reqs = reqs

    def wait(self) -> None:
        for q in self.reqs:
            q.wait()


class Grid2D:
    """An r×c process grid: a ``DeviceMesh`` with dims ('r', 'c'), this
    rank's coordinates and device.  ``shape`` and ``nprocs`` are the JAX
    Grid2D's; ``coords``, ``group``, ``size``, ``index`` and ``device``
    are the explicit handles the local-block code needs."""

    def __init__(self, mesh, device: torch.device):
        if tuple(mesh.mesh_dim_names or ()) != AXES:
            raise ValueError(f"Grid2D needs a mesh with dims {AXES}, got "
                             f"{mesh.mesh_dim_names}")
        self.mesh = mesh
        self.device = torch.device(device)
        self.stats = CollectiveStats()
        self._exchanges = {}

    def __repr__(self) -> str:
        return (f"Grid2D(shape={self.shape}, coords={self.coords}, "
                f"device={self.device})")

    @property
    def shape(self) -> dict:
        return {a: int(self.mesh.size(d)) for d, a in enumerate(AXES)}

    @property
    def nprocs(self) -> int:
        return int(self.mesh.size())

    @property
    def coords(self) -> tuple:
        """(i, j): this rank's row and column in the grid."""
        return tuple(int(x) for x in self.mesh.get_coordinate())

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        """The process group along ``axis``: the ranks of this rank's
        grid column for 'r', of its grid row for 'c'."""
        return self.mesh.get_group(axis)

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank of the member ``index`` of this rank's
        ``axis`` group."""
        return dist.get_global_rank(self.group(axis), index)

    # -- collectives ------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Sum ``t`` (or reduce it with ``op``: MAX of a real ``t``) over
        ``axis`` in place (``t`` must be contiguous); every member of the
        group gets the same bits.  Returns ``t``."""
        if self.size(axis) > 1:
            self.stats.add("all_reduce", t)
            dist.all_reduce(_wire(t), op=op, group=self.group(axis))
        return t

    def sum_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over 'r' of a per-row-block partial (a Gram, column
        dots), bitwise equal on every rank of the grid: summed within each
        grid column, then broadcast from grid column 0 along 'c' — two
        grid columns may sum in different orders, and every host decision
        of the solver reads these numbers.  ``t`` is a new contiguous
        tensor, overwritten."""
        t = self.all_reduce(t, "r")
        if self.size("c") > 1:
            self.stats.add("broadcast", t)
            dist.broadcast(_wire(t), src=self.global_rank("c", 0),
                           group=self.group("c"))
        return t

    def all_gather(self, t: torch.Tensor, axis: str = "r") -> torch.Tensor:
        """Every member's ``t`` stacked along dim 0 in group order: the
        whole multivector from its row blocks.  ``t`` itself for a group
        of one."""
        p = self.size(axis)
        if p == 1:
            return t
        t = t.contiguous()
        out = torch.empty((p * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        self.stats.add("all_gather", t)
        with warnings.catch_warnings():
            # renamed all_gather_single in newer torch, which warns on the
            # old name; the old one is the name every supported torch has
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(_wire(out), _wire(t),
                                        group=self.group(axis))
        return out

    def exchange(self, axis: str = "r"):
        """The ring's chunk exchange along ``axis``: ``swap(send, recv)``
        posts the send of ``send`` to the previous member and the receive
        of the next member's chunk into ``recv`` (both contiguous), as
        ``dist.batch_isend_irecv``, and returns a handle whose ``wait()``
        completes both — the JAX ring's ``ppermute`` (i → i−1)."""
        if axis not in self._exchanges:
            p, me = self.size(axis), self.index(axis)
            g = self.group(axis)
            prev = self.global_rank(axis, (me - 1) % p)
            nxt = self.global_rank(axis, (me + 1) % p)

            def swap(send: torch.Tensor, recv: torch.Tensor) -> _Requests:
                self.stats.add("sendrecv", send)
                return _Requests(dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, _wire(send), prev, g),
                    dist.P2POp(dist.irecv, _wire(recv), nxt, g)]))

            self._exchanges[axis] = swap
        return self._exchanges[axis]

    # -- layouts ----------------------------------------------------------

    def block(self, N: int, axis: str) -> tuple:
        """(start, length) of this rank's block of an N-long dimension cut
        over ``axis`` (N a multiple of the axis size)."""
        b = N // self.size(axis)
        return self.index(axis) * b, b


def _backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_grid(devices: Optional[Sequence[int]] = None,
              shape: Optional[tuple] = None, *, device="cuda") -> Grid2D:
    """The ('r', 'c') grid over the given global ranks (default: every
    rank of the process group), one device per rank.

    Args:
      devices: global ranks, in grid order (row-major); default all.
      shape: (r, c); default the most-square factorization of the rank
        count (``_near_square_dims``).  ValueError if it does not cover
        them.
      device: "cuda" (this rank's card, ``LOCAL_RANK``; the process group
        must be NCCL) or "cpu" (gloo).

    Needs an initialized process group (``multihost.init_grid`` makes one
    from a launcher's environment); RuntimeError without one, for a
    process group of the other backend, and for "cuda" without a card.
    """
    dev_type = torch.device(device).type
    if dev_type not in ("cuda", "cpu"):
        raise ValueError(f"make_grid runs on cuda or cpu, not {device!r}")
    if dev_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_grid(device='cuda') but torch.cuda.is_available() is "
            "False; chase_tpu_torch does not fall back to the CPU — pass "
            "device='cpu' for a gloo grid")
    if not dist.is_initialized():
        raise RuntimeError("make_grid needs an initialized process group: "
                           "call chase_tpu_torch.parallel.multihost."
                           "init_grid() (it reads torchrun's environment) "
                           "or torch.distributed.init_process_group first")
    backend = _backend_for(dev_type)
    if backend not in str(dist.get_backend()).lower():
        raise RuntimeError(f"a {dev_type} grid needs a {backend} process "
                           f"group; this one is {dist.get_backend()!r}")
    if devices is None:
        devices = list(range(dist.get_world_size()))
    devices = [int(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = _near_square_dims(n)
    r, c = (int(x) for x in shape)
    if r * c != n:
        raise ValueError(f"grid shape {tuple(shape)} does not cover {n} "
                         f"devices")
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh(dev_type, torch.tensor(devices).reshape(r, c),
                      mesh_dim_names=AXES)
    if dev_type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    return Grid2D(mesh, dev)
