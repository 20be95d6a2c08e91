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
of a multivector gathered over 'r' (:meth:`Grid2D.all_gather`), the
ring's chunk exchange (:meth:`Grid2D.exchange`) and its peer memory on
CUDA (:meth:`Grid2D.peers`, pulled bytes counted under "peer"), the
rotation of a multivector's rows that K-conjugation across ranks needs
(:meth:`Grid2D.rotate_rows`), and the 2-D ring's reduce-scatter
(:meth:`Grid2D.reduce_scatter`) and parity flip (:meth:`Grid2D.flip`).
Complex tensors travel as their real views.  A collective over an axis of size 1 is the
identity and issues nothing.  ``Grid2D.stats`` counts the collectives
issued and their payload bytes, and feeds the same counts to the
program's registry (``perf.COUNTS``' "comm:<kind>" and
"comm_bytes:<kind>"); each collective's issue and its wait are the span
``chase.comm`` (``perf.span``: a profiler range only while a profiler
records, no host sync).

Data that crosses the package's boundary sharded (a DTensor H, ``res.V``,
the sharded readers of ``io``) is a DTensor on ``grid.mesh``;
:func:`matrix_sharding`, :func:`colvec_sharding`, :func:`rowvec_sharding`
and :func:`replicated_sharding` name its layouts, the JAX package's
``P('r', 'c')``, ``P('r', None)``, ``P('c', None)`` and ``P()``.

The process group comes first (``multihost.init_grid`` makes one from a
launcher's environment): NCCL for ``device="cuda"``, gloo for
``device="cpu"``.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import math
import os
import warnings
from collections import defaultdict
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..perf import COMM, COMM_BYTES, count as perf_count, span

__all__ = ["Grid2D", "make_grid", "CollectiveStats", "Sharding",
           "matrix_sharding", "colvec_sharding", "rowvec_sharding",
           "replicated_sharding"]

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
    local tensor each call sends or reduces) by kind, counted here and
    in ``perf.COUNTS`` under "comm:<kind>" and "comm_bytes:<kind>"."""

    def __init__(self):
        self.calls = defaultdict(int)
        self.bytes = defaultdict(int)

    def add(self, kind: str, t: torch.Tensor) -> None:
        self.count(kind, t.numel() * t.element_size())

    def count(self, kind: str, nbytes: int) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += int(nbytes)
        perf_count(COMM + kind)
        perf_count(COMM_BYTES + kind, int(nbytes))

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def summary(self) -> dict:
        return {k: (self.calls[k], self.bytes[k]) for k in sorted(self.calls)}


class _Requests:
    """The ring exchange's pending sends and receives; ``wait()`` waits
    for all of them (on CUDA a wait of the current stream, not the
    host), inside the span ``chase.comm``."""

    def __init__(self, reqs):
        self.reqs = reqs

    def wait(self) -> None:
        with span("chase.comm"):
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
        self._peers = {}

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
            with span("chase.comm"):
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
            with span("chase.comm"):
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
        with span("chase.comm"), warnings.catch_warnings():
            self.stats.add("all_gather", t)
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
                with span("chase.comm"):
                    self.stats.add("sendrecv", send)
                    return _Requests(dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, _wire(send), prev, g),
                        dist.P2POp(dist.irecv, _wire(recv), nxt, g)]))

            self._exchanges[axis] = swap
        return self._exchanges[axis]

    def peers(self, axis: str = "r"):
        """The peer memory of the ring along ``axis``
        (``parallel/peers.PeerChunks``, made at the first call and kept
        until :meth:`close`): the (p, 1) ring product's route with the
        kernel on CUDA (``ops/ring_hemm.ring_hemm_peers``).  Its handles
        go round the axis's group in an object all-gather; its pulled
        bytes are counted under "peer"."""
        if axis not in self._peers:
            from .peers import PeerChunks
            g = self.group(axis)

            def allgather(obj):
                out = [None] * self.size(axis)
                dist.all_gather_object(out, obj, group=g)
                return out

            with span("chase.comm"):
                self._peers[axis] = PeerChunks(
                    self.index(axis), self.size(axis), self.device,
                    allgather, stats=self.stats)
        return self._peers[axis]

    def check_peers(self) -> None:
        """Raise the first failed wait of the peer route's finished
        launches (``PeerChunks.check``; a failed product comes out NaN).
        The solvers call it after each iteration's host read, which has
        synchronised."""
        for peers in self._peers.values():
            peers.check()

    def close(self) -> None:
        """Collective: free the grid's peer memory once every rank's queued
        work is done (``PeerChunks.close``).  Every rank calls it when the
        grid's work is done (``interface.finalize`` and the CLI do)."""
        for peers in self._peers.values():
            peers.close()
        self._peers.clear()

    def rotate_rows(self, t: torch.Tensor, shift: int,
                    axis: str = "r") -> torch.Tensor:
        """This rank's rows of the multivector rotated by ``shift`` rows,
        ``out[j] = x[(j + shift) mod N]`` (N = p·b), from ``t``, this
        rank's b rows of x — pass only the columns that must move.  Point
        to point: each destination run of b rows comes from at most two
        owners (one when b divides ``shift``: with shift = N/2 on an even
        p, rank (i + p/2) mod p sends its whole block), so a rank sends
        to and receives from at most two partners.  Counted under
        "rotate"; with one member only local copies.  Returns a new
        tensor."""
        p, me = self.size(axis), self.index(axis)
        b = t.shape[0]
        N = p * b
        shift %= N
        t = t.contiguous()
        out = torch.empty_like(t)

        def pieces(k):
            """(owner, first row of x, count, offset) of member k's
            destination rows."""
            runs, start, off = [], (k * b + shift) % N, 0
            while off < b:
                owner = start // b
                m = min(b - off, (owner + 1) * b - start)
                runs.append((owner, start, m, off))
                start, off = (start + m) % N, off + m
            return runs

        ops = []
        g = self.group(axis)
        for k in range(p):
            for owner, x0, m, off in pieces(k):
                if owner != me:
                    continue
                piece = t[x0 - me * b:x0 - me * b + m]
                if k == me:
                    out[off:off + m].copy_(piece)
                    continue
                self.stats.add("rotate", piece)
                ops.append(dist.P2POp(dist.isend, _wire(piece),
                                      self.global_rank(axis, k), g))
        for owner, x0, m, off in pieces(me):
            if owner != me:
                ops.append(dist.P2POp(dist.irecv, _wire(out[off:off + m]),
                                      self.global_rank(axis, owner), g))
        if ops:
            with span("chase.comm"):
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
        return out

    def reduce_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of every member's ``t`` over ``axis``, cut along dim 0
        in group order: member k gets rows ``[k·m, (k+1)·m)`` of the sum,
        m = ``t.shape[0]`` / the axis size (the JAX package's ``psum_scatter
        (tiled=True)``).  ``t`` itself for a group of one; else a new
        tensor."""
        p = self.size(axis)
        if p == 1:
            return t
        t = t.contiguous()
        out = torch.empty((t.shape[0] // p,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        with span("chase.comm"), warnings.catch_warnings():
            self.stats.add("reduce_scatter", t)
            # renamed reduce_scatter_single in newer torch (as all_gather)
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(_wire(out), _wire(t),
                                       group=self.group(axis))
        return out

    # -- the 2-D ring's chunk orders ---------------------------------------

    def parity_chunk(self, parity: str) -> int:
        """The chunk of N/(r·c) rows this rank holds in the 2-D ring's
        ``parity``: ``j·r + i`` in "A" (the JAX package's ``P(('c',
        'r'))``), ``i·c + j`` in "B" (``P(('r', 'c'))``) — the rows
        ``[j·N/(r·c), (j+1)·N/(r·c))`` of its own ``P('r', None)`` rows."""
        (i, j), r, c = self.coords, self.size("r"), self.size("c")
        return j * r + i if parity == "A" else i * c + j

    def _holder(self, chunk: int, parity: str) -> tuple:
        """(i, j) of the rank holding ``chunk`` in ``parity``."""
        r, c = self.size("r"), self.size("c")
        return (chunk % r, chunk // r) if parity == "A" \
            else (chunk // c, chunk % c)

    def flip(self, t: torch.Tensor, to: str) -> torch.Tensor:
        """The 2-D ring's parity flip: ``t`` is this rank's chunk in the
        other parity; returns its chunk in parity ``to`` ("A" or "B") —
        the JAX package's ``flip_a2b`` / ``flip_b2a`` ppermute.  Point to
        point over the whole grid (one send, one receive); a rank whose
        chunk stays with it (gloo cannot send to itself) returns ``t``
        itself.  Counted under "flip"."""
        frm = "B" if to == "A" else "A"
        dest = self._holder(self.parity_chunk(frm), to)
        if dest == self.coords:
            return t
        src = self._holder(self.parity_chunk(to), frm)
        t = t.contiguous()
        out = torch.empty_like(t)
        grid = self.mesh.mesh
        with span("chase.comm"):
            self.stats.add("flip", t)
            for work in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, _wire(t), int(grid[dest])),
                    dist.P2POp(dist.irecv, _wire(out), int(grid[src]))]):
                work.wait()
        return out

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


class Sharding(NamedTuple):
    """A DTensor layout: the mesh and one placement per mesh dimension,
    in the argument order of ``DTensor.from_local(t, *s)`` and
    ``distribute_tensor(t, *s)``."""
    mesh: object
    placements: tuple


def _sharding(grid: Optional[Grid2D], placements) -> Optional[Sharding]:
    return None if grid is None else Sharding(grid.mesh, tuple(placements))


def matrix_sharding(grid: Optional[Grid2D]) -> Optional[Sharding]:
    """The N×N operator, ``P('r', 'c')``: rows over 'r', columns over
    'c' — ``(Shard(0), Shard(1))``; None without a grid."""
    from torch.distributed.tensor import Shard
    return _sharding(grid, (Shard(0), Shard(1)))


def colvec_sharding(grid: Optional[Grid2D]) -> Optional[Sharding]:
    """A multivector in the column communicator, ``P('r', None)``: rows
    over 'r', the same on every rank of a grid row — ``(Shard(0),
    Replicate())``; None without a grid."""
    from torch.distributed.tensor import Replicate, Shard
    return _sharding(grid, (Shard(0), Replicate()))


def rowvec_sharding(grid: Optional[Grid2D]) -> Optional[Sharding]:
    """A multivector in the row communicator, ``P('c', None)``: rows over
    'c', replicated over 'r' — ``(Replicate(), Shard(0))``; None without
    a grid."""
    from torch.distributed.tensor import Replicate, Shard
    return _sharding(grid, (Replicate(), Shard(0)))


def replicated_sharding(grid: Optional[Grid2D]) -> Optional[Sharding]:
    """Replicated on every rank, ``P()`` — ``(Replicate(), Replicate())``;
    None without a grid."""
    from torch.distributed.tensor import Replicate
    return _sharding(grid, (Replicate(), Replicate()))
