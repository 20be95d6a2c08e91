"""Binary matrix I/O and solver-state checkpointing.

Port of ``chase_tpu/io.py`` (the reference's two persistence mechanisms,
SURVEY §5 "Checkpoint / resume"):

1. Raw column-major binary matrix files, byte-compatible with
   ``Matrix::saveToBinaryFile/readFromBinaryFile`` (matrix.hpp:276-351),
   the CLI's ``--path_in`` files and the JAX package's ``save_matrix``:
   a file written by either package is read by the other.
2. Warm-restart checkpoints: the (V, ritzv) pair that the "sequence of
   eigenproblems" feature feeds back through mode='A' (an ``.npz`` the
   JAX package's ``load_state`` reads, and the other way round).

Writers take a numpy array or a tensor on any device (a tensor with a lazy
conjugate or negative bit is written as the values it stands for); a CUDA
matrix is transposed on the card before it is copied to the host.  The
whole-matrix readers return numpy arrays, as the JAX package's do; the
entry points place them on the device.

On a process grid (one process per device, ``parallel/mesh.py``) the
sharded readers and writers take and return DTensors on ``grid.mesh`` and
every rank of the grid calls them — the replacement of the reference's
MPI-IO subarray reads and writes (``MPI_File_set_view`` + ``*_all``,
distMatrix.hpp:2243-2410): each rank reads or writes only the bytes of its
own block, through the native reader (``_native``).  A reader's blocks are
DTensor's even split of the matrix (``ceil(N/r)`` rows per grid row, the
last blocks short or empty), the split ``DenseOperator(grid=…)`` re-cuts
and pads; a writer ends with a barrier over the mesh, so a read after the
call sees the whole file.  ``load_matrix_blockcyclic`` reads the
block-cyclically owned rows and columns (``parallel/layouts.py``) with one
native gather per rank; ``save_state(sharded=True)`` / ``load_state(grid=
…)`` keep a checkpoint's V in a ChASE file beside the ``.npz``, in the
JAX package's format.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from . import _native
from .parallel.mesh import colvec_sharding, matrix_sharding

__all__ = ["save_matrix", "load_matrix", "load_matrix_sharded",
           "save_matrix_sharded", "load_matrix_blockcyclic",
           "save_state", "load_state"]


def _host(a) -> np.ndarray:
    """A numpy array holding ``a``'s values (a tensor is copied to the
    host; lazy conj/neg views resolved)."""
    if isinstance(a, torch.Tensor):
        return a.detach().resolve_conj().resolve_neg().cpu().numpy()
    return np.asarray(a)


def _column_major(H) -> np.ndarray:
    """The C-ordered (M, N) array whose bytes are H (N × M) column-major:
    a tensor is transposed where it lies (on the card for a CUDA tensor)
    before the host copy."""
    if isinstance(H, torch.Tensor):
        return _host(H.T.contiguous())
    return np.ascontiguousarray(np.asarray(H).T)


def save_matrix(H, path: str) -> None:
    """Raw column-major dump (ChASE binary format) of a 2-D numpy array or
    tensor."""
    if H.ndim != 2:
        raise ValueError(f"save_matrix takes a 2-D matrix, got shape "
                         f"{tuple(H.shape)}")
    _column_major(H).tofile(path)


def load_matrix(path: str, N: int, dtype, M: Optional[int] = None
                ) -> np.ndarray:
    """Load a column-major N×M binary matrix (ChASE format) into numpy: a
    Fortran-ordered (N, M) array, read by ``_native.read_block`` (the
    threaded reader, or its numpy version under ``CHASE_DISABLE_NATIVE``).
    ValueError if the file is shorter than the matrix."""
    M = M if M is not None else N
    dtype = np.dtype(dtype)
    expect = N * M * dtype.itemsize
    size = os.path.getsize(path)
    if size < expect:
        raise ValueError(f"{path}: {size} bytes < expected {expect}")
    return _native.read_block(path, N, dtype, 0, N, 0, M)


def _check_size(path: str, expect: int) -> None:
    size = os.path.getsize(path)
    if size < expect:
        raise ValueError(f"{path}: {size} bytes < expected {expect}")


def _numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _even_block(n: int, p: int, k: int) -> tuple:
    """(start, length) of part k of DTensor's even split of n over p:
    ``ceil(n/p)`` each, the last parts short or empty."""
    from .parallel.operator import _pieces
    start, stop = _pieces(n, p, -(-n // p))[k]
    return start, stop - start


def _on_mesh(block: np.ndarray, grid, sharding, shape) -> torch.Tensor:
    """This rank's ``block`` (numpy) as the local part of a DTensor of
    global ``shape`` laid out as ``sharding``: on the grid's device, or
    on the host where the mesh is a CPU mesh (where DTensor keeps its
    local parts)."""
    from torch.distributed.tensor import DTensor
    from .parallel.operator import to_device
    dev = grid.device
    if sharding.mesh.device_type != dev.type:
        dev = torch.device(sharding.mesh.device_type)
    local = to_device(block, dev)
    return DTensor.from_local(local, *sharding, run_check=False,
                              shape=torch.Size(shape),
                              stride=(shape[1], 1))


def load_matrix_sharded(path: str, N: int, dtype, grid,
                        M: Optional[int] = None) -> torch.Tensor:
    """Load a column-major N×M ChASE file straight into a DTensor
    ``(Shard(0), Shard(1))`` on ``grid.mesh`` (:func:`matrix_sharding`):
    each rank reads only its own block (DTensor's even split) with the
    native reader, a collective of no communication.  ValueError if the
    file is shorter than the matrix; a failing read raises."""
    M = M if M is not None else N
    dtype = np.dtype(dtype)
    _check_size(path, N * M * dtype.itemsize)
    r0, rn = _even_block(N, grid.size("r"), grid.index("r"))
    c0, cn = _even_block(M, grid.size("c"), grid.index("c"))
    block = _native.read_block(path, N, dtype, r0, rn, c0, cn)
    return _on_mesh(block, grid, matrix_sharding(grid), (N, M))


def _block_origin(H) -> tuple:
    """((row, column) offset of this rank's local block of a 2-D DTensor,
    whether this rank writes it): each mesh dimension ``Shard(0)``,
    ``Shard(1)`` (each tensor dimension sharded at most once, DTensor's
    even split) or ``Replicate()`` (only the copy at index 0 writes).
    ValueError for any other layout."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, coord = H.device_mesh, H.device_mesh.get_coordinate()
    origin, writer, sharded = [0, 0], True, set()
    for d, pl in enumerate(H.placements):
        if isinstance(pl, Replicate):
            writer = writer and coord[d] == 0
        elif isinstance(pl, Shard) and pl.dim % 2 not in sharded:
            dim = pl.dim % 2
            sharded.add(dim)
            origin[dim] = _even_block(H.shape[dim], mesh.size(d),
                                      coord[d])[0]
        else:
            raise ValueError(f"save_matrix_sharded writes a DTensor whose "
                             f"placements are Shard(0), Shard(1) or "
                             f"Replicate(), each dimension sharded at most "
                             f"once; got {tuple(H.placements)}")
    return tuple(origin), writer


def _mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` has arrived once this returns: a barrier
    along each mesh dimension in turn."""
    import torch.distributed as dist
    for d in range(mesh.ndim):
        if mesh.size(d) > 1:
            dist.barrier(group=mesh.get_group(d))


def save_matrix_sharded(H, path: str) -> None:
    """Write a matrix to a global column-major ChASE file, each rank only
    the bytes of its own block.

    Collective-write analogue of ``BlockBlockMatrix::saveToBinaryFile``
    (distMatrix.hpp:2241-2298, MPI subarray ``MPI_File_write_all``): for a
    DTensor H every rank of its mesh calls this; each writes its local
    block at its global offset with the native writer, a replicated copy
    only from the rank at index 0 of the replicating mesh dimension, so
    each global block is written once and no rank gathers the matrix; the
    call ends with a barrier over the mesh.  The file is opened with
    ``O_CREAT`` and no ``O_TRUNC`` and sized to exactly the matrix, never
    truncated by a late rank below what another rank wrote.  A numpy array
    or plain tensor goes to :func:`save_matrix`."""
    from torch.distributed.tensor import DTensor
    if not isinstance(H, DTensor):
        save_matrix(H, path)
        return
    if H.ndim != 2:
        raise ValueError(f"save_matrix_sharded takes a 2-D matrix, got "
                         f"shape {tuple(H.shape)}")
    (r0, c0), writer = _block_origin(H)
    N, M = H.shape
    expect = N * M * _numpy_dtype(H.dtype).itemsize
    fd = os.open(path, os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        if os.fstat(fd).st_size != expect:
            # exactly the matrix: stale trailing bytes of an oversized
            # file would break the byte-compatibility with save_matrix;
            # no rank writes beyond `expect`, so this drops nothing
            os.ftruncate(fd, expect)
    finally:
        os.close(fd)
    local = H.to_local()
    if writer and local.numel():
        # column-major bytes made where the block lies (on the card for a
        # CUDA block); the Fortran-ordered view of them is written as is
        _native.write_block(path, N, _column_major(local).T, r0, c0)
    _mesh_barrier(H.device_mesh)


def load_matrix_blockcyclic(path: str, N: int, dtype, grid, mb: int,
                            layout=None) -> tuple:
    """Load a global column-major ChASE file straight into the
    block-cyclic ownership order → (H, layout).

    Analogue of ``BlockCyclicMatrix::readFromBinaryFile``
    (distMatrix.hpp:3210-3260, an ``MPI_Type_create_darray`` view): H is
    the ownership-permuted operator ``layout.apply(file)`` as a DTensor
    ``(Shard(0), Shard(1))`` on ``grid.mesh`` (DTensor's even split), so
    the grid's contiguous blocks hold exactly what an (mb, r)×(mb, c)
    block-cyclic distribution gives each rank.  Each rank reads its rows
    and columns with one native gather (``_native.read_gather``: each of
    its columns' row span read once, the owned rows kept), not one read
    per pair of mb-runs.  ``layout`` defaults to
    ``BlockCyclicLayout(N, mb, r, c)``; its row permutation is used on
    both sides (the Hermitian similarity transform).  Pass eigenvector
    rows through ``layout.restore_rows`` on the way out."""
    from .parallel.layouts import BlockCyclicLayout
    dtype = np.dtype(dtype)
    _check_size(path, N * N * dtype.itemsize)
    if layout is None:
        layout = BlockCyclicLayout(N, mb, grid.size("r"), grid.size("c"))
    perm = layout.row_perm
    r0, rn = _even_block(N, grid.size("r"), grid.index("r"))
    c0, cn = _even_block(N, grid.size("c"), grid.index("c"))
    block = _native.read_gather(path, N, dtype, perm[r0:r0 + rn],
                                perm[c0:c0 + cn])
    return _on_mesh(block, grid, matrix_sharding(grid), (N, N)), layout


def save_state(path: str, V, ritzv, meta: Optional[dict] = None, *,
               sharded: bool = False) -> None:
    """Persist a warm-restart checkpoint (V, ritzv, meta) for sequence
    solves as ``np.savez`` writes it (``path`` gains ``.npz`` unless it
    ends so); V may be a tensor on any device.

    ``sharded=True`` writes V through :func:`save_matrix_sharded` into
    ``base + ".V.bin"`` (each rank only its own rows of a DTensor V, as
    ``eigsh(grid=…)`` returns it; a collective) and the small sidecar
    (ritzv, meta and V's rows, cols and dtype under ``_sharded_V``) into
    ``base + ".npz"`` from rank 0 alone: the JAX package's format, read
    by either package's ``load_state``."""
    if not sharded:
        np.savez(path, V=_host(V), ritzv=_host(ritzv),
                 meta=json.dumps(meta or {}))
        return
    base = path[:-4] if path.endswith(".npz") else path
    meta = dict(meta or {})
    meta["_sharded_V"] = {"rows": int(V.shape[0]), "cols": int(V.shape[1]),
                          "dtype": _numpy_dtype(V.dtype).name}
    from .parallel import multihost
    if multihost.process_info()["process_index"] == 0:
        # one writer: np.savez is not atomic, and concurrent writers of
        # one shared file would corrupt it
        np.savez(base + ".npz", ritzv=_host(ritzv), meta=json.dumps(meta))
    save_matrix_sharded(V, base + ".V.bin")     # ends with the barrier


def load_state(path: str, grid=None):
    """Load a warm-restart checkpoint → (V, ritzv, meta);
    ``eigsh(..., v0=V, ritzv0=ritzv, approx=True)`` resumes from it.

    A checkpoint whose V was written sharded (a ``.V.bin`` beside the
    ``.npz``, by either package) is read whole into numpy, or with
    ``grid`` as a DTensor ``(Shard(0), Replicate())`` on ``grid.mesh``
    (:func:`colvec_sharding`; each rank reads only its own rows; a
    collective) that ``eigsh(v0=…, grid=grid)`` takes as it stands."""
    base = path[:-4] if path.endswith(".npz") else path
    with np.load(base + ".npz", allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        ritzv = z["ritzv"]
        sv = meta.pop("_sharded_V", None)
        if sv is None:
            return z["V"], ritzv, meta
    vpath, dtype = base + ".V.bin", np.dtype(sv["dtype"])
    if grid is None:
        V = load_matrix(vpath, sv["rows"], dtype, M=sv["cols"])
    else:
        V = _load_tall_sharded(vpath, sv["rows"], sv["cols"], dtype, grid)
    return V, ritzv, meta


def _load_tall_sharded(path: str, N: int, M: int, dtype, grid):
    """An (N, M) column-major file as the warm-start layout, a DTensor
    ``(Shard(0), Replicate())``: this rank's rows of every column."""
    _check_size(path, N * M * np.dtype(dtype).itemsize)
    r0, rn = _even_block(N, grid.size("r"), grid.index("r"))
    block = _native.read_block(path, N, dtype, r0, rn, 0, M)
    return _on_mesh(block, grid, colvec_sharding(grid), (N, M))
