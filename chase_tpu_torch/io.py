"""Binary matrix I/O and solver-state checkpointing on one device.

Port of the single-device part of ``chase_tpu/io.py`` (the reference's two
persistence mechanisms, SURVEY §5 "Checkpoint / resume"):

1. Raw column-major binary matrix files, byte-compatible with
   ``Matrix::saveToBinaryFile/readFromBinaryFile`` (matrix.hpp:276-351),
   the CLI's ``--path_in`` files and the JAX package's ``save_matrix``:
   a file written by either package is read by the other.
2. Warm-restart checkpoints: the (V, ritzv) pair that the "sequence of
   eigenproblems" feature feeds back through mode='A' (an ``.npz`` the
   JAX package's ``load_state`` reads, and the other way round).

Writers take a numpy array or a tensor on any device (a tensor with a lazy
conjugate or negative bit is written as the values it stands for); a CUDA
matrix is transposed on the card before it is copied to the host.  Readers
return numpy arrays, as the JAX package's do; the entry points place them
on the device.  The sharded and block-cyclic readers and writers wait for
the multi-GPU slice's part 4 (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from . import _native

__all__ = ["save_matrix", "load_matrix", "save_state", "load_state"]


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


def save_state(path: str, V, ritzv, meta: Optional[dict] = None) -> None:
    """Persist a warm-restart checkpoint (V, ritzv, meta) for sequence
    solves as ``np.savez`` writes it (``path`` gains ``.npz`` unless it
    ends so); V may be a tensor on any device."""
    np.savez(path, V=_host(V), ritzv=_host(ritzv),
             meta=json.dumps(meta or {}))


def load_state(path: str):
    """Load a warm-restart checkpoint → (V, ritzv, meta), numpy arrays and
    a dict; ``eigsh(..., v0=V, ritzv0=ritzv, approx=True)`` resumes from
    it.  A checkpoint whose V the JAX package wrote sharded (a
    ``.V.bin`` beside the ``.npz``) is read whole."""
    base = path[:-4] if path.endswith(".npz") else path
    with np.load(base + ".npz", allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        ritzv = z["ritzv"]
        sv = meta.pop("_sharded_V", None)
        if sv is None:
            return z["V"], ritzv, meta
    V = load_matrix(base + ".V.bin", sv["rows"], np.dtype(sv["dtype"]),
                    M=sv["cols"])
    return V, ritzv, meta
