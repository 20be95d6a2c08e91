"""Host-side native code of the port: the threaded block reader/writer and
the C ABI library.

Port of ``chase_tpu/_native/__init__.py``.  ``chaseio.cpp`` (a copy of the
JAX package's) is compiled by ``g++`` at first use into the checkout's
``build/`` — the directory the CUDA kernels build into (``_build``) — as
``libchaseio-<digest>.so``, the digest covering the source and the flags,
and loaded with ctypes (which releases the GIL around calls, so the
reader's threads run in parallel).  ``build_capi`` compiles
``chase_capi.cpp`` into ``build/capi-<digest>/libchase_tpu_torch.so``.
These sources live here, not in ``csrc/``, so the kernels'
``source_digest`` does not see them.

No quiet fallback: a failed build raises RuntimeError.  The numpy path —
the plain version the tests hold the reader to — is taken only when the
caller sets ``CHASE_DISABLE_NATIVE`` (the variable the JAX package reads).
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig
import tempfile
import threading
from pathlib import Path

import numpy as np

from .._build import BUILD_DIR

__all__ = ["get_lib", "available", "read_block", "read_gather",
           "write_block", "build_capi"]

NATIVE_DIR = Path(__file__).resolve().parent
IO_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
CAPI_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None


def _digest(src: Path, flags) -> str:
    h = hashlib.sha256()
    h.update(" ".join(flags).encode() + b"\0" + src.read_bytes())
    return h.hexdigest()[:16]


def _compile(src: Path, out: Path, flags) -> None:
    """``$CXX`` (default g++) ``flags`` of ``src`` into ``out`` through a
    temporary file renamed into place; RuntimeError with the compiler's
    output if it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    try:
        try:
            proc = subprocess.run([cxx, str(src), *flags, "-o", tmp],
                                  capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:
            raise RuntimeError(f"{cxx} could not run to build {src.name}: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {src.name} (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The block reader's library, compiled into ``build/`` if needed and
    loaded; None only when ``CHASE_DISABLE_NATIVE`` is set.  A build or
    load that fails raises RuntimeError."""
    global _lib
    if os.environ.get("CHASE_DISABLE_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        src = NATIVE_DIR / "chaseio.cpp"
        so = BUILD_DIR / f"libchaseio-{_digest(src, IO_FLAGS)}.so"
        if not so.is_file():
            _compile(src, so, IO_FLAGS)
        lib = ctypes.CDLL(str(so))
        lib.chase_read_block.restype = ctypes.c_int
        lib.chase_read_block.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int]
        lib.chase_read_gather.restype = ctypes.c_int
        lib.chase_read_gather.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int]
        lib.chase_write_block.restype = ctypes.c_int
        lib.chase_write_block.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native reader is used: True unless
    ``CHASE_DISABLE_NATIVE`` is set (a failed build raises)."""
    return get_lib() is not None


def _check_block(rows_total: int, row_start: int, row_count: int,
                 col_start: int, col_count: int) -> None:
    if min(rows_total, row_start, row_count, col_start, col_count) < 0 \
            or row_start + row_count > rows_total:
        raise ValueError(f"block rows [{row_start}, {row_start + row_count})"
                         f" x cols [{col_start}, {col_start + col_count}) "
                         f"outside a {rows_total}-row matrix")


def read_block(path: str, rows_total: int, dtype, row_start: int,
               row_count: int, col_start: int, col_count: int,
               nthreads: int = 0) -> np.ndarray:
    """Read a sub-block of a column-major matrix file → (row_count,
    col_count) numpy array, a Fortran-ordered view (the transpose of the
    column-major block the reader fills).  OSError if the file is missing
    or shorter than the block."""
    dtype = np.dtype(dtype)
    _check_block(rows_total, row_start, row_count, col_start, col_count)
    lib = get_lib()
    if lib is None:
        need = (col_start + col_count) * rows_total * dtype.itemsize
        if os.path.getsize(path) < need:       # FileNotFoundError is OSError
            raise OSError(f"{path}: {os.path.getsize(path)} bytes, the block "
                          f"needs {need}")
        full = np.memmap(path, dtype=dtype, mode="r",
                         shape=(col_start + col_count, rows_total))
        return np.ascontiguousarray(
            full[col_start:col_start + col_count,
                 row_start:row_start + row_count]).T
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    out = np.empty((col_count, row_count), dtype=dtype)   # column-major
    rc = lib.chase_read_block(
        os.fsencode(path), rows_total, dtype.itemsize, row_start, row_count,
        col_start, col_count, out.ctypes.data_as(ctypes.c_void_p), nthreads)
    if rc != 0:
        raise OSError(rc, f"chase_read_block failed ({rc}) on {path}")
    return out.T


def read_gather(path: str, rows_total: int, dtype, rows, cols,
                nthreads: int = 0) -> np.ndarray:
    """Read the rows ``rows`` of the columns ``cols`` (global index
    arrays) of a column-major matrix file → (len(rows), len(cols)) numpy
    array, a Fortran-ordered view, in one native call: each column's row
    span [min(rows), max(rows)] is read once and the listed rows kept
    (``chase_read_gather``).  Under ``CHASE_DISABLE_NATIVE`` a numpy
    memmap gather (the plain version).  ValueError for an index outside
    the file's rows; OSError if the file is missing or short."""
    dtype = np.dtype(dtype)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    if rows.ndim != 1 or cols.ndim != 1:
        raise ValueError("read_gather takes 1-D row and column index arrays")
    if rows.size and (rows.min() < 0 or rows.max() >= rows_total) \
            or cols.size and cols.min() < 0:
        raise ValueError(f"row or column index outside a {rows_total}-row "
                         f"matrix")
    out = np.empty((cols.size, rows.size), dtype=dtype)   # column-major
    if rows.size == 0 or cols.size == 0:
        return out.T
    lib = get_lib()
    if lib is None:
        need = (int(cols.max()) + 1) * rows_total * dtype.itemsize
        if os.path.getsize(path) < need:
            raise OSError(f"{path}: {os.path.getsize(path)} bytes, the "
                          f"gather needs {need}")
        full = np.memmap(path, dtype=dtype, mode="r",
                         shape=(int(cols.max()) + 1, rows_total))
        out[:] = full[np.ix_(cols, rows)]
        return out.T
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    rc = lib.chase_read_gather(
        os.fsencode(path), rows_total, dtype.itemsize,
        rows.ctypes.data_as(ctypes.c_void_p), rows.size,
        cols.ctypes.data_as(ctypes.c_void_p), cols.size,
        out.ctypes.data_as(ctypes.c_void_p), nthreads)
    if rc != 0:
        raise OSError(rc, f"chase_read_gather failed ({rc}) on {path}")
    return out.T


def write_block(path: str, rows_total: int, arr, row_start: int,
                col_start: int) -> None:
    """Write a (rows, cols) block into a column-major matrix file, which
    is created if missing and otherwise written in place."""
    arr = np.asarray(arr)
    _check_block(rows_total, row_start, arr.shape[0], col_start,
                 arr.shape[1])
    colmaj = np.ascontiguousarray(arr.T)     # (cols, rows) = col-major stream
    lib = get_lib()
    if lib is None:
        cols = col_start + arr.shape[1]
        need = cols * rows_total * arr.dtype.itemsize
        with open(path, "ab") as f:              # create, never truncate
            if f.tell() < need:
                f.truncate(need)
        mm = np.memmap(path, dtype=arr.dtype, mode="r+",
                       shape=(cols, rows_total))
        mm[col_start:, row_start:row_start + arr.shape[0]] = colmaj
        mm.flush()
        del mm
        return
    rc = lib.chase_write_block(
        os.fsencode(path), rows_total, arr.dtype.itemsize, row_start,
        arr.shape[0], col_start, arr.shape[1],
        colmaj.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise OSError(rc, f"chase_write_block failed ({rc}) on {path}")


def _capi_flags() -> tuple:
    """Compiler flags for the C ABI library: this interpreter's include
    directory and ``--ldflags --embed`` (``python3-config``'s), plus an
    rpath to its libpython, so a C program finds it without
    ``LD_LIBRARY_PATH``."""
    pyconf = sys.executable + "-config"
    if not os.path.exists(pyconf):
        pyconf = "python3-config"
    try:
        ld = subprocess.run([pyconf, "--ldflags", "--embed"], check=True,
                            capture_output=True, text=True).stdout.split()
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"{pyconf} --ldflags --embed failed ({e}): "
                           f"this Python cannot be embedded") from e
    inc = "-I" + sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    rpath = (f"-Wl,-rpath,{libdir}",) if libdir else ()
    return (*CAPI_FLAGS, inc, *ld, *rpath)


def build_capi(out: str | None = None) -> str:
    """Build libchase_tpu_torch.so — the C ABI with the reference's symbol
    names (``{s,d,c,z}chase_*``, ``chase_set_*``, ``chase_has_*``, the
    ``p*`` families; ``chase_capi.cpp``), which embeds CPython around
    :mod:`chase_tpu_torch.interface`.  Without ``out`` it goes to
    ``build/capi-<digest>/libchase_tpu_torch.so`` (kept: a later call with
    the same source and flags reuses it).  Returns the library's path.
    A C program links it with ``-L<dir> -lchase_tpu_torch`` and runs with
    the repository on ``PYTHONPATH`` (and torch's site-packages, if the
    interpreter is a virtual environment's)."""
    src = NATIVE_DIR / "chase_capi.cpp"
    flags = _capi_flags()
    if out is None:
        so = (BUILD_DIR / f"capi-{_digest(src, flags)}"
              / "libchase_tpu_torch.so")
        if so.is_file():
            return str(so)
    else:
        so = Path(out)
    _compile(src, so, flags)
    return str(so)
