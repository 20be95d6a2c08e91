"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface under ``<checkout>/build/``,
named by :func:`source_digest` — a hash of every ``*.cu``/``*.cuh`` file
in ``csrc/`` (so an edited header is seen too) and the flags — and loaded
with ctypes.  A fresh checkout therefore builds on its first kernel call,
and an edited source never loads a stale library.  No ``-lcuda``: the one
driver-API call (``cuTensorMapEncodeTiled``, for TMA descriptors) is
reached through ``cudaGetDriverEntryPoint``.  ``-Xptxas -v`` keeps ptxas's
register/spill report in ``build/lib<name>-<digest>.log``.  Nothing here
runs at import time: the CPU tests import every module on machines
without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "nvcc_path", "source_digest",
           "load_library", "build_log"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels cannot be built on this machine")


def source_digest(name: str, csrc_dir: Path = CSRC_DIR,
                  flags=NVCC_FLAGS) -> str:
    """16 hex digits over ``<name>`` (the library built), the flags and
    every ``*.cu``/``*.cuh`` file of ``csrc_dir`` by name and content —
    all of them rather than the include graph, which would need a
    preprocessor."""
    h = hashlib.sha256()
    h.update(name.encode() + b"\0" + " ".join(flags).encode() + b"\0")
    for path in sorted(csrc_dir.iterdir()):
        if path.suffix in (".cu", ".cuh") and path.is_file():
            h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(name)}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas's per-kernel registers and spills) from the
    build of the current library, or "" if it was not built here."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, then
    load it.  The compile writes to a temporary file and renames it into
    place, so concurrent first calls never load a half-written library."""
    src = CSRC_DIR / f"{name}.cu"
    lib = _lib_path(name)
    if not lib.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                                   str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(lib))
