"""Flat init/solve/get/finalize interface — C-ABI semantic parity.

Port of ``chase_tpu/interface.py``.  The reference exposes a
singleton-per-type C API (interface/chase_c_interface.h:
``{s,d,c,z}chase_init_``, ``*chase_``, ``*chase_get_eigenpairs_``,
``*chase_finalize_``, the distributed ``p*chase_init*`` families, config
setters ``chase_set_*`` and build introspection ``chase_has_*``) consumed
by Fortran/C applications (FLEUR, YAMBO).  This module reproduces those
semantics in Python, with the JAX package's function names (the C ABI
library, ``_native/chase_capi.cpp``, calls ``'set_' + name``); the dtype
letter is inferred from the arrays.

    import chase_tpu_torch.interface as chase
    chase.init(N, nev, nex, H, device="cuda")     # dchase_init_
    chase.set_tol(1e-10); chase.set_deg(20)       # chase_set_*
    chase.solve(mode="R", opt="S", qr="C")        # dchase_
    evals, evecs = chase.get_eigenpairs()         # dchase_get_eigenpairs_
    chase.finalize()                              # dchase_finalize_

``init`` copies H onto the session's device once (``device="cuda"`` by
default; without a card that raises, as every entry point of the port
does); the solves of a session reuse that copy, and a mode-'A' solve
starts from the previous result's V where it lies.  ``get_eigenpairs``
returns host numpy arrays (the vectors Fortran-ordered, transposed where
V lies).

Process grids.  The JAX package drives a dim0×dim1 device mesh from one
process; the port runs one process per device on a ``torch.distributed``
group (``parallel/multihost.py``: torchrun's ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``; NCCL on cards, gloo for
``device="cpu"``), so every distributed entry point is collective: each
rank of the group calls it with the same arguments, and ``solve`` and
``get_eigenpairs`` with it.  A grid of more than one rank must be the
whole group (ValueError naming both sizes otherwise); ``grid_major``
'R' puts rank ``i·dim1 + j`` at grid coordinate (i, j), 'C' rank ``j·dim0
+ i``.  Two modes:

* whole matrix — ``init(distributed=True)``, ``init_pseudo(distributed=
  True)``, ``init_blockcyclic``: every rank passes the whole H, each keeps
  its block of it (``DenseOperator(grid=…)``); ``get_eigenpairs`` returns
  the whole V on every rank (rows restored under a block-cyclic layout);
* per rank — ``init_dist_local``: each rank passes only its (N/dim0,
  N/dim1) block, assembled into a DTensor without any rank holding the
  matrix; ``get_eigenpairs`` returns this rank's (N/dim0, nev) rows.

A 1×1 grid is the one-device solve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .api import eigsh, eigsh_pseudo
from .config import ChaseConfig
from .parallel.mesh import colvec_sharding, make_grid, matrix_sharding
from .parallel.operator import DenseOperator, resolve_device, to_device

__all__ = ["init", "init_pseudo", "init_blockcyclic", "init_dist_local",
           "solve", "get_eigenpairs", "finalize",
           "set_matrix", "set_tol", "set_deg", "set_opt", "set_maxiter",
           "set_lanczos", "set_decaying_rate", "set_upperb_scale_rate",
           "set_cluster_aware_degrees", "set_max_deg", "set_deg_extra",
           "set_cholqr", "set_approx", "enable_sym_check",
           "has_gpu", "has_distribution", "has_pseudo"]


@dataclasses.dataclass
class _Session:
    N: int
    nev: int
    nex: int
    device: torch.device
    op: Optional[DenseOperator]       # None until set_matrix (readHam)
    V0: object = None                 # numpy, or a DTensor (per-rank mode)
    ritzv0: Optional[np.ndarray] = None
    pseudo: bool = False
    grid: object = None               # Grid2D or None (one device)
    local_rows: Optional[int] = None  # per-rank mode: this rank's m
    layout: object = None             # (Pseudo)BlockCyclicLayout or None
    config: ChaseConfig = dataclasses.field(default_factory=ChaseConfig)
    result = None


_session: Optional[_Session] = None


def _require() -> _Session:
    if _session is None:
        raise RuntimeError("chase not initialized — call init() first")
    return _session


def _grid_for(grid_shape, grid_major: str = "R", device="cuda"):
    """The process grid for the reference's (dim0, dim1) process-grid
    dims, or None for a 1×1 grid (the one-device solve).

    Initializes the default process group from the launcher's environment
    if needed (``multihost.ensure_initialized``: NCCL for "cuda", gloo for
    "cpu"); ValueError unless dim0·dim1 is the group's world size.
    grid_major 'R' | 'C' maps the ranks row- or column-major onto the
    grid — the MpiGrid2D RowMajor/ColMajor analogue
    (grid/mpiGrid2D.hpp:188).  ``grid_shape=None``: the near-square grid
    over every rank."""
    import torch.distributed as dist
    from .parallel import multihost
    if grid_shape is None:
        multihost.ensure_initialized(device=device)
        return make_grid(device=device)
    d0, d1 = int(grid_shape[0]), int(grid_shape[1])
    n = d0 * d1
    if n <= 1:
        return None
    multihost.ensure_initialized(device=device)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"grid dims {d0}x{d1} need {n} ranks (one process per device), "
            f"the process group has {world}; start one process per rank "
            f"(see chase_tpu_torch.parallel.multihost)")
    ranks = np.arange(n)
    if str(grid_major).upper().startswith("C"):
        ranks = ranks.reshape(d1, d0).T.ravel()
    return make_grid(ranks.tolist(), shape=(d0, d1), device=device)


def _start(N, nev, nex, V, ritzv, grid, device, pseudo=False, **extra):
    """A new session on ``grid`` (or ``device`` without one), no matrix
    bound yet."""
    global _session
    _session = _Session(
        N=N, nev=nev, nex=nex, op=None, pseudo=pseudo, grid=grid,
        device=grid.device if grid is not None else resolve_device(device),
        V0=None if V is None else np.asarray(V),
        ritzv0=None if ritzv is None else
        np.asarray(ritzv, np.float64).copy(), **extra)
    return _session


def _check_shape(N: int, H) -> None:
    if tuple(H.shape) != (N, N):
        raise ValueError(f"H shape {tuple(H.shape)} != ({N}, {N})")


def init(N: int, nev: int, nex: int, H, V=None, ritzv=None, *,
         distributed: bool = False, grid_shape=None, grid_major: str = "R",
         device="cuda"):
    """*chase_init_ / p*chase_init_ with the whole matrix: bind the
    problem to the singleton and copy H (numpy array or tensor) onto
    ``device`` — or, with ``distributed=True``, this rank's block of it
    onto the grid's device (``grid_shape`` = the reference's (dim0, dim1)
    process-grid dims; a collective, see the module note).

    ``H=None`` binds no matrix yet: :func:`set_matrix` (the C ABI's
    ``*chase_readHam_``) supplies it before the first solve.  V/ritzv,
    when given, seed mode='A' warm starts (the reference reuses the
    caller's buffers as the approximate subspace)."""
    if H is not None:
        _check_shape(N, H)
    grid = _grid_for(grid_shape, grid_major, device) if distributed \
        else None
    _start(N, nev, nex, V, ritzv, grid, device)
    if H is not None:
        set_matrix(H)
    return 0


def init_pseudo(N: int, nev: int, nex: int, H, V=None, *,
                distributed: bool = False, grid_shape=None,
                grid_major: str = "R", device="cuda"):
    """*chase_init_pseudo_ / p{c,z}chase_init_pseudo_: a BSE problem
    (chase_c_interface.h:159-175); H (N even) as in :func:`init`."""
    init(N, nev, nex, None, V, distributed=distributed,
         grid_shape=grid_shape, grid_major=grid_major, device=device)
    s = _require()
    s.pseudo = True
    if H is not None:
        set_matrix(H)
    return 0


def init_dist_local(N: int, nev: int, nex: int, m: int, n: int, H_local,
                    V=None, ritzv=None, *, grid_shape, grid_major: str = "R",
                    pseudo: bool = False, device="cuda"):
    """Per-rank p*chase_init_ (chase_c_interface.h:126-157): each rank of
    a dim0×dim1 process group passes its LOCAL (m, n) block of the
    block-block distribution, exactly like an MPI rank of the reference.

    The blocks become one DTensor ``(Shard(0), Shard(1))`` on the grid's
    mesh (``DTensor.from_local``; no rank ever holds the whole matrix) and
    V, when given — this rank's (m, cols) rows of the column-communicator
    multivector, the same on every rank of a grid row — a DTensor
    ``(Shard(0), Replicate())``.  Collective.

    Requirements (ValueError otherwise): the process group has dim0·dim1
    ranks; rank r sits at grid coordinate (r // dim1, r % dim1) for 'R'
    major ((r % dim0, r // dim0) for 'C'); dim0·dim1 divides N (no padding
    across ranks); (m, n) = (N/dim0, N/dim1); V is (m, cols), cols =
    nev+nex (2·(nev+nex) for ``pseudo``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    d0, d1 = int(grid_shape[0]), int(grid_shape[1])
    grid = _grid_for((d0, d1), grid_major, device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if grid is None and world != 1:
        raise ValueError(f"per-rank init: grid dims {d0}x{d1} need "
                         f"{d0 * d1} ranks, the process group has {world}")
    if N % d0 or N % d1 or N % (d0 * d1):
        raise ValueError(
            f"per-rank init needs dim0·dim1 | N (no padding across "
            f"processes): N={N}, grid {d0}x{d1}")
    if m != N // d0 or n != N // d1:
        raise ValueError(
            f"local block ({m}, {n}) != (N/dim0, N/dim1) = "
            f"({N // d0}, {N // d1}) — uneven block splits are not "
            f"supported; pad N to a multiple of the grid")
    if tuple(H_local.shape) != (m, n):
        raise ValueError(f"H_local shape {tuple(H_local.shape)} != "
                         f"({m}, {n})")
    cols = 2 * (nev + nex) if pseudo else nev + nex
    if V is not None and tuple(V.shape) != (m, cols):
        raise ValueError(f"V local block shape {tuple(V.shape)} != "
                         f"({m}, {cols})")
    s = _start(N, nev, nex, None, ritzv, grid, device, pseudo=pseudo,
               local_rows=m)
    H = H_local
    if grid is not None:
        H = DTensor.from_local(to_device(H_local, s.device),
                               *matrix_sharding(grid), run_check=False,
                               shape=torch.Size((N, N)), stride=(N, 1))
        if V is not None:
            V = DTensor.from_local(to_device(V, s.device),
                                   *colvec_sharding(grid), run_check=False,
                                   shape=torch.Size((N, cols)),
                                   stride=(cols, 1))
    s.V0 = V
    set_matrix(H)
    return 0


def init_blockcyclic(N: int, nev: int, nex: int, mb: int, nb: int, H,
                     V=None, ritzv=None, *, pseudo: bool = False,
                     distributed: bool = True, grid_shape=None,
                     grid_major: str = "R", irsrc: int = 0, icsrc: int = 0,
                     device="cuda"):
    """p?chase_init_blockcyclic_ / p?chase_init_pseudo_blockcyclic_
    (chase_c_interface.h:61-121): bind the whole matrix with a
    ScaLAPACK-style (mb×nb) block-cyclic layout on the grid (collective).

    The layout is an ownership similarity transform
    (``parallel/layouts.BlockCyclicLayout``; the S-preserving
    ``PseudoBlockCyclicLayout`` for ``pseudo``): H's rows and columns are
    permuted once per matrix (at init, and at each :func:`set_matrix`) so
    that the grid's contiguous blocks own exactly the block-cyclically
    assigned indices; eigenvector rows are un-permuted in
    :func:`get_eigenpairs`, and init's V is permuted into the ownership
    order for a mode-'A' solve.  ``irsrc``/``icsrc`` (the source-process
    offsets of the ScaLAPACK descriptor) must be 0 (ValueError); nb ≠ mb
    warns and uses mb on both sides."""
    from .logger import get_logger
    from .parallel.layouts import BlockCyclicLayout, PseudoBlockCyclicLayout
    if irsrc != 0 or icsrc != 0:
        raise ValueError("irsrc/icsrc != 0 unsupported (no rank relabeling "
                         "on a process grid)")
    if nb != mb:
        get_logger().warn(f"block-cyclic nb={nb} != mb={mb}: the Hermitian "
                          f"similarity transform uses mb for both sides",
                          "interface")
    if H is not None:
        _check_shape(N, H)
    if pseudo:
        init_pseudo(N, nev, nex, None, V, distributed=distributed,
                    grid_shape=grid_shape, grid_major=grid_major,
                    device=device)
    else:
        init(N, nev, nex, None, V, ritzv, distributed=distributed,
             grid_shape=grid_shape, grid_major=grid_major, device=device)
    s = _require()
    g = s.grid
    cls = PseudoBlockCyclicLayout if pseudo else BlockCyclicLayout
    s.layout = cls(N, mb, g.size("r") if g else 1, g.size("c") if g else 1)
    if H is not None:
        set_matrix(H)
    return 0


def set_matrix(H):
    """Replace the session's H (the C ABI's ``*chase_readHam_``): copy it
    onto the session's device (this rank's block of it on a grid; under a
    block-cyclic layout permuted into the ownership order first) and drop
    what was derived from the old one (its reduced-precision shadow).  The
    previous result stays, so a mode-'A' solve warm-starts the new problem
    from it — the sequence pattern."""
    s = _require()
    _check_shape(s.N, H)
    s.op = None                  # the old copy goes before the new arrives
    if s.layout is not None:
        H = s.layout.apply(H)
    s.op = DenseOperator(H, None if s.grid is not None else s.device,
                         grid=s.grid, pseudo_hermitian=s.pseudo)
    return 0


def _configure(**updates):
    s = _require()
    s.config = dataclasses.replace(s.config, **updates)


def set_tol(tol: float):
    _configure(tol=float(tol))


def set_deg(deg: int):
    _configure(deg=int(deg))


def set_opt(opt: bool):
    _configure(optimization=bool(opt))


def set_maxiter(n: int):
    _configure(max_iter=int(n))


def set_lanczos(lanczos_iter: Optional[int], num_lanczos: int):
    """Lanczos steps per probe (None: the dtype's default) and probes."""
    _configure(lanczos_iter=None if lanczos_iter is None
               else int(lanczos_iter), num_lanczos=int(num_lanczos))


def set_decaying_rate(rate: float):
    _configure(decaying_rate=float(rate))


def set_upperb_scale_rate(rate: float):
    _configure(upperb_scale=float(rate))


def set_cluster_aware_degrees(flag: bool):
    _configure(cluster_aware_degrees=bool(flag))


def set_max_deg(max_deg: int):
    _configure(max_deg=int(max_deg))


def set_deg_extra(deg_extra: int):
    _configure(deg_extra=int(deg_extra))


def set_cholqr(flag: bool):
    _configure(cholqr=bool(flag))


def set_approx(flag: bool):
    _configure(approx=bool(flag))


def enable_sym_check(flag: bool):
    _configure(sym_check=bool(flag))


def solve(deg: Optional[int] = None, tol: Optional[float] = None,
          mode: str = "R", opt: str = "S", qr: str = "C"):
    """*chase_(deg, tol, mode, opt, qr): run the solver on the session;
    0 if it converged, 1 if not.

    mode='R'|'A' (random vs warm start: from the previous result's V, on
    the device, or else from the V+ritzv buffers given at init),
    opt='S'|'N' (degree optimization), qr='C'|'H' (CholQR vs Householder)
    — chase_c_interface.h:38-41.
    """
    s = _require()
    if s.op is None:
        raise RuntimeError("no matrix bound: pass H to init() or call "
                           "set_matrix() (readHam) before solve()")
    updates = {"optimization": opt != "N", "cholqr": qr == "C",
               "approx": mode == "A"}
    if deg is not None:
        updates["deg"] = int(deg)
    if tol is not None:
        updates["tol"] = float(tol)
    _configure(**updates)
    kwargs = {}
    if mode == "A":
        if s.result is not None:
            kwargs = {"v0": s.result.V, "ritzv0": s.result.ritzv_full,
                      "approx": True}
        elif s.V0 is not None and s.ritzv0 is not None \
                and np.any(s.ritzv0):
            # the caller's rows in their order → the ownership order
            v0 = s.V0 if s.layout is None else s.layout.apply_rows(s.V0)
            kwargs = {"v0": v0, "ritzv0": s.ritzv0, "approx": True}
        else:
            raise RuntimeError("mode='A' needs a previous solve or V+ritzv "
                               "buffers supplied at init")
    fn = eigsh_pseudo if s.pseudo else eigsh
    s.result = fn(s.op, s.nev, s.nex, config=s.config, **kwargs)
    return 0 if s.result.converged else 1


def get_eigenpairs():
    """*chase_get_eigenpairs_: (evals (nev,), evecs (N, nev)) as host
    numpy arrays, the vectors Fortran-ordered (transposed where V lies,
    on the card for a CUDA solve).

    On a grid every rank calls it (a collective): the whole-matrix modes
    return the whole V on every rank, its rows in the caller's order under
    a block-cyclic layout; the per-rank mode (:func:`init_dist_local`)
    returns this rank's (m, nev) rows — the reference's
    p*chase_get_eigenpairs_ semantics (rank-local LEigsV)."""
    from torch.distributed.tensor import DTensor
    s = _require()
    if s.result is None:
        raise RuntimeError("no solve() yet")
    V = s.result.V
    if isinstance(V, DTensor):
        local = V.to_local()[:, :s.nev]
        if s.local_rows is not None:
            V = local
        else:
            V = DTensor.from_local(local.contiguous(), V.device_mesh,
                                   V.placements, run_check=False,
                                   shape=torch.Size((V.shape[0], s.nev)),
                                   stride=(s.nev, 1)).full_tensor()
    V = V[:, :s.nev]
    if s.layout is not None:
        V = s.layout.restore_rows(V)
    # a new (nev, rows) tensor where V lies, never a view of the result
    Vt = torch.empty(V.shape[::-1], dtype=V.dtype, device=V.device)
    return s.result.ritzv.copy(), Vt.copy_(V.mT).cpu().numpy().T


def finalize(flag: int = 0):
    """*chase_finalize_: destroy the singleton (on a grid collectively:
    its peer memory is freed, ``Grid2D.close``)."""
    global _session
    if _session is not None and _session.grid is not None:
        _session.grid.close()
    _session = None
    return 0


# build introspection (chase_c_interface.h:234-239 chase_has_*)
def has_gpu() -> bool:
    return torch.cuda.is_available()


def has_distribution() -> bool:
    """Whether a solve can span more than one device — the JAX package's
    ``jax.device_count() > 1`` in the port's process model: more than one
    CUDA card visible to this process, or this process one rank of a
    process group of more than one rank."""
    from .parallel import multihost
    return torch.cuda.device_count() > 1 or multihost.is_multihost()


def has_pseudo() -> bool:
    return True
