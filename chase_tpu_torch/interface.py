"""Flat init/solve/get/finalize interface — C-ABI semantic parity.

Port of ``chase_tpu/interface.py`` on one torch device.  The reference
exposes a singleton-per-type C API (interface/chase_c_interface.h:
``{s,d,c,z}chase_init_``, ``*chase_``, ``*chase_get_eigenpairs_``,
``*chase_finalize_``, config setters ``chase_set_*`` and build
introspection ``chase_has_*``) consumed by Fortran/C applications (FLEUR,
YAMBO).  This module reproduces those semantics in Python, with the JAX
package's function names (the C ABI library, ``_native/chase_capi.cpp``,
calls ``'set_' + name``); the dtype letter is inferred from the arrays.

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
returns host numpy arrays.  Only a 1×1 process grid is accepted: the
distributed inits (``init_dist_local``, ``init_blockcyclic``, larger
grids) wait for the multi-GPU slice's part 4 (ROADMAP queue 1 item 5;
``eigsh(..., grid=)`` solves on a process grid now).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .api import eigsh, eigsh_pseudo
from .config import ChaseConfig
from .parallel.operator import DenseOperator, resolve_device

__all__ = ["init", "init_pseudo", "solve", "get_eigenpairs", "finalize",
           "set_matrix", "set_tol", "set_deg", "set_opt", "set_maxiter",
           "set_lanczos", "set_decaying_rate", "set_upperb_scale_rate",
           "set_cluster_aware_degrees", "set_max_deg", "set_deg_extra",
           "set_cholqr", "set_approx", "enable_sym_check",
           "has_gpu", "has_distribution", "has_pseudo"]

GRID_REFUSED = ("a process grid other than 1×1 (or a local block smaller "
                "than the matrix) needs the distributed bindings, ROADMAP "
                "queue 1 item 5, part 4; this interface solves on one "
                "device")


@dataclasses.dataclass
class _Session:
    N: int
    nev: int
    nex: int
    device: torch.device
    op: Optional[DenseOperator]       # None until set_matrix (readHam)
    V0: Optional[np.ndarray] = None
    ritzv0: Optional[np.ndarray] = None
    pseudo: bool = False
    config: ChaseConfig = dataclasses.field(default_factory=ChaseConfig)
    result = None


_session: Optional[_Session] = None


def _require() -> _Session:
    if _session is None:
        raise RuntimeError("chase not initialized — call init() first")
    return _session


def _check_grid(distributed: bool, grid_shape) -> None:
    if distributed and grid_shape is not None \
            and tuple(int(d) for d in grid_shape) != (1, 1):
        raise NotImplementedError(f"grid {tuple(grid_shape)}: "
                                  f"{GRID_REFUSED}")


def _operator(N: int, H, device, pseudo: bool) -> DenseOperator:
    if tuple(H.shape) != (N, N):
        raise ValueError(f"H shape {tuple(H.shape)} != ({N}, {N})")
    return DenseOperator(H, device, pseudo_hermitian=pseudo)


def init(N: int, nev: int, nex: int, H, V=None, ritzv=None, *,
         distributed: bool = False, grid_shape=None, grid_major: str = "R",
         device="cuda"):
    """*chase_init_ / p*chase_init_ on a 1×1 grid: bind the problem to
    the singleton and copy H (numpy array or tensor) onto ``device``.

    ``H=None`` binds no matrix yet: :func:`set_matrix` (the C ABI's
    ``*chase_readHam_``) supplies it before the first solve.  V/ritzv,
    when given, seed mode='A' warm starts (the reference reuses the
    caller's buffers as the approximate subspace).  ``distributed`` and
    ``grid_shape`` are accepted for a 1×1 grid only (NotImplementedError
    otherwise); ``grid_major`` has no meaning on one device."""
    global _session
    _check_grid(distributed, grid_shape)
    dev = resolve_device(device)
    op = None if H is None else _operator(N, H, dev, False)
    _session = _Session(N=N, nev=nev, nex=nex, device=dev, op=op,
                        V0=None if V is None else np.asarray(V),
                        ritzv0=None if ritzv is None else
                        np.asarray(ritzv, np.float64).copy())
    return 0


def init_pseudo(N: int, nev: int, nex: int, H, V=None, *,
                distributed: bool = False, grid_shape=None,
                grid_major: str = "R", device="cuda"):
    """*chase_init_pseudo_ / p{c,z}chase_init_pseudo_ on a 1×1 grid: a
    BSE problem (chase_c_interface.h:159-175); H (N even) as in
    :func:`init`."""
    init(N, nev, nex, None, V, distributed=distributed,
         grid_shape=grid_shape, grid_major=grid_major, device=device)
    s = _require()
    s.pseudo = True
    if H is not None:
        set_matrix(H)
    return 0


def set_matrix(H):
    """Replace the session's H (the C ABI's ``*chase_readHam_``): copy it
    onto the session's device and drop what was derived from the old one
    (its reduced-precision shadow).  The previous result stays, so a
    mode-'A' solve warm-starts the new problem from it — the sequence
    pattern."""
    s = _require()
    s.op = None                  # the old copy goes before the new arrives
    s.op = _operator(s.N, H, s.device, s.pseudo)
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
            kwargs = {"v0": s.V0, "ritzv0": s.ritzv0, "approx": True}
        else:
            raise RuntimeError("mode='A' needs a previous solve or V+ritzv "
                               "buffers supplied at init")
    fn = eigsh_pseudo if s.pseudo else eigsh
    s.result = fn(s.op, s.nev, s.nex, config=s.config, **kwargs)
    return 0 if s.result.converged else 1


def get_eigenpairs():
    """*chase_get_eigenpairs_: (evals (nev,), evecs (N, nev)) as host
    numpy arrays."""
    s = _require()
    if s.result is None:
        raise RuntimeError("no solve() yet")
    V = s.result.V[:, :s.nev].to("cpu", copy=True).numpy()
    return s.result.ritzv.copy(), V


def finalize(flag: int = 0):
    """*chase_finalize_: destroy the singleton."""
    global _session
    _session = None
    return 0


# build introspection (chase_c_interface.h:234-239 chase_has_*)
def has_gpu() -> bool:
    return torch.cuda.is_available()


def has_distribution() -> bool:
    """False until the distributed bindings (ROADMAP queue 1 item 5,
    part 4)."""
    return False


def has_pseudo() -> bool:
    return True
