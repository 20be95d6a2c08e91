"""The port's fused solvers, ``eigsh_fused`` and ``eigsh_pseudo_fused``, on
process grids against the JAX package's, on (2, 1) and (2, 2) gloo
grids (``tests/torch_grid_worker.py``, one group per shape, a hard time
limit each).  Tolerances:

* spectra within ``conftest.TOLS`` of ``chase_tpu.eigsh_fused(grid=…)`` /
  ``eigsh_pseudo_fused(grid=…)`` on the same shape; true residuals ≤
  10·tol; iterations within ±1 of the port's ``grid=None`` fused solve
  with the same seed; ``ritzv``, ``resid``, iterations, locked count and
  V bitwise equal on every rank (the loop's three host reads and every
  branch agree); on (2, 1) in f32 with ``ring_backend="pallas"`` every
  filter product p ring steps on the kernel's step (the chunk ring), in
  f64 none (no kernel operator);
* ``warmup(grid=…, fused=True)`` runs its jobs on the grid, Hermitian and
  BSE, without a failure.
"""

import numpy as np
import pytest
import torch

import jax

import chase_tpu
from chase_tpu_torch.models import clement, random_pseudo_hermitian

import torch_grid_worker as gw
from conftest import TOLS

torch.set_num_threads(1)

SHAPES = {"f21": (2, 1), "f22": (2, 2)}
JAX_PINS = dict(complex_backend="native", small_dense_backend="device",
                wide_f64="off", mixed_precision=False)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {name: gw.Group(name, r, c, tmp_path_factory.mktemp(name))
               for name, (r, c) in SHAPES.items()}
    yield started
    for g in started.values():
        g.kill()


def _jax_grid(shape):
    n = shape[0] * shape[1]
    return chase_tpu.make_grid(jax.devices()[:n], shape=shape)


def _all_equal(ranks, key) -> bool:
    return all(np.array_equal(r[key], ranks[0][key]) for r in ranks[1:])


def _cases():
    return [(name, what, dtype) for name in SHAPES
            for dtype, _ in gw.FUSED[name] for what in ("fused", "pfused")]


@pytest.mark.parametrize("name,what,dtype", _cases())
def test_fused_solvers_match_jax(groups, name, what, dtype):
    shape = SHAPES[name]
    p = shape[0]
    cfg = dict(gw.FUSED[name])[dtype]
    dt = np.dtype(dtype)
    N, nev, nex = gw.BSE["N"], gw.BSE["nev"], gw.BSE["nex"]
    tol = gw.BSE_TOL[dtype]
    if what == "fused":
        H = clement(N).astype(dt)
        solve = chase_tpu.eigsh_fused
    else:
        H = random_pseudo_hermitian(N, dt, seed=5)
        solve = chase_tpu.eigsh_pseudo_fused
    jres = solve(H, nev, nex, tol=tol, grid=_jax_grid(shape),
                 config=chase_tpu.ChaseConfig(**JAX_PINS))
    ranks = groups[name].results()
    rec = ranks[0]
    key = f"{what}/{dtype}"
    assert bool(rec[f"{key}/converged"]) and jres.converged
    ritzv = rec[f"{key}/ritzv"]
    np.testing.assert_allclose(ritzv, jres.ritzv, rtol=0, atol=TOLS[dt])
    V = rec[f"{key}/V"]
    assert V.shape == (N, nev)
    Hw = H.astype(np.complex128)
    assert np.linalg.norm(Hw @ V - V * ritzv, axis=0).max() <= 10 * tol
    assert abs(int(rec[f"{key}/iterations"])
               - int(rec[f"{key}/iterations0"])) <= 1
    for k in ("ritzv", "resid", "iterations", "locked", "V"):
        assert _all_equal(ranks, f"{key}/{k}"), k
    kernel = cfg.get("ring_backend") == "pallas" and shape[1] == 1 \
        and dt == np.float32
    steps, hemms = int(rec[f"{key}/steps"]), int(rec[f"{key}/hemm_steps"])
    assert hemms > 0
    assert steps == (p * hemms if kernel else 0)


@pytest.mark.parametrize("name", list(SHAPES))
def test_warmup_fused_on_a_grid(groups, name):
    for rec in groups[name].results():
        programs, failed, programs_p, failed_p = (int(x)
                                                  for x in rec["fwarmup"])
        assert programs == programs_p == 2 and failed == failed_p == 0
