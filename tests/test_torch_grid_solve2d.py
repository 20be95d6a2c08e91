"""The port's solvers on a (2, 2) process grid — the 2-D ping-pong ring
in every host-driver filter — against the JAX package's, whose solvers
take their own 2-D ring on a mesh of the same shape.

Two gloo groups of ``tests/torch_grid_worker.py`` (a hard time limit
each), started once for this module: ``s22`` (eigsh, eigsh_sequence and
eigsh_fused) and ``p22`` (eigsh_pseudo).  Tolerances:

* ``eigsh`` (Clement f64, a random c128 H, the f64 ladder on
  ``ring_backend="pallas"``) and ``eigsh_pseudo`` (a random BSE H in f64
  and c128, the f64 ladder), each with ``ring_filter`` None and True:
  converged, spectra within ``conftest.TOLS`` of ``chase_tpu.eigsh(grid=
  …)`` / ``eigsh_pseudo(grid=…)`` on a (2, 2) mesh, true residuals ≤
  10·tol, iterations within ±1 of the JAX package's and of the port's
  ``grid=None`` solve with the same seed — except the BSE ladder's,
  held to at most the JAX package's: at N = 128 its (2, 2) 2-D ring
  takes 6 iterations where its one-device and (p, 1) solves take 4 and
  its windowed (2, 2) solve 5, and the port 3 on every route (the two
  packages draw other start blocks and probes); ``ritzv``, ``resid``,
  iterations, locked count and V bitwise equal on every rank, and None's
  results bitwise True's (the same route); the ladder's every filter
  HEMM step on the kernel's step, r = c = 2 launches per rank each
  (ring_A's 'r' steps or ring_B's 'c' steps), the f64 and c128 solves
  none (``torch.matmul`` steps);
* ``eigsh_sequence`` on the grid: Ritz values within ``conftest.TOLS`` of
  ``chase_tpu.eigsh_sequence(grid=…)``, iterations ±1 of the port's
  ``grid=None`` run;
* ``eigsh_fused`` in f32 with ``ring_backend="pallas"``: converged, no
  kernel step (the fused solvers have no 2-D ring, as the JAX
  package's: ``dist.hemm``), its collectives all-gathers and all-reduces
  only, at least one all-gather per filter product.
"""

import numpy as np
import pytest
import torch

import jax

import chase_tpu
from chase_tpu_torch.models import clement, hermitian_sequence

import torch_grid_worker as gw
from conftest import TOLS

torch.set_num_threads(1)

SHAPE = (2, 2)
SHAPES = {"s22": SHAPE, "p22": SHAPE}
JAX_PINS = dict(complex_backend="native", small_dense_backend="device",
                wide_f64="off")


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {name: gw.Group(name, r, c, tmp_path_factory.mktemp(name),
                              timeout=300)
               for name, (r, c) in SHAPES.items()}
    yield started
    for g in started.values():
        g.kill()


def _jax_grid():
    return chase_tpu.make_grid(jax.devices()[:4], shape=SHAPE)


def _all_equal(ranks, key) -> bool:
    return all(np.array_equal(r[key], ranks[0][key]) for r in ranks[1:])


KEYS = ("ritzv", "resid", "iterations", "locked", "ritzv_full", "V")
# cases whose JAX (2, 2) solve takes more iterations than the JAX
# package's own one-device solve (the module note)
JAX_2D_SLOWER = {"random_float64_ladder"}


def _check(ranks, case, cfg, H, tol, jres):
    """One case's records against the JAX solve, for both ring_filter
    values; the kernel's steps of the ladder."""
    assert jres.converged
    Hw = H.astype(np.complex128)
    kernel = "ladder" in case
    for rf in ("None", "True"):
        key = f"{case}/{rf}"
        rec = ranks[0]
        assert bool(rec[f"{key}/converged"])
        ritzv = rec[f"{key}/ritzv"]
        np.testing.assert_allclose(ritzv, jres.ritzv, rtol=0,
                                   atol=TOLS[H.dtype])
        V = rec[f"{key}/V"]
        assert np.linalg.norm(Hw @ V - V * ritzv, axis=0).max() <= 10 * tol
        its = int(rec[f"{key}/iterations"])
        if case in JAX_2D_SLOWER:
            assert its <= jres.iterations
        else:
            assert abs(its - jres.iterations) <= 1
        assert abs(its - int(rec[f"{key}/iterations0"])) <= 1
        for k in KEYS:
            assert _all_equal(ranks, f"{key}/{k}"), k
            np.testing.assert_array_equal(rec[f"{key}/{k}"],
                                          rec[f"{case}/None/{k}"])
        steps, hemms = (int(rec[f"{key}/steps"]),
                        int(rec[f"{key}/hemm_steps"]))
        assert hemms > 0
        assert steps == (2 * hemms if kernel else 0)


@pytest.mark.parametrize("case", [c for c, _ in gw.SOLVES_2D])
def test_eigsh_on_the_2d_ring_matches_jax(groups, case):
    H, nev, nex, tol = gw.eig_problem(case)
    cfg = dict(gw.SOLVES_2D)[case]
    jres = chase_tpu.eigsh(
        H, nev, nex, tol=tol, grid=_jax_grid(),
        config=chase_tpu.ChaseConfig(
            complex_backend="native",
            mixed_precision=bool(cfg.get("mixed_precision", False))))
    _check(groups["s22"].results(), case, cfg, H, tol, jres)


@pytest.mark.parametrize("case", [c for c, _ in gw.PSEUDO_2D])
def test_eigsh_pseudo_on_the_2d_ring_matches_jax(groups, case):
    H, nev, nex, tol = gw.bse_problem(case)
    cfg = dict(gw.PSEUDO_2D)[case]
    jres = chase_tpu.eigsh_pseudo(
        H, nev, nex, tol=tol, grid=_jax_grid(),
        config=chase_tpu.ChaseConfig(
            mixed_precision=bool(cfg.get("mixed_precision", False)),
            **JAX_PINS))
    _check(groups["p22"].results(), case, cfg, H, tol, jres)


def test_eigsh_sequence_on_the_2d_ring(groups):
    ranks = groups["s22"].results()
    rec = ranks[0]
    seq = hermitian_sequence(96, 3, np.complex128, seed=17, drift=0.004)
    jres = list(chase_tpu.eigsh_sequence(
        iter(seq), 10, 8, tol=1e-9, grid=_jax_grid(),
        config=chase_tpu.ChaseConfig(complex_backend="native",
                                     mixed_precision=False),
        warmup=False))
    its, its0 = rec["sequence/iterations"], rec["sequence/iterations0"]
    assert np.all(np.abs(its - its0) <= 1)
    for H, ritzv, resid, jr in zip(seq, rec["sequence/ritzv"],
                                   rec["sequence/resid"], jres):
        assert jr.converged
        np.testing.assert_allclose(ritzv, jr.ritzv, rtol=0,
                                   atol=TOLS[np.dtype(np.complex128)])
        assert resid.max() <= 1e-9
    for key in ("sequence/iterations", "sequence/ritzv"):
        assert _all_equal(ranks, key)


def test_fused_solver_keeps_dist_hemm_on_a_2d_grid(groups):
    ranks = groups["s22"].results()
    exact = np.linalg.eigvalsh(clement(gw.BSE["N"]))[:gw.BSE["nev"]]
    for rec in ranks:
        assert bool(rec["fused2d/converged"])
        assert np.abs(rec["fused2d/ritzv"] - exact).max() <= 0.5
        assert int(rec["fused2d/steps"]) == 0
        assert set(str(k) for k in rec["fused2d/kinds"]) <= {
            "all_gather", "all_reduce", "broadcast"}
        assert int(rec["fused2d/all_gather"]) >= int(
            rec["fused2d/hemm_steps"]) > 0
    assert _all_equal(ranks, "fused2d/ritzv")
