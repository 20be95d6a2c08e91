"""The port's ``eigsh`` on (p, 1) process grids — the p-step chunk ring in
every filter — against the JAX package, on (2, 1) and (4, 1) gloo grids.

The groups are started once for this module, as in
``tests/test_torch_grid.py`` (``tests/torch_grid_worker.py``, a hard time
limit each).  Tolerances:

* ``eigsh``: spectra within ``conftest.TOLS`` of ``chase_tpu.eigsh(grid=…)``
  on the same shape, true residuals ≤ 10·tol, iterations ±1 of the port's
  ``grid=None`` solve with the same seed, every rank's results bitwise
  equal, the result's rows DTensor's even split of the unpadded rows; on
  (2, 1) in f32 and c64 with ``ring_backend="pallas"`` (every filter HEMM
  p ring steps on the kernel's step), on (4, 1) in f64 and c128 (the
  matmul ring), the padded N = 130, and the f64 ladder
  (``mixed_precision=True``, tol 1e-10) whose every filter HEMM takes the
  kernel's step on the f32 shadow;
* a DTensor H solves as the whole H does, and a warm start from the
  DTensor result converges at once; a padded DTensor H (N = 130 on (4,
  1)) is built into blocks without a gather
  (``test_torch_grid.check_dtensor_padded``);
* ``estimate_spectral_bounds`` on both grids against the JAX package's
  (``test_torch_grid.check_bounds``).
"""

import numpy as np
import pytest
import torch

import jax

import chase_tpu

import torch_grid_worker as gw
from conftest import TOLS
from test_torch_grid import check_bounds, check_dtensor_padded

torch.set_num_threads(1)

# battery → (grid shape, the worker's solve cases)
SHAPES = {"g21s": (2, 1), "g41s": (4, 1)}
CASES = {"g21s": gw.SOLVES["g21"], "g41s": gw.SOLVES["g41"]}


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


def _solve_cases():
    return [(name, case) for name in SHAPES for case, _ in CASES[name]]


@pytest.mark.parametrize("name,case", _solve_cases())
def test_eigsh_matches_jax(groups, name, case):
    H, nev, nex, tol = gw.eig_problem(case)
    p = SHAPES[name][0]
    cfg = dict(CASES[name])[case]
    jres = chase_tpu.eigsh(
        H, nev, nex, tol=tol, grid=_jax_grid(SHAPES[name]),
        config=chase_tpu.ChaseConfig(
            complex_backend="native",
            mixed_precision=bool(cfg.get("mixed_precision", False))))
    ranks = groups[name].results()
    rec = ranks[0]
    assert bool(rec[f"{case}/converged"]) and jres.converged
    ritzv = rec[f"{case}/ritzv"]
    np.testing.assert_allclose(ritzv, jres.ritzv, rtol=0,
                               atol=TOLS[H.dtype])
    V = rec[f"{case}/V"]
    assert V.shape == (H.shape[0], nev)
    true_res = np.linalg.norm(H @ V - V * ritzv, axis=0)
    assert true_res.max() <= 10 * tol
    assert abs(int(rec[f"{case}/iterations"])
               - int(rec[f"{case}/iterations0"])) <= 1
    for key in ("ritzv", "resid", "iterations", "locked", "ritzv_full",
                "V"):
        assert _all_equal(ranks, f"{case}/{key}"), key
    # the result's rows: DTensor's even split of the unpadded rows
    chunk = -(-H.shape[0] // p)
    sizes = [max(0, min(chunk, H.shape[0] - i * chunk)) for i in range(p)]
    assert [int(r[f"{case}/local_rows"]) for r in ranks] == sizes
    # every filter HEMM took p ring steps on the kernel's step where the
    # filter's operator is one the kernel takes
    kernel = cfg.get("ring_backend") == "pallas" and (
        H.dtype in (np.float32, np.complex64) or "ladder" in case)
    steps, hemms = int(rec[f"{case}/steps"]), int(rec[f"{case}/hemm_steps"])
    assert hemms > 0
    assert steps == (p * hemms if kernel else 0)


def test_dtensor_operator_and_warm_start(groups):
    H, nev, *_ = gw.eig_problem("clement_float64")
    exact = np.linalg.eigvalsh(H)[:nev]
    for rec in groups["g21s"].results():
        assert bool(rec["dtensor/equal"])
        assert int(rec["dtensor/warm_iterations"]) <= 1
        assert np.abs(rec["dtensor/warm_ritzv"] - exact).max() <= 1e-8


@pytest.mark.parametrize("name", list(SHAPES))
def test_estimate_spectral_bounds_on_a_ring_grid(groups, name):
    check_bounds(groups[name].results(), SHAPES[name])


def test_padded_dtensor_operator_is_not_gathered(groups):
    check_dtensor_padded(groups["g41s"].results())


def test_warmup_on_a_grid(groups):
    for rec in groups["g21s"].results():
        assert int(rec["warmup/failed"]) == 0
