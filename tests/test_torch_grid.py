"""The port on a torch.distributed process grid against the JAX package:
the grid, its products, and the Hermitian solver on 1×1, column (1, 2)
and 2-D (2, 2) grids.

Each grid shape is one gloo process group — ``tests/torch_grid_worker.py``,
one process per rank, which imports torch and the port only — started
once for this module; every rank runs its battery and writes what it
computed, and each test below holds that to ``chase_tpu`` on its 8
virtual CPU devices with the same numpy inputs and the same grid shape.
A group has a hard time limit (``Group``), so a hang fails its tests
instead of the run.  Tolerances:

* grid shapes, coordinates and groups: equal to ``chase_tpu.make_grid``'s
  mesh for 1, 2, 4 and 8 ranks;
* the windowed filter's product on the grid (gather over 'r', local
  block, reduce over 'c'): within 1e-12 of the largest entry of the dense
  f64/c128 product (a few roundings of 96-term sums);
* ``eigsh``: converged spectra within ``conftest.TOLS`` of
  ``chase_tpu.eigsh(grid=…)`` on the same shape; true residuals ≤ 10·tol;
  iterations within ±1 of the port's ``grid=None`` solve with the same
  seed; ``ritzv``, ``resid``, iterations and locked count bitwise equal on
  every rank (every host decision reads them); on the 1×1 grid the
  spectrum bitwise equal to ``grid=None``'s (the same arithmetic);
* ``eigsh_sequence`` with ``grid=``: Ritz values within ``conftest.TOLS``
  of ``chase_tpu.eigsh_sequence(grid=…)``, iterations ±1 of the port's
  ``grid=None`` run; ``estimate_spectral_bounds`` with ``grid=``: each
  bound's deviation from the exact spectrum within 1.5 times the JAX
  package's largest on the same grid shape over three keys, and within
  1e-12 relative of the port's ``grid=None`` estimate (the same probes);
* a padded DTensor H (N = 130 on (2, 2)) built into blocks without a
  gather, equal to the whole H's but for the phantom diagonal (N·ε);
  another layout refused;
* ``ring_filter`` on the 2-D grid: True takes the 2-D ring as None does
  (Clement N = 64 in f32 with ``ring_backend="pallas"``: the same Ritz
  values bitwise, every filter HEMM step r = c = 2 kernel steps per
  rank), False the windowed filter (no kernel step), all three within
  1e-2 of the exact spectrum;
* refusal: ``make_grid(device="cuda")`` without a card;
* the padded operator (N = 130 on 4 ranks) entry for entry the JAX
  package's, its phantom diagonal within N·ε (row sums added in another
  order).
"""

import numpy as np
import pytest
import torch

import jax

import chase_tpu
import chase_tpu_torch as ct
from chase_tpu_torch.parallel import multihost

import torch_grid_worker as gw
from conftest import TOLS

torch.set_num_threads(1)

SHAPES = {"g11": (1, 1), "g12": (1, 2), "g22": (2, 2), "g8": (2, 4)}


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


def test_make_grid_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="does not fall back"):
        ct.make_grid(device="cuda")
    with pytest.raises(RuntimeError, match="does not fall back"):
        multihost.ensure_initialized(device="cuda")


@pytest.mark.parametrize("name", list(SHAPES))
def test_make_grid_matches_jax(groups, name):
    """Shape, size, coordinates and the row/column groups of every rank
    against the JAX mesh of as many devices; the near-square default;
    a shape that does not cover the ranks raises."""
    ranks = groups[name].results()
    shape = SHAPES[name]
    n = shape[0] * shape[1]
    jgrid = _jax_grid(shape)
    jdefault = chase_tpu.make_grid(jax.devices()[:n])
    devs = np.vectorize(lambda d: d.id)(jgrid.mesh.devices)
    assert len(ranks) == n
    for rec in ranks:
        k = int(rec["mesh/rank"])
        i, j = (int(x) for x in np.argwhere(devs == k)[0])
        assert list(rec["mesh/shape"]) == [jgrid.shape["r"],
                                           jgrid.shape["c"]]
        assert int(rec["mesh/nprocs"]) == jgrid.nprocs == n
        assert list(rec["mesh/coords"]) == [i, j]
        assert list(rec["mesh/group_r"]) == sorted(devs[:, j].tolist())
        assert list(rec["mesh/group_c"]) == sorted(devs[i, :].tolist())
        assert list(rec["mesh/default_shape"]) == [jdefault.shape["r"],
                                                   jdefault.shape["c"]]
        assert list(rec["mesh/info"]) == [k, n, 1, n]
        assert bool(rec["mesh/multihost"]) == (n > 1)
        assert bool(rec["mesh/bad_shape_raises"])


@pytest.mark.parametrize("name", ["g12", "g22"])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_windowed_hemm_matches_dense(groups, name, dtype):
    H, X, *_ = gw.problem(96, 9, np.dtype(dtype).type, 21)
    ref = H @ X
    for rec in groups[name].results():
        W = rec[f"hemm/{dtype}"]
        assert np.abs(W - ref).max() <= 1e-12 * np.abs(ref).max()


def _solve_cases():
    return [(name, case) for name in ("g11", "g12", "g22")
            for case, _ in gw.SOLVES[name]]


@pytest.mark.parametrize("name,case", _solve_cases())
def test_eigsh_matches_jax(groups, name, case):
    H, nev, nex, tol = gw.eig_problem(case)
    jres = chase_tpu.eigsh(
        H, nev, nex, tol=tol, grid=_jax_grid(SHAPES[name]),
        config=chase_tpu.ChaseConfig(complex_backend="native",
                                     mixed_precision=False))
    ranks = groups[name].results()
    rec = ranks[0]
    assert bool(rec[f"{case}/converged"]) and jres.converged
    ritzv = rec[f"{case}/ritzv"]
    np.testing.assert_allclose(ritzv, jres.ritzv, rtol=0,
                               atol=TOLS[H.dtype])
    V = rec[f"{case}/V"]
    true_res = np.linalg.norm(H @ V - V * ritzv, axis=0)
    assert true_res.max() <= 10 * tol
    assert abs(int(rec[f"{case}/iterations"])
               - int(rec[f"{case}/iterations0"])) <= 1
    for key in ("ritzv", "resid", "iterations", "locked", "ritzv_full",
                "V"):
        assert _all_equal(ranks, f"{case}/{key}"), key
    if name == "g11":
        np.testing.assert_array_equal(ritzv, rec[f"{case}/ritzv0"])


def test_eigsh_sequence_on_a_grid(groups):
    from chase_tpu_torch.models import hermitian_sequence
    ranks = groups["g12"].results()
    rec = ranks[0]
    seq = hermitian_sequence(96, 3, np.complex128, seed=17, drift=0.004)
    jres = list(chase_tpu.eigsh_sequence(
        iter(seq), 10, 8, tol=1e-9, grid=_jax_grid(SHAPES["g12"]),
        config=chase_tpu.ChaseConfig(complex_backend="native",
                                     mixed_precision=False),
        warmup=False))
    its, its0 = rec["sequence/iterations"], rec["sequence/iterations0"]
    assert np.all(np.abs(its - its0) <= 1)
    assert its[1] < its[0]                   # the warm start helps
    for H, ritzv, resid, jr in zip(seq, rec["sequence/ritzv"],
                                   rec["sequence/resid"], jres):
        assert jr.converged
        np.testing.assert_allclose(ritzv, jr.ritzv, rtol=0,
                                   atol=TOLS[np.dtype(np.complex128)])
        assert np.abs(ritzv - np.linalg.eigvalsh(H)[:10]).max() <= 1e-8
        assert resid.max() <= 1e-9
    for key in ("sequence/iterations", "sequence/ritzv"):
        assert _all_equal(ranks, key)


def check_bounds(ranks, shape):
    """Every rank's ``estimate_spectral_bounds(clement(128), nev=12,
    grid=…)`` against the exact spectrum, each deviation within 1.5 times
    the largest of ``chase_tpu.estimate_spectral_bounds(grid=…)``'s over
    three keys on the same grid shape (the two draw other probes), and
    equal to the port's ``grid=None`` estimate within 1e-12 (the same
    probes)."""
    from chase_tpu_torch.models import clement
    H, nev = clement(128), 12
    w = np.linalg.eigvalsh(H)
    exact = np.array([w[-1], w[0], w[nev - 1]])
    jgrid = _jax_grid(shape)
    jdev = np.max([np.abs([b["upperb"], b["lambda_min"], b["lowerb"]]
                          - exact)
                   for b in (chase_tpu.estimate_spectral_bounds(
                       H, nev=nev, grid=jgrid, key=jax.random.key(s))
                       for s in range(3))], axis=0)
    for rec in ranks:
        b, b0 = rec["bounds"], rec["bounds0"]
        upperb, lambda_min, lowerb = b
        assert upperb >= w[-1]
        assert w[0] - 1e-8 * np.abs(w).max() <= lambda_min <= w[nev - 1]
        assert np.all(np.abs(b - exact) <= 1.5 * jdev)
        np.testing.assert_allclose(b, b0, rtol=1e-12)
    assert _all_equal(ranks, "bounds")


@pytest.mark.parametrize("name", ["g11", "g12", "g22"])
def test_estimate_spectral_bounds_on_a_grid(groups, name):
    check_bounds(groups[name].results(), SHAPES[name])


def check_dtensor_padded(ranks):
    """A padded DTensor H's blocks, each built from its rank's shard
    without a gather: entry for entry the whole H's blocks, the phantom
    diagonal within N·ε of theirs (its row sums added in another order)
    and bitwise the same on every rank; the solve from it equal to the
    whole H's within ``conftest.TOLS``; a DTensor of another layout
    refused with ValueError."""
    for dtype in ("float32", "complex128"):
        eps = np.finfo(np.dtype(dtype)).eps
        pads = set()
        for rec in ranks:
            A, B = rec[f"dtpad/{dtype}"], rec[f"dtpad/{dtype}/whole"]
            assert A.shape == B.shape and A.dtype == B.dtype
            near = np.abs(A - B) <= 130 * eps * np.abs(B).max()
            assert np.all(near)
            off = A != B
            rows, cols = np.nonzero(off)
            if off.any():                    # only on the phantom diagonal
                i, j = (int(x) for x in rec["dtpad/coords"])
                g_r = rows + i * A.shape[0]
                g_c = cols + j * A.shape[1]
                assert np.all((g_r == g_c) & (g_r >= 130))
                pads.update(A[rows, cols].tolist())
        assert len(pads) <= 1
    for rec in ranks:
        np.testing.assert_allclose(rec["dtpad/ritzv"],
                                   rec["dtpad/ritzv/whole"], rtol=0,
                                   atol=TOLS[np.dtype(np.float64)])
    assert _all_equal(ranks, "dtpad/ritzv")
    assert all(bool(rec["dtpad/other_layout_raises"]) for rec in ranks)


def test_padded_dtensor_operator_is_not_gathered(groups):
    check_dtensor_padded(groups["g22"].results())


def check_ring_filter_2d(ranks, key, exact):
    """ring_filter True and None on the 2-D grid: the 2-D ring, 2 kernel
    steps per filter HEMM step on every rank, the same bits; False: the
    windowed filter, no kernel step; all converged near ``exact``."""
    for rec in ranks:
        for rf in ("True", "None", "False"):
            assert bool(rec[f"{key}/{rf}/converged"])
            assert np.abs(rec[f"{key}/{rf}/ritzv"] - exact).max() <= 1e-2
            hemms = int(rec[f"{key}/{rf}/hemm_steps"])
            assert hemms > 0
            assert int(rec[f"{key}/{rf}/steps"]) == (
                0 if rf == "False" else 2 * hemms)
        np.testing.assert_array_equal(rec[f"{key}/True/ritzv"],
                                      rec[f"{key}/None/ritzv"])
    assert _all_equal(ranks, f"{key}/True/ritzv")


def test_ring_filter_true_on_a_2d_grid_raises(groups):
    from chase_tpu_torch.models import clement_eigenvalues
    check_ring_filter_2d(groups["g22"].results(), "ring2d",
                         clement_eigenvalues(64)[:4])


def test_one_device_solvers_take_a_1x1_grid(groups):
    rec = groups["g11"].results()[0]
    np.testing.assert_array_equal(rec["fused11/ritzv"],
                                  rec["fused11/ritzv0"])
    assert int(rec["warmup/failed"]) == 0


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
def test_padded_operator_matches_jax(dtype):
    """N = 130 padded to 132 for a 4-rank grid: every entry of the padded
    operator equal to the JAX package's; the phantom diagonal (the
    Gershgorin bound, a 130-term row sum) within N·ε of it — XLA's CPU
    reduction adds in another order."""
    from chase_tpu_torch.models import random_hermitian
    from chase_tpu_torch.parallel.operator import block_of, gershgorin_pad
    H = random_hermitian(130, np.dtype(dtype).type, seed=8)
    Hj = np.asarray(chase_tpu.DenseOperator(H, grid=_jax_grid((4, 1))).H)
    pad = gershgorin_pad(H)
    Ht = block_of(H, (0, 132), (0, 132), 132, dtype=pad.dtype,
                  device="cpu", pad=pad).numpy()
    assert Ht.shape == Hj.shape == (132, 132)
    diag = np.arange(130, 132)
    rest = np.ones((132, 132), bool)
    rest[diag, diag] = False
    np.testing.assert_array_equal(Ht[rest], Hj[rest])
    eps = np.finfo(np.dtype(dtype)).eps
    np.testing.assert_allclose(Ht[diag, diag], Hj[diag, diag], rtol=0,
                               atol=130 * eps * abs(Hj[130, 130]))
    assert abs(Hj[130, 130]) > np.abs(np.linalg.eigvalsh(H)).max()
