"""The port's p-step chunk ring on (p, 1) process grids against the JAX
package: ``ring_hemm(grid, …)``, the Hermitian and refine ring filters
and ``tsqr`` on (2, 1) and (4, 1) gloo grids.

The groups are started once for this module, as in
``tests/test_torch_grid.py`` (``tests/torch_grid_worker.py``, a hard time
limit each).  On the CPU every ring step is ``ring_hemm``'s plain version
(the tensors lie on the CPU); the steps are counted where the solver's
ring calls them.  Tolerances:

* ``ring_hemm(grid, H, V)`` against the dense product and
  ``chase_tpu.parallel.ring.ring_hemm`` on a (p, 1) mesh: 1e-5 of the
  largest entry in f32 and c64 (f32 sums of 96 terms in p chunks), 1e-12
  in f64; p steps per product;
* the ring filters at p > 1 against the port's p = 1 filters on the whole
  operator and against JAX's ``chebyshev_filter_ring`` /
  ``chebyshev_filter_refine_ring`` on a (p, 1) mesh: per column 1e-5 of
  its largest entry (f32 and c64 carries; the f64 window on its f32
  shadow), 1e-2 on the bf16 shadow (each product rounds its input to
  bf16, at other places than XLA); degree-0 columns bit-exact; p ring
  steps per HEMM step;
* ``tsqr`` on (4, 1): ‖QᴴQ − I‖ ≤ 1e-12 in f64, and R = QᴴV equal to
  ``chase_tpu.ops.qr.tsqr``'s up to the signs of its rows (the signs of
  Q's columns), within 1e-12 of its largest entry.

``eigsh`` on these grids is ``tests/test_torch_grid_solve.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chase_tpu
from chase_tpu.ops.qr import tsqr as j_tsqr
from chase_tpu.parallel import ring as jring

import torch_grid_worker as gw

torch.set_num_threads(1)

SHAPES = {"g21": (2, 1), "g41": (4, 1)}


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


def _rows(grid, a):
    return jax.device_put(jnp.asarray(a), grid.sharding("r", None))


def _col_rel(Y, ref):
    """max over columns of ‖Y_j − ref_j‖∞ / ‖ref_j‖∞."""
    num = np.abs(Y - ref).max(axis=0)
    den = np.maximum(np.abs(ref).max(axis=0), np.finfo(np.float64).tiny)
    return float((num / den).max())


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "complex64", "float64"])
def test_ring_hemm_matches_jax_and_dense(groups, name, dtype):
    p = SHAPES[name][0]
    H, X, *_ = gw.problem(gw.N_RING, gw.K_RING, np.dtype(dtype).type, 31)
    jgrid = _jax_grid(SHAPES[name])
    Wj = np.asarray(jring.ring_hemm(jgrid, _rows(jgrid, H), _rows(jgrid, X)))
    ref = H.astype(np.complex128) @ X.astype(np.complex128)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for rec in groups[name].results():
        W = rec[f"ring/{dtype}"]
        assert W.dtype == np.dtype(dtype)
        assert np.abs(W - ref).max() <= tol * np.abs(ref).max()
        assert np.abs(W - Wj).max() <= tol * np.abs(ref).max()
        # f32 and c64 take the kernel's step, f64 torch.matmul
        assert int(rec[f"ring/{dtype}/steps"]) == (0 if dtype == "float64"
                                                   else p)


def _jax_filter_inputs(case, jgrid):
    name, dt, shadow, seed = case
    H, X, lam1, lo, up = gw.problem(gw.N_FILT, gw.W_FILT, dt, seed)
    Hj = jnp.asarray(H) if shadow is None else jnp.asarray(
        H, getattr(jnp, shadow))
    Hj = jax.device_put(Hj, jgrid.sharding("r", None))
    return H, X, Hj, lam1, lo, up


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("case", gw.FILTER_CASES, ids=lambda c: c[0])
def test_ring_filter_matches_p1_and_jax(groups, name, case):
    p = SHAPES[name][0]
    jgrid = _jax_grid(SHAPES[name])
    H, X, Hj, lam1, lo, up = _jax_filter_inputs(case, jgrid)
    deg = gw.filter_degrees()
    Yj = np.asarray(jring.chebyshev_filter_ring(
        jgrid, Hj, _rows(jgrid, X), jnp.asarray(deg), lam1, lo, up,
        gw.DEG_FILT))
    tol = 1e-2 if case[2] == "bfloat16" else 1e-5
    for rec in groups[name].results():
        Y, Y1 = rec[f"filter/{case[0]}"], rec[f"filter/{case[0]}/p1"]
        assert Y.dtype == X.dtype
        assert _col_rel(Y[:, 3:], Y1[:, 3:]) <= tol
        assert _col_rel(Y[:, 3:], Yj[:, 3:]) <= tol
        np.testing.assert_array_equal(Y[:, :3], X[:, :3])
        assert int(rec[f"filter/{case[0]}/steps"]) == p * gw.DEG_FILT


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("case", gw.FILTER_CASES, ids=lambda c: c[0])
def test_refine_ring_filter_matches_p1_and_jax(groups, name, case):
    p = SHAPES[name][0]
    jgrid = _jax_grid(SHAPES[name])
    H, X, Hj, *_ = _jax_filter_inputs(case, jgrid)
    deg = gw.filter_degrees()
    V, R, tabs, cc = gw.refine_inputs(H, X, deg)
    Yj = np.asarray(jring.chebyshev_filter_refine_ring(
        jgrid, Hj, _rows(jgrid, V), _rows(jgrid, R), jnp.asarray(deg),
        *tabs, cc, gw.DEG_FILT))
    tol = 1e-2 if case[2] == "bfloat16" else 1e-5
    for rec in groups[name].results():
        Y, Y1 = rec[f"refine/{case[0]}"], rec[f"refine/{case[0]}/p1"]
        assert Y.dtype == V.dtype
        assert _col_rel(Y[:, 3:], Y1[:, 3:]) <= tol
        assert _col_rel(Y[:, 3:], Yj[:, 3:]) <= tol
        np.testing.assert_array_equal(Y[:, :3], V[:, :3])
        assert int(rec[f"refine/{case[0]}/steps"]) == p * (gw.DEG_FILT - 1)


@pytest.mark.parametrize("kind,k", [("tall", 10), ("wide", 30)])
def test_tsqr_matches_jax(groups, kind, k):
    rng = np.random.default_rng(41)
    V = rng.standard_normal((96, 10))
    if kind == "wide":
        V = rng.standard_normal((96, 30))
    jgrid = _jax_grid(SHAPES["g41"])
    Qj = np.asarray(j_tsqr(_rows(jgrid, V), grid=jgrid))
    Rj = Qj.T @ V
    for rec in groups["g41"].results():
        Q = rec[f"tsqr/{kind}"]
        assert np.abs(Q.T @ Q - np.eye(k)).max() <= 1e-12
        R = Q.T @ V
        signs = np.sign(np.diag(R)) * np.sign(np.diag(Rj))
        assert np.abs(signs[:, None] * R - Rj).max() \
            <= 1e-12 * np.abs(Rj).max()
