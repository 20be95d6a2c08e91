"""The port's Chebyshev filters against the JAX package's.

* the p=1 ring filter (chase_tpu_torch/parallel/ring.py) against JAX
  ``chebyshev_filter_ring_pallas`` on a one-device grid, whose Pallas ring
  kernel runs in the TPU interpreter: f32, mixed degrees including 0;
  1e-5 relative per column (f32 recurrences, different summation orders)
  and degree-0 columns bit-exact;
* the plain filter and the solver's segmented (bucket-shrinking) filter
  against JAX's in f64: 1e-12 relative per column.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chase_tpu
from chase_tpu import solver as jsolver
from chase_tpu.ops.filter import chebyshev_filter as j_filter
from chase_tpu.parallel.ring import (
    chebyshev_filter_ring_pallas as j_ring_filter)

from chase_tpu_torch import solver as tsolver
from chase_tpu_torch.ops.filter import chebyshev_filter as t_filter
from chase_tpu_torch.parallel.ring import (
    chebyshev_filter_ring_pallas as t_ring_filter)

torch.set_num_threads(1)


def _problem(N, k, dtype, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N))
    X = rng.standard_normal((N, k))
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((N, N))
        X = X + 1j * rng.standard_normal((N, k))
    H = ((A + A.conj().T) / 2).astype(dtype)
    X = X.astype(dtype)
    w = np.linalg.eigvalsh(H.astype(np.float64))
    return H, X, float(w[0]), float(w[k]), float(w[-1])


def _col_rel(Y, ref):
    """max over columns of ‖Y_j − ref_j‖∞ / ‖ref_j‖∞."""
    num = np.abs(Y - ref).max(axis=0)
    den = np.maximum(np.abs(ref).max(axis=0), np.finfo(np.float64).tiny)
    return float((num / den).max())


@pytest.mark.parametrize("deg_max", [10, 7], ids=["even", "odd"])
def test_ring_filter_p1_matches_jax_pallas_ring(deg_max):
    N, k = 256, 24
    H, X, lam1, lo, up = _problem(N, k, np.float32, seed=0)
    degrees = np.full(k, deg_max, np.int32)
    degrees[:3] = 0                          # locked / padding columns
    degrees[3:9] = 4                         # retired early
    degrees[9:12] = 1
    grid = chase_tpu.make_grid(jax.devices()[:1], shape=(1, 1))
    Hs = jax.device_put(jnp.asarray(H), grid.sharding("r", None))
    Xs = jax.device_put(jnp.asarray(X), grid.sharding("r", None))
    Yj = np.asarray(j_ring_filter(grid, Hs, Xs, jnp.asarray(degrees),
                                  lam1, lo, up, deg_max))
    Yt = t_ring_filter(torch.from_numpy(H), torch.from_numpy(X), degrees,
                       lam1, lo, up, deg_max)
    assert Yt.dtype == torch.float32
    Yt = Yt.numpy()
    assert _col_rel(Yt[:, 3:], Yj[:, 3:]) <= 1e-5
    np.testing.assert_array_equal(Yt[:, :3], X[:, :3])
    np.testing.assert_array_equal(Yt[:, :3], Yj[:, :3])


def test_ring_filter_on_a_column_window_of_the_block():
    """The solver hands the ring filter a column view (row stride > width);
    the result equals filtering a contiguous copy."""
    N, k = 96, 40
    H, X, lam1, lo, up = _problem(N, k, np.float32, seed=1)
    degrees = np.full(16, 6, np.int32)
    Ht, Xt = torch.from_numpy(H), torch.from_numpy(X)
    Yv = t_ring_filter(Ht, Xt[:, 20:36], degrees, lam1, lo, up, 6)
    Yc = t_ring_filter(Ht, Xt[:, 20:36].contiguous(), degrees, lam1, lo,
                       up, 6)
    assert torch.equal(Yv, Yc)


def test_ring_filter_rejects_mixed_dtypes():
    H = torch.zeros((8, 8), dtype=torch.float64)
    X = torch.zeros((8, 2), dtype=torch.float32)
    with pytest.raises(TypeError):
        t_ring_filter(H, X, np.ones(2, np.int32), -1.0, 0.0, 1.0, 1)


def test_plain_filter_matches_jax_f64():
    N, k = 128, 16
    H, X, lam1, lo, up = _problem(N, k, np.float64, seed=2)
    degrees = np.asarray([0, 2, 4, 4, 6, 6, 8, 9, 10, 10, 10, 10, 12, 12,
                          12, 12], np.int32)
    Yj = np.asarray(j_filter(jnp.asarray(H), jnp.asarray(X),
                             jnp.asarray(degrees), lam1, lo, up,
                             jnp.int32(12)))
    Yt = t_filter(torch.from_numpy(H), torch.from_numpy(X), degrees, lam1,
                  lo, up, 12).numpy()
    assert _col_rel(Yt, Yj) <= 1e-12
    np.testing.assert_array_equal(Yt[:, 0], X[:, 0])


@pytest.mark.parametrize("locked,B,dtype", [(0, 8, np.float64),
                                            (5, 8, np.float64),
                                            (13, 4, np.float64),
                                            (5, 8, np.complex128)],
                         ids=["unlocked", "locked5", "locked13_B4",
                              "locked5_c128"])
def test_segmented_filter_matches_jax_f64(locked, B, dtype):
    """solver._filter_windowed in both packages: same bucket plan, same
    shrinking windows, same executed column-steps, same V (also with a
    complex carry)."""
    N, nevex = 160, 32
    H, V, lam1, lo, up = _problem(N, nevex, dtype, seed=3 + locked)
    rng = np.random.default_rng(locked)
    degrees = np.sort(2 * rng.integers(1, 7, nevex - locked)).astype(
        np.int64)
    Vj, exec_j = jsolver._filter_windowed(
        jnp.asarray(H), jnp.asarray(V), degrees, locked, nevex, B, lam1, lo,
        up, np.float64, "highest")
    Vt, exec_t, hemms = tsolver._filter_windowed(
        torch.from_numpy(H), torch.from_numpy(V.copy()), degrees, locked,
        nevex, B, lam1, lo, up)
    assert exec_t == exec_j
    assert hemms == int(degrees.max())
    assert _col_rel(Vt.numpy(), np.asarray(Vj)) <= 1e-12
    np.testing.assert_array_equal(Vt.numpy()[:, :locked], V[:, :locked])


def test_ring_filter_equals_plain_filter_on_cpu():
    """On the CPU both run torch.matmul: the ring recurrence and the plain
    recurrence agree to f64 rounding."""
    N, k = 128, 12
    H, X, lam1, lo, up = _problem(N, k, np.float64, seed=9)
    degrees = np.asarray([0, 3, 5, 5, 7, 9, 9, 9, 9, 9, 9, 9], np.int32)
    Ht, Xt = torch.from_numpy(H).float(), torch.from_numpy(X).float()
    Yr = t_ring_filter(Ht, Xt, degrees, lam1, lo, up, 9).double().numpy()
    Yp = t_filter(Ht, Xt, degrees, lam1, lo, up, 9).double().numpy()
    assert _col_rel(Yr, Yp) <= 1e-5
