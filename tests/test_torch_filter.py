"""The port's Chebyshev filters against the JAX package's.

* the p=1 ring filter (chase_tpu_torch/parallel/ring.py) against JAX
  ``chebyshev_filter_ring_pallas`` on a one-device grid, whose Pallas ring
  kernel runs in the TPU interpreter: f32, mixed degrees including 0;
  1e-5 relative per column (f32 recurrences, different summation orders)
  and degree-0 columns bit-exact;
* the plain filter, and the solvers' filter driver on the windowed route
  (torch.matmul, each step on its live suffix) against JAX's windowed
  filter (whole buckets) in f64: 1e-12 relative per column, never more
  column-steps than JAX's bucket plan;
* the p = 1 ring filters' live suffix (each step on the columns from the
  first one still below its degree, in whole W tiles) against the
  full-width recurrence (``torch_grid_worker.full_width_*``) on windows
  wider than a tile — classic, refine, H² and refine H², f32 on the
  kernel's route (128-column tiles) and f64 on torch.matmul (tile 1),
  sorted, unsorted and equal degrees after a pad of degree 0: 1e-5 / 1e-12
  relative per column, degree-0 columns bit-exact, every product as wide
  as its step's suffix; and the solvers' filter drivers' executed count
  and ``perf.COUNTS``' "filter_cols:*" against those widths, on the
  kernel's route and on torch.matmul (``parallel/ring.filter_product``).
"""

import functools

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

from chase_tpu_torch import perf as tperf
from chase_tpu_torch import solver as tsolver
from chase_tpu_torch.ops import ring_hemm as rh
from chase_tpu_torch.ops.filter import chebyshev_filter as t_filter
from chase_tpu_torch.parallel import ring as pring
from chase_tpu_torch.parallel.ring import (
    chebyshev_filter_ring_pallas as t_ring_filter)

import torch_grid_worker as gw

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
def test_segmented_filter_matches_jax_f64(widths, locked, B, dtype):
    """The port's filter driver on the windowed route (one device,
    torch.matmul, each step on its live suffix at tile 1) against JAX's
    solver._filter_windowed (whole B buckets retired): the same V (also
    with a complex carry), the locked columns bitwise, and the executed
    column-steps the live suffix's widths, never more than JAX's."""
    N, nevex = 160, 32
    H, V, lam1, lo, up = _problem(N, nevex, dtype, seed=3 + locked)
    rng = np.random.default_rng(locked)
    degrees = np.sort(2 * rng.integers(1, 7, nevex - locked)).astype(
        np.int64)
    Vj, exec_j = jsolver._filter_windowed(
        jnp.asarray(H), jnp.asarray(V), degrees, locked, nevex, B, lam1, lo,
        up, np.float64, "highest")
    Ht = torch.from_numpy(H)
    prod = pring.filter_product(None, Ht, None, False)
    Vt, exec_t, hemms = tsolver._filter_ring(
        Ht, torch.from_numpy(V.copy()), degrees, locked, nevex, B, lam1, lo,
        up, prod)
    w_pad, start = tsolver._window_pad(nevex, locked, B)
    deg_win = np.zeros(w_pad, np.int64)
    deg_win[locked - start:] = degrees
    assert widths == gw.suffix_widths(deg_win, 1, 1)
    assert exec_t == sum(widths) <= exec_j
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


# -- the live suffix ---------------------------------------------------------

N_SUF, W_SUF, PAD_SUF, DEG_SUF = 384, 320, 40, 7
# window dtype → W tile: f32 on the kernel's route, f64 on torch.matmul
SUF_TILE = {"f32": (np.float32, 128), "f64": (np.float64, 1)}
KINDS = {"filter": (1, 1), "refine": (2, 1), "h2": (1, 2),
         "refine_h2": (2, 2)}           # (first step, products a step)


@pytest.fixture
def widths(monkeypatch):
    """The width of every ring product, as the rings call their step (the
    kernel's wrapper, looked up at call time, or matmul_step)."""
    seen = []

    def recording(real):
        def step(H, V, **kw):
            seen.append(V.shape[1])
            return real(H, V, **kw)
        return step

    monkeypatch.setattr(rh, "ring_hemm", recording(rh.ring_hemm))
    monkeypatch.setattr(pring, "matmul_step", recording(pring.matmul_step))
    return seen


@functools.lru_cache(maxsize=None)
def _suffix_base(case, h2):
    """(H, X, λ₁, lower, upper) of a window wider than a tile; the
    H²-spectrum's interval with ``h2``."""
    H, X, lam1, lo, up = _problem(N_SUF, W_SUF, SUF_TILE[case][0], seed=31)
    if h2:
        mu = np.sort(np.linalg.eigvalsh(H.astype(np.float64)) ** 2)
        lam1, lo, up = float(mu[0]), float(mu[W_SUF]), float(mu[-1] * 1.01)
    return H, X, lam1, lo, up


def _suffix_problem(case, kind, degrees):
    """(H, the ring filter's inputs after H, the window's first input)
    for ``kind`` on a window of ``degrees``."""
    h2 = kind in ("h2", "refine_h2")
    H, X, lam1, lo, up = _suffix_base(case, h2)
    if kind in ("filter", "h2"):
        return torch.from_numpy(H), (torch.from_numpy(X), degrees, lam1, lo,
                                     up, DEG_SUF), X
    V, R, tabs, cc = gw.suffix_refine_inputs(H, X, degrees, lam1, lo, up,
                                             power=2 if h2 else 1)
    return torch.from_numpy(H), (torch.from_numpy(V), torch.from_numpy(R),
                                 degrees, *tabs, cc, DEG_SUF), V


def _ring_filter(kind, kernel):
    return {"filter": (t_ring_filter if kernel else
                       lambda H, *a: pring.chebyshev_filter_ring(None, H,
                                                                 *a)),
            "refine": lambda H, *a: pring.chebyshev_filter_refine_ring(
                H, *a, kernel=kernel),
            "h2": lambda H, *a: pring.chebyshev_filter_h2_ring(
                H, *a, kernel=kernel),
            "refine_h2": lambda H, *a: pring.chebyshev_filter_refine_h2_ring(
                H, *a, kernel=kernel)}[kind]


@pytest.mark.parametrize("degs", ["sorted", "unsorted", "equal"])
@pytest.mark.parametrize("case", list(SUF_TILE))
@pytest.mark.parametrize("kind", list(KINDS))
def test_ring_suffix_matches_full_width(widths, kind, case, degs):
    dt, tile = SUF_TILE[case]
    first, products = KINDS[kind]
    degrees = gw.suffix_degrees(degs, W_SUF, PAD_SUF, DEG_SUF)
    H, args, first_in = _suffix_problem(case, kind, degrees)
    kernel = H.dtype in rh.KERNEL_DTYPES
    Y = _ring_filter(kind, kernel)(H, *args).numpy()
    launched = list(widths)
    if kind in ("filter", "h2"):
        ref = gw.full_width_filter(H, *args, products=products)
    else:
        ref = gw.full_width_refine(H, *args, products=products)
    ref = ref.numpy()
    zero = degrees == 0
    assert _col_rel(Y[:, ~zero], ref[:, ~zero]) <= (
        1e-5 if dt == np.float32 else 1e-12)
    np.testing.assert_array_equal(Y[:, zero], first_in[:, zero])
    want = [w for w in gw.suffix_widths(degrees, first, tile)
            for _ in range(products)]
    assert launched == want
    full = W_SUF * (DEG_SUF - first + 1) * products
    assert sum(launched) < 0.8 * full if degs == "sorted" else (
        sum(launched) <= full)


def _counted(before):
    return {k: n - before.get(k, 0) for k, n in tperf.COUNTS.items()
            if k.startswith(tperf.FILTER_COLS)}


# the product's route → (problem, solve route, ring_backend="pallas"): the
# kernel's route on one device, and the windowed route on torch.matmul
DRIVER_ROUTES = {"kernel_f32": ("f32", "p1", True),
                 "matmul_f64": ("f64", None, False)}


@pytest.mark.parametrize("route", list(DRIVER_ROUTES))
@pytest.mark.parametrize("degs", ["sorted", "equal"])
@pytest.mark.parametrize("driver", ["filter", "refine", "refine_h2"])
def test_ring_driver_counts_its_suffix(widths, driver, degs, route):
    """solver._filter_ring and _filter_refine_windowed on the padded
    window (64-column buckets, 40 locked) with the product
    ``parallel/ring.filter_product`` picks — the kernel for an f32
    problem on the p = 1 route, torch.matmul for an f64 one on the
    windowed route —: every product as wide as its step's live suffix in
    the product's tile, the executed column-steps the launched widths,
    the HEMM calls the launches, and "filter_cols:executed" / ":useful"
    grow by the launched widths and by the columns live at each step."""
    case, ring_route, pallas = DRIVER_ROUTES[route]
    tile = SUF_TILE[case][1]
    nevex, locked, B = W_SUF, PAD_SUF, 64
    H, X, lam1, lo, up = _suffix_base(case, False)
    Ht = torch.from_numpy(H)
    prod = pring.filter_product(ring_route, Ht, None, pallas)
    assert (prod.kernel, prod.tile, prod.ring2d) == (pallas, tile, None)
    deg_win = gw.suffix_degrees(degs, W_SUF, PAD_SUF, DEG_SUF)
    deg_act = deg_win[locked:]
    w_pad, start = tsolver._window_pad(nevex, locked, B)
    assert (w_pad, start) == (W_SUF, 0)
    first, products = KINDS[driver]
    before = dict(tperf.COUNTS)
    if driver == "filter":
        _, executed, hemms = tsolver._filter_ring(
            Ht, torch.from_numpy(X), deg_act, locked, nevex, B, lam1, lo, up,
            prod)
    else:
        V, R, _, _ = gw.suffix_refine_inputs(
            H, X, np.zeros(nevex, np.int32), lam1, lo, up, deg_max=1)
        ritz = np.linspace(lam1, lo, nevex - locked)
        _, executed, hemms = tsolver._filter_refine_windowed(
            Ht, torch.from_numpy(V), torch.from_numpy(R), ritz, deg_act,
            locked, nevex, B, lam1, lo, up, DEG_SUF, prod, products)
    assert widths == [w for w in gw.suffix_widths(deg_win, first, tile)
                      for _ in range(products)]
    assert executed == sum(widths)
    assert hemms == len(widths) == (DEG_SUF - first + 1) * products
    live = np.maximum(deg_act.astype(np.int64) - (first - 1), 0).sum()
    assert _counted(before) == {"filter_cols:executed": executed,
                                "filter_cols:useful": live * products}
    full = w_pad * (DEG_SUF - first + 1) * products
    assert executed < full if degs == "sorted" else executed <= full


def test_live_suffixes_cover_every_live_column():
    """Each step's suffix starts at or left of every column still below
    its degree, on whole tiles from the right edge and never past column
    0, in any order of the degrees; a step with no live column ends the
    list."""
    rng = np.random.default_rng(7)
    for tile in (1, 64, 128):
        for _ in range(20):
            d = rng.integers(0, 9, rng.integers(1, 400))
            starts = pring.live_suffixes(d, 1, 12, tile)
            assert len(starts) == d.max()
            for t, s in enumerate(starts, 1):
                live = np.flatnonzero(d >= t)
                assert 0 <= s <= live[0]
                assert s == 0 or (d.size - s) % tile == 0
                assert s == 0 or s + tile > live[0]
