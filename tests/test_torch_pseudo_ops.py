"""The pseudo-Hermitian (BSE) ops of the port against the JAX package's.

Every test makes its inputs with numpy from a seed and hands the same
arrays to both packages (JAX with x64 on, on the CPU).  Tolerances:

* generators, ``scale_lower_rows``, ``apply_s``, ``flip_locked_cols``,
  ``k_conjugate_cols`` and the host bookkeeping: exact;
* the H² filters (whole, the solver's windowed route, deviation form,
  p = 1 ring) per column relative to the column's largest entry: 1e-12
  in f64/c128 (the same recurrence, products summed in another order),
  1e-4 in f32/c64 and on an f32/c64 shadow (twice as many f32 products
  per step as the Hermitian filter's 1e-5 covers, amplified by the
  polynomial); degree-0 columns bit-exact;
  on a bf16 shadow against JAX: 1e-2 (each step rounds two f32
  intermediates to bf16, and one that differs from JAX's in its last bit
  rounds to the other bf16 neighbour, 2^-9 of it, which the polynomial
  amplifies);
* ``h2_residual``: 1e-12 of the largest entry (f64); ``lanczos_scan_pseudo``
  alphas and betas: 1e-10 relative (f64/c128, m = 16 steps);
* the pencil Rayleigh–Ritz: Ritz values within 1e-10, residual norms
  within 1e-9 absolute, the same ``ok``; Ritz vectors within 1e-8 once
  their sign (phase) is aligned; in f32: values within 1e-5;
* ``orthonormalize_pseudo``: S-orthogonality to the flipped locked columns
  to 1e-12, Q within 1e-10 of JAX's Q (CholQR is unique).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chase_tpu import config as jconfig
from chase_tpu import models as jmodels
from chase_tpu import solver as jsolver
from chase_tpu import solver_pseudo as jsp
from chase_tpu.ops import blocks as jblocks
from chase_tpu.ops import checks as jchecks
from chase_tpu.ops import filter as jfilt
from chase_tpu.ops import pseudo as jps
from chase_tpu.ops import qr as jqr

import chase_tpu_torch as ct
from chase_tpu_torch import models as tmodels
from chase_tpu_torch import solver as tsolver
from chase_tpu_torch import solver_pseudo as tsp
from chase_tpu_torch.ops import blocks as tblocks
from chase_tpu_torch.ops import checks as tchecks
from chase_tpu_torch.ops import filter as tfilt
from chase_tpu_torch.ops import pseudo as tps
from chase_tpu_torch.ops import qr as tqr
from chase_tpu_torch.ops import ring_hemm as trh
from chase_tpu_torch.parallel import ring as tring

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
DT_IDS = ["f32", "f64", "c64", "c128"]
DEGS = np.array([4, 6, 8, 8, 10, 12, 0, 8, 2, 14], np.int32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    x = jnp.asarray(np.asarray(a))
    return x if dtype is None else x.astype(dtype)


def _cplx(dtype):
    return np.issubdtype(np.dtype(dtype), np.complexfloating)


def _randn(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if _cplx(dtype):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _col_rel(Y, ref):
    """max over columns of ‖Y_j − ref_j‖∞ / ‖ref_j‖∞."""
    Y, ref = np.asarray(Y), np.asarray(ref)
    num = np.abs(Y - ref).max(axis=0)
    den = np.maximum(np.abs(ref).max(axis=0), np.finfo(np.float64).tiny)
    return float((num / den).max())


def _filter_case(N, w, dtype, seed):
    """A BSE H (upper and lower halves differ), a unit-column block X and
    an H²-space interval from H's spectrum: (H, X, μ₁, lower, b_sup)."""
    H = jmodels.random_pseudo_hermitian(N, np.complex128 if _cplx(dtype)
                                        else np.float64, seed=seed)
    rng = np.random.default_rng(seed)
    X = _randn(rng, (N, w), np.complex128 if _cplx(dtype) else np.float64)
    X /= np.linalg.norm(X, axis=0)
    ev2 = np.sort(np.abs(np.linalg.eigvals(H)) ** 2)
    return H.astype(dtype), X.astype(dtype), ev2[0] * 0.9, ev2[N // 3], \
        ev2[-1] * 1.01


def _tol(dtype):
    return 1e-12 if np.dtype(dtype) in (np.float64, np.complex128) else 1e-4


# ---- generators and glue ops: exact -----------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_random_pseudo_hermitian_is_the_jax_packages(dtype):
    np.testing.assert_array_equal(
        tmodels.random_pseudo_hermitian(64, dtype, seed=3, coupling=0.3),
        jmodels.random_pseudo_hermitian(64, dtype, seed=3, coupling=0.3))


def test_structured_pseudo_hermitian_is_the_jax_packages():
    Ht, lt = tmodels.structured_pseudo_hermitian(60, seed=2)
    Hj, lj = jmodels.structured_pseudo_hermitian(60, seed=2)
    np.testing.assert_array_equal(Ht, Hj)
    np.testing.assert_array_equal(lt, lj)
    with pytest.raises(ValueError):
        tmodels.structured_pseudo_hermitian(61)
    with pytest.raises(ValueError):
        tmodels.structured_pseudo_hermitian(60, np.complex128)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_scale_lower_rows_bit_exact(dtype):
    V = _randn(np.random.default_rng(0), (30, 7), dtype)
    np.testing.assert_array_equal(
        tblocks.scale_lower_rows(_t(V), 0.001).numpy(),
        np.asarray(jblocks.scale_lower_rows(_j(V), 0.001)))


@pytest.mark.parametrize("dtype", [np.float64, np.complex64],
                         ids=["f64", "c64"])
def test_apply_s_and_flip_locked_cols_bit_exact(dtype):
    V = _randn(np.random.default_rng(1), (40, 9), dtype)
    np.testing.assert_array_equal(tps.apply_s(_t(V)).numpy(),
                                  np.asarray(jps.apply_s(_j(V))))
    for nflip in (0, 3, 9):
        Vt = _t(V)
        out = tps.flip_locked_cols(Vt, nflip).numpy()
        np.testing.assert_array_equal(
            out, np.asarray(jps.flip_locked_cols(_j(V), jnp.int32(nflip))))
        np.testing.assert_array_equal(Vt.numpy(), V)      # input untouched


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_k_conjugate_cols_bit_exact_and_materialized(dtype):
    V = _randn(np.random.default_rng(2), (20, 8), dtype)
    src = np.array([0, 1, 2, 3, 1, 2, 6, 0])
    mask = np.array([0, 0, 0, 0, 1, 1, 0, 1], bool)
    out = tps.k_conjugate_cols(_t(V), src, mask)
    assert not out.is_conj() and not out.is_neg()
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jps.k_conjugate_cols(_j(V), _j(src),
                                                     _j(mask))))
    np.testing.assert_array_equal(
        tps.k_conjugate_cols(_t(V), src, np.zeros(8, bool)).numpy(), V)


def test_k_conjugation_maps_eigenvectors():
    """tests/test_pseudo.py's check: K x of the eigenvector of λ is the
    eigenvector of −λ."""
    H = tmodels.random_pseudo_hermitian(60, np.complex128, seed=1)
    w, X = np.linalg.eig(H)
    i = np.argsort(np.abs(w.real))[0]
    V = np.zeros((60, 2), np.complex128)
    V[:, 0] = X[:, i]
    kx = tps.k_conjugate_cols(_t(V), np.array([0, 0]),
                              np.array([False, True])).numpy()[:, 1]
    r = H @ kx + w[i].real * kx
    assert np.linalg.norm(r) / np.linalg.norm(kx) < 1e-10


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_check_pseudo_hermitian_agrees_with_jax(dtype):
    H = tmodels.random_pseudo_hermitian(80, dtype, seed=4)
    bad = H.copy()
    bad[3, 50] += 0.5
    for M, want in ((H, True), (bad, False)):
        assert tchecks.check_pseudo_hermitian(_t(M)) is want
        assert jchecks.check_pseudo_hermitian(_j(M)) is want
    # a Hermitian (not S-pseudo-Hermitian) matrix fails the probe
    A = tmodels.random_hermitian(80, dtype, seed=4)
    assert not tchecks.check_pseudo_hermitian(_t(A))


# ---- the H² filter ------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_chebyshev_filter_h2_matches_jax(dtype):
    H, X, lam1, lo, up = _filter_case(96, len(DEGS), dtype, seed=7)
    dmax = int(DEGS.max())
    # the interval may come in either order, as in the JAX package
    Yt = tps.chebyshev_filter_h2(_t(H), _t(X), DEGS, lam1, up, lo,
                                 dmax).numpy()
    Yj = np.asarray(jps.chebyshev_filter_h2(_j(H), _j(X), _j(DEGS), lam1, lo,
                                            up, dmax))
    assert Yt.dtype == dtype
    act = DEGS > 0
    assert _col_rel(Yt[:, act], Yj[:, act]) <= _tol(dtype)
    np.testing.assert_array_equal(Yt[:, ~act], X[:, ~act])


@pytest.mark.parametrize("problem,shadow,tol", [
    (np.float64, np.float32, 1e-4), (np.complex128, np.complex64, 1e-4),
    (np.float32, "bf16", 1e-2)], ids=["f32_shadow_f64", "c64_shadow_c128",
                                      "bf16_shadow_f32"])
def test_chebyshev_filter_h2_on_a_shadow_matches_jax(problem, shadow, tol):
    """The carry follows filter_carry_dtype: the shadow's for f32/c64,
    X's f32 for bf16 (whose intermediate H·X is rounded to bf16 before
    the second product)."""
    H, X, lam1, lo, up = _filter_case(96, len(DEGS), problem, seed=8)
    ts, js = ((torch.bfloat16, jnp.bfloat16) if shadow == "bf16"
              else (_t(np.zeros(1, shadow)).dtype, shadow))
    dmax = int(DEGS.max())
    Yt = tps.chebyshev_filter_h2(_t(H, ts), _t(X), DEGS, lam1, lo, up,
                                 dmax).numpy()
    Yj = np.asarray(jps.chebyshev_filter_h2(_j(H, js), _j(X), _j(DEGS), lam1,
                                            lo, up, dmax))
    assert Yt.dtype == problem
    act = DEGS > 0
    assert _col_rel(Yt[:, act], Yj[:, act]) <= tol
    np.testing.assert_array_equal(Yt[:, ~act], X[:, ~act])


def test_h2_carry_init_and_steps_match_jax():
    """JAX's h2_carry_init/h2_steps (steps 1…8) against the path the
    port's solver runs for them: parallel/ring's H² recurrence on
    torch.matmul, each step on its live suffix (the degrees unsorted, so
    the suffix keeps the whole window) — the same iterate, degree-0
    columns bitwise."""
    H, X, lam1, lo, up = _filter_case(80, len(DEGS), np.float64, seed=9)
    c, e = np.float64((up + lo) / 2), np.float64((up - lo) / 2)
    sigma1 = e / (np.float64(lam1) - c)
    _, Yj, sj = jps.h2_carry_init(_j(H), _j(X), _j(DEGS), c, e, sigma1)
    _, Yj, sj = jps.h2_steps(_j(H), _j(X), Yj, _j(DEGS), sj, sigma1, c, e,
                             2, 9)
    Yt = tring.chebyshev_filter_h2_ring(_t(H), _t(X), DEGS, lam1, lo, up, 8,
                                        kernel=False).numpy()
    act = DEGS > 0
    assert _col_rel(Yt[:, act], np.asarray(Yj)[:, act]) <= 1e-12
    np.testing.assert_array_equal(Yt[:, ~act], X[:, ~act])


@pytest.mark.parametrize("problem,shadow,tol", [
    (np.float64, np.float64, 1e-12), (np.complex128, np.complex128, 1e-12),
    (np.float32, np.float32, 1e-4), (np.complex64, np.complex64, 1e-4),
    (np.float64, np.float32, 1e-4)],
    ids=["f64", "c128", "f32", "c64", "f32_shadow"])
def test_segmented_h2_filter_matches_jax(problem, shadow, tol):
    """The H² filter on the windowed route — the port's
    solver._filter_ring with two products a step on torch.matmul, each
    step on its live suffix, JAX's solver_pseudo._h2_filter_windowed — on
    a window whose bucket plan retires two of JAX's buckets (shrinks
    twice) with 5 locked columns inside its first bucket; the port counts
    two products per step, where the JAX solver doubles the executed
    column-steps at its call, and executes fewer than JAX's plan."""
    N, nevex, locked, B = 150, 32, 5, 8
    H, V, lam1, lo, up = _filter_case(N, nevex, problem, seed=10)
    degs = np.array([2] * 3 + [4] * 8 + [6] * 16, np.int32)
    deg_win = np.concatenate([np.zeros(locked, np.int32), degs])
    assert len(jsolver._shrink_plan(deg_win, B, nevex)) == 3
    Hs = _t(H.astype(shadow))
    Vt, ex_t, steps = tsolver._filter_ring(
        Hs, _t(V.copy()), degs, locked, nevex, B, lam1, lo, up,
        tring.filter_product(None, Hs, None, False), 2)
    Vj, ex_j = jsp._h2_filter_windowed(
        _j(H.astype(shadow)), _j(V.copy()), deg_win, 0, B, nevex, lam1, lo,
        up, "highest")
    live = [int(np.sum(deg_win >= t)) for t in range(1, 7)]
    assert ex_t == 2 * sum(live) < 2 * ex_j
    assert steps == 2 * int(deg_win.max())
    assert _col_rel(Vt.numpy()[:, locked:], np.asarray(Vj)[:, locked:]) <= tol
    np.testing.assert_array_equal(Vt.numpy()[:, :locked], V[:, :locked])


def _refine_case(N, w, dtype, seed):
    """A BSE H, its window V, expansion points θ, the H²-residuals
    R2 = H²V − Vθ² and the H²-space tables."""
    H, V, lam1, lo, up = _filter_case(N, w, dtype, seed)
    theta = np.random.default_rng(seed).uniform(np.sqrt(lam1) * 1.1,
                                                np.sqrt(lo), w)
    H64 = H.astype(np.complex128 if _cplx(dtype) else np.float64)
    R2 = H64 @ (H64 @ V) - V * (theta ** 2)[None, :]
    tabs = tfilt.refine_tables(theta ** 2, DEGS[:w], lam1, lo, up, 36)
    return H, V, R2.astype(V.dtype), theta, tabs, (up + lo) / 2.0


@pytest.mark.parametrize("problem,shadow,tol", [
    (np.float64, np.float64, 1e-12), (np.complex128, np.complex128, 1e-12),
    (np.float64, np.float32, 1e-4), (np.complex128, np.complex64, 1e-4),
    (np.float32, "bf16", 1e-2)],
    ids=["f64", "c128", "f32_shadow", "c64_shadow", "bf16_shadow"])
def test_chebyshev_filter_refine_h2_matches_jax(problem, shadow, tol):
    H, V, R2, theta, tabs, cc = _refine_case(96, len(DEGS), problem, seed=11)
    ts, js = ((torch.bfloat16, jnp.bfloat16) if shadow == "bf16"
              else (_t(np.zeros(1, shadow)).dtype, shadow))
    dmax = int(DEGS.max())
    Yt = tps.chebyshev_filter_refine_h2(_t(H, ts), _t(V), _t(R2), DEGS,
                                        *tabs, cc, dmax).numpy()
    Yj = np.asarray(jps.chebyshev_filter_refine_h2(
        _j(H, js), _j(V), _j(R2), _j(DEGS), *tabs, cc, dmax))
    act = DEGS > 0
    assert _col_rel(Yt[:, act], Yj[:, act]) <= tol
    np.testing.assert_array_equal(Yt[:, ~act], V[:, ~act])


@pytest.mark.parametrize("shadow,tol", [(np.float64, 1e-12),
                                        (np.float32, 1e-4)],
                         ids=["f64", "f32_shadow"])
def test_segmented_refine_h2_matches_jax(shadow, tol):
    """The deviation-form H² filter on the windowed route — the port's
    solver._filter_refine_windowed with two products a step on
    torch.matmul, each step on its live suffix, seeded by the H-residuals
    through h2_residual and θ², JAX's solver_pseudo._h2_refine_windowed
    on the same seed — on a window whose plan shrinks JAX's twice, with 5
    locked columns in the first bucket."""
    N, nevex, locked, B = 150, 32, 5, 8
    H, V, lam1, lo, up = _filter_case(N, nevex, np.float64, seed=12)
    degs = np.array([2] * 3 + [4] * 8 + [6] * 16, np.int32)
    deg_win = np.concatenate([np.zeros(locked, np.int32), degs])
    theta = np.linspace(np.sqrt(lam1) * 1.1, np.sqrt(lo), nevex)
    theta[:locked] = 0.0                   # the driver pads locked slots
    R = H @ V - V * theta[None, :]
    Ht, Hs = _t(H), _t(H.astype(shadow))
    Vt, ex_t, hemms = tsolver._filter_refine_windowed(
        Hs, _t(V.copy()), _t(R), theta[locked:], degs, locked, nevex, B,
        lam1, lo, up, 36, tring.filter_product(None, Hs, None, False), 2,
        seed=lambda Rw, th: (tps.h2_residual(Ht, Rw, th), th ** 2))
    tabs = tfilt.refine_tables(theta ** 2, deg_win, lam1, lo, up, 36)
    R2 = jps.h2_residual(_j(H), _j(R), _j(theta))
    Vj, ex_j = jsp._h2_refine_windowed(
        _j(H.astype(shadow)), _j(V.copy()), _j(V.copy()), R2, deg_win, 0,
        B, nevex, *tabs, (up + lo) / 2.0, "highest")
    live = [int(np.sum(deg_win >= t)) for t in range(2, 7)]
    assert ex_t == 2 * sum(live) < 2 * ex_j
    assert hemms == 2 * (int(deg_win.max()) - 1)
    assert _col_rel(Vt.numpy()[:, locked:], np.asarray(Vj)[:, locked:]) <= tol
    np.testing.assert_array_equal(Vt.numpy()[:, :locked], V[:, :locked])


def test_refine_h2_equals_the_direct_h2_filter_in_f64():
    """tests/test_ladder_pseudo.py's algebraic check on the port: the
    deviation form reproduces the direct H² filter to 1e-12."""
    H, V, lam1, lo, up = _filter_case(128, len(DEGS), np.float64, seed=3)
    theta = np.random.default_rng(3).uniform(0.5, 3.0, len(DEGS))
    R2 = H @ (H @ V) - V * (theta ** 2)[None, :]
    tabs = tfilt.refine_tables(theta ** 2, DEGS, lam1, lo, up, 36)
    dmax = int(DEGS.max())
    Yr = tps.chebyshev_filter_refine_h2(_t(H), _t(V), _t(R2), DEGS, *tabs,
                                        (up + lo) / 2.0, dmax).numpy()
    Yd = tps.chebyshev_filter_h2(_t(H), _t(V), DEGS, lam1, lo, up,
                                 dmax).numpy()
    assert _col_rel(Yr, Yd) <= 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_h2_residual_matches_jax_and_the_factorization(dtype):
    H = tmodels.random_pseudo_hermitian(96, dtype, seed=5)
    rng = np.random.default_rng(5)
    V = _randn(rng, (96, 5), dtype)
    theta = rng.uniform(0.5, 2.0, 5)
    R = H @ V - V * theta[None, :]
    R2t = tps.h2_residual(_t(H), _t(R), theta).numpy()
    R2j = np.asarray(jps.h2_residual(_j(H), _j(R), _j(theta)))
    direct = H @ (H @ V) - V * (theta ** 2)[None, :]
    scale = np.abs(direct).max()
    assert np.abs(R2t - R2j).max() <= 1e-12 * scale
    assert np.abs(R2t - direct).max() <= 1e-12 * scale


# ---- the p = 1 H² rings against the JAX filters -----------------------------

def _count_ring_calls(monkeypatch):
    calls = []
    real = trh.ring_hemm
    monkeypatch.setattr(trh, "ring_hemm",
                        lambda *a, **k: calls.append(a[0].dtype)
                        or real(*a, **k))
    return calls


@pytest.mark.parametrize("problem,shadow,tol", [
    (np.float32, None, 1e-4), (np.complex64, None, 1e-4),
    (np.float64, np.float32, 1e-4), (np.complex128, np.complex64, 1e-4),
    (np.float32, "bf16", 1e-2)],
    ids=["f32", "c64", "f32_shadow", "c64_shadow", "bf16_shadow"])
def test_h2_ring_matches_jax_filter(problem, shadow, tol, monkeypatch):
    """The p = 1 H² ring on the CPU (every product through ring_hemm's
    plain version) against JAX's chebyshev_filter_h2 on the same operator:
    two ring_hemm calls per step, degree-0 columns bit-exact."""
    H, X, lam1, lo, up = _filter_case(96, len(DEGS), problem, seed=13)
    if shadow is None:
        ts, js = _t(H).dtype, problem
    elif shadow == "bf16":
        ts, js = torch.bfloat16, jnp.bfloat16
    else:
        ts, js = _t(np.zeros(1, shadow)).dtype, shadow
    calls = _count_ring_calls(monkeypatch)
    dmax = int(DEGS.max())
    Yt = tring.chebyshev_filter_h2_ring(_t(H, ts), _t(X), DEGS, lam1, lo, up,
                                        dmax).numpy()
    Yj = np.asarray(jps.chebyshev_filter_h2(_j(H, js), _j(X), _j(DEGS), lam1,
                                            lo, up, dmax))
    assert len(calls) == 2 * dmax and set(calls) == {ts}
    act = DEGS > 0
    assert _col_rel(Yt[:, act], Yj[:, act]) <= tol
    np.testing.assert_array_equal(Yt[:, ~act], X[:, ~act])


@pytest.mark.parametrize("problem,shadow,tol", [
    (np.float64, np.float32, 1e-4), (np.complex128, np.complex64, 1e-4),
    (np.float32, "bf16", 1e-2)],
    ids=["f32_shadow", "c64_shadow", "bf16_shadow"])
def test_refine_h2_ring_matches_jax_refine(problem, shadow, tol,
                                           monkeypatch):
    H, V, R2, theta, tabs, cc = _refine_case(96, len(DEGS), problem, seed=14)
    ts, js = ((torch.bfloat16, jnp.bfloat16) if shadow == "bf16"
              else (_t(np.zeros(1, shadow)).dtype, shadow))
    calls = _count_ring_calls(monkeypatch)
    dmax = int(DEGS.max())
    Yt = tring.chebyshev_filter_refine_h2_ring(_t(H, ts), _t(V), _t(R2),
                                               DEGS, *tabs, cc, dmax).numpy()
    Yj = np.asarray(jps.chebyshev_filter_refine_h2(
        _j(H, js), _j(V), _j(R2), _j(DEGS), *tabs, cc, dmax))
    assert len(calls) == 2 * (dmax - 1)
    act = DEGS > 0
    assert _col_rel(Yt[:, act], Yj[:, act]) <= tol
    np.testing.assert_array_equal(Yt[:, ~act], V[:, ~act])


@pytest.mark.parametrize("dtype", [np.float32, np.complex64],
                         ids=["f32", "c64"])
def test_h2_ring_reads_no_symmetry(dtype):
    """One degree-1 step of the H² ring on a BSE H whose upper and lower
    halves differ is (σ1/e)·(H·(H·X) − c·X) — held against the plain
    H @ (H @ X) in f64, 1e-5 of the largest entry."""
    H, X, lam1, lo, up = _filter_case(64, 5, dtype, seed=15)
    n = 32
    assert np.abs(H[:n, :n] - H[n:, n:]).max() > 0.1
    deg = np.ones(5, np.int32)
    Y = tring.chebyshev_filter_h2_ring(_t(H), _t(X), deg, lam1, lo, up,
                                       1).numpy()
    c, e = (up + lo) / 2, (up - lo) / 2
    H64 = H.astype(np.complex128 if _cplx(dtype) else np.float64)
    ref = (e / (lam1 - c) / e) * (H64 @ (H64 @ X) - c * X)
    assert np.abs(Y - ref).max() <= 1e-5 * np.abs(ref).max()


# ---- S-Lanczos -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_lanczos_scan_pseudo_matches_jax(dtype):
    N = 120
    H = tmodels.random_pseudo_hermitian(N, dtype, seed=3)
    V0 = _randn(np.random.default_rng(0), (N, 4), dtype)
    V0[N // 2:] *= 0.001
    at, bt, Bt = tps.lanczos_scan_pseudo(_t(H), _t(V0), m=16)
    aj, bj, Bj = jps.lanczos_scan_pseudo(_j(H), _j(V0), m=16)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-10)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-10)
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), atol=1e-10)
    _, _, none = tps.lanczos_scan_pseudo(_t(H), _t(V0), m=4,
                                         want_basis=False)
    assert none is None


# ---- the pencil Rayleigh–Ritz -------------------------------------------------

def _pencil_block(N, K2, dtype, seed, noise=1e-3):
    """An orthonormal block spanning the eigenvectors of the K2/2
    |λ|-smallest ± pairs plus ``noise``, and those pairs' eigenvalues in
    the block's column order."""
    H = tmodels.random_pseudo_hermitian(N, np.complex128 if _cplx(dtype)
                                        else np.float64, seed=seed)
    w, X = np.linalg.eig(H)
    order = np.argsort(np.abs(w.real))[:K2]
    rng = np.random.default_rng(seed)
    Q = X[:, order] + noise * _randn(rng, (N, K2), np.complex128)
    Q = Q if _cplx(dtype) else Q.real
    Q, _ = np.linalg.qr(Q)
    return H.astype(dtype), Q.astype(dtype), w.real[order]


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("locked", [0, 2])
def test_rayleigh_ritz_residuals_pseudo_matches_jax(dtype, locked):
    H, Q, lam = _pencil_block(96, 16, dtype, seed=2, noise=1e-4)
    Vt, tht, rst, Rt, okt = tps.rayleigh_ritz_residuals_pseudo(
        _t(H), _t(Q), locked, polish=2, want_vectors=True)
    Vj, thj, rsj, Rj, okj = jps.rayleigh_ritz_residuals_pseudo(
        _j(H), _j(Q), jnp.int32(locked), polish=2, want_vectors=True)
    assert okt is True and bool(okj) is True
    u = 16 // 2 - locked
    act = slice(locked, locked + u)
    np.testing.assert_allclose(tht.numpy()[act], np.asarray(thj)[act],
                               atol=1e-10)
    np.testing.assert_allclose(rst.numpy()[act], np.asarray(rsj)[act],
                               atol=1e-9)
    Vt, Vj, Rt, Rj = (np.asarray(a) for a in (Vt, Vj, Rt, Rj))
    ph = np.sum(Vj.conj() * Vt, axis=0)
    ph = ph / np.abs(ph)
    assert np.abs(Vt[:, act] * ph[act].conj() - Vj[:, act]).max() <= 1e-8
    assert np.abs(Rt[:, act] * ph[act].conj() - Rj[:, act]).max() <= 1e-8
    # columns outside the written range are the input's
    np.testing.assert_array_equal(Vt[:, :locked], Q[:, :locked])
    np.testing.assert_array_equal(Vt[:, locked + u:], Q[:, locked + u:])
    if locked == 0:
        # the block spans the 8 pairs plus noise of norm ~1e-3 per column:
        # the positive Ritz values are their eigenvalues to ~‖H‖·1e-6
        np.testing.assert_allclose(tht.numpy()[act], np.sort(lam[lam > 0]),
                                   atol=1e-5)


def test_rayleigh_ritz_pseudo_f32_and_geev_cross_check():
    """The f32 pencil (factored in f64) against JAX's f32 one, and the
    production pencil against the numpy geev path of both packages."""
    H, Q, _ = _pencil_block(60, 8, np.float64, seed=4, noise=0.0)
    _, th, _, ok = tps.rayleigh_ritz_residuals_pseudo(_t(H), _t(Q), 0)
    th_gt, _ = tps.rayleigh_ritz_pseudo_geev(_t(H), _t(Q))
    th_gj, _ = jps.rayleigh_ritz_pseudo_geev(H, Q)
    np.testing.assert_array_equal(th_gt, th_gj)
    np.testing.assert_allclose(np.sort(th_gt[th_gt > 0])[:4],
                               th.numpy()[:4], atol=1e-12)
    H32, Q32 = H.astype(np.float32), Q.astype(np.float32)
    _, th32, rs32, ok32 = tps.rayleigh_ritz_residuals_pseudo(_t(H32),
                                                             _t(Q32), 0)
    _, thj, rsj, okj = jps.rayleigh_ritz_residuals_pseudo(_j(H32), _j(Q32),
                                                          jnp.int32(0))
    assert ok and ok32 and bool(okj)
    assert th32.dtype == torch.float32
    np.testing.assert_allclose(th32.numpy()[:4], np.asarray(thj)[:4],
                               atol=1e-5)
    np.testing.assert_allclose(rs32.numpy()[:4], np.asarray(rsj)[:4],
                               atol=1e-5)


def test_pencil_cholesky_failure_is_reported():
    """A block whose QᴴSHQ is not positive definite (an S-indefinite
    mix) gives ok=False in both packages, and finite output."""
    N = 40
    H = tmodels.random_pseudo_hermitian(N, np.float64, seed=6)
    Q = np.zeros((N, 4))
    Q[0, 0] = Q[N // 2, 1] = Q[1, 2] = Q[N // 2 + 1, 3] = 1.0
    Hneg = H.copy()
    Hneg[:N // 2, :N // 2] *= -1       # M = S·H indefinite
    _, th, _, ok = tps.rayleigh_ritz_residuals_pseudo(_t(Hneg), _t(Q), 0)
    _, _, _, okj = jps.rayleigh_ritz_residuals_pseudo(_j(Hneg), _j(Q),
                                                      jnp.int32(0))
    assert ok is False and bool(okj) is False
    assert torch.isfinite(th).all()


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_residuals_pseudo_matches_jax(dtype):
    H, Q, _ = _pencil_block(48, 6, dtype, seed=7)
    theta = np.linspace(0.5, 1.5, 6)
    np.testing.assert_allclose(
        tps.residuals_pseudo(_t(H), _t(Q), theta).numpy(),
        np.asarray(jps.residuals_pseudo(_j(H), _j(Q), _j(theta))),
        rtol=1e-12)


# ---- S-aware QR ----------------------------------------------------------------

def _rcfgs(dtype):
    return (ct.ChaseConfig().resolve(_t(np.zeros(1, dtype)).dtype, "cpu"),
            jconfig.ChaseConfig().resolve(np.dtype(dtype)))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_orthonormalize_pseudo_with_locked_matches_jax(dtype):
    """With 2 locked pairs: the active block comes back orthonormal and
    S-orthogonal to the locked columns with their lower halves negated;
    the locked columns are untouched; Q agrees with JAX's."""
    N, K2, locked = 80, 12, 2
    H, Q0, _ = _pencil_block(N, K2, dtype, seed=8)
    rng = np.random.default_rng(8)
    V = Q0 + 0.1 * _randn(rng, (N, K2), dtype)
    rt, rj = _rcfgs(dtype)
    Qt = tqr.orthonormalize_pseudo(_t(V), locked, 30.0, rt).numpy()
    Qj = np.asarray(jqr.orthonormalize_pseudo(_j(V), locked, 30.0, rj))
    assert np.abs(Qt - Qj).max() <= 1e-10
    lk = np.r_[0:locked, K2 - locked:K2]
    act = np.r_[locked:K2 - locked]
    np.testing.assert_array_equal(Qt[:, lk], V[:, lk])
    Lf = V[:, lk].copy()
    Lf[N // 2:] *= -1
    assert np.abs(Lf.conj().T @ Qt[:, act]).max() <= 1e-12
    G = Qt[:, act].conj().T @ Qt[:, act]
    assert np.abs(G - np.eye(len(act))).max() <= 1e-12


def test_orthonormalize_pseudo_guard_routes_a_collapsed_block_to_householder(
        caplog):
    """An over-compressed block (the iteration-0 collapse the degree cap
    prevents: columns equal to 1e-9 noise off one rank-3 span) fails the
    CholQR guard and is rescued by Householder: finite and orthonormal."""
    from chase_tpu_torch.logger import get_logger
    N, K2 = 64, 10
    rng = np.random.default_rng(9)
    V = rng.standard_normal((N, 3)) @ rng.standard_normal((3, K2)) \
        + 1e-9 * rng.standard_normal((N, K2))
    warns = []
    log = get_logger()
    orig = log.warn
    log.warn = lambda msg, *a, **k: warns.append(str(msg))
    try:
        rt, _ = _rcfgs(np.float64)
        Q = tqr.orthonormalize_pseudo(_t(V), 0, 1e3, rt).numpy()
    finally:
        log.warn = orig
    assert any("falling back to Householder" in w for w in warns), warns
    assert np.isfinite(Q).all()
    assert np.abs(Q.T @ Q - np.eye(K2)).max() <= 1e-12


# ---- host bookkeeping: exact ---------------------------------------------------

def test_detect_eigenvalue_clusters_equals_jax():
    rng = np.random.default_rng(10)
    ritz = np.sort(rng.uniform(0.5, 2.0, 20))
    ritz[5:9] = ritz[5] + 1e-9 * np.arange(4)       # a tight cluster
    resid = 10.0 ** rng.uniform(-12, -2, 20)
    for n in (0, 1, 12, 20):
        np.testing.assert_array_equal(
            tsp.detect_eigenvalue_clusters(ritz, resid, 1e-10, n, 9.0, 1.4),
            jsp.detect_eigenvalue_clusters(ritz, resid, 1e-10, n, 9.0, 1.4))


@pytest.mark.parametrize("is_sp,cluster", [(False, True), (True, True),
                                           (False, False)])
def test_calc_degrees_pseudo_h2_equals_jax(is_sp, cluster):
    rng = np.random.default_rng(11)
    u, nex = 14, 4
    ritz = rng.uniform(0.3, 2.5, u)
    resid = 10.0 ** rng.uniform(-11, 0, u)
    resid_last = resid * rng.uniform(0.9, 3.0, u)
    out = []
    for sp, cfgmod in ((tsp, ct), (jsp, None)):
        r, s, rl = ritz.copy(), resid.copy(), resid_last.copy()
        d = np.zeros(u, np.int64)
        if cfgmod is ct:
            rcfg = ct.ChaseConfig(cluster_aware_degrees=cluster).resolve(
                torch.float64, "cpu")
        else:
            rcfg = jconfig.ChaseConfig(
                cluster_aware_degrees=cluster).resolve(np.dtype(np.float64))
        res = sp.calc_degrees_pseudo_h2_host(u, nex, 9.0, 1.4, 1e-10, r, s,
                                             rl, d, rcfg, is_sp)
        out.append((res[0], res[1], r, s, d))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("iteration", [1, 5])
def test_locking_pseudo_v3_equals_jax(iteration):
    rng = np.random.default_rng(12)
    u, nex, tol = 12, 3, 1e-10
    ritz = np.sort(rng.uniform(0.5, 2.0, u))
    resid = np.array([5e-11, 2e-8, 3e-11, 5e-8, 1e-3, 8e-11, 2e-9, 1e-2,
                      4e-11, 1e-12, 1e-5, 1e-6])
    resid_last = resid * np.array([2, 0.5, 1, 0.9, 1, 1, 0.1, 1, 1, 1, 1, 1])
    out = []
    for sp in (tsp, jsp):
        r, s, rl = ritz.copy(), resid.copy(), resid_last.copy()
        n, perm, early = sp.locking_pseudo_v3_host(r, s, rl, u, nex, tol,
                                                   iteration)
        out.append((n, perm, early, r, s, rl))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert out[0][0] >= 4


def test_iter0_degree_cap_equals_jax():
    cases = [(1.0, 25.0, 400.0, 36), (24.9, 25.0, 1000.0, 20),
             (30.0, 25.0, 20.0, 20), (0.75, 1.44, 9.0, 20),
             (0.1, 0.2, 1e4, 36)]
    for args in cases:
        assert tsp._iter0_degree_cap(*args) == jsp._iter0_degree_cap(*args)
    cap = tsp._iter0_degree_cap(1.0, 25.0, 400.0, 36)
    assert 8 <= cap < 36 and cap % 2 == 0
