"""The precision ladder of the port against the JAX package's.

Every test makes its inputs with numpy from a seed and hands the same
arrays to both packages (JAX with x64 on, on the CPU).  Tolerances:

* the deviation-form refinement filter in f64: 1e-12 relative per column
  against JAX's and against the port's own direct filter (the same
  polynomial, factored differently; f64 rounding), degree-0 columns
  bit-exact; on an f32 (c64) shadow of an f64 (c128) block: 1e-5 (the
  w recurrence runs in f32 sums in another order than XLA's);
* the bf16 product: 1e-6 relative (bf16·bf16 products are exact in f32,
  only the f32 summation order differs); filters on a bf16 shadow: 1e-3
  per column (each step rounds the f32 carry to bf16, and a carry that
  differs from JAX's in its last bit may round to the other bf16
  neighbour, an error of 2^-9 of that entry);
* RR's residual vectors: 1e-9 of the largest entry (f64 eigensolves by
  two LAPACK builds; columns aligned by the Ritz vectors' phase);
* end to end (N=256 perturbed Clement, the JAX package's own ladder
  tests): converged, reported residual ≤ 1e-9, true residual < 5e-9,
  Ritz values within 1e-9 of eigvalsh, ≥ 80% of the FLOPs in f32/c64
  (JAX: 85%), iterations ≤ JAX's + 1; the bf16 rung on f32 at tol 1e-3
  with ≥ 75% on bf16 (JAX: 79.5%).  ``ring_backend="pallas"`` runs the
  p = 1 ring filters (each HEMM through ring_hemm's plain version on the
  CPU), "xla" the windowed ones.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chase_tpu
from chase_tpu import solver as jsolver
from chase_tpu.ops import filter as jfilt
from chase_tpu.ops import rr as jrr

import chase_tpu_torch as ct
from chase_tpu_torch import solver as tsolver
from chase_tpu_torch.models import clement, hermitian_sequence
from chase_tpu_torch.ops import filter as tfilt
from chase_tpu_torch.ops import rr as trr
from chase_tpu_torch.ops import ring_hemm as trh
from chase_tpu_torch.parallel import ring as tring
from chase_tpu_torch.types import filter_carry_dtype, low_precision_dtype

torch.set_num_threads(1)

N_E2E, NEV, NEX = 256, 24, 16


def _perturbed_clement(N, dtype, seed=0):
    """tests/test_ladder.py's problem: Clement + 1e-6 Hermitian noise."""
    rng = np.random.default_rng(seed)
    H = clement(N)
    E = rng.standard_normal((N, N))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        E = E + 1j * rng.standard_normal((N, N))
    return (H + 1e-6 * (E + E.conj().T) / 2).astype(dtype)


def _herm(N, k, dtype, seed):
    """A Hermitian H, a unit-column block V, per-column shifts, R = H·V −
    V·λ, and an interval from H's spectrum."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N))
    V = rng.standard_normal((N, k))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = A + 1j * rng.standard_normal((N, N))
        V = V + 1j * rng.standard_normal((N, k))
    H = ((A + A.conj().T) / 2).astype(dtype)
    V = (V / np.linalg.norm(V, axis=0)).astype(dtype)
    w = np.linalg.eigvalsh(H)
    lam = rng.uniform(w[0], w[k], k)
    R = H @ V - V * lam[None, :]
    return H, V, R, lam, float(w[0]) - 0.1, float(w[k]), float(w[-1])


def _col_rel(Y, ref):
    """max over columns of ‖Y_j − ref_j‖∞ / ‖ref_j‖∞."""
    Y, ref = np.asarray(Y), np.asarray(ref)
    num = np.abs(Y - ref).max(axis=0)
    den = np.maximum(np.abs(ref).max(axis=0), np.finfo(np.float64).tiny)
    return float((num / den).max())


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    x = jnp.asarray(np.asarray(a))
    return x if dtype is None else x.astype(dtype)


# the JAX (numpy) dtype of each torch dtype the tests hand across
_NP = {torch.float64: np.float64, torch.complex128: np.complex128,
       torch.float32: np.float32, torch.complex64: np.complex64,
       torch.bfloat16: jnp.bfloat16}


# ---- types ---------------------------------------------------------------

@pytest.mark.parametrize("problem,low", [
    (torch.float64, torch.float32), (torch.complex128, torch.complex64),
    (torch.float32, torch.bfloat16), (torch.complex64, torch.complex64)],
    ids=["f64", "c128", "f32", "c64"])
def test_low_precision_and_carry_dtypes_match_jax(problem, low):
    from chase_tpu import types as jt
    assert low_precision_dtype(problem) == low
    assert np.dtype(jt.low_precision_dtype(_NP[problem])) \
        == np.dtype(_NP[low])
    carry = filter_carry_dtype(low, problem)
    assert np.dtype(_NP[carry]) == np.dtype(
        jt.filter_carry_dtype(_NP[low], _NP[problem]))


# ---- refinement tables and filter -------------------------------------------

@pytest.mark.parametrize("seed,max_deg", [(0, 36), (1, 18), (2, 40)])
def test_refine_tables_equal_jax(seed, max_deg):
    rng = np.random.default_rng(seed)
    w = 12
    ritz = rng.uniform(-50, 20, w)
    degs = 2 * rng.integers(0, max_deg // 2 + 1, w)
    args = (ritz, degs, -60.0, -10.0, 90.0, max_deg)
    for a, b in zip(tfilt.refine_tables(*args), jfilt.refine_tables(*args)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


DEGS = np.array([4, 6, 8, 8, 10, 12, 0, 8, 2, 14], np.int32)


@pytest.mark.parametrize("problem,shadow,tol", [
    (np.float64, np.float64, 1e-12), (np.float64, np.float32, 1e-5),
    (np.complex128, np.complex128, 1e-12),
    (np.complex128, np.complex64, 1e-5)],
    ids=["f64", "f32_shadow", "c128", "c64_shadow"])
def test_chebyshev_filter_refine_matches_jax(problem, shadow, tol):
    H, V, R, lam, lam1, lo, up = _herm(120, len(DEGS), problem, seed=1)
    tabs = tfilt.refine_tables(lam, DEGS, lam1, lo, up, 36)
    cc, dmax = (up + lo) / 2.0, int(DEGS.max())
    Yt = tfilt.chebyshev_filter_refine(_t(H.astype(shadow)), _t(V), _t(R),
                                       DEGS, *tabs, cc, dmax).numpy()
    Yj = np.asarray(jfilt.chebyshev_filter_refine(
        _j(H.astype(shadow)), _j(V), _j(R), _j(DEGS), *tabs, cc, dmax))
    assert Yt.dtype == problem
    act = DEGS > 0
    assert _col_rel(Yt[:, act], Yj[:, act]) <= tol
    np.testing.assert_array_equal(Yt[:, ~act], V[:, ~act])
    if shadow == problem:
        # the same polynomial as the direct filter, in f64
        Yd = tfilt.chebyshev_filter(_t(H), _t(V), DEGS, lam1, lo, up,
                                    dmax).numpy()
        assert _col_rel(Yt, Yd) <= tol


@pytest.mark.parametrize("shadow,tol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)],
                         ids=["f64", "f32_shadow"])
def test_segmented_refine_matches_jax(shadow, tol):
    """solver._filter_refine_windowed in both packages on the windowed
    route, with a degree plan that retires two of JAX's buckets (shrinks
    its window twice) and 5 locked columns inside the first bucket: the
    port's steps on torch.matmul, each on its live suffix (tile 1), so
    it executes fewer column-steps than JAX's plan."""
    N, nevex, locked, B = 150, 32, 5, 8
    H, V, R, _, lam1, lo, up = _herm(N, nevex, np.float64, seed=4)
    degs = np.array([2] * 3 + [4] * 8 + [6] * 16, np.int64)
    ritz = np.linspace(lam1 + 1, lo, nevex - locked)
    deg_win = np.concatenate([np.zeros(locked, np.int64), degs])
    assert len(jsolver._shrink_plan(deg_win, B, nevex)) == 3
    Vj, ex_j = jsolver._filter_refine_windowed(
        _j(H.astype(shadow)), _j(V), _j(R), ritz, degs, locked, nevex, B,
        lam1, lo, up, 36, "highest")
    Hs = _t(H.astype(shadow))
    Vt, ex_t, hemms = tsolver._filter_refine_windowed(
        Hs, _t(V.copy()), _t(R), ritz, degs, locked, nevex, B, lam1, lo, up,
        36, tring.filter_product(None, Hs, None, False))
    live = [int(np.sum(deg_win >= t)) for t in range(2, 7)]
    assert live == [27, 24, 24, 16, 16]
    assert ex_t == sum(live) < ex_j and hemms == int(degs.max()) - 1
    assert _col_rel(Vt.numpy()[:, locked:], np.asarray(Vj)[:, locked:]) \
        <= tol
    np.testing.assert_array_equal(Vt.numpy()[:, :locked], V[:, :locked])


@pytest.mark.parametrize("problem,tol", [(np.float64, 1e-5),
                                         (np.complex128, 1e-5),
                                         (np.float32, 1e-3)],
                         ids=["f32_shadow", "c64_shadow", "bf16_shadow"])
def test_refine_ring_p1_matches_jax_refine(problem, tol, monkeypatch):
    """The p = 1 refinement ring on the CPU (every H·w through ring_hemm's
    plain version) against JAX's chebyshev_filter_refine on the same
    shadow: the same polynomial, compared to the carry's tolerance; one
    ring_hemm call per step after the first."""
    H, V, R, lam, lam1, lo, up = _herm(96, len(DEGS), problem, seed=2)
    low = low_precision_dtype(torch.from_numpy(H).dtype)
    tabs = tfilt.refine_tables(lam, DEGS, lam1, lo, up, 36)
    cc, dmax = (up + lo) / 2.0, int(DEGS.max())
    calls = []
    real = trh.ring_hemm
    monkeypatch.setattr(trh, "ring_hemm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    Ht = _t(H, low)
    Yt = tring.chebyshev_filter_refine_ring(Ht, _t(V), _t(R), DEGS, *tabs,
                                            cc, dmax).numpy()
    jlow = _NP[low]
    Yj = np.asarray(jfilt.chebyshev_filter_refine(
        _j(H, jlow), _j(V), _j(R), _j(DEGS), *tabs, cc, dmax))
    assert len(calls) == dmax - 1
    act = DEGS > 0
    assert _col_rel(Yt[:, act], Yj[:, act]) <= tol
    np.testing.assert_array_equal(Yt[:, ~act], V[:, ~act])


@pytest.mark.parametrize("problem,tol", [(np.complex128, 1e-5),
                                         (np.float64, 1e-5),
                                         (np.float32, 1e-3)],
                         ids=["c64_H_c128_X", "f32_H_f64_X", "bf16_H_f32_X"])
def test_ring_filter_with_narrower_h_matches_jax(problem, tol):
    """The p = 1 ring filter on the shadow of X's dtype against JAX's
    chebyshev_filter on the same pair: the carry is the shadow's (f32 for
    bf16), the result X's dtype, degree-0 columns bit-exact."""
    H, X, _, _, lam1, lo, up = _herm(96, len(DEGS), problem, seed=3)
    low = low_precision_dtype(torch.from_numpy(H).dtype)
    jlow = _NP[low]
    dmax = int(DEGS.max())
    Yt = tring.chebyshev_filter_ring_pallas(_t(H, low), _t(X), DEGS, lam1,
                                            lo, up, dmax).numpy()
    Yj = np.asarray(jfilt.chebyshev_filter(_j(H, jlow), _j(X), _j(DEGS),
                                           lam1, lo, up, dmax))
    assert Yt.dtype == problem
    act = DEGS > 0
    assert _col_rel(Yt[:, act], Yj[:, act]) <= tol
    np.testing.assert_array_equal(Yt[:, ~act], X[:, ~act])


def test_ring_filter_refuses_a_wider_h():
    H = torch.zeros((8, 8), dtype=torch.complex128)
    X = torch.zeros((8, 2), dtype=torch.complex64)
    with pytest.raises(TypeError):
        tring.chebyshev_filter_ring_pallas(H, X, np.ones(2, np.int32), -1.0,
                                           0.0, 1.0, 1)


@pytest.mark.parametrize("c", [0.0, 3.5])
def test_bf16_hemm_shift_matches_jax(c):
    rng = np.random.default_rng(5)
    H = rng.standard_normal((200, 200)).astype(np.float32)
    X = rng.standard_normal((200, 17)).astype(np.float32)
    Yt = tfilt._hemm_shift(_t(H, torch.bfloat16), _t(X), c).numpy()
    Yj = np.asarray(jfilt._hemm_shift(_j(H, jnp.bfloat16), _j(X), c,
                                      "highest"))
    ref = np.asarray(jnp.matmul(_j(H, jnp.bfloat16), _j(X, jnp.bfloat16),
                                preferred_element_type=jnp.float32)) - c * X
    assert Yt.dtype == np.float32
    assert np.abs(Yt - ref).max() / np.abs(ref).max() <= 1e-6
    assert np.abs(Yt - Yj).max() / np.abs(Yj).max() <= 1e-6


# ---- RR residual vectors -------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
def test_rr_residual_vectors_match_jax(dtype, window):
    """rayleigh_ritz_residuals(want_vectors=True): R rolled like V, in
    the problem dtype, equal to JAX's once each Ritz vector's sign (phase)
    is aligned."""
    H, V, _, _, _, _, _ = _herm(90, 20, dtype, seed=6)
    V, _ = np.linalg.qr(V)
    locked = 4
    if window:                    # the solver's padded window: columns 2..
        V, locked = V[:, 2:], locked - 2
    Vt, rt_, st, Rt = trr.rayleigh_ritz_residuals(_t(H), _t(V), locked,
                                                  want_vectors=True)
    Vj, rj, sj, Rj = jrr.rayleigh_ritz_residuals(_j(H), _j(V), locked,
                                                 want_vectors=True)
    Vt, Rt, Vj, Rj = (np.asarray(a) for a in (Vt, Rt, Vj, Rj))
    assert Rt.dtype == dtype and Rt.shape == V.shape
    np.testing.assert_allclose(rt_.numpy()[locked:], np.asarray(rj)[locked:],
                               atol=1e-10)
    ph = np.sum(Vj.conj() * Vt, axis=0)
    ph = ph / np.abs(ph)
    act = slice(locked, None)
    scale = np.abs(Rj[:, act]).max()
    assert np.abs(Rt[:, act] * ph[act].conj() - Rj[:, act]).max() \
        <= 1e-9 * scale
    # the vectors are the residuals of the Ritz pairs they sit beside
    np.testing.assert_allclose(
        np.linalg.norm(Rt[:, act], axis=0), st.numpy()[act], rtol=1e-10)


# ---- end to end --------------------------------------------------------------

_JAX = {}


def _jax_solve(key, H, V0, tol, cfg):
    if key not in _JAX:
        _JAX[key] = chase_tpu.eigsh(H, NEV, NEX, tol=tol, v0=V0, config=cfg,
                                    collect_perf=True)
    return _JAX[key]


def _v0(N, dtype, seed=11):
    rng = np.random.default_rng(seed)
    V0 = rng.standard_normal((N, NEV + NEX))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        V0 = V0 + 1j * rng.standard_normal((N, NEV + NEX))
    return V0.astype(dtype)


def _true_resid(H, V, lam):
    V = np.asarray(V)
    return np.linalg.norm(H @ V - V * lam[None, :].astype(V.dtype), axis=0)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_ladder_reaches_1e10_with_low_precision_flops_like_jax(dtype,
                                                               backend):
    H = _perturbed_clement(N_E2E, dtype)
    V0 = _v0(N_E2E, dtype)
    rj = _jax_solve(("mp", dtype), H, V0, 1e-10,
                    chase_tpu.ChaseConfig(mixed_precision=True))
    cfg = ct.ChaseConfig(mixed_precision=True, ring_backend=backend)
    rt = ct.eigsh(H, NEV, NEX, tol=1e-10, v0=V0, config=cfg, device="cpu",
                  collect_perf=True)
    assert rj.converged and rt.converged
    assert rt.resid.max() <= 1e-9
    assert _true_resid(H, rt.V[:, :NEV].numpy(), rt.ritzv).max() < 5e-9
    exact = np.linalg.eigvalsh(H)[:NEV]
    assert np.abs(rt.ritzv - exact).max() <= 1e-9
    assert np.abs(rt.ritzv - rj.ritzv).max() <= 1e-9
    rcfg = cfg.resolve(torch.from_numpy(H).dtype, "cpu")
    frac = rt.perf.low_flop_fraction(N_E2E, rcfg.lanczos_iter, 4,
                                     torch.from_numpy(H).dtype)
    assert frac >= 0.80, f"only {frac:.0%} of FLOPs were low-precision"
    assert rt.iterations <= rj.iterations + 1
    assert rt.V.dtype == torch.from_numpy(H).dtype


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_bf16_rung_matches_jax(backend, monkeypatch):
    """tests/test_solver.py's bf16 rung case: an f32 problem filtered on
    its bf16 shadow converges to tol 1e-3 and the spectrum, with ≥ 75% of
    the FLOPs on bf16; on the ring path every filter HEMM is a bf16
    ring_hemm call."""
    H = _perturbed_clement(N_E2E, np.float32)
    V0 = _v0(N_E2E, np.float32)
    rj = _jax_solve(("bf16",), H, V0, 1e-3,
                    chase_tpu.ChaseConfig(bf16_filter=True))
    shapes = []
    real = trh.ring_hemm
    monkeypatch.setattr(trh, "ring_hemm",
                        lambda Hk, *a, **k: shapes.append(Hk.dtype)
                        or real(Hk, *a, **k))
    cfg = ct.ChaseConfig(bf16_filter=True, ring_backend=backend)
    rt = ct.eigsh(H, NEV, NEX, tol=1e-3, v0=V0, config=cfg, device="cpu",
                  collect_perf=True)
    assert rj.converged and rt.converged
    exact = np.linalg.eigvalsh(H.astype(np.float64))[:NEV]
    np.testing.assert_allclose(rt.ritzv, exact, atol=1e-3 * N_E2E * 10)
    assert _true_resid(H, rt.V[:, :NEV].numpy(), rt.ritzv).max() \
        < 1e-3 * N_E2E * 10
    assert np.abs(rt.ritzv - rj.ritzv).max() <= 1e-3 * N_E2E
    frac = rt.perf.low_flop_fraction(N_E2E, 12, 4, torch.float32)
    assert frac >= 0.75, f"only {frac:.0%} of FLOPs were bf16"
    if backend == "pallas":
        assert len(shapes) == rt.perf.filter_hemm_steps > 0
        assert set(shapes) == {torch.bfloat16}
    else:
        assert not shapes


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_bf16_rung_negative_definite_disengage_like_jax(backend):
    """tests/test_solver.py's regression: a fully negative spectrum
    (upperb < 0) still gates the rung on the spectral radius's
    magnitude."""
    N, nev, nex = 192, 12, 12
    H = (np.asarray(clement(N)) - 2.0 * N * np.eye(N)).astype(np.float32)
    rj = chase_tpu.eigsh(H, nev, nex, tol=1e-4,
                         config=chase_tpu.ChaseConfig(bf16_filter=True))
    rt = ct.eigsh(H, nev, nex, tol=1e-4, device="cpu",
                  config=ct.ChaseConfig(bf16_filter=True,
                                        ring_backend=backend))
    assert rj.converged and rt.converged
    assert rt.resid.max() < 1e-4 * 3 * N
    exact = np.linalg.eigvalsh(H.astype(np.float64))[:nev]
    np.testing.assert_allclose(rt.ritzv, exact, atol=1e-2)
    np.testing.assert_allclose(rt.ritzv, rj.ritzv, atol=1e-2)


def test_eigsh_sequence_c128_ladder_matches_jax():
    """Three correlated c128 members with mixed_precision: each member at
    tol 1e-10 with ≥ 80% of its FLOPs in c64; eigenvalues within 1e-9 of
    JAX's sequence and of eigvalsh; warm members take no more iterations
    than the cold one."""
    seq = hermitian_sequence(150, 3, np.complex128, seed=21, drift=0.004)
    rj = list(chase_tpu.eigsh_sequence(
        seq, 10, 8, tol=1e-10, warmup=False,
        config=chase_tpu.ChaseConfig(mixed_precision=True,
                                     complex_backend="native")))
    rt = list(ct.eigsh_sequence(iter(seq), 10, 8, tol=1e-10, device="cpu",
                                collect_perf=True,
                                config=ct.ChaseConfig(mixed_precision=True)))
    for H, a, b in zip(seq, rt, rj):
        assert a.converged and b.converged
        exact = np.linalg.eigvalsh(H)[:10]
        assert np.abs(a.ritzv - exact).max() <= 1e-9
        assert np.abs(a.ritzv - b.ritzv).max() <= 1e-9
        assert _true_resid(H, a.V[:, :10].numpy(), a.ritzv).max() < 5e-9
        assert a.perf.low_flop_fraction(150, 25, 4, torch.complex128) >= 0.8
    assert max(r.iterations for r in rt[1:]) <= rt[0].iterations


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128,
                                   torch.float32], ids=["f64", "c128", "f32"])
def test_mixed_precision_default_is_off_on_the_cpu(dtype):
    """``mixed_precision=None`` resolves to False on the CPU, as the JAX
    package resolves it on its CPU backend; forcing it engages."""
    for dev in (None, "cpu"):
        assert ct.ChaseConfig().resolve(dtype, dev).mixed_precision is False
    assert ct.ChaseConfig(mixed_precision=True).resolve(
        dtype, "cpu").mixed_precision is True
    assert chase_tpu.ChaseConfig().resolve(_NP[dtype]).mixed_precision \
        is False


def test_uses_ring_kernel_sees_the_shadow():
    """eigsh_sequence's warm-up loads the kernel library when some filter
    will run on it: an f64/c128 problem with the ladder (its f32/c64
    shadow), an f32 problem with the bf16 rung — not native f64."""
    def uses(dtype, **kw):
        rcfg = ct.ChaseConfig(ring_backend="pallas", **kw).resolve(dtype,
                                                                    "cpu")
        return tsolver.uses_ring_kernel(rcfg, dtype)
    assert uses(torch.float64, mixed_precision=True)
    assert uses(torch.complex128, mixed_precision=True)
    assert uses(torch.float32, bf16_filter=True)
    assert not uses(torch.float64)
    assert not uses(torch.complex128, bf16_filter=True)


def test_operator_shadow_is_cached_in_the_low_dtype():
    op = ct.DenseOperator(_perturbed_clement(64, np.complex128), "cpu")
    assert op.H_low.dtype == torch.complex64 and op.H_low is op.H_low
    np.testing.assert_array_equal(op.H_low.numpy(),
                                  op.H.numpy().astype(np.complex64))
    op32 = ct.DenseOperator(clement(64).astype(np.float32), "cpu")
    assert op32.H_low.dtype == torch.bfloat16


def test_perf_low_flop_fraction_and_report_match_jax():
    from chase_tpu.perf import PerfData as JPerf
    from chase_tpu_torch.perf import PerfData as TPerf
    pj, pt = JPerf(), TPerf()
    for p in (pj, pt):
        p.add_filtered_vecs(1000, low=True, executed=1200)
        p.add_filtered_vecs(300)
        for b in (300, 200):
            p.add_iter_blocksize(b)
    assert pt.low_flop_fraction(4000, 25, 4, torch.complex128) == \
        pj.low_flop_fraction(4000, 25, 4, np.complex128)
    pt.add_time("All", 1.0)
    assert "Low-precision FLOP share" in pt.report(4000, 25, 4,
                                                   torch.complex128)


@pytest.mark.parametrize("backend,on", [("pallas", True), ("xla", False)])
def test_mixed_precision_default_on_cuda_follows_the_measurement(backend,
                                                                  on):
    """On CUDA ``mixed_precision=None`` takes the H100 measurement's
    default for f64/c128 problems, per ring_backend; f32 and c64 problems
    never default to a ladder."""
    from chase_tpu_torch.config import MIXED_PRECISION_ON_CUDA
    assert MIXED_PRECISION_ON_CUDA[backend] is on
    cfg = ct.ChaseConfig(ring_backend=backend)
    for dtype in (torch.float64, torch.complex128):
        assert cfg.resolve(dtype, "cuda").mixed_precision is on
    for dtype in (torch.float32, torch.complex64):
        assert cfg.resolve(dtype, "cuda").mixed_precision is False
    assert ct.ChaseConfig(ring_backend=backend, mixed_precision=False) \
        .resolve(torch.float64, "cuda").mixed_precision is False
