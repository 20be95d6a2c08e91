"""``eigsh_pseudo`` of the port against ``chase_tpu.eigsh_pseudo``, end to
end on the CPU.

Both packages get the same numpy matrix.  The RNG streams differ (torch
and jax.random), so the converged spectra and the true residuals
‖Hv − θv‖ are compared, not iterates.  The JAX side pins
``complex_backend="native"``, ``mixed_precision=False``,
``small_dense_backend="device"`` and ``wide_f64="off"`` (its
backend-dependent defaults).  Tolerances:

* ``random_pseudo_hermitian`` (N=200, nev=10, nex=8) at the JAX package's
  own e2e tolerances (tests/test_pseudo.py): tol 1e-9 DP / 1e-4 SP;
  eigenvalues within 100·tol·max(1, λ_max) of numpy's ``eigvals`` and of
  JAX's, true residuals below 100·tol·max(1, λ_max);
* the locking progression (c128, N=160, nev=16, tol 1e-10): eigenvalues
  within 1e-7, at least 2 iterations;
* the structured generator (exact spectrum ±√(a² − b²), N=240): within
  1e-7 of the exact values.

``ring_backend="pallas"`` runs every f32/c64 H² filter as the p = 1 ring
(each product through ring_hemm's plain version on the CPU); "xla" the
windowed filter (the same recurrence on torch.matmul).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chase_tpu

import chase_tpu_torch as ct
from chase_tpu_torch import solver_pseudo as tsp
from chase_tpu_torch.models import (random_pseudo_hermitian,
                                    structured_pseudo_hermitian)
from chase_tpu_torch.ops import ring_hemm as trh

torch.set_num_threads(1)

E2E_TOL = {np.dtype(np.float32): 1e-4, np.dtype(np.complex64): 1e-4,
           np.dtype(np.float64): 1e-9, np.dtype(np.complex128): 1e-9}
JAX_PINS = dict(complex_backend="native", small_dense_backend="device",
                wide_f64="off")


def _positive_spectrum(H, k):
    ev = np.linalg.eigvals(H.astype(np.complex128))
    assert np.abs(ev.imag).max() < 1e-8
    evr = np.sort(ev.real)
    return evr[evr > 0][:k]


def _true_resid(H, res, nev):
    V = np.asarray(res.V)[:, :nev]
    R = H.astype(V.dtype) @ V - V * res.ritzv[None, :].astype(V.dtype)
    return np.linalg.norm(R, axis=0)


_JAX = {}


def _jax_solve(key, H, nev, nex, tol, **cfg):
    if key not in _JAX:
        _JAX[key] = chase_tpu.eigsh_pseudo(
            H, nev, nex, tol=tol,
            config=chase_tpu.ChaseConfig(**{"mixed_precision": False,
                                            **JAX_PINS, **cfg}))
    return _JAX[key]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128],
                         ids=["f32", "f64", "c64", "c128"])
def test_eigsh_pseudo_matches_jax(dtype, backend, monkeypatch):
    dtype = np.dtype(dtype)
    N, nev, nex = 200, 10, 8
    tol = E2E_TOL[dtype]
    H = random_pseudo_hermitian(N, dtype=dtype, seed=5)
    pos = _positive_spectrum(H, nev)
    rj = _jax_solve(("e2e", dtype), H, nev, nex, tol)
    calls = []
    real = trh.ring_hemm
    monkeypatch.setattr(trh, "ring_hemm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rt = ct.eigsh_pseudo(H, nev, nex, tol=tol, device="cpu",
                         collect_perf=True,
                         config=ct.ChaseConfig(ring_backend=backend))
    assert rj.converged and rt.converged
    assert rt.V.shape == (N, 2 * (nev + nex)) and rt.V.dtype == \
        torch.from_numpy(H).dtype
    scale = max(1.0, float(pos[-1]))
    np.testing.assert_allclose(rt.ritzv, pos, atol=tol * scale * 100)
    np.testing.assert_allclose(rt.ritzv, rj.ritzv, atol=tol * scale * 100)
    assert _true_resid(H, rt, nev).max() < tol * scale * 100
    assert rt.perf.matrix_type == 1
    # two products per H² step, on the ring one ring_hemm call each
    ring = backend == "pallas" and dtype in (np.float32, np.complex64)
    assert len(calls) == (rt.perf.filter_hemm_steps if ring else 0)
    assert rt.perf.filter_hemm_steps % 2 == 0
    assert rt.perf.filtered_vecs_executed >= rt.perf.filtered_vecs


def test_eigsh_pseudo_locking_progression_like_jax():
    """tests/test_pseudo.py's tight-tolerance case: several locking rounds
    (the locked > 0 QR, RR and K-conjugation paths)."""
    N, nev, nex = 160, 16, 6
    H = random_pseudo_hermitian(N, dtype=np.complex128, seed=6,
                                coupling=0.4, spread=0.8)
    pos = _positive_spectrum(H, nev)
    rj = _jax_solve(("lock",), H, nev, nex, 1e-10)
    rt = ct.eigsh_pseudo(H, nev, nex, tol=1e-10, device="cpu")
    assert rj.converged and rt.converged
    assert rt.iterations >= 2
    np.testing.assert_allclose(rt.ritzv, pos, atol=1e-7)
    np.testing.assert_allclose(rt.ritzv, rj.ritzv, atol=1e-7)
    assert _true_resid(H, rt, nev).max() < 1e-9


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_eigsh_pseudo_structured_exact_spectrum(backend):
    N, nev, nex = 240, 12, 8
    H, lam = structured_pseudo_hermitian(N, dtype=np.float64, seed=11)
    rj = _jax_solve(("structured",), H, nev, nex, 1e-9)
    rt = ct.eigsh_pseudo(H, nev, nex, tol=1e-9, device="cpu",
                         config=ct.ChaseConfig(ring_backend=backend))
    assert rj.converged and rt.converged
    np.testing.assert_allclose(rt.ritzv, lam[:nev], atol=1e-7)
    np.testing.assert_allclose(rj.ritzv, lam[:nev], atol=1e-7)
    assert _true_resid(H, rt, nev).max() < 1e-8


def test_eigsh_pseudo_warm_start_reconverges():
    """approx=True with v0 = a converged block skips the initial QR and
    the DoS injection and re-converges at once, as in the JAX package."""
    N, nev, nex = 120, 6, 6
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=3)
    r1 = ct.eigsh_pseudo(H, nev, nex, tol=1e-9, device="cpu")
    r2 = ct.eigsh_pseudo(H, nev, nex, tol=1e-9, device="cpu", v0=r1.V,
                         ritzv0=r1.ritzv_full, approx=True)
    assert r1.converged and r2.converged
    assert r2.iterations < r1.iterations
    np.testing.assert_allclose(r2.ritzv, r1.ritzv, atol=1e-9)


def test_eigsh_pseudo_takes_an_operator_and_a_generator():
    N = 96
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=4)
    Ht = torch.from_numpy(H)
    op = ct.DenseOperator(Ht, "cpu", pseudo_hermitian=True)
    assert op.pseudo_hermitian and op.H is Ht      # resident: no copy
    g = torch.Generator().manual_seed(7)
    r = ct.eigsh_pseudo(op, 4, 4, tol=1e-9, generator=g)
    assert r.converged and r.V.device.type == "cpu"
    np.testing.assert_allclose(r.ritzv, _positive_spectrum(H, 4), atol=1e-8)


def test_eigsh_pseudo_residual_history_and_purge_run():
    """save_residuals writes the history CSV; phantom_purge (off by
    default, as in the reference) runs without harm."""
    import os
    import tempfile
    H = random_pseudo_hermitian(96, dtype=np.float64, seed=8)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "resid.csv")
        r = ct.eigsh_pseudo(H, 4, 4, tol=1e-9, device="cpu",
                            config=ct.ChaseConfig(save_residuals=path,
                                                  phantom_purge=True))
        lines = open(path).read().splitlines()
    assert r.converged and lines[0] == "iteration,residual"
    assert len(lines) == 1 + r.iterations * 8


# ---- refusals --------------------------------------------------------------

def test_eigsh_pseudo_refuses_like_jax():
    H = random_pseudo_hermitian(40, dtype=np.float64, seed=0)
    odd = np.zeros((41, 41))
    for fn, kw in ((ct.eigsh_pseudo, dict(device="cpu")),
                   (chase_tpu.eigsh_pseudo, {})):
        with pytest.raises(ValueError):
            fn(odd, 2, 2, **kw)                      # odd N
        with pytest.raises(ValueError):
            fn(H, 12, 9, **kw)                       # nev+nex > N/2
        with pytest.raises(ValueError):
            fn(H, 2, 2, approx=True, **kw)           # approx without v0
    with pytest.raises(ValueError):
        ct.DenseOperator(odd, "cpu", pseudo_hermitian=True)
    with pytest.raises(ValueError):
        ct.eigsh_pseudo(H, 2, 2, v0=np.zeros((40, 3)), device="cpu")


def test_eigsh_pseudo_cuda_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    ran = []
    monkeypatch.setattr(tsp, "solve_pseudo", lambda *a, **k: ran.append(1))
    H = random_pseudo_hermitian(16, dtype=np.float64, seed=0)
    with pytest.raises(RuntimeError, match="does not fall back"):
        ct.eigsh_pseudo(H, 2, 2)
    with pytest.raises(RuntimeError, match="does not fall back"):
        ct.eigsh_pseudo(H, 2, 2, device="cuda")
    assert not ran


def test_polish_passes_follow_precision_for_the_pencil():
    """The BSE pencil takes the Hermitian rule (the JAX package's
    ``pseudo`` argument selects nothing and is not ported)."""
    for dtype, want in ((torch.float64, 2), (torch.float32, 0),
                        (torch.complex128, 2), (torch.complex64, 0)):
        rcfg = ct.ChaseConfig().resolve(dtype, "cpu")
        assert rcfg.polish_passes() == want
        jr = chase_tpu.ChaseConfig().resolve(
            {torch.float64: np.float64, torch.float32: np.float32,
             torch.complex128: np.complex128,
             torch.complex64: np.complex64}[dtype])
        assert jr.polish_passes(pseudo=True) == want
    rcfg = dataclasses.replace(ct.ChaseConfig(), eigh_polish=1).resolve(
        torch.float64, "cpu")
    assert rcfg.polish_passes() == 1
