"""Problem sequences, spectral bounds and the standalone helpers of the
port against the JAX package.

* ``eigsh_sequence``: ``hermitian_sequence(180, 3, seed=17,
  drift=0.004)`` in c128 and f64, nev=10, nex=8, tol 1e-9, passed as a
  generator, against ``chase_tpu.eigsh_sequence(warmup=False)``: per
  member, eigenvalues within 1e-8 of JAX's and of eigvalsh, and
  iterations within ±1 of JAX's; warm members take no more iterations
  than the cold one.
* ``estimate_spectral_bounds`` (c128, f64): upperb ≥ λ_max, lambda_min ≥
  λ_min − 1e-8·‖H‖, and lowerb as close to the exact spectrum as the JAX
  package's own estimates get over a few probe keys.  The frameworks'
  probes differ, so there is no bitwise parity.
* ``ops.residuals.residuals``, ``checks.force_hermitian`` and
  ``models.hermitian_sequence`` against the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chase_tpu
from chase_tpu.models import hermitian_sequence as j_hermitian_sequence
from chase_tpu.ops.checks import force_hermitian as j_force_hermitian
from chase_tpu.ops.residuals import residuals as j_residuals

import chase_tpu_torch as ct
from chase_tpu_torch.models import hermitian_sequence, random_hermitian
from chase_tpu_torch.ops.checks import force_hermitian
from chase_tpu_torch.ops.residuals import residuals

torch.set_num_threads(1)

N, COUNT, NEV, NEX, TOL = 180, 3, 10, 8, 1e-9


@pytest.mark.parametrize("dtype", [np.complex128, np.float64],
                         ids=["c128", "f64"])
def test_eigsh_sequence_matches_jax(dtype):
    seq = hermitian_sequence(N, COUNT, dtype, seed=17, drift=0.004)
    cfg_j = chase_tpu.ChaseConfig(complex_backend="native")
    rj = list(chase_tpu.eigsh_sequence(seq, NEV, NEX, tol=TOL, config=cfg_j,
                                       warmup=False))
    results = ct.eigsh_sequence((H for H in seq), NEV, NEX, tol=TOL,
                                device="cpu")
    assert not isinstance(results, list)        # yields member by member
    rt = list(results)
    assert len(rt) == len(rj) == COUNT
    for H, a, b in zip(seq, rt, rj):
        assert a.converged and b.converged
        assert np.abs(a.ritzv - b.ritzv).max() <= 1e-8
        assert np.abs(a.ritzv - np.linalg.eigvalsh(H)[:NEV]).max() <= 1e-8
        assert a.V.dtype == torch.from_numpy(H).dtype
        assert abs(a.iterations - b.iterations) <= 1
    assert max(r.iterations for r in rt[1:]) <= rt[0].iterations


def test_eigsh_sequence_warm_starts_from_the_previous_member(monkeypatch):
    """Member i > 0 gets v0 = the previous V (a tensor on the device, no
    host round trip), ritzv0 = its ritzv_full and approx=True."""
    from chase_tpu_torch import api
    seq = hermitian_sequence(60, 3, np.complex128, seed=2, drift=0.004)
    seen = []
    real = api.eigsh

    def spy(H, nev, nex, **kw):
        seen.append((kw["v0"], kw["ritzv0"], kw["approx"]))
        return real(H, nev, nex, **kw)

    monkeypatch.setattr(api, "eigsh", spy)
    rt = list(ct.eigsh_sequence(iter(seq), 4, 6, tol=1e-9, device="cpu"))
    assert seen[0] == (None, None, False)
    for (v0, ritzv0, approx), prev in zip(seen[1:], rt[:-1]):
        assert approx and v0 is prev.V and ritzv0 is prev.ritzv_full


def _spectral_case(dtype):
    H = random_hermitian(N, dtype, seed=5)
    return H, np.linalg.eigvalsh(H)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64],
                         ids=["c128", "f64"])
def test_estimate_spectral_bounds(dtype):
    H, w = _spectral_case(dtype)
    nev = 18
    t = ct.estimate_spectral_bounds(H, nev=nev, device="cpu")
    assert set(t) == {"upperb", "lambda_min", "lowerb"}
    norm = np.abs(w).max()
    assert t["upperb"] >= w[-1]
    assert t["lambda_min"] >= w[0] - 1e-8 * norm
    assert t["lambda_min"] <= w[nev - 1]
    jax_dev = [abs(chase_tpu.estimate_spectral_bounds(
        H, nev=nev, key=jax.random.key(s))["lowerb"] - w[nev - 1])
        for s in range(3)]
    assert abs(t["lowerb"] - w[nev - 1]) <= 1.5 * max(jax_dev)
    # nev = 0: lowerb is the smallest Ritz value, as in the JAX package
    t0 = ct.estimate_spectral_bounds(H, device="cpu")
    assert t0["lowerb"] == t0["lambda_min"]


def test_estimate_spectral_bounds_accepts_a_generator_and_an_operator():
    H, _ = _spectral_case(np.float64)
    op = ct.DenseOperator(H, device="cpu")
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    a = ct.estimate_spectral_bounds(op, generator=g1)
    b = ct.estimate_spectral_bounds(torch.from_numpy(H), device="cpu",
                                    generator=g2)
    assert a == b


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12),
                                       (np.complex64, 1e-5),
                                       (np.complex128, 1e-12)],
                         ids=["f32", "f64", "c64", "c128"])
def test_residuals_match_jax(dtype, tol):
    H = random_hermitian(64, dtype, seed=6)
    w, Q = np.linalg.eigh(H.astype(np.complex128 if np.iscomplexobj(H)
                                   else np.float64))
    rng = np.random.default_rng(7)
    V = (Q[:, :9] + 1e-3 * rng.standard_normal((64, 9))).astype(dtype)
    lam = w[:9]
    rj = np.asarray(j_residuals(jnp.asarray(H), jnp.asarray(V),
                                jnp.asarray(lam)))
    rt = residuals(torch.from_numpy(H), torch.from_numpy(V), lam)
    real = torch.float32 if dtype in (np.float32, np.complex64) \
        else torch.float64
    assert rt.dtype == real and tuple(rt.shape) == (9,)
    assert np.abs(rt.numpy() - rj).max() <= tol * np.abs(rj).max()


@pytest.mark.parametrize("upper", [True, False], ids=["upper", "lower"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_force_hermitian_matches_jax(upper, dtype):
    rng = np.random.default_rng(8)
    A = rng.standard_normal((23, 23))
    if dtype == np.complex128:
        A = A + 1j * rng.standard_normal((23, 23))
    Hj = np.asarray(j_force_hermitian(jnp.asarray(A), upper=upper))
    Ht = force_hermitian(torch.from_numpy(A), upper=upper).numpy()
    np.testing.assert_array_equal(Ht, Hj)
    np.testing.assert_array_equal(Ht, Ht.conj().T)
    tri = np.triu if upper else np.tril
    np.testing.assert_array_equal(tri(Ht, 1 if upper else -1),
                                  tri(A, 1 if upper else -1))


@pytest.mark.parametrize("dtype", [np.complex128, np.float32],
                         ids=["c128", "f32"])
def test_hermitian_sequence_identical_to_jax(dtype):
    a = hermitian_sequence(40, 4, dtype, seed=3, drift=0.02)
    b = j_hermitian_sequence(40, 4, dtype, seed=3, drift=0.02)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(x, y)
