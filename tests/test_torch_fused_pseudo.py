"""The port's fused BSE solver (``eigsh_pseudo_fused``, ``fused_pseudo.
solve_pseudo_fused``) against the JAX package on the CPU.

* The whole solver on the same input: ``solve_pseudo_fused`` of both
  packages with the same V0 (lower rows damped by 0.001) and
  ``probes=None``, f64 and c128 ``random_pseudo_hermitian`` (N=160,
  nev=10, nex=8, tol 1e-9; and the multi-round locking case): the same
  iterations, locked count and filtered-vector count, positive Ritz
  values within 1e-9.
* Cases modelled on ``tests/test_fused_pseudo.py``: the spectrum against
  numpy's ``eigvals`` (1e-7), agreement with the port's ``eigsh_pseudo``,
  perf counters, a tiny block, the DP ladder at 1e-10, the cluster-tail
  regression and the bf16 rung (tol 1e-4, eigenvalues within 1e-2), on
  "xla" and on the ring path ("pallas": two ring_hemm calls per H²
  step, through its plain version on the CPU).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chase_tpu as jchase
from chase_tpu import fused_pseudo as jfp

import chase_tpu_torch as ct
from chase_tpu_torch import fused_pseudo as tfp
from chase_tpu_torch.models import random_pseudo_hermitian
from chase_tpu_torch.ops import ring_hemm as trh

from conftest import TOLS

torch.set_num_threads(1)


def _pos(H, k):
    ev = np.sort(np.linalg.eigvals(H.astype(np.complex128)).real)
    return ev[ev > 0][:k]


def _true_resid(H, res, nev):
    V = res.V.numpy()[:, :nev]
    R = H.astype(V.dtype) @ V - V * res.ritzv[None, :].astype(V.dtype)
    return np.linalg.norm(R, axis=0)


CASES = {"f64": (np.float64, 5, {}, 10, 8, 1e-9),
         "c128": (np.complex128, 5, {}, 10, 8, 1e-9),
         "c128-lock": (np.complex128, 11, dict(coupling=0.4, spread=0.8),
                       14, 6, 1e-10)}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_pseudo_fused_matches_jax(case):
    dtype, seed, gen, nev, nex, tol = CASES[case]
    H = random_pseudo_hermitian(160, dtype=dtype, seed=seed, **gen)
    rng = np.random.default_rng(3)
    V0 = rng.standard_normal((160, 2 * (nev + nex)))
    if dtype == np.complex128:
        V0 = V0 + 1j * rng.standard_normal(V0.shape)
    V0[80:] *= 0.001
    V0 = V0.astype(dtype)
    kw = dict(nev=nev, nex=nex, tol=tol, deg0=20, max_deg=36, eigh_polish=2)
    a = jfp.solve_pseudo_fused(jnp.asarray(H), jnp.asarray(V0), **kw)
    b = tfp.solve_pseudo_fused(torch.from_numpy(H), torch.from_numpy(V0),
                               **kw)
    assert int(b["iterations"]) == int(a["iterations"])
    assert int(b["locked"]) == int(a["locked"]) >= nev
    assert int(b["filtered_vecs"]) == int(a["filtered_vecs"])
    np.testing.assert_allclose(b["ritzv"].numpy()[:nev],
                               np.asarray(a["ritzv"])[:nev], atol=1e-9)
    np.testing.assert_allclose(b["ritzv"].numpy()[:nev], _pos(H, nev),
                               atol=1e-8)
    # the mirrors are materialised K-conjugates, never lazy views
    assert not b["V"].is_conj()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_eigsh_pseudo_fused_matches_spectrum(dtype, backend):
    H = random_pseudo_hermitian(160, dtype=dtype, seed=5)
    res = ct.eigsh_pseudo_fused(H, 10, 8, tol=1e-9, device="cpu",
                                config=ct.ChaseConfig(ring_backend=backend))
    assert res.converged and res.V.shape == (160, 36)
    np.testing.assert_allclose(res.ritzv, _pos(H, 10), atol=1e-7)
    assert _true_resid(H, res, 10).max() < 1e-7


def test_eigsh_pseudo_fused_agrees_with_host_driver():
    H = random_pseudo_hermitian(140, dtype=np.complex128, seed=9)
    a = ct.eigsh_pseudo(H, 8, 8, tol=1e-9, device="cpu")
    b = ct.eigsh_pseudo_fused(H, 8, 8, tol=1e-9, device="cpu")
    assert a.converged and b.converged
    np.testing.assert_allclose(a.ritzv, b.ritzv, atol=1e-7)


def test_eigsh_pseudo_fused_multiround_locking():
    H = random_pseudo_hermitian(160, dtype=np.complex128, seed=11,
                                coupling=0.4, spread=0.8)
    res = ct.eigsh_pseudo_fused(H, 14, 6, tol=1e-10, device="cpu")
    assert res.converged and res.iterations >= 2
    np.testing.assert_allclose(res.ritzv, _pos(H, 14), atol=1e-6)


def test_eigsh_pseudo_fused_perf_counters_and_ring_calls(monkeypatch):
    """Two products per H² step: the perf counters count them, and on the
    ring path each is one ring_hemm call."""
    calls = []
    real = trh.ring_hemm
    monkeypatch.setattr(trh, "ring_hemm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    H = random_pseudo_hermitian(128, dtype=np.float32, seed=2)
    res = ct.eigsh_pseudo_fused(H, 6, 6, tol=1e-4, device="cpu",
                                collect_perf=True,
                                config=ct.ChaseConfig(ring_backend="pallas"))
    assert res.converged
    perf = res.perf
    assert perf.matrix_type == 1 and perf.filtered_vecs > 0
    assert perf.iter_count == res.iterations
    assert perf.get_flops(128, 12, 4, torch.float32) > 0
    assert perf.filter_hemm_steps % 2 == 0
    assert len(calls) == perf.filter_hemm_steps > 0


def test_eigsh_pseudo_fused_tiny_block():
    """2·(nev+nex) below num_lanczos: the probe count follows the block.
    At k = 3 the Lanczos estimate is crude (its step count is capped by
    nev+nex) and, by the start block, the solve settles on the smallest
    pairs or on a cluster above them, in either package; what it returns
    are eigenpairs of H."""
    H = random_pseudo_hermitian(64, dtype=np.float64, seed=1)
    ev = np.sort(np.linalg.eigvals(H).real)
    res = ct.eigsh_pseudo_fused(H, 2, 1, tol=1e-8, device="cpu")
    assert res.ritzv.shape == (2,) and (res.ritzv > 0).all()
    assert np.abs(res.ritzv[:, None] - ev[None, :]).min(axis=1).max() < 1e-5


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_eigsh_pseudo_fused_refine_ladder_dp(backend):
    """The BSE DP ladder at 1e-10: H² products on the f32 shadow, true
    residuals at DP accuracy, iterations within 2 of the f64 filter's."""
    H = random_pseudo_hermitian(192, dtype=np.float64, seed=29)
    res = ct.eigsh_pseudo_fused(H, 16, 12, tol=1e-10, device="cpu",
                                config=ct.ChaseConfig(mixed_precision=True,
                                                      ring_backend=backend))
    assert res.converged
    assert _true_resid(H, res, 16).max() < 5e-9
    np.testing.assert_allclose(res.ritzv, _pos(H, 16), atol=1e-8)
    f64 = ct.eigsh_pseudo_fused(H, 16, 12, tol=1e-10, device="cpu",
                                config=ct.ChaseConfig(mixed_precision=False))
    assert abs(res.iterations - f64.iterations) <= 2


def test_eigsh_pseudo_fused_ladder_cluster_tail_regression():
    """The cluster factors leave the nex tail's degrees alone (inflating
    them tipped this problem into f32 overflow in the JAX package)."""
    H = random_pseudo_hermitian(200, dtype=np.float64, seed=7)
    res = ct.eigsh_pseudo_fused(H, 16, 10, tol=1e-10, device="cpu",
                                config=ct.ChaseConfig(mixed_precision=True))
    assert res.converged and res.iterations <= 8
    assert _true_resid(H, res, 16).max() < 5e-9


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_eigsh_pseudo_fused_bf16_rung(backend):
    H = random_pseudo_hermitian(160, dtype=np.float64, seed=31)
    Hf = H.astype(np.float32)
    res = ct.eigsh_pseudo_fused(Hf, 10, 8, tol=1e-4, device="cpu",
                                config=ct.ChaseConfig(bf16_filter=True,
                                                      ring_backend=backend))
    assert res.converged
    np.testing.assert_allclose(res.ritzv, _pos(H, 10), atol=1e-2)
    assert _true_resid(Hf, res, 10).max() < 1e-2


def test_eigsh_pseudo_fused_c128_ladder_matches_jax(monkeypatch):
    """The c128 BSE on the ladder (the route eigsh_pseudo_fused takes on
    the card: both products of every H² step on the c64 shadow's kernel
    route; ring_hemm's plain version here) against
    chase_tpu.eigsh_pseudo_fused on the same H and v0, mixed_precision
    and small_dense_backend pinned on both sides: converged spectra
    within conftest.TOLS, iterations ±1, one c64 ring_hemm call per HEMM
    step, every vector filtered on the shadow."""
    H = random_pseudo_hermitian(160, dtype=np.complex128, seed=5)
    rng = np.random.default_rng(3)
    V0 = rng.standard_normal((160, 36)) + 1j * rng.standard_normal((160, 36))
    V0[80:] *= 0.001
    calls = []
    real = trh.ring_hemm
    monkeypatch.setattr(trh, "ring_hemm", lambda *a, **k: calls.append(
        (a[0].dtype, a[1].dtype)) or real(*a, **k))
    kw = dict(mixed_precision=True, small_dense_backend="device",
              ring_backend="pallas")
    a = jchase.eigsh_pseudo_fused(H, 10, 8, tol=1e-10, v0=V0,
                                  config=jchase.ChaseConfig(**kw))
    b = ct.eigsh_pseudo_fused(H, 10, 8, tol=1e-10, v0=V0, device="cpu",
                              collect_perf=True, config=ct.ChaseConfig(**kw))
    assert a.converged and b.converged
    assert abs(b.iterations - a.iterations) <= 1
    atol = TOLS[np.dtype(np.complex128)]
    np.testing.assert_allclose(b.ritzv, a.ritzv, atol=atol)
    np.testing.assert_allclose(b.ritzv, _pos(H, 10), atol=atol)
    assert _true_resid(H, b, 10).max() < 5e-9
    assert len(calls) == b.perf.filter_hemm_steps > 0
    assert set(calls) == {(torch.complex64, torch.complex64)}
    assert b.perf.filtered_vecs_low == b.perf.filtered_vecs


def test_eigsh_pseudo_fused_bf16_rung_hands_back_to_f32():
    """The fused bf16 rung filters on the bf16 shadow until its low phase
    ends and on the f32 H after it: part of the filtered vectors count as
    low precision, not all."""
    H = random_pseudo_hermitian(160, dtype=np.float64, seed=31)
    res = ct.eigsh_pseudo_fused(H.astype(np.float32), 10, 8, tol=1e-4,
                                device="cpu", collect_perf=True,
                                config=ct.ChaseConfig(bf16_filter=True))
    assert res.converged
    assert 0 < res.perf.filtered_vecs_low < res.perf.filtered_vecs


def test_eigsh_pseudo_fused_warm_start_reconverges():
    H = random_pseudo_hermitian(120, dtype=np.float64, seed=3)
    r1 = ct.eigsh_pseudo_fused(H, 6, 6, tol=1e-9, device="cpu")
    r2 = ct.eigsh_pseudo_fused(H, 6, 6, tol=1e-9, v0=r1.V, device="cpu")
    assert r1.converged and r2.converged
    assert r2.iterations < r1.iterations
    np.testing.assert_allclose(r2.ritzv, r1.ritzv, atol=1e-9)


def test_eigsh_pseudo_fused_refuses(monkeypatch):
    H = random_pseudo_hermitian(40, dtype=np.float64, seed=0)
    with pytest.raises(ValueError):
        ct.eigsh_pseudo_fused(np.zeros((41, 41)), 2, 2, device="cpu")
    with pytest.raises(ValueError):
        ct.eigsh_pseudo_fused(H, 12, 9, device="cpu")
    with pytest.raises(ValueError):
        ct.eigsh_pseudo_fused(H, 2, 2, v0=np.zeros((40, 3)), device="cpu")
    if torch.cuda.is_available():
        return
    ran = []
    monkeypatch.setattr(tfp, "solve_pseudo_fused",
                        lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="does not fall back"):
        ct.eigsh_pseudo_fused(H, 2, 2)
    assert not ran
