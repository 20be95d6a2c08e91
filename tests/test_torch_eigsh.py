"""The port's whole slice against the JAX package's solver.

Both solvers get the same numpy inputs (H, V0).  ``solve`` draws fresh
Lanczos probes even with V0, and the two frameworks' generators differ,
so the tests compare converged spectra and true residuals, not iterates.

* f32: Clement N=512, nev=40, nex=20, tol 1e-2 (absolute, ~2e-5·‖H‖).
  The port runs ring_backend="pallas" on the CPU — the p=1 ring filter,
  each HEMM through ring_hemm's plain version; JAX runs the same config on
  a (2, 1) grid, so its Pallas ring kernel runs in the TPU interpreter.
  Eigenvalues within 1e-3 of the exact spectrum and of each other; true
  residuals ≤ 10·tol.
* f64: random symmetric N=256, nev=24, nex=16, tol 1e-8, against JAX's
  default eigsh: eigenvalues within 1e-7.
* warm start: the f32 solve restarted from the JAX result (convert.py).
"""

import numpy as np
import pytest
import torch

import jax

import chase_tpu
import chase_tpu_torch as ct
from chase_tpu_torch import convert
from chase_tpu_torch.models import (clement, clement_eigenvalues,
                                    random_hermitian)
from chase_tpu_torch.ops import ring_hemm as trh
from chase_tpu_torch.utils import residual_norms, validate_result

torch.set_num_threads(1)

N32, NEV32, NEX32, TOL32 = 512, 40, 20, 1e-2


def _true_resid(H, V, lam):
    return residual_norms(np.asarray(H, np.float64),
                          np.asarray(V, np.float64), lam)


@pytest.fixture(scope="module")
def f32_case():
    H = clement(N32).astype(np.float32)
    V0 = np.random.default_rng(0).standard_normal(
        (N32, NEV32 + NEX32)).astype(np.float32)
    grid = chase_tpu.make_grid(jax.devices()[:2], shape=(2, 1))
    rj = chase_tpu.eigsh(H, NEV32, NEX32, tol=TOL32, v0=V0, grid=grid,
                         config=chase_tpu.ChaseConfig(ring_backend="pallas"))
    return H, V0, rj


def test_f32_slice_ring_pallas_matches_jax(f32_case, monkeypatch):
    H, V0, rj = f32_case
    calls = []
    real = trh.ring_hemm

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(trh, "ring_hemm", counting)
    rt = ct.eigsh(H, NEV32, NEX32, tol=TOL32, v0=V0, device="cpu",
                  config=ct.ChaseConfig(ring_backend="pallas"),
                  collect_perf=True)
    exact = clement_eigenvalues(N32)[:NEV32]
    assert rj.converged and rt.converged
    assert np.abs(rt.ritzv - exact).max() <= 1e-3
    assert np.abs(rj.ritzv - exact).max() <= 1e-3
    assert np.abs(rt.ritzv - rj.ritzv).max() <= 1e-3
    V = rt.V[:, :NEV32].numpy()
    assert _true_resid(H, V, rt.ritzv).max() <= 10 * TOL32
    Vj = np.asarray(rj.V)[:, :NEV32]
    assert _true_resid(H, Vj, rj.ritzv).max() <= 10 * TOL32
    # every filter step went through the ring HEMM wrapper
    assert len(calls) == rt.perf.filter_hemm_steps > 0
    assert rt.V.dtype == torch.float32 and rt.V.device.type == "cpu"


def test_f32_windowed_filter_path_converges(f32_case):
    """ring_backend='xla' keeps the segmented windowed filter on one
    device (the JAX package's single-device route)."""
    H, V0, rj = f32_case
    rt = ct.eigsh(H, NEV32, NEX32, tol=TOL32, v0=V0, device="cpu")
    assert rt.converged
    assert np.abs(rt.ritzv - rj.ritzv).max() <= 1e-3


def test_f32_warm_start_from_jax_result(f32_case):
    H, _, rj = f32_case
    v0, ritzv0 = convert.warm_start_from(rj, device="cpu")
    assert v0.dtype == torch.float32 and tuple(v0.shape) == (N32,
                                                             NEV32 + NEX32)
    rt = ct.eigsh(convert.array_to_torch(H, device="cpu"), NEV32, NEX32,
                  tol=TOL32,
                  v0=v0, ritzv0=ritzv0, approx=True, device="cpu",
                  config=ct.ChaseConfig(ring_backend="pallas"))
    assert rt.converged
    assert rt.iterations <= rj.iterations
    assert np.abs(rt.ritzv - clement_eigenvalues(N32)[:NEV32]).max() <= 1e-3
    assert _true_resid(H, rt.V[:, :NEV32].numpy(),
                       rt.ritzv).max() <= 10 * TOL32


def test_f64_random_symmetric_matches_jax_default():
    H = random_hermitian(256, dtype=np.float64)
    V0 = np.random.default_rng(1).standard_normal((256, 40))
    rj = chase_tpu.eigsh(H, 24, 16, tol=1e-8, v0=V0)
    rt = ct.eigsh(H, 24, 16, tol=1e-8, v0=V0, device="cpu")
    assert rj.converged and rt.converged
    assert np.abs(rt.ritzv - rj.ritzv).max() <= 1e-7
    assert np.abs(rt.ritzv - np.linalg.eigvalsh(H)[:24]).max() <= 1e-7
    validate_result(H, rt)


def test_f64_clement_largest_and_no_v0():
    H = clement(200)
    rt = ct.eigsh(H, 10, 10, tol=1e-10, device="cpu", largest=True)
    rj = chase_tpu.eigsh(H, 10, 10, tol=1e-10, largest=True)
    assert rt.converged
    np.testing.assert_allclose(rt.ritzv, clement_eigenvalues(200)[-10:],
                               atol=1e-8)
    np.testing.assert_allclose(rt.ritzv, rj.ritzv, atol=1e-8)


def test_perf_report_and_resid_history(tmp_path):
    path = tmp_path / "resid.csv"
    cfg = ct.ChaseConfig(save_residuals=str(path))
    rt = ct.eigsh(clement(128), 8, 8, tol=1e-10, device="cpu", config=cfg,
                  collect_perf=True)
    assert rt.converged
    lines = path.read_text().splitlines()
    assert lines[0] == "iteration,residual" and len(lines) > 1
    report = rt.perf.report(128, 25, 4, torch.float64)
    assert "GFLOPS(filter)" in report
    assert "fraction-of-peak" not in report
    assert rt.perf.timings["All"] > 0


def test_unported_options_raise_naming_the_roadmap():
    """What eigsh refuses: nev+nex > N, and a warm start without v0.  (The
    precision ladder, once refused here, is ported and tested in
    test_torch_ladder.py.)"""
    H = clement(64)
    with pytest.raises(ValueError):
        ct.eigsh(H, 40, 40, device="cpu")
    with pytest.raises(ValueError):
        ct.eigsh(H, 4, 4, device="cpu", approx=True)
