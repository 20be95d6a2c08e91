"""The BSE precision ladder of the port against the JAX package's
(tests/test_ladder_pseudo.py and tests/test_pseudo.py's bf16 rung).

f64 and c128 BSE problems (``random_pseudo_hermitian``, N=256, nev=24,
nex=16) at tol 1e-10 with ``mixed_precision=True``: the iteration-0 H²
filter on the f32/c64 shadow, then the deviation-form H² filter seeded by
the problem-precision H²-residuals.  On the windowed path (``"xla"``) and
on the p = 1 ring (``"pallas"``, every product through ring_hemm's plain
version on the CPU).  Gates, as the JAX package's own ladder tests:
converged; reported residual ≤ 1e-9; true residual < 5e-9; eigenvalues
within 1e-8 of numpy's ``eigvals`` and of JAX's; ≥ 80% of the analytic
FLOPs in f32/c64; iterations ≤ the port's pure-f64/c128 solve's + 1.  The
JAX side pins ``complex_backend="native"``, ``small_dense_backend=
"device"`` and ``wide_f64="off"``.

The f32 bf16 rung (tests/test_pseudo.py::test_bse_solve_bf16_filter): tol
1e-4, eigenvalues and true residuals within 100·tol·max(1, λ_max), some
filter FLOPs on bf16; on the ring every filter product is a bf16
ring_hemm call.
"""

import numpy as np
import pytest
import torch

import chase_tpu

import chase_tpu_torch as ct
from chase_tpu_torch.models import random_pseudo_hermitian
from chase_tpu_torch.parallel import ring as tring

torch.set_num_threads(1)

N, NEV, NEX = 256, 24, 16
JAX_PINS = dict(complex_backend="native", small_dense_backend="device",
                wide_f64="off")


def _positive_spectrum(H, k):
    ev = np.linalg.eigvals(H.astype(np.complex128))
    evr = np.sort(ev.real)
    return evr[evr > 0][:k]


def _true_resid(H, res, nev):
    V = np.asarray(res.V)[:, :nev]
    R = H.astype(V.dtype) @ V - V * res.ritzv[None, :].astype(V.dtype)
    return np.linalg.norm(R, axis=0)


def _count_ring_calls(monkeypatch):
    dtypes = []
    real = tring.ring_hemm
    monkeypatch.setattr(tring, "ring_hemm",
                        lambda Hk, *a, **k: dtypes.append(Hk.dtype)
                        or real(Hk, *a, **k))
    return dtypes


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_pseudo_ladder_reaches_1e10_with_low_precision_flops_like_jax(
        dtype, backend, monkeypatch):
    H = random_pseudo_hermitian(N, dtype=dtype, seed=11)
    exact = _positive_spectrum(H, NEV)
    rj = chase_tpu.eigsh_pseudo(
        H, NEV, NEX, tol=1e-10, collect_perf=True,
        config=chase_tpu.ChaseConfig(mixed_precision=True, **JAX_PINS))
    r64 = ct.eigsh_pseudo(H, NEV, NEX, tol=1e-10, device="cpu",
                          config=ct.ChaseConfig(mixed_precision=False,
                                                ring_backend=backend))
    calls = _count_ring_calls(monkeypatch)
    cfg = ct.ChaseConfig(mixed_precision=True, ring_backend=backend)
    rt = ct.eigsh_pseudo(H, NEV, NEX, tol=1e-10, device="cpu", config=cfg,
                         collect_perf=True)
    assert rj.converged and rt.converged and r64.converged
    assert rt.resid.max() <= 1e-9
    assert _true_resid(H, rt, NEV).max() < 5e-9
    np.testing.assert_allclose(rt.ritzv, exact, atol=1e-8)
    np.testing.assert_allclose(rt.ritzv, rj.ritzv, atol=1e-8)
    tdt = torch.from_numpy(H).dtype
    rcfg = cfg.resolve(tdt, "cpu")
    frac = rt.perf.low_flop_fraction(N, rcfg.lanczos_iter, 4, tdt)
    assert frac >= 0.80, f"only {frac:.0%} of FLOPs were low-precision"
    assert rt.iterations <= r64.iterations + 1
    assert rt.V.dtype == tdt
    if backend == "pallas":
        # every filter product of every iteration on the shadow's route
        low = torch.complex64 if tdt.is_complex else torch.float32
        assert len(calls) == rt.perf.filter_hemm_steps > 0
        assert set(calls) == {low}
    else:
        assert not calls


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_pseudo_bf16_rung_like_jax(backend, monkeypatch):
    N2, nev, nex = 200, 10, 8
    H = random_pseudo_hermitian(N2, dtype=np.float32, seed=5)
    pos = _positive_spectrum(H, nev)
    tol = 1e-4
    rj = chase_tpu.eigsh_pseudo(
        H, nev, nex, tol=tol, collect_perf=True,
        config=chase_tpu.ChaseConfig(bf16_filter=True, **JAX_PINS))
    calls = _count_ring_calls(monkeypatch)
    rt = ct.eigsh_pseudo(H, nev, nex, tol=tol, device="cpu",
                         collect_perf=True,
                         config=ct.ChaseConfig(bf16_filter=True,
                                               ring_backend=backend))
    assert rj.converged and rt.converged
    scale = max(1.0, float(pos[-1]))
    np.testing.assert_allclose(rt.ritzv, pos, atol=tol * scale * 100)
    np.testing.assert_allclose(rt.ritzv, rj.ritzv, atol=tol * scale * 100)
    assert _true_resid(H, rt, nev).max() < tol * scale * 100
    assert rt.perf.filtered_vecs_low > 0 and rj.perf.filtered_vecs_low > 0
    if backend == "pallas":
        assert len(calls) == rt.perf.filter_hemm_steps > 0
        assert set(calls) == {torch.bfloat16}


def test_complex_bse_never_takes_bf16(monkeypatch):
    """bf16_filter on a c64 BSE problem is ignored, as in the JAX package:
    every ring product is a c64 call and nothing counts as low."""
    H = random_pseudo_hermitian(120, dtype=np.complex64, seed=2)
    calls = _count_ring_calls(monkeypatch)
    r = ct.eigsh_pseudo(H, 6, 6, tol=1e-4, device="cpu", collect_perf=True,
                        config=ct.ChaseConfig(bf16_filter=True,
                                              ring_backend="pallas"))
    assert r.converged
    assert set(calls) == {torch.complex64}
    assert r.perf.filtered_vecs_low == 0


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_pseudo_ladder_iter0_cap_avoids_qr_rescue(backend):
    """tests/test_ladder_pseudo.py's wide-gap case (the largest rho₁, the
    regime of the iteration-0 S-QR collapse): with the cap, no CholQR
    rescue is logged, the cap is, and the ladder reaches 1e-10."""
    from chase_tpu_torch.logger import get_logger
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=23, gap=4.0,
                                spread=0.5)
    msgs = []
    log = get_logger()
    orig_warn, orig_info = log.warn, log.info
    log.warn = lambda msg, *a, **k: msgs.append(("warn", str(msg)))
    log.info = lambda msg, *a, **k: msgs.append(("info", str(msg)))
    try:
        res = ct.eigsh_pseudo(H, 16, 8, tol=1e-10, device="cpu",
                              config=ct.ChaseConfig(mixed_precision=True,
                                                    ring_backend=backend))
    finally:
        log.warn, log.info = orig_warn, orig_info
    assert res.converged
    assert _true_resid(H, res, 16).max() < 5e-9
    assert any("iteration-0 H² degree capped" in m for _, m in msgs)
    rescue = [m for k, m in msgs if k == "warn" and "falling back" in m]
    assert not rescue, rescue
