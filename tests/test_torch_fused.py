"""The port's fused Hermitian solver (``eigsh_fused``, ``fused.
solve_fused``), ``step.iteration_step`` and ``warmup`` against the JAX
package on the CPU.

* Helpers: ``_tier_offsets`` gives the JAX integers; the batched
  tridiagonal eigh, the DoS bounds and the Chebyshev radius agree within
  1e-12 (f64); ``iteration_step`` within 1e-10.
* The whole solver on the same input: ``solve_fused`` of both packages
  with the same V0 and ``probes=None`` (both take the Lanczos probes from
  the orthonormalised V0, so the runs are deterministic): f64 Clement and
  c128 ``random_hermitian`` (N=256, nev=24, nex=16, tol 1e-10) with the
  same iterations, locked count, filtered-vector count and block history,
  Ritz values within 1e-9 and every residual ≤ tol; f32 on the ring path
  (``ring_hemm``'s plain version on the CPU) within ±1 iteration and
  1e-3·‖H‖.
* Cases modelled on ``tests/test_fused.py``, against exact spectra or the
  port's own ``eigsh``.
"""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chase_tpu
from chase_tpu import fused as jfused
from chase_tpu.step import iteration_step as j_iteration_step

import chase_tpu_torch as ct
from chase_tpu_torch import convert, fused as tfused
from chase_tpu_torch.models import (clement, clement_eigenvalues,
                                    hermitian_sequence, random_hermitian)
from chase_tpu_torch.ops import ring_hemm as trh
from chase_tpu_torch.parallel.ring import filter_product
from chase_tpu_torch.step import iteration_step

from conftest import TOLS

torch.set_num_threads(1)

N, NEV, NEX = 256, 24, 16


def _v0(n, k, dtype, seed=3):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, k))
    if np.issubdtype(dtype, np.complexfloating):
        V = V + 1j * rng.standard_normal((n, k))
    return V.astype(dtype)


def _case(dtype):
    if np.issubdtype(dtype, np.complexfloating):
        H = random_hermitian(N, dtype, seed=9)
        return H, np.linalg.eigvalsh(H)[:NEV]
    return clement(N).astype(dtype), clement_eigenvalues(N)[:NEV]


def _true_resid(H, res, nev):
    V = res.V.numpy()[:, :nev]
    R = H.astype(V.dtype) @ V - V * res.ritzv[None, :].astype(V.dtype)
    return np.linalg.norm(R, axis=0)


# ---- helpers -----------------------------------------------------------------

@pytest.mark.parametrize("k", [8, 40, 100, 512, 768, 3000])
def test_tier_offsets_match_jax(k):
    for tiers in (1, 2, 3, 4):
        assert tfused._tier_offsets(k, tiers) == \
            jfused._tier_offsets(k, tiers)


def test_tridiagonal_eigh_dos_bounds_and_rho_match_jax():
    rng = np.random.default_rng(1)
    m, nv = 12, 4
    a = rng.standard_normal((m, nv))
    b = np.abs(rng.standard_normal((m, nv))) + 0.1
    wj, Qj = jfused._eigh_tridiag_batched(jnp.asarray(a), jnp.asarray(b[:-1]))
    wt, Qt = tfused.eigh_tridiag_batched(torch.from_numpy(a),
                                         torch.from_numpy(b[:-1]))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-12)
    # eigenvectors up to sign: compare the DoS weights |q_0|²
    tau_j = np.abs(np.asarray(Qj)[:, 0, :]) ** 2
    tau_t = Qt[:, 0, :].abs().numpy() ** 2
    np.testing.assert_allclose(tau_t, tau_j, atol=1e-12)
    for nevex, n in ((10, 200), (40, 200), (190, 200)):
        bj = jfused._dos_bounds(jnp.asarray(wj), jnp.asarray(tau_j),
                                jnp.asarray(b[-1]), nevex, n)
        bt = tfused._dos_bounds(wt, torch.from_numpy(tau_t),
                                torch.from_numpy(b[-1]), nevex, n)
        for x, y in zip(bt, bj):
            assert abs(float(x) - float(y)) <= 1e-12
    t = np.array([-3.0, -1.0, -0.2, 0.0, 0.5, 1.0, 1.7, 40.0])
    np.testing.assert_allclose(tfused.cheb_rho(torch.from_numpy(t)).numpy(),
                               np.asarray(jfused._cheb_rho(jnp.asarray(t))),
                               atol=1e-12)


def test_iteration_step_matches_jax():
    H = clement(N)
    V = _v0(N, 40, np.float64)
    V, _ = np.linalg.qr(V)
    deg = np.full(40, 8, np.int32)
    deg[:5] = 0
    deg[20:] = 12
    args = (-255.0, -150.0, 255.0, 5)
    Vj, rj, sj = j_iteration_step(jnp.asarray(H), jnp.asarray(V),
                                  jnp.asarray(deg), *args)
    Vt, rt, st = iteration_step(torch.from_numpy(H), torch.from_numpy(V),
                                deg, *args)
    np.testing.assert_allclose(rt.numpy()[5:], np.asarray(rj)[5:],
                               atol=1e-10)
    np.testing.assert_allclose(st.numpy()[5:], np.asarray(sj)[5:],
                               atol=1e-10)
    # Ritz vectors up to sign
    dots = np.abs(np.sum(Vt.numpy() * np.asarray(Vj), axis=0))
    np.testing.assert_allclose(dots[5:], 1.0, atol=1e-10)


# ---- the whole solver on the same input ------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_solve_fused_matches_jax(dtype):
    H, exact = _case(np.dtype(dtype))
    V0 = _v0(N, NEV + NEX, dtype)
    kw = dict(nev=NEV, nex=NEX, tol=1e-10, deg0=20, max_deg=36,
              eigh_polish=2)
    a = jfused.solve_fused(jnp.asarray(H), jnp.asarray(V0), **kw)
    b = tfused.solve_fused(torch.from_numpy(H), torch.from_numpy(V0), **kw)
    it = int(a["iterations"])
    assert int(b["iterations"]) == it and int(b["locked"]) == \
        int(a["locked"]) >= NEV
    assert int(b["filtered_vecs"]) == int(a["filtered_vecs"])
    assert b["block_history"][:it].tolist() == \
        np.asarray(a["block_history"])[:it].tolist()
    np.testing.assert_allclose(b["ritzv"].numpy()[:NEV],
                               np.asarray(a["ritzv"])[:NEV], atol=1e-9)
    np.testing.assert_allclose(b["ritzv"].numpy()[:NEV], exact, atol=1e-9)
    assert float(b["resid"][:NEV].max()) <= 1e-10
    assert b["hemm_steps"] > 0


def test_solve_fused_f32_ring_matches_jax(monkeypatch):
    """The p = 1 route with "pallas": every filter product through
    ring_hemm (its plain version on the CPU), one call per HEMM step."""
    H = clement(N).astype(np.float32)
    V0 = _v0(N, NEV + NEX, np.float32)
    kw = dict(nev=NEV, nex=NEX, tol=1e-3, deg0=10, max_deg=18,
              eigh_polish=0)
    calls = []
    real = trh.ring_hemm
    monkeypatch.setattr(trh, "ring_hemm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    a = jfused.solve_fused(jnp.asarray(H), jnp.asarray(V0), **kw)
    b = tfused.solve_fused(torch.from_numpy(H), torch.from_numpy(V0),
                           chunk=functools.partial(filter_product, "p1",
                                                   pallas=True), **kw)
    assert abs(int(b["iterations"]) - int(a["iterations"])) <= 1
    assert int(b["locked"]) >= NEV
    np.testing.assert_allclose(b["ritzv"].numpy()[:NEV],
                               np.asarray(a["ritzv"])[:NEV],
                               atol=1e-3 * (N - 1))
    assert len(calls) == b["hemm_steps"] > 0


def test_loop_reads_control_once_per_iteration(monkeypatch):
    """The host reads one packed control tensor per iteration, plus the
    read that ends the loop."""
    reads = []
    real = tfused.control
    monkeypatch.setattr(tfused, "control",
                        lambda *v: reads.append(1) or real(*v))
    res = ct.eigsh_fused(clement(128), 8, 8, tol=1e-9, device="cpu")
    assert res.converged and len(reads) == res.iterations + 1


# ---- end to end (tests/test_fused.py's cases) -------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_eigsh_fused_exact_spectrum(dtype):
    H, exact = _case(np.dtype(dtype))
    res = ct.eigsh_fused(H, NEV, NEX, tol=1e-10, device="cpu")
    assert res.converged and res.V.dtype == torch.from_numpy(H).dtype
    np.testing.assert_allclose(res.ritzv, exact, atol=1e-7)
    assert _true_resid(H, res, NEV).max() < 1e-8 * N


def test_eigsh_fused_agrees_with_host_driver():
    H = random_hermitian(200, np.float64, seed=13)
    a = ct.eigsh(H, 16, 12, tol=1e-10, device="cpu")
    b = ct.eigsh_fused(H, 16, 12, tol=1e-10, device="cpu")
    assert a.converged and b.converged
    np.testing.assert_allclose(a.ritzv, b.ritzv, atol=1e-8)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_eigsh_fused_f32_and_bf16_rung(backend):
    H = clement(192).astype(np.float32)
    exact = clement_eigenvalues(192)[:12]
    for bf16 in (False, True):
        res = ct.eigsh_fused(H, 12, 12, tol=1e-4, device="cpu",
                             config=ct.ChaseConfig(bf16_filter=bf16,
                                                   ring_backend=backend))
        assert res.converged
        np.testing.assert_allclose(res.ritzv, exact, atol=1e-1)


def test_eigsh_fused_perf_and_residual_history():
    H = clement(128)
    with tempfile.TemporaryDirectory() as d:
        csv = os.path.join(d, "hist.csv")
        res = ct.eigsh_fused(H, 8, 8, tol=1e-9, device="cpu",
                             collect_perf=True,
                             config=ct.ChaseConfig(save_residuals=csv))
        lines = open(csv).read().strip().splitlines()
    assert res.converged and res.perf is not None
    assert res.perf.filtered_vecs > 0 and res.perf.filter_hemm_steps > 0
    assert res.perf.iter_count == res.iterations == \
        len(res.perf.iter_blocksizes)
    assert res.perf.get_flops(128, 25, 4, torch.float64) > 0
    assert res.perf.timings["All"] > 0
    assert lines[0] == "iteration,residual"
    assert len(lines) == 1 + res.iterations * 16
    last = np.array([float(x.split(",")[1]) for x in lines[1:]
                     if x.startswith(f"{res.iterations - 1},")])
    assert last[last >= 0].min() < 1e-8 * 128


def test_eigsh_fused_largest():
    res = ct.eigsh_fused(clement(200), 10, 10, tol=1e-9, largest=True,
                         device="cpu")
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(200)[-10:],
                               atol=1e-6)
    V = res.V.numpy()[:, :10]
    R = clement(200) @ V - V * res.ritzv[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-6


def test_eigsh_fused_warm_start_converges_faster():
    H1, H2 = hermitian_sequence(256, 2, np.float64, seed=4)
    r1 = ct.eigsh_fused(H1, 16, 16, tol=1e-9, device="cpu")
    cold = ct.eigsh_fused(H2, 16, 16, tol=1e-9, device="cpu")
    warm = ct.eigsh_fused(H2, 16, 16, tol=1e-9, v0=r1.V, device="cpu")
    assert r1.converged and warm.converged
    assert warm.iterations < cold.iterations
    np.testing.assert_allclose(warm.ritzv, np.linalg.eigvalsh(H2)[:16],
                               atol=1e-6)


def test_eigsh_fused_tiny_block_smaller_than_num_lanczos():
    res = ct.eigsh_fused(clement(64), 2, 1, tol=1e-9, device="cpu")
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(64)[:2],
                               atol=1e-7)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_eigsh_fused_refine_ladder_dp(backend):
    """The DP ladder at 1e-10: the filter on the f32 shadow (the
    deviation form from iteration 1), true residuals at DP accuracy,
    iterations within 2 of the f64 filter's."""
    rng = np.random.default_rng(0)
    E = rng.standard_normal((N, N))
    H = clement(N) + 1e-6 * (E + E.T) / 2
    res = ct.eigsh_fused(H, NEV, NEX, tol=1e-10, device="cpu",
                         collect_perf=True, config=ct.ChaseConfig(
                             mixed_precision=True, ring_backend=backend))
    assert res.converged
    assert _true_resid(H, res, NEV).max() < 5e-9
    np.testing.assert_allclose(res.ritzv, np.linalg.eigvalsh(H)[:NEV],
                               atol=1e-9)
    f64 = ct.eigsh_fused(H, NEV, NEX, tol=1e-10, device="cpu",
                         config=ct.ChaseConfig(mixed_precision=False))
    assert abs(res.iterations - f64.iterations) <= 2


def test_eigsh_fused_phase_tiers_match_full_width():
    """fused_tiers=3 runs the upper tiers once columns lock (low degrees
    make the locking gradual) and converges to the spectrum of the
    full-width body (fused_tiers=1)."""
    H = clement(200)
    assert tfused._tier_offsets(32, 3) == [0, 16, 24]
    ritz = {}
    for tiers in (1, 3):
        res = ct.eigsh_fused(H, 24, 8, tol=1e-10, device="cpu",
                             collect_perf=True,
                             config=ct.ChaseConfig(fused_tiers=tiers, deg=8,
                                                   max_deg=12))
        assert res.converged
        ritz[tiers] = res.ritzv
        assert _true_resid(H, res, 24).max() < 1e-8
        # blocks of k − locked ≤ 16: the tier at offset 16 ran
        assert min(res.perf.iter_blocksizes) <= 32 - 16
    np.testing.assert_allclose(ritz[1], clement_eigenvalues(200)[:24],
                               atol=1e-8)
    np.testing.assert_allclose(ritz[1], ritz[3], atol=1e-9)


# the card's fused routes, where no case held them to the JAX package:
# (dtype, mixed_precision, ring_backend, tol)
FUSED_ROUTES = {"c64-pallas": (np.complex64, False, "pallas", 1e-4),
                "c128-ladder": (np.complex128, True, "pallas", 1e-10)}


@pytest.mark.parametrize("route", list(FUSED_ROUTES))
def test_eigsh_fused_route_matches_jax_fused(route, monkeypatch):
    """eigsh_fused on the routes FilterProducts takes on the card — c64
    on "pallas" (the kernel's c64 route; ring_hemm's plain version here)
    and the c128 ladder (every product on the c64 shadow's route) —
    against chase_tpu.eigsh_fused on the same H and v0, mixed_precision
    and small_dense_backend pinned on both sides: converged spectra within
    conftest.TOLS, iterations ±1, one c64 ring_hemm call per HEMM step."""
    dtype, mixed, backend, tol = FUSED_ROUTES[route]
    H = random_hermitian(N, dtype, seed=9)
    V0 = _v0(N, NEV + NEX, dtype)
    calls = []
    real = trh.ring_hemm
    monkeypatch.setattr(trh, "ring_hemm", lambda *a, **k: calls.append(
        (a[0].dtype, a[1].dtype)) or real(*a, **k))
    kw = dict(mixed_precision=mixed, small_dense_backend="device",
              ring_backend=backend)
    a = chase_tpu.eigsh_fused(H, NEV, NEX, tol=tol, v0=V0,
                              config=chase_tpu.ChaseConfig(**kw))
    b = ct.eigsh_fused(H, NEV, NEX, tol=tol, v0=V0, device="cpu",
                       collect_perf=True, config=ct.ChaseConfig(**kw))
    assert a.converged and b.converged
    assert abs(b.iterations - a.iterations) <= 1
    atol = TOLS[np.dtype(dtype)]
    np.testing.assert_allclose(b.ritzv, a.ritzv, atol=atol)
    np.testing.assert_allclose(
        b.ritzv, np.linalg.eigvalsh(H.astype(np.complex128))[:NEV],
        atol=atol)
    assert _true_resid(H.astype(np.complex128), b, NEV).max() <= 10 * tol
    assert len(calls) == b.perf.filter_hemm_steps > 0
    assert set(calls) == {(torch.complex64, torch.complex64)}
    # the ladder filters every vector on the shadow, c64 on its own H
    assert b.perf.filtered_vecs_low == (b.perf.filtered_vecs if mixed
                                        else 0)


@pytest.mark.parametrize("rung", ["native", "ladder", "bf16"])
def test_eigsh_fused_counts_the_vectors_filtered_on_the_shadow(rung):
    """The fused PerfData's filtered_vecs_low (the low-precision FLOP
    share's numerator): none natively, all of them on the DP ladder, and
    on the bf16 rung those of the iterations before its low phase ended
    (then the f32 H filters)."""
    H = clement(192)
    cfg = dict(native=dict(mixed_precision=False),
               ladder=dict(mixed_precision=True),
               bf16=dict(bf16_filter=True))[rung]
    if rung == "bf16":
        H = H.astype(np.float32)
    res = ct.eigsh_fused(H, 12, 12, tol=1e-4 if rung == "bf16" else 1e-10,
                         device="cpu", collect_perf=True,
                         config=ct.ChaseConfig(**cfg))
    perf = res.perf
    assert res.converged and perf.filtered_vecs > 0
    low = perf.filtered_vecs_low
    if rung == "native":
        assert low == 0 and perf.low_flop_fraction(192, 25, 4,
                                                   H.dtype) == 0.0
    elif rung == "ladder":
        assert low == perf.filtered_vecs
    else:
        assert 0 < low < perf.filtered_vecs


def test_eigsh_fused_early_lock_reporting():
    """A tolerance just below the f32 floor: pairs stagnate inside
    100·tol and lock early; their residuals surface in early_locked."""
    res = ct.eigsh_fused(clement(160).astype(np.float32), 8, 8, tol=1e-5,
                         device="cpu")
    assert res.converged
    assert res.early_locked and all(r > 1e-5 for r in res.early_locked)


def test_eigsh_fused_host_small_dense_is_a_noop():
    res = ct.eigsh_fused(clement(160), 8, 8, tol=1e-9, device="cpu",
                         config=ct.ChaseConfig(small_dense_backend="host"))
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(160)[:8],
                               atol=1e-6)


# ---- warmup, refusals, carrying state across ---------------------------------

def test_warmup_returns_the_jax_keys_and_loads_nothing_on_the_cpu(
        monkeypatch):
    loaded = []
    monkeypatch.setattr(trh, "load_kernels", lambda: loaded.append(1))
    H = clement(96).astype(np.float32)
    cfg = ct.ChaseConfig(ring_backend="pallas")
    out = ct.warmup(H, 8, 8, config=cfg, device="cpu")
    jout = chase_tpu.warmup(H, 8, 8)
    assert set(out) == set(jout) == {"programs", "failed", "widths"}
    assert out == {"programs": 0, "failed": 0, "widths": jout["widths"]}
    fused = ct.warmup(ct.DenseOperator(H, "cpu"), 8, 8, config=cfg,
                      fused=True, max_workers=2)
    assert fused["programs"] == 2 and fused["failed"] == 0
    assert not loaded


def test_eigsh_fused_cuda_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    ran = []
    monkeypatch.setattr(tfused, "solve_fused", lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="does not fall back"):
        ct.eigsh_fused(clement(16), 2, 2)
    with pytest.raises(RuntimeError, match="does not fall back"):
        ct.eigsh_fused(clement(16), 2, 2, device="cuda")
    with pytest.raises(RuntimeError, match="does not fall back"):
        ct.warmup(clement(16), 2, 2, fused=True)
    with pytest.raises(ValueError):
        ct.eigsh_fused(clement(16), 12, 8, device="cpu")
    assert not ran


def test_jax_result_warm_starts_the_port():
    """A chase_tpu.eigsh_fused result carried across by
    convert.warm_start_from re-converges at once in the port."""
    H = clement(N)
    rj = chase_tpu.eigsh_fused(H, NEV, NEX, tol=1e-10)
    v0, _ = convert.warm_start_from(rj, device="cpu")
    cold = ct.eigsh_fused(H, NEV, NEX, tol=1e-10, device="cpu")
    warm = ct.eigsh_fused(H, NEV, NEX, tol=1e-10, v0=v0, device="cpu")
    assert rj.converged and warm.converged
    assert warm.iterations < cold.iterations
    np.testing.assert_allclose(warm.ritzv, rj.ritzv, atol=1e-9)
