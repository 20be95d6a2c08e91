"""The Hermitian solver's warm start (``approx``, ``eigsh_sequence``)
against the plain eigensolver.

* A stale lower edge: on a dense H with Clement's spectrum (N = 400, nev
  30, nex 10) a cold solve's DoS edge falls below lambda_nevex, so its
  last extra columns keep Ritz values deep in the spectrum.  The next
  member of the sequence, warm started from it, must converge within
  ``max_iter`` to ``torch.linalg.eigh``'s lowest nev (the JAX package,
  taking max(ritzv0) as the edge, stops at ``max_iter``).
* Small c128 and f64 sequences (N = 240), member by member, against
  ``torch.linalg.eigh``: eigenvalues, true residuals and orthogonality.
* The warm start's span ``chase.warm_start`` and its counters
  ``warm_start:members`` / ``warm_start:dos_lowered``: recorded on a warm
  solve, absent on a cold one; a sound previous block keeps its edge.
"""

import json

import numpy as np
import pytest
import torch

import chase_tpu_torch as ct
from chase_tpu_torch import perf
from chase_tpu_torch.models import hermitian_sequence

torch.set_num_threads(1)

N, NEV, NEX = 400, 30, 10
TOL = 1e-10 * (N - 1)
MEMBERS = "warm_start:members"
LOWERED = "warm_start:dos_lowered"
DTYPES = [pytest.param(np.complex128, id="c128"),
          pytest.param(np.float64, id="f64")]


def clement_dense(n: int, dtype, seed: int) -> np.ndarray:
    """Q·diag(λ)·Qᴴ with Clement's spectrum λ_i = −(n−1) + 2i, Q from the
    QR of a Gaussian drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, n))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        X = X + 1j * rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(X)
    lam = np.arange(-(n - 1), n, 2, dtype=np.float64)
    H = (Q * lam) @ Q.conj().T
    return ((H + H.conj().T) / 2).astype(dtype)


def perturbed(H: np.ndarray, drift: float, seed: int) -> np.ndarray:
    """H plus a Hermitian perturbation of scale drift·‖H‖_F/N."""
    rng = np.random.default_rng(seed)
    E = rng.standard_normal(H.shape)
    if np.iscomplexobj(H):
        E = E + 1j * rng.standard_normal(H.shape)
    scale = drift * np.linalg.norm(H) / H.shape[0]
    return H + (scale / 2) * (E + E.conj().T)


def counts() -> dict:
    return {k: perf.COUNTS[k] for k in (MEMBERS, LOWERED)}


def grew(before: dict) -> dict:
    return {k: n - before[k] for k, n in counts().items()}


def check_pairs(H: np.ndarray, res, nev: int, tol: float) -> None:
    """Converged, eigenvalues within 1e-8 of eigh's lowest nev, true
    residuals within 10·tol and an orthonormal V."""
    exact = torch.linalg.eigvalsh(torch.from_numpy(H)).numpy()[:nev]
    assert res.converged
    assert np.abs(res.ritzv - exact).max() <= 1e-8
    V = res.V[:, :nev].numpy()
    R = H @ V - V * res.ritzv
    assert np.linalg.norm(R, axis=0).max() <= 10 * tol
    assert np.abs(V.conj().T @ V - np.eye(nev)).max() <= 1e-12


@pytest.mark.parametrize("mixed", [False, True], ids=["native", "ladder"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_warm_member_after_a_stale_edge_converges(dtype, mixed):
    cfg = ct.ChaseConfig(seed=0, mixed_precision=mixed,
                         ring_backend="pallas")
    H0 = clement_dense(N, dtype, 0)
    r0 = ct.eigsh(H0, NEV, NEX, tol=TOL, config=cfg, device="cpu")
    # the fault's precondition: member 0 converged, one of its extra Ritz
    # values left deep in the spectrum, far above lambda_nevex
    lam = np.arange(-(N - 1), N, 2, dtype=np.float64)
    assert r0.converged
    assert r0.ritzv_full.max() > lam[NEV + NEX - 1] + 0.1 * (N - 1)
    H1 = perturbed(H0, 1e-3, 1)
    before = counts()
    r1 = ct.eigsh(H1, NEV, NEX, tol=TOL, config=cfg, device="cpu",
                  v0=r0.V, ritzv0=r0.ritzv_full, approx=True)
    assert r1.iterations < cfg.max_iter
    check_pairs(H1, r1, NEV, TOL)
    assert grew(before) == {MEMBERS: 1, LOWERED: 1}


@pytest.mark.parametrize("mixed", [False, True], ids=["native", "ladder"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sequence_member_by_member_against_eigh(dtype, mixed):
    n, count, nev, nex, tol = 240, 4, 20, 12, 1e-9
    seq = hermitian_sequence(n, count, dtype, seed=23, drift=0.002)
    cfg = ct.ChaseConfig(mixed_precision=mixed)
    before = counts()
    results = list(ct.eigsh_sequence(iter(seq), nev, nex, tol=tol,
                                     config=cfg, device="cpu"))
    assert len(results) == count
    for H, res in zip(seq, results):
        check_pairs(H, res, nev, tol)
        assert res.iterations < cfg.max_iter
    assert max(r.iterations for r in results[1:]) <= results[0].iterations
    assert grew(before)[MEMBERS] == count - 1


def _spans(fn, tmp_path):
    """fn() under torch.profiler: (result, the names of its chase.*
    ranges with their events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and str(e.get("name", "")).startswith("chase.")]
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    return res, by


def _inside(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("start", ["cold", "sound", "stale"])
def test_warm_start_span_and_counters(start, tmp_path):
    cfg = ct.ChaseConfig(seed=0)
    if start == "stale":
        # member 0 of the stale-edge case above
        H0, nev, nex, tol = clement_dense(N, np.complex128, 0), NEV, NEX, TOL
    else:
        H0, nev, nex, tol = (hermitian_sequence(240, 1, np.complex128,
                                                seed=23)[0], 20, 12, 1e-9)
    r0 = ct.eigsh(H0, nev, nex, tol=tol, config=cfg, device="cpu")
    H1 = perturbed(H0, 1e-3, 1)
    warm = {} if start == "cold" else dict(v0=r0.V, ritzv0=r0.ritzv_full,
                                           approx=True)
    before = counts()
    res, by = _spans(lambda: ct.eigsh(H1, nev, nex, tol=tol, config=cfg,
                                      device="cpu", **warm), tmp_path)
    check_pairs(H1, res, nev, tol)
    lanczos, = by["chase.lanczos"]
    if start == "cold":
        assert "chase.warm_start" not in by
        assert grew(before) == {MEMBERS: 0, LOWERED: 0}
        return
    span, = by["chase.warm_start"]
    assert _inside(lanczos, span)
    assert all(not _inside(e, span) for e in by["chase.iteration"])
    assert grew(before) == {MEMBERS: 1, LOWERED: int(start == "stale")}
    if start == "sound":
        # the previous block's largest Ritz value was sound (near
        # lambda_nevex), so the edge stayed max(ritzv0): the warm member
        # needs fewer iterations
        lam = np.linalg.eigvalsh(H0)
        assert r0.ritzv_full.max() <= (lam[nev + nex - 1]
                                       + 0.02 * (lam[-1] - lam[0]))
        assert res.iterations < r0.iterations
