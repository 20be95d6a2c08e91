"""The port's spans and counters (``chase_tpu_torch.perf``) on the CPU.

* Under ``torch.profiler`` a solve's ``chase.*`` spans are
  ``user_annotation`` ranges on the solving thread, nested solve ⊃
  iteration ⊃ {degrees, filter, [kconj,] qr, rr, locking}, one
  ``chase.iteration`` per reported iteration.
* Without a profiler no ``record_function`` is entered, and without
  ``collect_perf`` no phase is timed.
* ``collect_perf`` fills every PerfData phase from the spans' ends
  (``PhaseClock``): on the card one synchronize per solve, faked here.
* The counter registry: host syncs repeat exactly from one solve to the
  next and are at least the RR's two reads per iteration; QR fallbacks
  count where the Cholesky QR breaks down; ``ops.ring_hemm.LAUNCHES`` is
  the registry; counts from many threads are not lost.
"""

from __future__ import annotations

import json
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import chase_tpu_torch as ct
from chase_tpu_torch import perf
from chase_tpu_torch.config import ChaseConfig
from chase_tpu_torch.models import clement, random_pseudo_hermitian
from chase_tpu_torch.ops import qr as qrops
from chase_tpu_torch.ops import ring_hemm as rh

PACKAGE = Path(ct.__file__).resolve().parent
LOOP = ("chase.degrees", "chase.filter", "chase.qr", "chase.rr",
        "chase.locking")


def _host_syncs() -> int:
    return sum(n for k, n in list(perf.COUNTS.items())
               if k.startswith(perf.HOST_SYNC))


def _herm(collect_perf=False, seed=3):
    # f32 on the kernel's route: the filter's products are ring_hemm calls
    H = clement(200).astype(np.float32)
    return ct.eigsh(H, 12, 8, tol=1e-3, device="cpu",
                    collect_perf=collect_perf,
                    config=ChaseConfig(ring_backend="pallas", seed=seed))


def _pseudo(collect_perf=False, seed=3):
    H = random_pseudo_hermitian(160, np.float64, seed=5)
    return ct.eigsh_pseudo(H, 8, 6, tol=1e-9, device="cpu",
                           collect_perf=collect_perf,
                           config=ChaseConfig(seed=seed))


SOLVES = {"eigsh": (_herm, LOOP),
          "eigsh_pseudo": (_pseudo, LOOP + ("chase.kconj",))}


def _traced(fn, tmp_path):
    """fn() under torch.profiler (CPU): (result, the chase.* ranges of
    the exported trace)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("chase.")]
    return res, spans


def _inside(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("entry", list(SOLVES))
def test_spans_nest_in_the_trace(entry, tmp_path):
    fn, loop = SOLVES[entry]
    res, spans = _traced(fn, tmp_path)
    assert {e["cat"] for e in spans} == {"user_annotation"}
    assert len({e["tid"] for e in spans}) == 1
    names = {e["name"] for e in spans}
    assert names <= set(perf.SPANS)
    by = {n: [e for e in spans if e["name"] == n] for n in names}
    solve, = by["chase.solve"]
    iters = by["chase.iteration"]
    assert len(iters) == res.iterations > 0
    for name in ("chase.operator", "chase.init_vecs", "chase.lanczos"):
        assert by[name] and all(_inside(e, solve) for e in by[name])
    for it in iters:
        assert _inside(it, solve)
    for name in loop:
        assert len(by[name]) == res.iterations
        assert all(any(_inside(e, it) for it in iters) for e in by[name])
    for e in by.get("chase.ring_hemm", []):
        assert any(_inside(e, f) for f in by["chase.filter"])
    if entry == "eigsh":        # every filter product is a ring_hemm call
        assert by["chase.ring_hemm"]


@pytest.mark.parametrize("entry", list(SOLVES))
def test_no_record_function_without_a_profiler(entry, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    fn, _ = SOLVES[entry]
    with monkeypatch.context() as m:     # and no phase timer runs
        m.setattr(torch.cuda, "synchronize", refuse)
        m.setattr(torch.cuda, "Event", refuse)
        assert fn().perf is None
    assert set(fn(collect_perf=True).perf.timings) == set(perf.PHASES)


@pytest.mark.parametrize("entry", list(SOLVES))
def test_collect_perf_times_every_phase(entry):
    fn, _ = SOLVES[entry]
    t = fn(collect_perf=True).perf.timings
    assert set(t) == set(perf.PHASES)
    timed = [p for p in perf.PHASES if p != "All"
             and (entry == "eigsh_pseudo" or p != "ApplyKconjugate")]
    assert all(t[p] > 0 for p in timed), t
    assert t["All"] >= sum(t[p] for p in perf.PHASES if p != "All")


@pytest.mark.parametrize("entry", list(SOLVES))
def test_host_syncs_repeat_and_cover_every_iteration(entry):
    fn, _ = SOLVES[entry]
    counts = []
    for _ in range(2):
        before = _host_syncs()
        res = fn()
        counts.append(_host_syncs() - before)
    assert counts[0] == counts[1] >= 2 * res.iterations


class _FakeEvent:
    """A CUDA event stand-in: its time is the order it was recorded in,
    in ms."""
    n = 0

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self, stream=None):
        _FakeEvent.n += 1
        self.t = _FakeEvent.n

    def elapsed_time(self, other):
        return float(other.t - self.t)


def test_phase_clock_on_a_card_synchronizes_once(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "synchronize", syncs.append)
    dev = torch.device("cuda")
    p = perf.PerfData()
    with perf.PhaseClock(p, dev):
        for name in ("chase.init_vecs", "chase.lanczos", "chase.filter",
                     "chase.qr", "chase.rr", "chase.locking",
                     "chase.filter", "chase.qr"):
            with perf.span(name):
                assert not syncs
    assert syncs == [dev]
    t = p.timings
    assert (t["InitVecs"], t["Lanczos"], t["Rr"], t["Resids_Locking"]) \
        == (1e-3,) * 4
    assert t["Filter"] == t["Qr"] == 2e-3
    assert t["All"] == 9e-3           # the start mark to the end mark


def test_phase_clock_times_nothing_when_the_solve_raises():
    p = perf.PerfData()
    with pytest.raises(ValueError):
        with perf.PhaseClock(p, torch.device("cpu")):
            with perf.span("chase.filter"):
                pass
            raise ValueError("solve failed")
    assert p.timings == perf.PerfData().timings
    assert getattr(perf._local, "clock", None) is None


def test_span_names_in_the_code_are_the_documented_ones():
    used = set()
    for path in PACKAGE.rglob("*.py"):
        used |= set(re.findall(r'span\("([^"]+)"\)', path.read_text()))
    assert used == set(perf.SPANS)
    assert set(perf.PHASE_OF) <= set(perf.SPANS)
    assert set(perf.PHASE_OF.values()) | {"All"} == set(perf.PHASES)


def test_launch_counts_are_the_registry():
    assert rh.LAUNCHES is perf.COUNTS
    before = rh.LAUNCHES["ring_hemm"]
    W = rh.ring_hemm(torch.ones(8, 4), torch.ones(4, 3))   # the plain one
    assert torch.equal(W, torch.full((8, 3), 4.0))
    assert rh.LAUNCHES["ring_hemm"] == before


def test_counts_from_many_threads_are_not_lost():
    before = perf.COUNTS["test:threads"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [perf.count("test:threads") for _ in range(500)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert perf.COUNTS["test:threads"] - before == 16 * 500


def _rank_deficient(n=64, k=8):
    g = torch.Generator().manual_seed(0)
    V = torch.randn((n, k), generator=g, dtype=torch.float64)
    V[:, -1] = V[:, 0]                 # the Gram is singular
    return V


def test_qr_fallback_to_householder_is_counted():
    rcfg = ChaseConfig().resolve(torch.float64, torch.device("cpu"))
    key = perf.QR_FALLBACK + "householder"
    before = perf.COUNTS[key]
    Q = qrops.orthonormalize(_rank_deficient(), 0, 1.0, rcfg)
    assert perf.COUNTS[key] == before + 1
    assert torch.allclose(Q.T @ Q, torch.eye(8, dtype=Q.dtype), atol=1e-12)
    Q = qrops.orthonormalize(torch.linalg.qr(_rank_deficient())[0] * 3,
                             0, 1.0, rcfg)
    assert perf.COUNTS[key] == before + 1       # no breakdown, no count


def test_qr_fallback_to_the_full_block_is_counted():
    rcfg = ChaseConfig().resolve(torch.float64, torch.device("cpu"))
    V = _rank_deficient()
    V[:, -1] = V[:, 3]                 # inside the window [2, 8)
    V[:, :2] = torch.linalg.qr(V[:, :2])[0]
    full = perf.QR_FALLBACK + "full_block"
    before = perf.COUNTS[full]
    Q = qrops.orthonormalize_window(V, 2, 6, 2, 1.0, rcfg)
    assert perf.COUNTS[full] == before + 1
    assert torch.allclose(Q.T @ Q, torch.eye(8, dtype=Q.dtype), atol=1e-12)


def test_host_syncs_count_the_reads_of_a_cholesky_qr():
    """cholqr reads the info flag and the checks of L in one read a
    pass."""
    before = _host_syncs()
    V = torch.randn((50, 6), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    _, ok = qrops.cholqr(V, passes=2)
    assert ok
    assert _host_syncs() - before == 2
