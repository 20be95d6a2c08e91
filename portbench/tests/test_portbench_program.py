"""The readers of what the program records about itself: its spans'
device time (``filter_device_s``, ``qr_rr_device_s``, ``lanczos_s``) on a
synthetic trace summarized by ``devtrace``, and its counters
(``host_syncs``, ``qr_fallbacks``) from their snapshots — and None where
there is nothing to read."""

from __future__ import annotations

import importlib.util

import pytest
import torch

import tiny
from portbench import devtrace
from portbench.loop import Solve

SPAN_READERS = {"filter_device_s": ("chase.filter",),
                "qr_rr_device_s": ("chase.qr", "chase.rr"),
                "lanczos_s": ("chase.lanczos",)}


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", tiny.PORTBENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def launch(ts, corr, tid=1):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 2, tid=tid, corr=corr)


def kernel(name, ts, dur, corr):
    return ev("kernel", name, ts, dur, tid=7, corr=corr)


# two solves' worth of spans in a 10 ms window (µs)
EVENTS = [
    ev("user_annotation", devtrace.WINDOW, 0, 10000),
    ev("user_annotation", "chase.lanczos", 100, 200),
    launch(110, 1), kernel("lanczos_scan", 120, 150, 1),
    ev("user_annotation", "chase.filter", 400, 3000),
    launch(410, 2), kernel("tf32_split", 420, 30, 2),
    launch(450, 3), kernel("ring_hemm_kernel", 460, 2500, 3),
    launch(500, 4, tid=2), kernel("other_thread", 2960, 20, 4),
    ev("user_annotation", "chase.qr", 3500, 500),
    launch(3510, 5), kernel("zgemm", 3520, 400, 5),
    ev("user_annotation", "chase.rr", 4100, 800),
    launch(4110, 6), kernel("zheevd", 4120, 600, 6),
    ev("user_annotation", "chase.filter", 5000, 3000),
    launch(5010, 7), kernel("ring_hemm_kernel", 5020, 2700, 7),
    launch(9100, 8), kernel("outside_any_span", 9110, 100, 8),
]


def run_data(trace=None, notes=None, iterations=(5, 6), errors=()):
    solves = [Solve(t0=0.0, t1=1.0, iterations=i, error=e)
              for i, e in zip(iterations, list(errors) + [None] * 9)]
    return tiny.load_run_module().RunData(
        workload="herm_tiny.cold", setup_s=1.0, window_s=0.01,
        solves=solves, trace=trace or {}, notes=notes or {},
        card={"name": "cpu", "power_limit_w": None})


@pytest.fixture(scope="module")
def summary():
    ranges = tuple(r for n in SPAN_READERS for r in reader(n).RANGES)
    return devtrace.summarize(EVENTS, ranges)


@pytest.mark.parametrize("name,want_us", [("filter_device_s", 30 + 2500
                                           + 2700),
                                          ("qr_rr_device_s", 400 + 600),
                                          ("lanczos_s", 150)])
def test_span_readers_on_a_synthetic_trace(summary, name, want_us):
    mod = reader(name)
    assert mod.RANGES == SPAN_READERS[name]
    got = mod.read(run_data(summary))
    assert got == pytest.approx(want_us * 1e-6 / 2)      # two solves


@pytest.mark.parametrize("name", list(SPAN_READERS))
def test_span_readers_read_nothing_without_their_spans(name):
    mod = reader(name)
    bare = devtrace.summarize([e for e in EVENTS
                               if not e["name"].startswith("chase.")],
                              mod.RANGES)
    assert bare["annotated"]
    assert mod.read(run_data(bare)) is None
    assert mod.read(run_data({})) is None                # untraced run
    no_device = devtrace.summarize([e for e in EVENTS
                                    if e["cat"] != "kernel"], mod.RANGES)
    assert mod.read(run_data(no_device)) is None
    assert mod.read(run_data(devtrace.summarize(EVENTS, mod.RANGES),
                             iterations=(5,), errors=("raised",))) is None


def test_span_readers_skip_failed_solves(summary):
    got = reader("filter_device_s").read(
        run_data(summary, iterations=(5, 6, 7), errors=(None, "raised")))
    assert got == pytest.approx((30 + 2500 + 2700) * 1e-6 / 2)


COUNTS_BEFORE = {"ring_hemm": 10, "host_sync:solver.rr": 40,
                 "host_sync:qr.cholqr": 7, "qr_fallback:householder": 1}
COUNTS_AFTER = {"ring_hemm": 30, "host_sync:solver.rr": 62,
                "host_sync:qr.cholqr": 18, "host_sync:rr.eigh": 11,
                "qr_fallback:householder": 1, "qr_fallback:full_block": 2}


def test_host_syncs_per_iteration():
    notes = {"host_syncs": [COUNTS_BEFORE, COUNTS_AFTER]}
    got = reader("host_syncs").read(run_data(notes=notes))
    assert got == pytest.approx((22 + 11 + 11) / 11)


def test_qr_fallbacks_per_solve():
    notes = {"qr_fallbacks": [COUNTS_BEFORE, COUNTS_AFTER]}
    assert reader("qr_fallbacks").read(run_data(notes=notes)) == 1.0
    none = {"qr_fallbacks": [{"host_sync:x": 1}, {"host_sync:x": 9}]}
    assert reader("qr_fallbacks").read(run_data(notes=none)) == 0.0


@pytest.mark.parametrize("name", ("host_syncs", "qr_fallbacks"))
def test_counter_readers_read_nothing_without_the_counts(name):
    mod = reader(name)
    assert mod.read(run_data()) is None                   # no notes
    assert mod.read(run_data(notes={name: []})) is None   # no registry
    full = {name: [COUNTS_BEFORE, COUNTS_AFTER]}
    assert mod.read(run_data(notes=full, iterations=(5,),
                             errors=("raised",))) is None


@pytest.mark.parametrize("name", ("host_syncs", "qr_fallbacks"))
def test_counter_readers_instrument_the_program(name):
    """Around a tiny solve of the program on the CPU: two snapshots of its
    registry, and a count to read."""
    import numpy as np

    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement
    mod = reader(name)
    notes = []
    with mod.instrument(notes):
        res = ct.eigsh(clement(120), 8, 6, tol=1e-8, device="cpu")
    assert len(notes) == 2
    run = run_data(notes={name: notes}, iterations=(res.iterations,))
    got = mod.read(run)
    assert got is not None and got >= 0
    if name == "host_syncs":
        assert got >= 2.0               # RR's two reads per iteration
    assert np.all(np.isfinite(res.ritzv))


def test_counter_readers_note_nothing_on_a_program_without_counts(
        monkeypatch):
    import chase_tpu_torch.perf as perf
    monkeypatch.delattr(perf, "COUNTS")
    for name in ("host_syncs", "qr_fallbacks"):
        notes = []
        with reader(name).instrument(notes):
            torch.ones(2)
        assert notes == []
        assert reader(name).read(run_data(notes={name: notes})) is None
