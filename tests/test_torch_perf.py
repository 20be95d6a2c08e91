"""The port's perf helpers (``chase_tpu_torch.perf``): the card's peaks
(None on the CPU and for a card the table does not name; the H100 SXM's
data-sheet figures with the device name monkeypatched), the filter's rung
and fraction of peak in ``report``, the phase clock behind the spans
(``PhaseClock``) and ``profiler_trace``, beside the JAX package's
``chase_tpu.perf``."""

import json
import os
import time

import numpy as np
import pytest
import torch

import chase_tpu.perf as jperf
import chase_tpu_torch as ct
from chase_tpu_torch import perf
from chase_tpu_torch.models import clement


@pytest.fixture
def card(monkeypatch):
    """Pretend a CUDA card of a given name is present."""
    def set_name(name):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a: name)
    return set_name


def test_no_peak_on_the_cpu():
    """Off CUDA every peak is None, as the JAX package's off-TPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU path")
    assert perf.device_bf16_peak() is None
    for rung in ("bf16", "3xtf32", "tf32", "f32", "f64", None):
        assert perf.device_matmul_peak(rung) is None
    assert jperf.device_bf16_peak() is None      # conftest's CPU devices


@pytest.mark.parametrize("name,bf16,tf32,f32,f64", [
    ("NVIDIA H100 80GB HBM3", 989e12, 495e12, 67e12, 67e12),
    ("NVIDIA H100 PCIe", 756e12, 378e12, 51e12, 51e12)],
    ids=["sxm", "pcie"])
def test_h100_peaks(card, name, bf16, tf32, f32, f64):
    card(name)
    assert perf.device_bf16_peak() == bf16
    assert perf.device_matmul_peak("bf16") == bf16
    assert perf.device_matmul_peak("tf32") == tf32
    assert perf.device_matmul_peak("3xtf32") == tf32 / 3
    assert perf.device_matmul_peak("f32") == f32
    assert perf.device_matmul_peak("f64") == f64
    assert perf.device_matmul_peak("wide-f64:3") is None
    assert perf.device_matmul_peak(None) is None


def test_unknown_card_has_no_peak(card):
    card("NVIDIA A100-SXM4-80GB")
    assert perf.device_bf16_peak() is None
    assert perf.device_matmul_peak("bf16") is None


def test_every_peak_names_its_card_and_source():
    for key, source, peaks in perf.MATMUL_PEAKS:
        assert "H100" in key and "data sheet" in source and "W" in source
        assert set(peaks) == {"bf16", "tf32", "f32", "f64"}


@pytest.mark.parametrize("dtype,low,rung", [
    (np.float32, False, "3xtf32"), (np.float32, True, "bf16"),
    (np.complex64, False, "3xtf32"), (np.float64, True, "3xtf32"),
    (np.complex128, True, "3xtf32"), (np.float64, False, "f64"),
    (torch.complex128, False, "f64")])
def test_filter_rung(dtype, low, rung):
    """The rungs the port's kernel route runs; the JAX package names the
    same split (its full-precision f64 has no hardware rung)."""
    assert perf.filter_rung(dtype, low) == rung
    if not isinstance(dtype, torch.dtype):
        assert (jperf.filter_rung(dtype, low) is None) == (rung == "f64")


def _solve_perf():
    return ct.eigsh(clement(200).astype(np.float32), 10, 10, tol=1e-3,
                    device="cpu", collect_perf=True).perf


def test_report_prints_the_fraction_of_peak(card):
    """On a named card the filter's fraction of its rung's peak, as the
    JAX report prints it; none on the CPU."""
    p = _solve_perf()
    args = (200, 25, 4, np.float32)
    if not torch.cuda.is_available():
        assert p.filter_mfu(200, np.float32) is None
        assert "fraction-of-peak" not in p.report(*args)
    card("NVIDIA H100 80GB HBM3")
    frac, rung, peak_g = p.filter_mfu(200, np.float32)
    assert rung == "3xtf32" and peak_g == 165e3
    rate = p.get_filter_flops(200, np.float32) / p.timings["Filter"]
    assert frac == pytest.approx(rate / peak_g)
    assert (f" | Filter fraction-of-peak = {100 * frac:.1f}% of the 3xtf32 "
            f"peak (165 TFLOP/s)") in p.report(*args)
    assert perf.PerfData().filter_mfu(200, np.float32) is None


def test_phase_timer():
    """A PhaseClock on the CPU: each span of PHASE_OF that closes marks its
    phase's end, the phase's time running from the previous mark; spans
    without a phase mark nothing, and without a clock nothing is timed."""
    p = perf.PerfData()
    with perf.PhaseClock(p, torch.device("cpu")):
        with perf.span("chase.qr"):
            time.sleep(0.02)
        with perf.span("chase.iteration"):
            time.sleep(0.01)
            with perf.span("chase.rr"):
                pass
        with perf.span("chase.qr"):
            time.sleep(0.01)
    t = p.timings
    assert 0.03 <= t["Qr"] and 0.01 <= t["Rr"]
    assert t["All"] >= t["Qr"] + t["Rr"]
    idle = perf.PerfData()
    with perf.span("chase.qr"):
        time.sleep(0.001)
    assert idle.timings == perf.PerfData().timings
    with perf.phase_clock(None, torch.device("cpu")):
        with perf.span("chase.qr"):
            pass


def test_profiler_trace_writes_a_trace(tmp_path):
    d = tmp_path / "trace"
    with perf.profiler_trace(str(d)) as tr:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = d / "trace.json"
    assert path.is_file() and os.path.getsize(path) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert tr.profile.key_averages() is not None
