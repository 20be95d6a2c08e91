"""devtrace on a synthetic Chrome trace."""

from __future__ import annotations

import pytest

import tiny  # noqa: F401
from portbench import devtrace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


EVENTS = [
    ev("user_annotation", devtrace.WINDOW, 0, 1000),
    ev("cpu_op", "aten::setup", 0, 115),
    ev("user_annotation", "portbench.ring_hemm", 100, 100),
    ev("cuda_runtime", "cudaLaunchKernel", 110, 2, corr=1),
    ev("cuda_runtime", "cudaLaunchKernelExC", 150, 2, corr=2),
    ev("cuda_runtime", "cudaLaunchKernel", 300, 2, corr=3),
    ev("cuda_runtime", "cudaLaunchKernel", 160, 2, tid=2, corr=4),
    ev("kernel", "tf32_split", 120, 50, tid=7, corr=1),
    ev("kernel", "ring_hemm_kernel", 170, 90, tid=7, corr=2),
    ev("kernel", "other", 310, 90, tid=7, corr=3),
    ev("kernel", "side", 400, 10, tid=7, corr=4),
    ev("gpu_memcpy", "Memcpy DtoH", 500, 20, tid=7),
    ev("cpu_op", "aten::item", 420, 170),
    ev("cuda_runtime", "cudaStreamSynchronize", 600, 300),
    ev("kernel", "outside", 2000, 50, tid=7),
]


def test_summary():
    s = devtrace.summarize(EVENTS, ("portbench.ring_hemm",))
    assert s["window_s"] == pytest.approx(1000e-6)
    # [120, 260] ∪ [310, 410] ∪ [500, 520]
    assert s["busy_s"] == pytest.approx(260e-6)
    hemm = s["annotated"]["portbench.ring_hemm"]
    assert hemm["ranges"] == 1
    assert hemm["device_s"] == pytest.approx(140e-6)   # corr 1 and 2 only
    assert dict(s["device_ops"])["other"] == pytest.approx(90e-6)
    assert "outside" not in dict(s["device_ops"])
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::setup"] == pytest.approx(120e-6)    # [0, 120]
    assert gaps["cudaStreamSynchronize"] == pytest.approx(480e-6)  # [520, 1000]
    assert gaps["aten::item"] == pytest.approx(90e-6)      # [410, 500]
    assert gaps[devtrace.WINDOW] == pytest.approx(50e-6)   # [260, 310]
    assert sum(gaps.values()) == pytest.approx(740e-6)


def test_no_window_no_summary():
    assert devtrace.summarize(EVENTS[1:]) == {}
