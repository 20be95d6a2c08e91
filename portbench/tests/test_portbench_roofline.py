"""The roofline arithmetic against hand counts."""

from __future__ import annotations

import pytest

from portbench import roofline

SXM = "NVIDIA H100 80GB HBM3"


def test_work_by_route():
    m, b, k = 1000, 37, 10
    assert roofline.hemm_work(m, b, k, "torch.float32") == (
        2.0 * m * b * k, 4.0 * (m * b + b * k + m * k), "3xtf32")
    assert roofline.hemm_work(m, b, k, "torch.complex64") == (
        8.0 * m * b * k, 8.0 * (m * b + b * k + m * k), "3xtf32")
    assert roofline.hemm_work(m, b, k, "torch.bfloat16") == (
        2.0 * m * b * k, 2.0 * m * b + 4.0 * (b * k + m * k), "bf16")


def test_bounds_at_the_kernel_table_shapes():
    # PERF.md's kernel table: (30000, 3000) bound 32.73 / 130.91 / 5.460 ms
    for dtype, ms in (("torch.float32", 32.727), ("torch.complex64", 130.909),
                      ("torch.bfloat16", 5.460)):
        t = roofline.hemm_bound_s(30000, 30000, 3000, dtype, SXM)
        assert t * 1e3 == pytest.approx(ms, abs=1e-3)
    # a thin product is bound by its bytes
    flop, nbytes, _ = roofline.hemm_work(30000, 30000, 8, "torch.float32")
    assert roofline.hemm_bound_s(30000, 30000, 8, "torch.float32", SXM) \
        == pytest.approx(nbytes / 3.35e12)
    assert nbytes / 3.35e12 > flop / 165e12


def test_peaks():
    rates, bandwidth = roofline.card_peaks(SXM)
    assert rates["3xtf32"] == pytest.approx(165e12)
    assert rates["bf16"] == 989e12 and bandwidth == 3.35e12
    assert roofline.card_peaks("NVIDIA A100-SXM4-80GB") is None
    assert roofline.hemm_bound_s(10, 10, 10, "torch.float32", "cpu") is None
    assert roofline.hemm_bound_s(10, 10, 10, "torch.float64", SXM) is None
    assert roofline.bound_s(2.0, 1.0, 1.0, 1.0) == (2.0, "operations")
    assert roofline.bound_s(1.0, 3.0, 1.0, 1.0) == (3.0, "bytes")
