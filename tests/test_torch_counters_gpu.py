"""The program's counters on the card (``gpu`` marker; the card machine
has no JAX, so run with ``--noconftest``):

    python -m pytest tests/test_torch_counters_gpu.py -m gpu --noconftest

* ``ring_hemm`` launches by route and width (``"ring_hemm:<route>[ trans]
  k=<k>"``) add up to the main launches and to the solver's HEMM steps,
  on the f32, c64 and bf16 routes and the trans route;
* the host-sync count of one solve (``"host_sync:<site>"``) equals the
  synchronizing operations torch's CUDA sync debug mode reports from the
  port's code, on the host solvers (Hermitian on the c128 ladder, the f32
  bf16 rung, a warm start, BSE on the f64 ladder) and the fused ones.
"""

from __future__ import annotations

import os
import traceback
import warnings

import numpy as np
import pytest
import torch

import chase_tpu_torch as ct
from chase_tpu_torch import perf
from chase_tpu_torch.models import (clement, random_hermitian,
                                    structured_pseudo_hermitian)
from chase_tpu_torch.ops import ring_hemm as rh

PORT = f"chase_tpu_torch{os.sep}"


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _since(before: dict, prefix: str) -> dict:
    return {k: v - before.get(k, 0) for k, v in list(perf.COUNTS.items())
            if k.startswith(prefix) and v != before.get(k, 0)}


def _debug_syncs(fn):
    """fn() under torch's CUDA sync debug mode: (result, the number of
    synchronizing operations it reported with a frame of the port on the
    stack)."""
    found = []
    orig = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message) and any(
                PORT in f.filename for f in traceback.extract_stack()):
            found.append(1)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = orig
    return out, len(found)


def _solves(dev):
    """name → fn(max_iter, collect_perf=False) of a small solve on the
    card."""
    N = 2000
    Hc = torch.as_tensor(random_hermitian(N, np.complex128, seed=1),
                         device=dev)
    Hf = clement(N).astype(np.float32)
    Hp, _ = structured_pseudo_hermitian(N, np.float64)
    Hp = torch.as_tensor(Hp, device=dev)

    def cfg(mi, **kw):
        return ct.ChaseConfig(ring_backend="pallas", max_iter=mi or 25, **kw)

    warm = {}

    def herm_warm(mi, collect_perf=False):
        if "r" not in warm:
            warm["r"] = ct.eigsh(Hc, 150, 50, tol=1e-9, device=dev,
                                 config=cfg(None))
        r = warm["r"]
        return ct.eigsh(Hc, 150, 50, tol=1e-9, device=dev, v0=r.V,
                        ritzv0=r.ritzv_full, approx=True, config=cfg(mi),
                        collect_perf=collect_perf)

    return {
        "herm_c128_ladder": lambda mi, collect_perf=False: ct.eigsh(
            Hc, 150, 50, tol=1e-9, device=dev, config=cfg(mi),
            collect_perf=collect_perf),
        "herm_f32_bf16": lambda mi, collect_perf=False: ct.eigsh(
            Hf, 150, 50, tol=1e-2, device=dev,
            config=cfg(mi, bf16_filter=True), collect_perf=collect_perf),
        "herm_c128_warm": herm_warm,
        "bse_f64_ladder": lambda mi, collect_perf=False: ct.eigsh_pseudo(
            Hp, 80, 40, tol=1e-10, device=dev, config=cfg(mi),
            collect_perf=collect_perf),
        "herm_c128_fused": lambda mi, collect_perf=False: ct.eigsh_fused(
            Hc, 150, 50, tol=1e-9, device=dev, config=cfg(mi),
            collect_perf=collect_perf),
        "bse_f64_fused": lambda mi, collect_perf=False: ct.eigsh_pseudo_fused(
            Hp, 80, 40, tol=1e-10, device=dev, config=cfg(mi),
            collect_perf=collect_perf),
    }


CASES = ("herm_c128_ladder", "herm_f32_bf16", "herm_c128_warm",
         "bse_f64_ladder", "herm_c128_fused", "bse_f64_fused")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_host_syncs_match_the_sync_debug_mode(case):
    dev = _card()
    fn = _solves(dev)[case]
    fn(1)                        # kernels built, handles made
    torch.cuda.synchronize()
    before = dict(perf.COUNTS)
    res, debug = _debug_syncs(lambda: fn(None))
    counted = _since(before, perf.HOST_SYNC)
    assert res.iterations > 1
    assert sum(counted.values()) == debug, counted


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("herm_c128_ladder", "herm_f32_bf16",
                                  "bse_f64_ladder"))
def test_launches_by_route_and_width(case):
    dev = _card()
    fn = _solves(dev)[case]
    fn(1)
    torch.cuda.synchronize()
    before = dict(perf.COUNTS)
    res = fn(None, collect_perf=True)
    torch.cuda.synchronize()
    routes = _since(before, "ring_hemm:")
    main = perf.COUNTS["ring_hemm"] - before.get("ring_hemm", 0)
    assert sum(routes.values()) == main == res.perf.filter_hemm_steps > 0
    want = {"herm_c128_ladder": "c64", "herm_f32_bf16": "bf16",
            "bse_f64_ladder": "f32"}[case]
    # the bf16 rung hands its last iterations back to the f32 H
    assert sum(n for k, n in routes.items()
               if k.startswith(f"ring_hemm:{want} ")) > 0
    assert all(int(k.rsplit("=", 1)[1]) > 0 for k in routes)


@pytest.mark.gpu
def test_trans_route_counts_under_its_own_key():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    H = torch.randn((512, 512), generator=g, device=dev)
    V = torch.randn((256, 96), generator=g, device=dev)
    before = dict(perf.COUNTS)
    W = rh.ring_hemm(H, V, col0=128, trans=True)
    torch.cuda.synchronize()
    assert _since(before, "ring_hemm") == {"ring_hemm": 1,
                                           "ring_hemm:f32 trans k=96": 1}
    ref = H[128:384, :].mT @ V
    assert torch.allclose(W, ref, rtol=1e-4, atol=1e-3)
