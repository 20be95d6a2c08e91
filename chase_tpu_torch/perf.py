"""Phase timers, spans, counters + analytic FLOP model.

Port of ``chase_tpu/perf.py`` (the reference's ChasePerfData: timed
phases and the closed-form FLOP counters of performance.hpp:135-293, and
the PerformanceDecoratorChase wrapper).  Phase times come from the
solvers' spans (:func:`span`): each phase's end is a CUDA event on the
card (the host clock on the CPU), resolved after one synchronize at the
end of the solve (:class:`PhaseClock`).  The same spans are
``torch.profiler`` ranges when a profiler records, and :data:`COUNTS`
holds the kernel launches, host syncs and QR fallbacks counted where
they happen.  The fraction-of-peak line of :meth:`PerfData.report`
holds the filter's rate against the card's published matmul peak for the
precision the filter ran in (:func:`device_matmul_peak`): the JAX
package's TPU table is replaced by the NVIDIA cards' data-sheet figures,
and off CUDA, or on a card the table does not name, there is no peak.
:class:`profiler_trace` wraps ``torch.profiler`` — the NVTX-range analogue
(Impl/chase_gpu/nvtx.hpp SCOPED_NVTX_RANGE).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from .types import is_complex_dtype, real_dtype

__all__ = ["PerfData", "profiler_trace", "device_bf16_peak",
           "device_matmul_peak", "filter_rung", "MATMUL_PEAKS", "span",
           "SPANS", "PHASE_OF", "PhaseClock", "phase_clock", "COUNTS",
           "count", "host_sync", "to_host", "item", "to_device",
           "HOST_SYNC", "QR_FALLBACK", "COMM", "COMM_BYTES", "FILTER_COLS",
           "WARM_START"]

PHASES = ("All", "InitVecs", "Lanczos", "Filter", "ApplyKconjugate",
          "Qr", "Rr", "Resids_Locking")


@dataclass
class PerfData:
    """Accumulates per-phase wall time and the analytic FLOP counters."""

    timings: Dict[str, float] = field(default_factory=lambda: {p: 0.0 for p in PHASES})
    iter_count: int = 0
    iter_blocksizes: List[int] = field(default_factory=list)
    filtered_vecs: int = 0     # sum over filter HEMM calls of columns touched
    filtered_vecs_low: int = 0  # subset filtered in a REDUCED precision
    # EXECUTED filter column-steps (launched width × recurrence steps):
    # each step runs on the window's live suffix, retired and padded
    # columns only inside its tile (the kernel's W tile, one column on
    # torch.matmul), so executed ≥ useful (filtered_vecs) but for the
    # refine filters' first step, which needs no product
    filtered_vecs_executed: int = 0
    # N×N HEMM calls the filter issued (one per recurrence step and
    # product) — on the kernel's route, one ring_hemm launch each
    filter_hemm_steps: int = 0
    matrix_type: int = 0       # 0 = (real)symmetric/Hermitian, 1 = pseudo-Hermitian

    def add_time(self, phase: str, seconds: float):
        self.timings[phase] = self.timings.get(phase, 0.0) + seconds

    def add_iter_blocksize(self, block: int):
        self.iter_blocksizes.append(int(block))
        self.iter_count += 1

    def add_filtered_vecs(self, n: int, low: bool = False, executed=None):
        self.filtered_vecs += int(n)
        if low:
            self.filtered_vecs_low += int(n)
        self.filtered_vecs_executed += int(n if executed is None
                                           else executed)

    def filter_window_efficiency(self):
        """useful / executed filter column-steps (1.0 = zero masking
        waste, the reference's per-vector retirement)."""
        if self.filtered_vecs_executed <= 0:
            return None
        return self.filtered_vecs / self.filtered_vecs_executed

    def low_flop_fraction(self, N: int, lanczos_iter: int, num_lanczos: int,
                          dtype) -> float:
        """Share of the solve's analytic FLOPs run in a reduced precision
        — the precision ladder's success metric (the DP north star at
        1e-10 with the bulk of the FLOPs below f64).  Filter FLOPs count
        by the precision they ran in (``filtered_vecs_low``); every other
        phase at the problem's."""
        total = self.get_flops(N, lanczos_iter, num_lanczos, dtype)
        f = self._factor(dtype)
        low = 2.0 * f * N * float(self.filtered_vecs_low) * N / 1e9
        return low / total if total > 0 else 0.0

    # -- analytic FLOP model (performance.hpp:135-293) ---------------------
    def _factor(self, dtype) -> int:
        return 4 if is_complex_dtype(dtype) else 1

    def get_filter_flops(self, N: int, dtype) -> float:
        """GFLOPs of the filter: 2·factor·N²·filtered_vecs (+BSE flips)."""
        f = self._factor(dtype)
        flop = 2.0 * f * N * self.filtered_vecs * N
        if self.matrix_type == 1:
            flop += 2.0 * f * (N / 2) * self.filtered_vecs
        return flop / 1e9

    def get_flops(self, N: int, lanczos_iter: int, num_lanczos: int, dtype) -> float:
        """Total analytic GFLOPs of a solve (mirrors performance.hpp:135-231)."""
        f = self._factor(dtype)
        flop = lanczos_iter * 2.0 * N * num_lanczos * N
        if self.matrix_type == 1:
            flop += lanczos_iter * (N / 2) * num_lanczos
        flop += float(lanczos_iter) ** 2 * num_lanczos ** 2
        first_block = self.iter_blocksizes[0] if self.iter_blocksizes else 0
        for block in self.iter_blocksizes:
            # QR (cholQR2 assumed): syherk + potrf + trsm
            flop += 2.0 * N * block * block + 2.0 * block ** 3 + 2.0 * N * block * block
            if self.matrix_type == 1:
                flop += (first_block - block) * (N / 2)
            # RR: W=H·V, A=WᴴV, heevd, back-GEMM
            flop += 2.0 * N * block * N
            flop += 2.0 * block * block * N
            flop += 4.0 * block ** 3
            if self.matrix_type == 1:
                flop += 2.0 * block * (N / 2) + 2.0 * block ** 3 \
                        + 6.0 * block ** 3 + 3.0 * block * block
            flop += 2.0 * N * block * block
            # residuals: HEMM + axpy + norms
            flop += 2.0 * N * block * N + 3.0 * block * N + N * block
        # filter
        flop += 2.0 * N * self.filtered_vecs * N
        if self.matrix_type == 1:
            flop += 2.0 * self.filtered_vecs * (N / 2)
        return flop * f / 1e9

    def report(self, N: int, lanczos_iter: int, num_lanczos: int, dtype) -> str:
        """The reference's performance table, the FLOP rates and the
        share of FLOPs run in a reduced precision."""
        gflops_all = self.get_flops(N, lanczos_iter, num_lanczos, dtype)
        gflops_filter = self.get_filter_flops(N, dtype)
        t = self.timings
        lines = [
            " | Size  | Iterations | Vecs   |  All       | Lanczos    |"
            " Filter     | QR         | RR         | Resid      |",
            f" | {N:5d} | {self.iter_count:10d} | {self.filtered_vecs:6d} |"
            f" {t['All']:.4e} | {t['Lanczos']:.4e} | {t['Filter']:.4e} |"
            f" {t['Qr']:.4e} | {t['Rr']:.4e} | {t['Resids_Locking']:.4e} |",
        ]
        if t["All"] > 0:
            lines.append(f" | GFLOPS(all) = {gflops_all / t['All']:.4e}")
        if t["Filter"] > 0:
            lines.append(f" | GFLOPS(filter) = {gflops_filter / t['Filter']:.4e}")
            mfu = self.filter_mfu(N, dtype)
            if mfu is not None:
                frac, rung, peak_g = mfu
                lines.append(
                    f" | Filter fraction-of-peak = {100 * frac:.1f}% of the "
                    f"{rung} peak ({peak_g / 1e3:.0f} TFLOP/s)")
            weff = self.filter_window_efficiency()
            if weff is not None:
                lines.append(
                    f" | Filter window efficiency = {100 * weff:.1f}% "
                    f"(useful/executed column-steps; masking waste "
                    f"= {self.filtered_vecs_executed - self.filtered_vecs})")
        low = self.low_flop_fraction(N, lanczos_iter, num_lanczos, dtype)
        lines.append(f" | Low-precision FLOP share = {100 * low:.1f}% "
                     f"(filter FLOPs on the reduced-precision operator)")
        return "\n".join(lines)

    def filter_mfu(self, N: int, dtype):
        """(fraction, rung_name, peak_gflops) of the filter phase against
        the card's matmul peak for the rung MOST of the filter ran in
        (:func:`filter_rung`) — the reference prints GFLOPS
        (performance.hpp:352-451); the fraction of the card's roofline
        makes a rate regression show in every perf table.  None when no
        peak applies: no CUDA card, a card the table does not name, or
        nothing filtered."""
        t = self.timings.get("Filter", 0.0)
        if t <= 0 or self.filtered_vecs == 0:
            return None
        low_frac = self.filtered_vecs_low / self.filtered_vecs
        rung = filter_rung(dtype, low=low_frac >= 0.5)
        peak = device_matmul_peak(rung)
        if peak is None:
            return None
        eff = self.get_filter_flops(N, dtype) / t      # GFLOP/s
        return eff / (peak / 1e9), rung, peak / 1e9


# -- the card's peaks (the roofline the fraction-of-peak is measured against)
#
# Dense matmul rates (no sparsity) from NVIDIA's H100 data sheet, at the
# card's full power limit (700 W for SXM5, 350 W for PCIe): a card set
# below it runs slower under load.  The rungs are what the port runs:
# "bf16" (tensor cores; the bf16 rung's ring kernel, cuBLAS bf16),
# "3xtf32" (the ring kernel's f32 and c64 routes: three TF32 products per
# f32 product, so a third of the TF32 rate), "tf32" (tensor cores),
# "f32" (IEEE f32 on the CUDA cores: cuBLAS SGEMM/CGEMM with TF32 off,
# torch's default) and "f64" (the FP64 tensor cores: cuBLAS DGEMM/ZGEMM).
# Each card is matched by a substring of torch.cuda.get_device_name().

MATMUL_PEAKS = (
    # (name substring, card and source, {rung: FLOP/s})
    ("H100 80GB HBM3", "H100 SXM5, 700 W, NVIDIA H100 data sheet, dense",
     {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "f64": 67e12}),
    ("H100 PCIe", "H100 PCIe, 350 W, NVIDIA H100 data sheet, dense",
     {"bf16": 756e12, "tf32": 378e12, "f32": 51e12, "f64": 51e12}),
)


def _card_peaks():
    """The peak table entry of the current CUDA card, or None (no card,
    or a card the table does not name)."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name()
    for key, _, peaks in MATMUL_PEAKS:
        if key in name:
            return peaks
    return None


def device_bf16_peak():
    """The current CUDA card's dense bf16 tensor-core peak (FLOP/s), or
    None off CUDA / for a card the table does not name."""
    peaks = _card_peaks()
    return None if peaks is None else peaks["bf16"]


def device_matmul_peak(rung):
    """Peak FLOP/s of the current CUDA card for a named precision rung
    ('bf16' | '3xtf32' | 'tf32' | 'f32' | 'f64'), or None when no peak
    applies (no rung, no card, a card the table does not name)."""
    peaks = _card_peaks()
    if rung is None or peaks is None:
        return None
    if rung == "3xtf32":
        return peaks["tf32"] / 3.0
    return peaks.get(rung)


def filter_rung(dtype, low: bool):
    """Which rung the filter's HEMM ran in on the port's main route (the
    ring kernel, ``ring_backend="pallas"``): f32 and c64 problems run
    '3xtf32' at full precision and 'bf16' on the low rung; f64 and c128
    problems run '3xtf32' on the low rung (the f32/c64 shadow of the
    ladder) and 'f64' at full precision (cuBLAS on the FP64 tensor
    cores)."""
    if real_dtype(dtype) == torch.float32:
        return "bf16" if low else "3xtf32"
    return "3xtf32" if low else "f64"


class profiler_trace:
    """Context manager around a ``torch.profiler`` trace (CPU, and the
    card when there is one) — the NVTX-range analogue
    (Impl/chase_gpu/nvtx.hpp SCOPED_NVTX_RANGE).  On exit the trace is
    written to ``log_dir/trace.json`` (Chrome trace format: chrome://
    tracing or Perfetto); ``.profile`` is the profiler, for its
    ``key_averages()``::

        with chase_tpu_torch.perf.profiler_trace("/tmp/chase_trace"):
            chase_tpu_torch.eigsh(H, nev, nex)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.profile = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.profile = profile(activities=acts)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        self.profile.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.profile.export_chrome_trace(os.path.join(self.log_dir,
                                                      "trace.json"))
        return False


# -- spans, the phase clock and the counters ----------------------------------
#
# ``span(name)`` is the program's one tracing mechanism: a
# ``torch.profiler.record_function`` range where a profiler records on the
# running thread (the trace then ties every kernel launched inside it to
# the span, on the profiler's clock), and the end of a PerfData phase
# where a :class:`PhaseClock` runs on the thread.  Without either it
# costs one flag check.

# the span names; a route or a rung goes to a counter, never into a name
SPANS = ("chase.solve", "chase.operator", "chase.init_vecs", "chase.lanczos",
         "chase.iteration", "chase.degrees", "chase.filter", "chase.kconj",
         "chase.qr", "chase.rr", "chase.locking", "chase.ring_hemm",
         "chase.comm", "chase.warm_start")

# the PerfData phase whose end each span marks (PHASES); a phase's time
# runs from the previous mark to its own, so "Filter" holds the degrees
PHASE_OF = {"chase.init_vecs": "InitVecs", "chase.lanczos": "Lanczos",
            "chase.filter": "Filter", "chase.kconj": "ApplyKconjugate",
            "chase.qr": "Qr", "chase.rr": "Rr",
            "chase.locking": "Resids_Locking"}

_profiling = torch._C._autograd._profiler_enabled   # per thread
_local = threading.local()


class span:
    """Context manager: the program's span ``name`` (:data:`SPANS`)."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        clock = getattr(_local, "clock", None)
        if clock is not None and exc[0] is None:
            phase = PHASE_OF.get(self.name)
            if phase is not None:
                clock.mark(phase)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


class PhaseClock:
    """Context manager: the PerfData phase times of one solve on
    ``device``.  While it runs, each span of :data:`PHASE_OF` that closes
    on this thread marks its phase's end: a CUDA event recorded on the
    device's current stream (no synchronize), or the host clock on the
    CPU.  On a clean exit it marks the end of "All", waits once for the
    device (the timer's wait, not one of the solve's ``host_sync``
    counts), and adds each phase's time — previous mark to its own — and
    "All" — first mark to last — to ``perf.timings``."""

    def __init__(self, perf: PerfData, device: torch.device):
        self.perf = perf
        self.device = device
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self._outer = None

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def mark(self, phase: str) -> None:
        self.marks.append((phase, self._now()))

    def _seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def __enter__(self):
        self._outer = getattr(_local, "clock", None)
        _local.clock = self
        self.marks = [(None, self._now())]
        return self

    def __exit__(self, *exc):
        _local.clock = self._outer
        if exc[0] is not None:
            return False
        self.mark("All")
        if self.cuda:
            torch.cuda.synchronize(self.device)
        first = prev = self.marks[0][1]
        for phase, t in self.marks[1:-1]:
            self.perf.add_time(phase, self._seconds(prev, t))
            prev = t
        self.perf.add_time("All", self._seconds(first, self.marks[-1][1]))
        return False


def phase_clock(perf: "PerfData | None", device: torch.device):
    """:class:`PhaseClock` over a solve that fills ``perf``; with no
    PerfData a context that does nothing."""
    return (contextlib.nullcontext() if perf is None
            else PhaseClock(perf, device))


# Counts of the program's events, in one registry (``ops.ring_hemm.
# LAUNCHES`` is this object), each made where the event happens, under a
# lock — ranks simulated as threads of one process count at once; a key
# not yet counted reads 0:
#
# * launches by kernel wrapper: "ring_hemm", "tf32_split", "bf16_pack",
#   "ring_hemm_peers", "peer_gather", "peer_publish";
# * main launches by route and width: "ring_hemm:<f32|c64|bf16>[ trans]
#   k=<k>" and "ring_hemm_peers:<route> k=<k>" (k: V's columns);
# * host syncs by site, "host_sync:<site>": every point of a solve where
#   the host waits for the device — a read of a device value, or a copy
#   of a host array onto it (a pageable copy drains the stream) — counted
#   on every device, so that a CPU solve counts what the card would do;
# * QR fallbacks, "qr_fallback:<to>": a Cholesky QR that broke down and
#   was redone by Householder QR ("householder") or on the full block
#   ("full_block");
# * a grid's collectives by kind, "comm:<kind>" (calls) and
#   "comm_bytes:<kind>" (payload bytes), as ``parallel.mesh.
#   CollectiveStats`` counts them: "all_reduce", "broadcast",
#   "all_gather", "sendrecv", "reduce_scatter", "flip", "rotate", "peer";
# * the filter's column-products, "filter_cols:executed" (the summed
#   width of every filter product launched) and "filter_cols:useful"
#   (the columns whose degree the step had not passed), each × the
#   products per step (2 for the H² filters), counted by the solvers'
#   filter drivers;
# * the Hermitian solver's warm starts, "warm_start:members" (solves
#   started from a caller's block with ``approx``) and
#   "warm_start:dos_lowered" (those whose stale lower edge the DoS
#   quantile capped, ``solver._warm_bounds``).

COUNTS = collections.Counter()
_COUNT_LOCK = threading.Lock()
HOST_SYNC = "host_sync:"
QR_FALLBACK = "qr_fallback:"
COMM = "comm:"
COMM_BYTES = "comm_bytes:"
FILTER_COLS = "filter_cols:"
WARM_START = "warm_start:"


def count(key: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        COUNTS[key] += n


def host_sync(site: str) -> None:
    """Count one host sync at ``site`` ("<module>.<what>") that a library
    call makes inside itself (``torch.linalg.eigh`` reading its info, a
    tensor's ``.to``/``copy_`` from the host); a read or a copy the
    program makes itself goes through :func:`to_host`, :func:`item` or
    :func:`to_device`, which count it."""
    count(HOST_SYNC + site)


def to_host(t: torch.Tensor, site: str) -> np.ndarray:
    """``t``'s values as a numpy array: a device→host read, one host sync
    at ``site``."""
    host_sync(site)
    return t.detach().cpu().numpy()


def item(t: torch.Tensor, site: str):
    """``t``'s one value as a Python number: a device→host read, one host
    sync at ``site``."""
    host_sync(site)
    return t.item()


def to_device(a, site: str, **kwargs) -> torch.Tensor:
    """``torch.as_tensor(a, **kwargs)`` of host data onto a device: a
    pageable copy that drains the stream, one host sync at ``site``."""
    host_sync(site)
    return torch.as_tensor(a, **kwargs)
