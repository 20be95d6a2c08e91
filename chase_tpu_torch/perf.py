"""Phase timers + analytic FLOP model.

Port of ``chase_tpu/perf.py`` (the reference's ChasePerfData: timed
phases and the closed-form FLOP counters of performance.hpp:135-293).
Phase times are host wall-clock around work that ends in a device
synchronize (see solver.solve).  The JAX package's TPU peak table is not
ported, so no fraction-of-peak is reported: on CUDA it stays unset until
a measured H100 peak is wired in.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .types import is_complex_dtype

__all__ = ["PerfData"]

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
    # EXECUTED filter column-steps (window width × recurrence steps): the
    # windows run retired/padded columns until their bucket completes, so
    # executed ≥ useful (filtered_vecs)
    filtered_vecs_executed: int = 0
    # N×N HEMM calls the filter issued (one per recurrence step and
    # window segment) — on the ring path, one ring_hemm launch each
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

    def get_lanczos_flops(self, N: int, lanczos_iter: int, num_lanczos: int,
                          dtype) -> float:
        f = self._factor(dtype)
        flop = lanczos_iter * 2.0 * N * num_lanczos * N
        if self.matrix_type == 1:
            flop += lanczos_iter * (N / 2) * num_lanczos
        flop += float(lanczos_iter) ** 2 * num_lanczos ** 2
        return flop * f / 1e9

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
