"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives chase_tpu_torch's main paths on the card and fails (non-zero exit,
no result line) on any fault:

  device   require CUDA; print the card's name and power limit
  build    compile the port's CUDA kernels from csrc/ (nvcc, sm_90a);
           registers and spills of the 3xTF32 main kernels (f32 and c64,
           plain and trans), none of which may spill
  kernel   ring_hemm (TMA + wgmma, 3xTF32) against its plain version
           (torch.matmul) at the filter's shapes, both held against an f64
           product at (N, k) = (1000, 37), (30000, 750/1500/2250/3000),
           timed, with TFLOP/s and the share of the 165 TFLOP/s 3xTF32
           ceiling (the card's peaks: chase_tpu_torch.perf's data-sheet
           table); its TF32 split pre-pass against its plain
           version (bit-exact); a strided window, a two-chunk ring step,
           NaNs of either sign with every mantissa bit set and an inf in
           H making their whole rows of W NaN (plain and trans route; the
           pre-pass of such a V bit-exact) and an N=1001 operator whose
           row stride DenseOperator pads to 1004
  filter   the p=1 ring Chebyshev filter (every HEMM on the kernel)
           against the plain filter at N=30000, width 750, degree 10
  slice    eigsh on the Clement matrix at the solver's reference scale
           (N=30000, nev=2250, nex=750, f32, ring_backend="pallas"):
           convergence, eigenvalues against the exact spectrum, true
           residuals, and ring_hemm and tf32_split launches == the
           filter's HEMM steps
  profile  warm solves of the slice on the ring path and on the windowed
           (cuBLAS) path, then a torch.profiler trace of one warm
           ring-path solve: device busy share and time by kernel name
  gridring the (p, 1) ring's stripes of a dense random H at the slice's
           size (N=30000) at p = 2 and 4 on one card (the slice's Clement
           H is zero off its diagonal band, so its stripes would hold the
           kernel to a few terms per entry): each simulated rank's stripe
           laid out as
           DenseOperator(grid=…) lays it out, the production step loop
           (parallel.ring.ring_steps: p ring_hemm calls with col0 = src·N/p
           and accumulate) with the simulated ranks' exchange (one
           thread each, chunks handed through a shared board between
           barriers) standing in for NCCL, on the f32 and bf16 routes here (k = 3000; 1500 too for
           bf16) and on the c64 route after cprofile; H·V against a wide
           product per rank and the plain version's loop at the kernel
           gate, launches = p² per ring run; one stripe call (N/p, N/p, k)
           timed beside its plain version, the library call and its
           bound; the pre-pass of a received chunk beside what sending
           the chunk in the pre-pass's layout would add (f32, c64: hi and
           lo) or save (bf16: half the bytes) at 450 GB/s of NVLink
           (the BSE H² rings: after pfilter, below).  Then the 2-D
           ping-pong ring at a simulated (2, 2) grid (four threads whose
           collectives — the chunk exchange along 'r' and 'c', the
           reduce-scatter, the parity flip, the all_gather — go through
           a shared board between barriers): each rank's (N/2 × N/2)
           block (torch.cuda.memory_allocated before and after a Ring2D
           is built on it: equal, no copy), ring_A's passes (H·V, 2
           kernel steps on the block) and ring_B's (Hᴴ·V, 2 on the
           block's trans route, ring_hemm(trans=True)) against wide
           products and the plain version's passes at the kernel gate, 2
           launches per rank and pass, one stripe call of each (N/2, N/4,
           k) timed beside its plain version, the library call
           (torch.matmul of the block, of its conjugate-transposed view
           for ring_B: cuBLAS ConjTrans) and its bound, ring_B's also
           beside the untransposed route at its shape (then the same at
           (2, 4)); the Hermitian 2-D ring filter on
           (H + Hᴴ)/2 against the plain filter at filter's width,
           degrees and gate (1e-2 on the bf16 shadow), 80 launches
  io       the slice's H written with io.save_matrix to a ChASE file in a
           temporary directory (kept until gridhost, which reads it
           again), read back by
           io.load_matrix through the native reader (bitwise against H on
           the card; write and read GB/s and the placement timed apart:
           DenseOperator copies the Fortran-ordered view as it lies and
           transposes it on the card, beside the host transpose
           np.ascontiguousarray for comparison), solved
           from the file on the ring (the slice's gates,
           launches = HEMM steps), its (V, ritzv_full) through save_state /
           load_state (bitwise) and a warm start from them (iterations
           beside the cold solve's)
  cli      chase_tpu_torch.cli.main in this process on that file at the
           slice's shape (CHASE_RING_BACKEND=pallas: ring_hemm and
           tf32_split launches equal and above 0; exit code, "converged",
           the printed eigenvalues against Clement's spectrum), then
           --fused at fmid's shape, then `python -m chase_tpu_torch` in a
           child process (Clement N=1000)
  capi     libchase_tpu_torch.so built from _native/chase_capi.cpp, the
           unchanged examples/c_interface_demo.c (f64, N=301) and
           examples/c_file_demo.c compiled against it and run as child
           processes on the card: the demo must PASS; the file driver
           reads the file through schase_init_internal_ + schase_readHam_
           and solves the slice on the ring (its gates: eigenvalues within
           0.5 of Clement's, true residuals ≤ 10·tol, computed in C), with
           its init, readHam, solve and get times beside the in-process
           warm TTS and its ring_hemm launches
  ckernel  complex64 ring_hemm (its c64 kernel, Gauss's three real
           products, with the complex pre-pass's six planes) against its
           plain version (complex
           torch.matmul) and a c128 product at (1001, 37) through
           DenseOperator (row stride 1002), (30000, 750), (30000, 1500),
           (30000, 3000);
           the complex pre-pass bit-exact; a two-chunk ring step at
           col0 = 15001; an odd-stride c64 H refused
  cslice   eigsh on a phase-rotated Clement matrix H = D·C·Dᴴ (dense
           complex Hermitian storage, Clement's exact spectrum), N=30000,
           nev=2250, nex=750, c64, ring_backend="pallas", with the same
           gates and launch counts as the slice; then the cprofile phase:
           warm solves on the ring and windowed (cuBLAS CGEMM) paths and a
           trace of the warm ring solve
  bkernel  the bf16 route of ring_hemm (bf16 H, f32 V rounded to bf16 by
           its pre-pass, f32 sums) against its plain version and the
           library's bf16 GEMM (torch.mm, f32 out), all held against an
           f64 product of the bf16-rounded operands, at (1000, 37),
           (30000, 750), (30000, 1500), (30000, 3000), with the SM clock
           and power draw (nvidia-smi) while the kernel runs, a strided
           window and a two-chunk ring step at col0 = 15001; the pre-pass
           bit-exact.  kernel, ckernel and bkernel each end with one call
           of the trans route (H[row0:row0+b, :]ᴴ·V, the 2-D ring's
           ring_B step) at a (2, 2) stripe's shape with a ragged row0 and
           b, added into a strided window, against its plain version (the
           library's for bf16) and a wide product
  bslice   the f32 slice with the bf16 rung (bf16_filter=True, pallas):
           every filter HEMM on the bf16 route, the slice's gates
  dp       the north star in double precision: the phase-rotated Clement
           in c128 at N=30000, nev=2250, nex=750, tol 1e-10·‖H‖ absolute,
           windowed path (native ZGEMM, mixed_precision=False)
  ladder   the same c128 H with the precision ladder (mixed_precision=True):
           first windowed (cuBLAS CGEMM on the c64 shadow), then with
           ring_backend="pallas", every filter HEMM on the kernel's c64
           route; dp's gates, ≥ 80% of the FLOPs in c64, the TTS beside
           dp's; a torch.profiler trace of one more kernel-ring solve
  sequence eigsh_sequence over 10 correlated c128 problems (N=8000,
           nev=400, nex=100, drift 1e-3·‖H‖_F/N per member) built on the
           card and passed as a generator, mixed_precision pinned to the
           f64/c128 default on CUDA; estimate_spectral_bounds
  pfilter  the p=1 H² ring filter (two ring_hemm launches per step)
           against the plain H² filter on a structured BSE matrix (exact
           spectrum ±√(a²−b²), built on the card), N=30000, at the BSE
           solves' first window (width nev+nex = 1500), degree 10, on the
           operator of each BSE solve below: the f32 route (f32 shadow,
           f64 window), the bf16 route (bf16 shadow, f32 window) and,
           before zpseudo, the c64 route (c64 shadow, c128 window);
           launches = 2·10, degree-0 columns bit-exact; then [gridring]'s
           H² rings: chebyshev_filter_h2_ring(grid=…) at p = 2 and 4
           simulated ranks (one thread each, the ring's exchange through a
           shared board between barriers) on each rank's stripe of that
           operator and its rows of that window, both products of every
           step a p-step ring_steps ring on the kernel; the stacked result
           against the plain H² filter at pfilter's gate, degree-0
           columns bit-exact, launches = 2·p² per H² step; an f32 and a
           c64 stripe call (N/p, N/p, 1500) timed beside its plain
           version, the library call and its bound; then the 2-D H² ring
           filter (chebyshev_filter_h2_ring2d: each H² step a ring_B pass
           on the block's trans route and a ring_A pass on the block, r + c = 4
           launches per rank) at the simulated (2, 2) grid against the
           same plain H² filter and gate, and its ring_A and ring_B
           stripe calls (N/2, N/4, 1500) on the f32 and c64 routes
  bpseudo  eigsh_pseudo on the f32 copy of that BSE matrix, tol 1e-4, on
           the bf16 rung (bf16_filter=True, ring_backend="pallas"): every
           filter product on the kernel's bf16 route (ring_hemm launches
           = bf16_pack launches = the filter's HEMM steps), eigenvalues
           and true residuals (against the f64 H) within 10·tol
  pseudo   eigsh_pseudo on that BSE matrix in f64, N=30000, nev=1000,
           nex=500, tol 1e-10 absolute: natively (windowed, DGEMM), then
           on the ladder (mixed_precision=True, ring_backend="pallas":
           every filter product on the kernel's f32 route); eigenvalues
           against the exact spectrum and true residuals ≤ 10·tol, on the
           ladder ≥ 80% of the FLOPs in f32 and ring_hemm launches =
           tf32_split launches = the filter's HEMM steps; a torch.profiler
           trace of one more ladder solve
  zpseudo  the same BSE made complex, H_c = D·H·D⁻¹ with D = diag(d,
           conj(d)) of random unit phases (same spectrum), c128 on the
           ladder on the kernel's c64 route, pseudo's gates; pseudo,
           bpseudo and zpseudo print whether the iteration-0 H² degree cap
           engaged and which QR variant iteration 0 ran
  fslice   eigsh_fused (the device-resident solver) on the slice's H and
           config beside profile's warm ring solve; fsmall (Clement
           N=1000, nev=100, f32 default tol) and fmid (N=8192, nev=512,
           nex=256, tol 0.1) beside eigsh, both on "pallas"; fpseudo:
           eigsh_pseudo_fused on pseudo's f64 BSE on the ladder and the
           kernel ring beside pseudo's ladder solve; zfused: a c128 BSE at
           N=4096, nev=200, nex=56 natively, eigsh_pseudo and
           eigsh_pseudo_fused.  Each prints the first and warm TTS and
           iterations of both, the host syncs per fused iteration
           (the program's count, at most 3) and, on the kernel
           ring, ring_hemm and pre-pass launches against the solver's HEMM
           steps (equal); the phase's gates hold for both solvers.  The
           fused solvers on the kernel's other routes, each the same way
           with its peak device memory: fbslice (after bslice, beside
           its TTS): eigsh_fused on the slice's H on the bf16 rung
           (bf16_filter=True; its pre-passes bf16_pack while the rung's
           low phase holds and tf32_split after it, together one per HEMM
           step, bf16_pack at least once); fcmid (after cprofile):
           eigsh_fused on the phase-rotated Clement in c64 at fmid's
           shape (the c64 route), traced; fladder (after ladder, beside
           its kernel-ring solve): eigsh_fused on the c128 north star on
           the ladder (mixed_precision=True, the c64 shadow's route),
           dp's gates and ≥ 80% of the FLOPs in c64; fbpseudo (after
           bpseudo, beside it): eigsh_pseudo_fused on the f32 BSE on the
           bf16 rung, bpseudo's gates; zfladder (after zfused): the c128
           BSE at zfused's shape on the ladder, eigsh_pseudo and
           eigsh_pseudo_fused, the c64 route
  examples the port's Python examples (examples/torch_hello_world.py,
           torch_interface_demo.py, torch_bse_benchmark.py) as child
           processes on the card at their default sizes: each exits 0
           with its PASS line, whose eigenvalue error against Clement's
           exact spectrum (or, for the BSE, the true residual) is ≤ 1e-9
  grid1    a child process with torchrun's variables at WORLD_SIZE=1:
           multihost.init_grid() on NCCL, the grid's collectives once
           (all_reduce f32 and c64, all_gather_into_tensor, broadcast,
           the ring's chunk exchange), then with grid= on the (1, 1)
           grid, each at its one-device phase's gates: the f32 slice
           (eigsh, cold and warm), eigsh_fused at fslice's shape, the f64
           BSE ladder of pseudo (eigsh_pseudo, cold and warm) and
           eigsh_pseudo_fused at fpseudo's shape (first, warm, one
           iteration: at most 3 host syncs per iteration); each with its
           phase's iteration count, its warm TTS within ±5% of the
           phase's, ring_hemm launches = the HEMM steps, no collective
           issued (Grid2D.stats); then the distributed I/O on io's file:
           io.load_matrix_sharded of it (the native read timed alone
           first; bitwise against H), eigsh of that DTensor at the
           slice's gates (launches = HEMM steps), its V through
           save_state(sharded=True) and load_state(grid=) (bitwise), a
           warm start from that checkpoint (no more iterations than the
           cold solve), and interface.init_blockcyclic(mb = nb = 64) +
           solve + get_eigenpairs at the slice's gates
  gridnccl with two cards or more, p = min(cards, 4) ranks run grid1's
           solves and I/O on a (p, 1) NCCL grid with their gates (each
           rank's ring_hemm launches = p × its HEMM steps) and the
           unchanged examples/c_dist_2proc_demo.c on two ranks, and with
           four or more gridhost's (2, 2) solves and I/O on an NCCL grid
           and examples/c_dist_interface_demo.c on four ranks; with one
           card it prints "not run: 1 device" and counts nothing as
           passed
  gridhost two child processes (torchrun's variables, a gloo group) that
           share card 0 on a (2, 1) grid of HostStagedGrid, a Grid2D
           defined here whose collectives copy CUDA tensors to pinned
           host memory, run gloo and copy back (not NCCL, which refuses
           two ranks on one card): Clement N=8192, nev=512, nex=256, f32
           tol 0.1 (eigsh, eigsh_fused) and the structured BSE N=8192,
           nev=256, nex=128, f64 ladder tol 1e-10 (eigsh_pseudo,
           eigsh_pseudo_fused), on "pallas": each at its phase's accuracy
           gate, iterations within ±1 of the same solve on one device,
           ritzv, resid, iterations and locked bitwise equal on both
           ranks, ring_hemm launches = 2 × HEMM steps per rank with every
           launch on a stripe (N/2 rows, col0 0 or N/2); then four such
           children on a (2, 2) grid (HostStagedGrid also stages the
           reduce-scatter and the parity flip) solve the Clement
           and BSE-ladder problems with eigsh and eigsh_pseudo on the 2-D
           ring: the same gates, results bitwise equal on all four
           ranks, launches = 2 × HEMM steps per rank, every launch on a
           stripe (N/2 rows, col0 0 or N/4) of the one filter operator
           block (ring_B's on the trans route), and each rank's peak
           device memory (torch.cuda.max_memory_allocated) around each
           of the two solves;
           then each of the four reads its (15000, 15000) block of io's
           N=30000 file with io.load_matrix_sharded and
           io.load_matrix_blockcyclic(mb=64) (one native gather of its
           columns' row spans; each native read timed alone first, bytes
           and seconds per rank), each bitwise against the matching
           (permuted) block of H built on the card, and solves fmid's
           Clement (N=8192) through interface.init_blockcyclic(64, 64)
           and interface.init_dist_local (its (4096, 4096) block) on the
           2-D ring at the Clement gates in the user's row order, ritzv
           bitwise equal on all four ranks, every launch on a 2-D stripe,
           the per-rank result through a sharded checkpoint (bitwise) and
           a warm start from it; its times are of ranks sharing one card,
           not performance numbers

Each phase prints lines with its numbers and seconds.  A full run then
prints the kernels' JSON summary and, last, {"ok": true, "device": {...}}.
There is no CPU fallback: without a GPU the script exits non-zero before
any phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

# slice configuration: the repo's north-star shape, f32 at an absolute
# tolerance of ~1e-5·‖H‖ (‖H‖ = N - 1 for Clement)
SLICE = dict(N=30000, nev=2250, nex=750, tol=0.3)
# (30000, 1500): the BSE solves' first filter window, w = nev + nex
KERNEL_SHAPES = ((1000, 37), (30000, 750), (30000, 1500), (30000, 2250),
                 (30000, 3000))
C64_SHAPES = ((30000, 750), (30000, 1500), (30000, 3000))
BF16_WIDTHS = (750, 1500, 3000)
# the sequence parity configuration (BASELINE.md): 10 correlated problems
SEQUENCE = dict(N=8000, nev=400, nex=100, count=10, drift=1e-3)
# the BSE (pseudo-Hermitian) phases: K2 = 2·(nev+nex) = 3000, the
# Hermitian slice's block width; tol absolute, solve_pseudo's DP default
# (f32 on the bf16 rung: the JAX package's SP BSE test tolerance)
BSE = dict(N=30000, nev=1000, nex=500, tol=1e-10, sp_tol=1e-4)
# the fused Clement phases at the JAX package's fused cells
# (BENCH_NOTES.md:100-113): (phase, N, nev, nex, tol); nex None is
# max(nev/4, 8), tol None the f32 default 1e-5
FUSED_CLEMENT = (("fsmall", 1000, 100, None, None),
                 ("fmid", 8192, 512, 256, 0.1))
# the JAX package's fused BSE cell (BENCH_NOTES.md:129-131), in c128
ZFUSED = dict(N=4096, nev=200, nex=56)
# the I/O and bindings phases: the CLI's fused run at fmid's shape, and the
# module entry in a child process at fsmall's
CLI_FUSED = ("--isMatGen", "clement", "--n", "8192", "--nev", "512", "--nex",
             "256", "--tol", "0.1", "--dtype", "float32", "--fused")
CLI_MODULE = ("--isMatGen", "clement", "--n", "1000", "--nev", "100",
              "--dtype", "float32")
ROOT = Path(__file__).resolve().parent
SEED = 20261016
HBM_TBS = 3.35              # TB/s: the H100 SXM's device-memory rate
SPIN_CYCLES = 100_000_000   # queued_ms's spinning kernel: ~50 ms at 2 GHz


def peak_tflops(rung: str) -> float:
    """The card's dense peak for ``rung`` ("3xtf32": the kernels'
    f32-accuracy route, a third of the TF32 rate; "bf16") in TFLOP/s, from
    chase_tpu_torch.perf's data-sheet table; a card the table does not
    name stops the script (its bounds would be unknown)."""
    from chase_tpu_torch.perf import device_matmul_peak
    peak = device_matmul_peak(rung)
    if peak is None:
        raise AssertionError(f"no {rung} peak for "
                             f"{torch.cuda.get_device_name(0)} in "
                             f"chase_tpu_torch.perf.MATMUL_PEAKS")
    return peak / 1e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_fns(fns, reps: int) -> list:
    """One warm-up each, then every function in order and again in reverse
    order (plain, kernel, kernel, plain for two); the mean ms of each."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    fwd = [time_ms(fn, reps) for fn in fns]
    rev = [time_ms(fn, reps) for fn in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(fwd, rev)]


class EmptyTrace(AssertionError):
    """Three torch.profiler traces in a row held no device activity."""


def device_ms(fn, reps: int, match: str = "") -> tuple:
    """(mean ms, count) of the device activities — kernels, copies — whose
    name holds ``match`` in a torch.profiler trace of ``reps`` calls of
    ``fn`` after one warm-up call: their durations on the card, without
    the launch gaps that CUDA events around the calls count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a trace has come back empty: trace again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA and match in e.name]
        if spans:
            return sum(spans) / len(spans) / 1e3, len(spans)
    raise EmptyTrace(f"three traces show no device activity named "
                     f"{match!r}")


def queued_ms(fn, reps: int) -> float:
    """Mean milliseconds on the card of the ops that ``fn(timed)`` runs
    through ``timed(op)``, over ``reps`` calls of ``fn`` after one warm-up
    call: CUDA events around each op, all queued behind a kernel that
    spins while this thread enqueues them (the stream is checked still
    busy after the last), so that each span holds its op's duration on
    the card and no launch gap from the host; the events' own few µs on
    the card are in it, which a kernel duration (:func:`device_ms`) is
    not."""
    fn(lambda op: op())
    torch.cuda.synchronize()
    spans = []

    def timed(op):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        op()
        b.record()
        spans.append((a, b))

    torch.cuda._sleep(SPIN_CYCLES)
    for _ in range(reps):
        fn(timed)
    queued = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    if not (queued and spans):
        raise AssertionError(f"the timed ops were not queued before a "
                             f"kernel of {SPIN_CYCLES} cycles ended")
    return statistics.mean(a.elapsed_time(b) for a, b in spans)


def sampled(fn):
    """(fn(), median SM clock in MHz, median power draw in W, samples):
    nvidia-smi polled in a thread while ``fn`` runs."""
    out, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            r = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.split(",")
            try:
                out.append((float(r[0]), float(r[1])))
            except (ValueError, IndexError):
                pass

    t = threading.Thread(target=poll, daemon=True)
    t.start()
    try:
        res = fn()
    finally:
        stop.set()
        t.join()
    if not out:
        return res, float("nan"), float("nan"), 0
    return (res, statistics.median(x[0] for x in out),
            statistics.median(x[1] for x in out), len(out))


def bound(flop: float, nbytes: float, rung: str = "3xtf32") -> tuple:
    """(ms, "operations" | "bytes"): the least time the card could take —
    the larger of the operations over the ``rung``'s peak (the 3xTF32
    ceiling of the kernels' f32-accuracy route, or the bf16 rate) and the
    bytes over HBM's rate."""
    t_ops = flop / (peak_tflops(rung) * 1e9)
    t_mem = nbytes / (HBM_TBS * 1e9)
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def hemm_bound(m: int, b: int, k: int, dtype) -> tuple:
    """ring_hemm's bound: H (m × b), V (b × k) read once, W (m × k)
    written once; 2·m·b·k FLOPs, 8·m·b·k for complex."""
    flop = (8 if dtype.is_complex else 2) * m * b * k
    return bound(flop, dtype.itemsize * (m * b + b * k + m * k))


def bf16_hemm_bound(m: int, b: int, k: int) -> tuple:
    """The bf16 route's bound: H (m × b) bf16, V (b × k) f32 read once, W
    (m × k) f32 written once; 2·m·b·k FLOPs at the bf16 rate."""
    return bound(2.0 * m * b * k, 2 * m * b + 4 * (b * k + m * k), "bf16")


def pack_bound(b: int, k: int) -> tuple:
    """The bf16 pre-pass's bound: V (b × k) f32 read once, the (w_pad ×
    b_pad) bf16 output written once."""
    from chase_tpu_torch.ops.ring_hemm import pack_shape
    b_pad, w_pad = pack_shape(b, k)
    return bound(0.0, 4 * b * k + 2 * w_pad * b_pad)


def split_bound(b: int, k: int, dtype) -> tuple:
    """The pre-pass's bound: V read once, the (planes, w_pad, b_pad) f32
    output written once (2 planes for f32, 6 for c64)."""
    from chase_tpu_torch.ops.ring_hemm import split_shape
    planes = 6 if dtype.is_complex else 2
    b_pad, w_pad = split_shape(b, k, 0, dtype)
    return bound(0.0, dtype.itemsize * b * k + 4 * planes * w_pad * b_pad)


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x − ref| / max |ref|, x taken to ref's (f64 or c128) type."""
    return float((x.to(ref.dtype) - ref).abs().max() / ref.abs().max())


def clement_on_device(N: int, dev, dtype=torch.float32, seed: int = SEED
                      ) -> torch.Tensor:
    """The Clement matrix (tridiagonal, exact spectrum ±(N-1), ±(N-3),
    ...) built on the card.  For a complex dtype it is phase-rotated,
    H = D·C·Dᴴ with D = diag(exp(iθ_j)), θ uniform from ``seed``: complex
    Hermitian, with Clement's spectrum."""
    i = torch.arange(N - 1, dtype=torch.float64, device=dev)
    off = torch.sqrt((i + 1) * (N - i - 1))
    if dtype.is_complex:
        g = torch.Generator(device=dev).manual_seed(seed)
        theta = 2 * np.pi * torch.rand(N, generator=g, dtype=torch.float64,
                                       device=dev)
        off = off * torch.exp(1j * (theta[:-1] - theta[1:]))
    off = off.to(dtype)
    H = torch.zeros((N, N), dtype=dtype, device=dev)
    idx = torch.arange(N - 1, device=dev)
    H[idx, idx + 1] = off
    H[idx + 1, idx] = off.conj()
    return H


def dense_on_device(N: int, dev, dtype, seed: int = SEED + 7
                    ) -> torch.Tensor:
    """A dense N × N standard normal H built on the card (the ring
    stripes' operand: every block of it is full, so a column block read
    at the wrong col0 shows, and the error gate sums N terms per entry as
    the kernel phases do)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((N, N), generator=g, device=dev, dtype=dtype)


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", f"{name}; count={torch.cuda.device_count()}; torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}")
    return {"name": name, "smi": smi}


KERNEL_SOURCES = ("ring_hemm", "ring_peers")     # csrc/<name>.cu
# the 3xTF32 main kernels of csrc/ring_hemm.cu, by the pattern of their
# mangled names in ptxas's report
MAIN_KERNELS = {
    "ring_hemm_kernel<Tf32x3, 0>": r"ring_hemm_kernelI\w*?Tf32x3E\w*?Li0E",
    "ring_hemm_kernel<Tf32x3, 1>": r"ring_hemm_kernelI\w*?Tf32x3E\w*?Li1E",
    "ring_hemm_kernel_c64<0>": r"ring_hemm_kernel_c64ILi0E",
    "ring_hemm_kernel_c64<1>": r"ring_hemm_kernel_c64ILi1E",
}


def kernel_registers(ptxas_log: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} of the
    MAIN_KERNELS found in a ``ptxas -v`` report."""
    out, fn = {}, None
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            fn = next((n for n, pat in MAIN_KERNELS.items()
                       if re.search(pat, line)), None)
            continue
        if fn is None:
            continue
        out.setdefault(fn, [None, None])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn][1] = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn][0] = int(m[1])
    return {n: (r, *(s or (None, None))) for n, (r, s) in out.items()}


def phase_build() -> float:
    """Every kernel library built from csrc/, one nvcc per source, all
    started together; ptxas's registers and spills logged."""
    from concurrent.futures import ThreadPoolExecutor
    from chase_tpu_torch import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_build.load_library, KERNEL_SOURCES))
    dt = time.perf_counter() - t0
    release = subprocess.run([_build.nvcc_path(), "--version"],
                             capture_output=True, text=True).stdout
    release = [ln for ln in release.splitlines() if "release" in ln]
    log("build", f"{', '.join(KERNEL_SOURCES)} built and loaded in "
                 f"{dt:.2f} s (nvcc {_build.nvcc_path()}: "
                 f"{release[0].strip() if release else 'version unknown'}; "
                 f"{_build.BUILD_DIR})")
    for name in KERNEL_SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Function" in line:
                log("build", line.strip())
    regs = kernel_registers(_build.build_log("ring_hemm"))
    log("build", "main kernels (registers, spill store / load bytes): " +
        "; ".join(f"{n} {regs.get(n)}" for n in MAIN_KERNELS))
    if not (set(regs) == set(MAIN_KERNELS) and
            all(r[1:] == (0, 0) for r in regs.values())):
        raise AssertionError(f"a 3xTF32 main kernel spills or is missing "
                             f"from ptxas's report: {regs}")
    return dt


def _hemm_case(phase, H, V, ref, reps: int) -> dict:
    """ring_hemm(H, V) against its plain version and the wide product
    ``ref``, timed beside the plain version and the library call
    (torch.matmul: cuBLAS SGEMM / CGEMM, TF32 off); raises past the gate."""
    from chase_tpu_torch.ops.ring_hemm import ring_hemm, ring_hemm_reference
    t0 = time.perf_counter()
    (N, n_cols), k = H.shape, V.shape[1]
    W = ring_hemm(H, V)
    torch.cuda.synchronize()
    Wp = ring_hemm_reference(H, V)
    err, errp = rel_err(W, ref), rel_err(Wp, ref)
    abs_err = float((W.to(ref.dtype) - ref).abs().max())
    del W, Wp
    plain_ms, kern_ms, lib_ms = time_fns(
        [lambda: ring_hemm_reference(H, V), lambda: ring_hemm(H, V),
         lambda: torch.matmul(H, V)], reps)
    gflop = (8.0 if H.is_complex() else 2.0) * N * n_cols * k / 1e9
    rate = gflop / kern_ms                   # GFLOP / ms = TFLOP/s
    bound_ms, bound_by = hemm_bound(N, n_cols, k, H.dtype)
    log(phase, f"(N, k)=({N}, {k}) {H.dtype}: rel err kernel {err:.3e} "
               f"plain {errp:.3e}; max abs err {abs_err:.3e}; kernel "
               f"{kern_ms:.3f} ms ({rate:.1f} TFLOP/s, "
               f"{rate / peak_tflops('3xtf32'):.1%} of the "
               f"{peak_tflops('3xtf32'):.0f} TFLOP/s "
               f"3xTF32 ceiling), plain {plain_ms:.3f} ms "
               f"({gflop / plain_ms:.1f} TFLOP/s), library (torch.matmul) "
               f"{lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); "
               f"{time.perf_counter() - t0:.2f} s")
    # f32 sums over K terms in two orders: 1e-5 of the largest entry,
    # and no worse than 4x the plain version's own error
    if not (err <= 1e-5 and err <= 4 * errp):
        raise AssertionError(f"ring_hemm error {err:.3e} at ({N}, {k}) "
                             f"{H.dtype} exceeds 1e-5 or 4x plain "
                             f"({errp:.3e})")
    return dict(err=err, errp=errp, abs_err=abs_err, ms=kern_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def _split_case(phase, V, reps: int) -> dict:
    """The pre-pass alone: bit-exact against its plain version, and
    each plane pair's hi + lo within 2^-22 of the matrix it splits (V; for
    c64 Vr, fl(Vi − Vr) and fl(Vr + Vi)); timed."""
    from chase_tpu_torch.ops.ring_hemm import tf32_split, tf32_split_reference
    b, k = V.shape
    Vt, Vr = tf32_split(V), tf32_split_reference(V)
    torch.cuda.synchronize()
    split_err = float((Vt - Vr).abs().max())
    parts = ((V.real, V.imag - V.real, V.real + V.imag) if V.is_complex()
             else (V,))
    rebuild = max(float(((Vt[2 * c] + Vt[2 * c + 1])[:k, :b] - X.T)
                        .abs().max() / X.abs().max())
                  for c, X in enumerate(parts))
    del Vt, Vr, parts
    sp_plain, sp_ms = time_fns([lambda: tf32_split_reference(V),
                                lambda: tf32_split(V)], reps)
    bound_ms, bound_by = split_bound(b, k, V.dtype)
    log(phase, f"tf32_split ({b}, {k}) {V.dtype}: max |kernel - plain| "
               f"{split_err}; hi + lo vs B rel {rebuild:.3e}; kernel "
               f"{sp_ms:.3f} ms, plain {sp_plain:.3f} ms, bound "
               f"{bound_ms:.3f} ms ({bound_by})")
    if not (split_err == 0.0 and rebuild <= 2.0 ** -22):
        raise AssertionError(f"tf32_split ({V.dtype}) disagrees with its "
                             f"plain version")
    return dict(abs_err=split_err, ms=sp_ms, plain_ms=sp_plain,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def _trans_case(phase, H, row0: int, b: int, k: int, g) -> None:
    """One call of ring_hemm's trans route at a 2-D stripe's shape with a
    ragged row0 and b: ``W[:, 5:5+k] += H[row0:row0+b, :]ᴴ · V`` into a
    strided column window of a wider W (the columns around it checked
    untouched), against an f64 (c128) product at 1e-5 of the largest
    entry and 4× the plain version's error (bf16: the library's bf16
    GEMM's, of the transposed view)."""
    from chase_tpu_torch.ops.ring_hemm import ring_hemm, ring_hemm_reference
    bf16 = H.dtype == torch.bfloat16
    vdt = torch.float32 if bf16 else H.dtype
    wide = torch.complex128 if vdt.is_complex else torch.float64
    m = H.shape[1]
    V = torch.randn((b, k), generator=g, device=H.device, dtype=vdt)
    Wfull = torch.randn((m, k + 10), generator=g, device=H.device, dtype=vdt)
    before = Wfull.clone()
    Hb = H[row0:row0 + b]
    Vr = V.to(torch.bfloat16) if bf16 else V
    ref = before[:, 5:5 + k].to(wide) + Hb.to(wide).mH @ Vr.to(wide)
    launches = _count("ring_hemm")
    ring_hemm(H, V, col0=row0, out=Wfull[:, 5:5 + k], accumulate=True,
              trans=True)
    torch.cuda.synchronize()
    launched = _count("ring_hemm") - launches
    err = rel_err(Wfull[:, 5:5 + k], ref)
    outside = bool(torch.equal(Wfull[:, :5], before[:, :5])
                   and torch.equal(Wfull[:, 5 + k:], before[:, 5 + k:]))
    if bf16:
        yard = before[:, 5:5 + k].to(wide) + torch.mm(
            Hb.mT, Vr, out_dtype=torch.float32).to(wide)
        yname = "library"
    else:
        Wp = before[:, 5:5 + k].clone()
        ring_hemm_reference(H, V, col0=row0, out=Wp, accumulate=True,
                            trans=True)
        yard, yname = Wp.to(wide), "plain"
    erry = rel_err(yard, ref)
    del V, Wfull, before, ref, yard
    log(phase, f"trans route H[{row0}:{row0 + b}, :{m}]ᴴ·V (k={k}, "
               f"{H.dtype}) += into W[:, 5:{5 + k}] (row stride {k + 10}): "
               f"rel err kernel {err:.3e} {yname} {erry:.3e}; launches "
               f"{launched}; columns outside the window untouched: "
               f"{outside}")
    if not (err <= 1e-5 and err <= 4 * erry and outside and launched == 1):
        raise AssertionError(f"{phase}: ring_hemm trans route failed")


def _nan_rows_case(phase, dev, g) -> None:
    """NaNs in an f32 H of either sign with every mantissa bit set (bits
    0x7FFFFFFF and 0xFFFFFFFF, which the TF32 split's integer rounding
    carries into a zero hi; its guard keeps lo a NaN) and an inf make their
    whole row of W NaN, on the plain route (col0 = 3, with inf and NaN in
    the three columns left of the block, which must reach nothing) and the
    trans route (NaN in the rows around the slab); the pre-pass of a V
    holding both NaNs bit-exact against its plain version."""
    from chase_tpu_torch.ops.ring_hemm import (ring_hemm, tf32_split,
                                               tf32_split_reference)
    col0, b, m = 3, 250, 200
    H = torch.randn((m, 304), generator=g, device=dev)[:, :300]
    bits = H.view(torch.int32)
    H[:, 0] = float("inf")
    H[::3, 1] = float("nan")
    bits[::5, 2] = -1
    planted = {5: 0x7FFFFFFF, 7: -1, 9: 0x7FC00000, 11: 0x7F800000}
    for r, v in planted.items():
        bits[r, col0 + 4 * r] = v
    V = torch.randn((b, 50), generator=g, device=dev)
    W = ring_hemm(H, V, col0=col0)
    bad = torch.zeros(m, dtype=torch.bool, device=dev)
    bad[list(planted)] = True
    plain_ok = bool(torch.isnan(W[bad]).all() and
                    torch.isfinite(W[~bad]).all())
    row0 = 20
    Ht = torch.randn((300, m), generator=g, device=dev)
    bits = Ht.view(torch.int32)
    Ht[row0 - 1] = float("nan")
    Ht[row0 + b] = float("inf")
    for r, v in planted.items():
        bits[row0 + 7 * r, 3 * r] = v
    W = ring_hemm(Ht, V, col0=row0, trans=True)
    bad = torch.zeros(m, dtype=torch.bool, device=dev)
    bad[[3 * r for r in planted]] = True
    trans_ok = bool(torch.isnan(W[bad]).all() and
                    torch.isfinite(W[~bad]).all())
    Vn = V.clone()
    Vn.view(torch.int32)[[3, 100], [7, 49]] = torch.tensor(
        [0x7FFFFFFF, -1], dtype=torch.int32, device=dev)
    Vt = tf32_split(Vn)
    split_ok = bool(torch.equal(Vt.view(torch.int32),
                                tf32_split_reference(Vn).view(torch.int32))
                    and torch.isnan(Vt[1, [7, 49], [3, 100]]).all())
    torch.cuda.synchronize()
    log(phase, f"NaN rows (bits 0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, inf) in "
               f"f32 H: whole rows of W NaN, the others finite, on the "
               f"plain route (col0={col0}, non-finite columns left of the "
               f"block) {plain_ok} and the trans route {trans_ok}; the "
               f"pre-pass of a V holding both NaNs bit-exact against its "
               f"plain version, lo NaN: {split_ok}")
    if not (plain_ok and trans_ok and split_ok):
        raise AssertionError(f"{phase}: a NaN in H or V did not reach W")


def phase_kernel(dev) -> dict:
    from chase_tpu_torch.ops.ring_hemm import ring_hemm, ring_hemm_reference
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    summary = {}
    H = H64 = None
    for N, k in KERNEL_SHAPES:
        if H is None or H.shape[0] != N:
            H = H64 = None
            torch.cuda.empty_cache()
            H = torch.randn((N, N), generator=g, device=dev)
            H64 = H.double()
        V = torch.randn((N, k), generator=g, device=dev)
        reps = 20 if N * N * k < 1e11 else 3
        summary[(N, k)] = _hemm_case("kernel", H, V, H64 @ V.double(), reps)
        if k == KERNEL_SHAPES[-1][1]:
            summary["split"] = _split_case("kernel", V, reps)

    # a strided column window of V, accumulated into a strided window of
    # W: the solver's view of its (N, nev+nex) block
    N = H.shape[0]
    Vfull = torch.randn((N, 3000), generator=g, device=dev)
    Wfull = torch.randn((N, 3000), generator=g, device=dev)
    Wbefore = Wfull.clone()
    Vw, Ww = Vfull[:, 1000:1750], Wfull[:, 1000:1750]
    ring_hemm(H, Vw, out=Ww, accumulate=True)
    torch.cuda.synchronize()
    ref = Wbefore[:, 1000:1750].double() + H64 @ Vw.double()
    errw = rel_err(Ww, ref)
    outside = bool(torch.equal(Wfull[:, :1000], Wbefore[:, :1000])
                   and torch.equal(Wfull[:, 1750:], Wbefore[:, 1750:]))
    log("kernel", f"strided window V[:, 1000:1750] (ldv=3000) += into "
                  f"W[:, 1000:1750]: rel err {errw:.3e}; columns outside "
                  f"the window untouched: {outside}")
    if not (errw <= 1e-5 and outside):
        raise AssertionError("strided-window ring_hemm failed")
    del Vfull, Wfull, Wbefore, ref

    # ring semantics: two column chunks, store then accumulate (col0 > 0)
    Hs = H[:1000]
    V = torch.randn((N, 37), generator=g, device=dev)
    half = N // 2
    W = ring_hemm(Hs, V[:half], col0=0)
    ring_hemm(Hs, V[half:], col0=half, out=W, accumulate=True)
    torch.cuda.synchronize()
    errc = rel_err(W, H64[:1000] @ V.double())
    log("kernel", f"two-chunk ring step (col0=0 store, col0={half} add) on a "
                  f"1000-row stripe: rel err {errc:.3e}")
    if not errc <= 1e-5:
        raise AssertionError("two-chunk ring_hemm failed")
    del H64, Hs, W, V
    # the trans route at a (2, 2) ring_B stripe's shape (a 15000 × 15000
    # block, ~7500-row slab), ragged
    _trans_case("kernel", H[:15000, :15000], 7501, 7497, 750, g)
    del H
    torch.cuda.empty_cache()
    _nan_rows_case("kernel", dev, g)

    # N = 1001: TMA needs a row stride that is a multiple of 4 floats, so
    # DenseOperator pads it to 1004; an unpadded CUDA H is refused
    from chase_tpu_torch import DenseOperator
    H1 = np.random.default_rng(SEED).standard_normal(
        (1001, 1001)).astype(np.float32)
    op = DenseOperator(H1, device=dev)
    V = torch.randn((1001, 37), generator=g, device=dev)
    W = ring_hemm(op.H, V)
    torch.cuda.synchronize()
    ref = op.H.double() @ V.double()
    err1 = rel_err(W, ref)
    errp1 = rel_err(ring_hemm_reference(op.H, V), ref)
    try:
        ring_hemm(torch.as_tensor(H1, device=dev), V)
        refused = False
    except ValueError:
        refused = True
    log("kernel", f"N=1001 DenseOperator: row stride {op.H.stride(0)}; rel "
                  f"err kernel {err1:.3e} plain {errp1:.3e}; contiguous "
                  f"(stride 1001) H refused with ValueError: {refused}")
    if not (op.H.stride(0) == 1004 and err1 <= 1e-5 and err1 <= 4 * errp1
            and refused):
        raise AssertionError("N=1001 operator check failed")
    log("kernel", f"phase ok in {time.perf_counter() - t_phase:.2f} s")
    return summary


def phase_complex_kernel(dev) -> dict:
    """The c64 route at the complex slice's shapes, against complex
    torch.matmul (CGEMM, TF32 off) and a c128 product."""
    from chase_tpu_torch import DenseOperator
    from chase_tpu_torch.ops.ring_hemm import ring_hemm
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    c64, c128 = torch.complex64, torch.complex128
    summary = {}

    # N = 1001 through DenseOperator: c64 rows of 1001 elements are 2002
    # floats, so the row stride is padded to 1002 (an even count); the
    # contiguous (odd-stride) H is refused before any launch
    rng = np.random.default_rng(SEED + 3)
    H1 = (rng.standard_normal((1001, 1001))
          + 1j * rng.standard_normal((1001, 1001))).astype(np.complex64)
    op = DenseOperator(H1, device=dev)
    V = torch.randn((1001, 37), generator=g, device=dev, dtype=c64)
    summary[(1001, 37)] = _hemm_case(
        "ckernel", op.H, V, op.H.to(c128) @ V.to(c128), 20)
    before = _count("ring_hemm")
    try:
        ring_hemm(torch.as_tensor(H1, device=dev), V)
        refused = False
    except ValueError:
        refused = _count("ring_hemm") == before
    log("ckernel", f"N=1001 DenseOperator: row stride {op.H.stride(0)}; "
                   f"contiguous (stride 1001) c64 H refused with ValueError "
                   f"and no launch: {refused}")
    if not (op.H.stride(0) == 1002 and refused):
        raise AssertionError("N=1001 c64 operator check failed")
    del op

    N = C64_SHAPES[0][0]
    H = torch.randn((N, N), generator=g, device=dev, dtype=c64)
    H128 = H.to(c128)
    for _, k in C64_SHAPES:
        V = torch.randn((N, k), generator=g, device=dev, dtype=c64)
        summary[(N, k)] = _hemm_case("ckernel", H, V, H128 @ V.to(c128), 3)
    summary["split"] = _split_case("ckernel", V, 3)

    # ring semantics with an odd col0: its float column is 2 mod 4
    Hs = H[:1000]
    V = torch.randn((N, 37), generator=g, device=dev, dtype=c64)
    half = N // 2 + 1
    W = ring_hemm(Hs, V[:half], col0=0)
    ring_hemm(Hs, V[half:], col0=half, out=W, accumulate=True)
    torch.cuda.synchronize()
    errc = rel_err(W, H128[:1000] @ V.to(c128))
    log("ckernel", f"two-chunk ring step (col0=0 store, col0={half} add) on "
                   f"a 1000-row stripe: rel err {errc:.3e}")
    if not errc <= 1e-5:
        raise AssertionError("two-chunk c64 ring_hemm failed")
    del H128, Hs, W, V
    _trans_case("ckernel", H[:15000, :15000], 7501, 7497, 750, g)
    del H
    torch.cuda.empty_cache()
    log("ckernel", f"phase ok in {time.perf_counter() - t_phase:.2f} s")
    return summary


def _bf16_case(phase, H, V, reps: int, col0: int = 0) -> dict:
    """ring_hemm's bf16 route on (H, V) against its plain version and the
    library's bf16 GEMM (torch.mm of H and V rounded to bf16, f32 out),
    all against an f64 product of the bf16-rounded operands; timed; raises
    past the gate."""
    from chase_tpu_torch.ops.ring_hemm import ring_hemm, ring_hemm_reference
    t0 = time.perf_counter()
    m, (b, k) = H.shape[0], V.shape
    Hb = H[:, col0:col0 + b]
    ref = Hb.double() @ V.to(torch.bfloat16).double()

    def library():
        return torch.mm(Hb, V.to(torch.bfloat16), out_dtype=torch.float32)

    W = ring_hemm(H, V, col0=col0)
    torch.cuda.synchronize()
    err, errp, errl = (rel_err(x, ref) for x in (
        W, ring_hemm_reference(H, V, col0=col0), library()))
    abs_err = float((W.double() - ref).abs().max())
    del W, ref
    plain_ms, kern_ms, lib_ms = time_fns(
        [lambda: ring_hemm_reference(H, V, col0=col0),
         lambda: ring_hemm(H, V, col0=col0), library], reps)
    # the card's clock and power while the kernel alone runs for ~0.5 s
    _, mhz, watt, ns = sampled(lambda: time_ms(
        lambda: ring_hemm(H, V, col0=col0), max(reps, int(500 / kern_ms))))
    gflop = 2.0 * m * b * k / 1e9
    rate = gflop / kern_ms
    bound_ms, bound_by = bf16_hemm_bound(m, b, k)
    log(phase, f"(m, b, k)=({m}, {b}, {k}) col0={col0} bf16 H: rel err "
               f"kernel {err:.3e} plain {errp:.3e} library {errl:.3e}; max "
               f"abs err {abs_err:.3e}; kernel {kern_ms:.3f} ms "
               f"({rate:.1f} TFLOP/s, {rate / peak_tflops('bf16'):.1%} of "
               f"the {peak_tflops('bf16'):.0f} TFLOP/s bf16 peak), plain "
               f"{plain_ms:.3f} "
               f"ms, library (torch.mm bf16, f32 out) {lib_ms:.3f} ms, "
               f"bound {bound_ms:.3f} ms ({bound_by}); kernel alone: SM "
               f"{mhz:.0f} MHz, {watt:.1f} W (median of {ns} nvidia-smi "
               f"samples); {time.perf_counter() - t0:.2f} s")
    # exact products, f32 sums over K terms: 1e-5 of the largest entry,
    # and no worse than 4x the library's bf16 GEMM
    if not (err <= 1e-5 and err <= 4 * errl):
        raise AssertionError(f"bf16 ring_hemm error {err:.3e} at "
                             f"({m}, {b}, {k}) exceeds 1e-5 or 4x the "
                             f"library's ({errl:.3e})")
    return dict(err=err, errp=errp, errl=errl, abs_err=abs_err, ms=kern_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_bf16_kernel(dev) -> dict:
    """The bf16 route at the bf16 rung's shapes, its pre-pass, a strided
    window and a two-chunk ring step at an unaligned col0."""
    from chase_tpu_torch.ops.ring_hemm import (bf16_pack, bf16_pack_reference,
                                               ring_hemm)
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    summary = {}
    H1 = torch.randn((1000, 1000), generator=g, device=dev).bfloat16()
    summary[(1000, 37)] = _bf16_case(
        "bkernel", H1, torch.randn((1000, 37), generator=g, device=dev), 20)
    del H1
    N = SLICE["N"]
    H = torch.randn((N, N), generator=g, device=dev).bfloat16()
    for k in BF16_WIDTHS:
        V = torch.randn((N, k), generator=g, device=dev)
        summary[(N, k)] = _bf16_case("bkernel", H, V, 3)

    # the pre-pass alone at (30000, 3000): bit-exact against V.to(bf16),
    # and the library call (one strided, rounding copy_ into a zeroed
    # pack) bit-exact against the kernel
    k = V.shape[1]
    Vb, Vr = bf16_pack(V), bf16_pack_reference(V)
    Vl = torch.zeros_like(Vr)

    def library():
        Vl[:k, :N].copy_(V.mT)

    library()
    torch.cuda.synchronize()
    exact = bool(torch.equal(Vb.view(torch.int16), Vr.view(torch.int16)))
    exact_lib = bool(torch.equal(Vl.view(torch.int16), Vb.view(torch.int16)))
    del Vb, Vr
    pk_plain, pk_ms, pk_lib = time_fns([lambda: bf16_pack_reference(V),
                                        lambda: bf16_pack(V), library], 3)
    del Vl
    pk_bound, pk_by = pack_bound(N, k)
    log("bkernel", f"bf16_pack ({N}, {k}): bit-exact against "
                   f"V.to(bfloat16): {exact}; the library call "
                   f"Vb[:k, :b].copy_(V.mT) bit-exact against the kernel: "
                   f"{exact_lib}; kernel {pk_ms:.3f} ms, plain "
                   f"{pk_plain:.3f} ms, library {pk_lib:.3f} ms, bound "
                   f"{pk_bound:.3f} ms ({pk_by})")
    if not (exact and exact_lib):
        raise AssertionError("bf16_pack disagrees with V.to(bfloat16) or "
                             "with the library's copy_")
    summary["pack"] = dict(abs_err=0.0, ms=pk_ms, plain_ms=pk_plain,
                           library_ms=pk_lib, bound_ms=pk_bound,
                           bound_by=pk_by)

    # a strided column window of V accumulated into a strided window of W
    Hs = H[:1000]
    Vfull = torch.randn((N, 3000), generator=g, device=dev)
    Wfull = torch.randn((Hs.shape[0], 3000), generator=g, device=dev)
    Wbefore = Wfull.clone()
    Vw, Ww = Vfull[:, 1000:1750], Wfull[:, 1000:1750]
    ring_hemm(Hs, Vw, out=Ww, accumulate=True)
    torch.cuda.synchronize()
    ref = Wbefore[:, 1000:1750].double() + Hs.double() \
        @ Vw.to(torch.bfloat16).double()
    errw = rel_err(Ww, ref)
    outside = bool(torch.equal(Wfull[:, :1000], Wbefore[:, :1000])
                   and torch.equal(Wfull[:, 1750:], Wbefore[:, 1750:]))
    # ring semantics: chunk 0 stored, chunk 1 (col0 = 15001, 1 mod 8) added
    V = Vfull[:, :37]
    half = N // 2 + 1
    W = ring_hemm(Hs, V[:half], col0=0)
    ring_hemm(Hs, V[half:], col0=half, out=W, accumulate=True)
    torch.cuda.synchronize()
    errc = rel_err(W, Hs.double() @ V.to(torch.bfloat16).double())
    log("bkernel", f"strided window V[:, 1000:1750] (ldv=3000) += into "
                   f"W[:, 1000:1750]: rel err {errw:.3e}, columns outside "
                   f"untouched: {outside}; two-chunk ring step (col0=0 "
                   f"store, col0={half} add) on a 1000-row stripe: rel err "
                   f"{errc:.3e}")
    if not (errw <= 1e-5 and outside and errc <= 1e-5):
        raise AssertionError("bf16 strided-window or two-chunk step failed")
    del Hs, Vfull, Wfull, Wbefore, ref, W, V
    _trans_case("bkernel", H[:15000, :15000], 7501, 7497, 1500, g)
    del H
    torch.cuda.empty_cache()
    log("bkernel", f"phase ok in {time.perf_counter() - t_phase:.2f} s")
    return summary


def phase_filter(dev, H) -> None:
    from chase_tpu_torch.ops.filter import chebyshev_filter
    from chase_tpu_torch.parallel.ring import chebyshev_filter_ring_pallas
    t_phase = time.perf_counter()
    N, w, deg_max = H.shape[0], 750, 10
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    X = torch.randn((N, w), generator=g, device=dev)
    X /= torch.linalg.vector_norm(X, dim=0)
    deg = np.full(w, deg_max, np.int32)
    deg[:50] = 0                 # locked padding
    deg[50:300] = 6              # retired early
    lam1, lower, upper = -(N - 1.0), -(N - 1.0) + 2.0 * 3000, N - 1.0
    args = (deg, lam1, lower, upper, deg_max)
    Yk = chebyshev_filter_ring_pallas(H, X, *args)
    Yp = chebyshev_filter(H, X, *args)
    torch.cuda.synchronize()
    err = rel_err(Yk, Yp.double())
    exact0 = bool(torch.equal(Yk[:, :50], X[:, :50]))
    plain_ms, kern_ms = time_fns([lambda: chebyshev_filter(H, X, *args),
                                  lambda: chebyshev_filter_ring_pallas(
                                      H, X, *args)], 1)
    gf = 2.0 * N * N * (int(deg.sum())) / 1e9
    log("filter", f"N={N} w={w} deg_max={deg_max}: rel err ring vs plain "
                  f"{err:.3e}; degree-0 columns bit-exact: {exact0}; ring "
                  f"{kern_ms:.1f} ms, plain {plain_ms:.1f} ms "
                  f"({gf:.0f} useful GFLOP); "
                  f"{time.perf_counter() - t_phase:.2f} s")
    # same f32 recurrence, HEMMs summed in two orders
    if not (err <= 1e-5 and exact0):
        raise AssertionError("ring filter disagrees with the plain filter")


def phase_slice(dev, H, phase: str = "slice", bf16: bool = False) -> dict:
    """eigsh on the (phase-rotated, for complex H) Clement matrix at the
    slice's shape on the ring path — with ``bf16`` the f32 problem on the
    bf16 rung, every filter HEMM on the kernel's bf16 route; the launch
    counts are set to 0 just before the solve and read just after it."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement_eigenvalues
    N, nev, nex, tol = SLICE["N"], SLICE["nev"], SLICE["nex"], SLICE["tol"]
    cfg = ct.ChaseConfig(ring_backend="pallas", bf16_filter=bf16,
                         mixed_precision=False)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_ring_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with launch_widths() as widths:
        res = ct.eigsh(H, nev, nex, tol=tol, config=cfg, device=dev,
                       collect_perf=True)
    torch.cuda.synchronize()
    tts = time.perf_counter() - t0
    launches = _count("ring_hemm")
    # the pre-pass of the route the slice runs, and the other one's
    split_launches, other = _count("tf32_split"), _count("bf16_pack")
    if bf16:
        split_launches, other = other, split_launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    perf = res.perf
    ev_err = float(np.abs(res.ritzv - clement_eigenvalues(N)[:nev]).max())
    V = res.V[:, :nev]
    lam = torch.as_tensor(res.ritzv, device=dev).to(H.dtype)
    true_res = float(torch.linalg.vector_norm(H @ V - V * lam, dim=0).max())
    t = perf.timings
    filter_rate = perf.get_filter_flops(N, H.dtype) / t["Filter"]
    low = perf.low_flop_fraction(N, cfg.resolve(H.dtype).lanczos_iter, 4,
                                 H.dtype)
    pre = "bf16_pack" if bf16 else "tf32_split"
    log(phase, f"eigsh Clement N={N} nev={nev} nex={nex} {H.dtype} "
               f"tol={tol} ring_backend=pallas bf16_filter={bf16}: "
               f"converged={res.converged} "
               f"iterations={res.iterations} TTS {tts:.2f} s; phases "
               f"Lanczos {t['Lanczos']:.2f} Filter {t['Filter']:.2f} "
               f"QR {t['Qr']:.2f} RR {t['Rr']:.2f} Resids_Locking "
               f"{t['Resids_Locking']:.2f} InitVecs {t['InitVecs']:.2f} s; "
               f"filter {filter_rate:.0f} GFLOP/s (useful FLOP model); "
               f"max eigenvalue err {ev_err:.3e}; max true residual "
               f"{true_res:.3e}; reported max resid {res.resid.max():.3e}; "
               f"ring_hemm launches {launches}, {pre} launches "
               f"{split_launches}, other pre-pass {other}, filter HEMM steps "
               f"{perf.filter_hemm_steps} ({widths_line(widths)}); "
               f"low-precision FLOP share {low:.3f}; peak device memory "
               f"{peak:.1f} GiB")
    if not res.converged:
        raise AssertionError(f"{phase} did not converge")
    if not ev_err <= 0.5:
        raise AssertionError(f"eigenvalue error {ev_err} > 0.5")
    if not true_res <= 10 * tol:
        raise AssertionError(f"true residual {true_res} > {10 * tol}")
    if not (0 < launches == split_launches == perf.filter_hemm_steps
            and other == 0):
        raise AssertionError(f"ring_hemm launched {launches} times, "
                             f"{pre} {split_launches}, the other pre-pass "
                             f"{other}; the filter ran "
                             f"{perf.filter_hemm_steps} HEMM steps")
    return dict(ring_hemm=launches, prepass=split_launches, tts=tts,
                low=low, iterations=res.iterations)


def trace_solve(phase: str, what: str, solve) -> tuple:
    """``solve()`` (returning (tts, res)) under torch.profiler: logs the
    device busy share and the top kernels by device time, and raises
    unless it converged with a ring_hemm kernel on the device."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tts, res = solve()
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages() if e.device_time_total > 0]
    kernels = [r for r in rows if not r[0].startswith("aten::")]
    busy = sum(r[1] for r in kernels) / 1e6
    log(phase, f"traced {what}: TTS {tts:.3f} s; summed device kernel time "
               f"{busy:.3f} s, busy share {busy / tts:.3f}; "
               f"{sum(r[2] for r in kernels)} kernel launches in "
               f"{res.iterations} iterations")
    for key, us, count in sorted(kernels, key=lambda r: -r[1])[:15]:
        log(phase, f"  {us / 1e6:8.3f} s {us / 1e6 / busy:6.1%} "
                   f"x{count:<5d} {key[:90]}")
    if not (res.converged
            and any("ring_hemm_kernel" in key for key, _, _ in kernels)):
        raise AssertionError(f"traced {what} did not converge or the trace "
                             f"shows no ring_hemm kernel on the device")
    return tts, res


def phase_profile(dev, H, phase: str = "profile") -> None:
    """Warm solves of the slice (ring path, then windowed path) and a
    torch.profiler trace of one warm ring-path solve."""
    import chase_tpu_torch as ct
    N, nev, nex, tol = SLICE["N"], SLICE["nev"], SLICE["nex"], SLICE["tol"]

    def solve(backend):
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ct.eigsh(H, nev, nex, tol=tol, device=dev, collect_perf=True,
                       config=ct.ChaseConfig(ring_backend=backend,
                                             mixed_precision=False))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    warm = {}
    for backend in ("pallas", "xla"):
        tts, res = solve(backend)
        warm[backend] = tts
        warm[backend + "_iterations"] = res.iterations
        t = res.perf.timings
        log(phase, f"warm solve {H.dtype} ring_backend={backend}: TTS "
                   f"{tts:.3f} s, iterations {res.iterations}, Filter "
                   f"{t['Filter']:.3f} RR {t['Rr']:.3f} QR {t['Qr']:.3f} "
                   f"Lanczos {t['Lanczos']:.3f} s, peak device memory "
                   f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB, "
                   f"converged={res.converged}")
        if not res.converged:
            raise AssertionError(f"warm {backend} solve did not converge")
    trace_solve(phase, f"warm ring solve {H.dtype}",
                lambda: solve("pallas"))
    return warm


def _count(name: str) -> int:
    """The launches of ``ops.ring_hemm``'s kernel ``name`` since the
    counts were last set to 0 (``ops.ring_hemm.LAUNCHES``)."""
    from chase_tpu_torch.ops.ring_hemm import LAUNCHES
    return LAUNCHES[name]


def _ring_counts() -> tuple:
    return _count("ring_hemm"), _count("tf32_split"), _count("bf16_pack")


def _peer_counts() -> tuple:
    """The peer route's launches: (ring_hemm_peers — its main kernel —,
    peer_gather, peer_publish)."""
    return (_count("ring_hemm_peers"), _count("peer_gather"),
            _count("peer_publish"))


# the widths k of the kernel table's rows (PERF.md §6): a ring_hemm call
# of width k counts in the first row whose width is k or more
WIDTH_ROWS = (750, 1500, 2250, 3000)
# the program's count of ring_hemm launches by route and width
# (``ops.ring_hemm.LAUNCHES``): "ring_hemm:<route>[ trans] k=<k>"
_ROUTE_KEY = re.compile(r"ring_hemm:(\w+)(?: trans)? k=(\d+)")


def _since(before: dict, prefix: str) -> dict:
    """The program's counts (``perf.COUNTS``) under keys that start with
    ``prefix``, less ``before`` (a snapshot), where they grew."""
    from chase_tpu_torch.perf import COUNTS
    out = {}
    for key, n in list(COUNTS.items()):
        if key.startswith(prefix) and n > before.get(key, 0):
            out[key[len(prefix):]] = n - before.get(key, 0)
    return out


@contextlib.contextmanager
def launch_widths():
    """Inside the block every ring_hemm launch's route and width row (of
    :data:`WIDTH_ROWS`) is counted into the yielded Counter, from the
    program's own counts by route and width, read before and after it."""
    import collections
    from chase_tpu_torch.perf import COUNTS
    before, seen = dict(COUNTS), collections.Counter()
    try:
        yield seen
    finally:
        for key, n in _since(before, "ring_hemm:").items():
            m = _ROUTE_KEY.fullmatch("ring_hemm:" + key)
            k = int(m[2])
            seen[m[1], next((w for w in WIDTH_ROWS if k <= w), k)] += n


def widths_line(seen) -> str:
    """``launch_widths``' counts as "route k≤row: n" in row order."""
    return ", ".join(f"{route} k≤{w}: {n}"
                     for (route, w), n in sorted(seen.items())) or "none"


def _zero_ring_counts() -> None:
    from chase_tpu_torch.ops.ring_hemm import LAUNCHES
    LAUNCHES.clear()


def _main_counts() -> tuple:
    """(main launches, pre-pass launches) of either route: ring_hemm +
    ring_hemm_peers, tf32_split + bf16_pack + peer_gather."""
    (hemm, split, pack), (peers, gather, _) = _ring_counts(), _peer_counts()
    return hemm + peers, split + pack + gather


def phase_io(dev, H, path: str) -> None:
    """The slice's H through a ChASE file and back, then solved from it;
    a checkpoint of the solve and a warm start from it."""
    import chase_tpu_torch as ct
    from chase_tpu_torch import _native, io as cio
    N, nev, nex, tol = SLICE["N"], SLICE["nev"], SLICE["nex"], SLICE["tol"]
    gb = H.numel() * H.element_size() / 1e9
    free = shutil.disk_usage(os.path.dirname(path)).free / 1e9
    log("io", f"{path}: {free:.1f} GB free; native reader: "
              f"{_native.available()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cio.save_matrix(H, path)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    Hl = cio.load_matrix(path, N, np.float32)
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = ct.DenseOperator(Hl, dev)      # copied as it lies, transposed here
    torch.cuda.synchronize()
    t_place = time.perf_counter() - t0
    same = bool(torch.equal(op.H, H))
    # for comparison, not what DenseOperator does: a transpose on the host
    t0 = time.perf_counter()
    Hc = np.ascontiguousarray(Hl)
    t_copy = time.perf_counter() - t0
    same = same and bool(np.array_equal(Hc[:2], H[:2].cpu().numpy()))
    del Hc
    log("io", f"save_matrix {gb:.2f} GB in {t_write:.3f} s "
              f"({gb / t_write:.2f} GB/s, device transpose + copy to the "
              f"host + write); load_matrix (native reader, Fortran-ordered "
              f"view) {t_read:.3f} s ({gb / t_read:.2f} GB/s); placement "
              f"(DenseOperator: the view's column-major block copied to the "
              f"card as it lies, pageable, then transposed there) "
              f"{t_place:.3f} s ({gb / t_place:.2f} GB/s); for comparison, "
              f"np.ascontiguousarray of the view on the host {t_copy:.3f} s "
              f"({gb / t_copy:.2f} GB/s); bitwise equal to H: {same}")
    if not (same and Hl.flags.f_contiguous and _native.available()):
        raise AssertionError("io: the file did not come back bitwise through "
                             "the native reader")
    del Hl
    cfg = ct.ChaseConfig(ring_backend="pallas", mixed_precision=False)
    gate = clement_gate("io", H, nev, 0.5, 10 * tol)
    _zero_ring_counts()
    cold, res = timed(lambda: ct.eigsh(op, nev, nex, tol=tol, config=cfg,
                                       collect_perf=True))
    launches = _ring_counts()
    gate(res, "solve from the file")
    steps = res.perf.filter_hemm_steps
    if not 0 < launches[0] == launches[1] == steps:
        raise AssertionError(f"io: launches {launches} against {steps} "
                             f"HEMM steps")
    state = path + ".state"
    t0 = time.perf_counter()
    cio.save_state(state, res.V, res.ritzv_full, {"N": N})
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    V, ritzv, meta = cio.load_state(state)
    t_load = time.perf_counter() - t0
    same_state = (bool(torch.equal(torch.from_numpy(V), res.V.cpu()))
                  and np.array_equal(ritzv, res.ritzv_full)
                  and meta == {"N": N})
    warm, res2 = timed(lambda: ct.eigsh(op, nev, nex, tol=tol, config=cfg,
                                        v0=V, ritzv0=ritzv, approx=True))
    gate(res2, "warm start from the checkpoint")
    os.remove(state + ".npz")
    mb = V.nbytes / 1e6
    log("io", f"eigsh from the file (pallas): TTS {cold:.3f} s, "
              f"{res.iterations} iterations, ring_hemm / tf32_split / "
              f"bf16_pack launches {launches}, HEMM steps {steps}; "
              f"save_state of V ({V.shape[0]}x{V.shape[1]} f32, {mb:.0f} "
              f"MB) and ritzv {t_save:.3f} s, load_state {t_load:.3f} s, "
              f"bitwise: {same_state}; warm start from it: TTS {warm:.3f} "
              f"s, {res2.iterations} iterations (cold {res.iterations})")
    if not same_state:
        raise AssertionError("io: the checkpoint did not come back bitwise")


@contextlib.contextmanager
def ring_backend_env(value: str):
    """CHASE_RING_BACKEND set to ``value`` inside the block (read by
    ChaseConfig.resolve, as the CLI and the C ABI run it)."""
    old = os.environ.get("CHASE_RING_BACKEND")
    os.environ["CHASE_RING_BACKEND"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["CHASE_RING_BACKEND"]
        else:
            os.environ["CHASE_RING_BACKEND"] = old


def printed_eigenvalues(out: str) -> np.ndarray:
    """The values of the CLI's first ``eigenvalues:`` line."""
    line = next(ln for ln in out.splitlines() if "eigenvalues:" in ln)
    return np.array([float(x) for x in re.findall(
        r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?", line.split(":", 1)[1])])


def _cli(argv) -> tuple:
    """chase_tpu_torch.cli.main(argv) in this process on the "pallas"
    ring, its stdout captured (and echoed): (rc, out, seconds, launches);
    the launch counts set to 0 just before and read just after."""
    from chase_tpu_torch import cli
    buf = io.StringIO()
    _zero_ring_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ring_backend_env("pallas"), contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _ring_counts()
    out = buf.getvalue()
    for line in out.splitlines():
        log("cli", "  " + line)
    return rc, out, dt, launches


def _cli_gate(what: str, rc, out, N: int, launches) -> None:
    from chase_tpu_torch.models import clement_eigenvalues
    ev = printed_eigenvalues(out)
    err = float(np.abs(ev - clement_eigenvalues(N)[:len(ev)]).max())
    log("cli", f"{what}: rc {rc}; printed eigenvalues' max error {err:.3e}; "
               f"ring_hemm / tf32_split / bf16_pack launches {launches}")
    if not (rc == 0 and "[problem 0] converged in" in out and err <= 0.5
            and 0 < launches[0] == launches[1] and launches[2] == 0):
        raise AssertionError(f"cli: {what} failed its gates")


def child_env(**extra) -> dict:
    """The environment of a child process: the checkout and this
    interpreter's sys.path on PYTHONPATH (an embedded interpreter finds
    torch there), solving on the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] +
                                        [p for p in sys.path if p])
    env.pop("CHASE_TPU_PLATFORM", None)
    env.update(extra)
    return env


def run_child(phase: str, cmd, **extra) -> tuple:
    """(stdout, seconds) of a child process that must exit 0; its output
    echoed."""
    t0 = time.perf_counter()
    r = subprocess.run([str(c) for c in cmd], capture_output=True, text=True,
                       env=child_env(**extra), cwd=ROOT, timeout=600)
    dt = time.perf_counter() - t0
    for line in (r.stdout + r.stderr).splitlines()[-12:]:
        log(phase, "  " + line)
    if r.returncode != 0:
        raise AssertionError(f"{phase}: {Path(str(cmd[0])).name} exited "
                             f"{r.returncode}")
    return r.stdout, dt


def phase_cli(dev, path: str, warm_tts: float) -> None:
    """The CLI in this process on the slice's file and at fmid's shape
    (--fused), then ``python -m chase_tpu_torch`` in a child process."""
    N, nev, nex, tol = SLICE["N"], SLICE["nev"], SLICE["nex"], SLICE["tol"]
    rc, out, tts, launches = _cli(
        ["--n", str(N), "--nev", str(nev), "--nex", str(nex), "--dtype",
         "float32", "--tol", str(tol), "--path_in", path, "--device",
         str(dev)])
    _cli_gate(f"--path_in at the slice's shape: {tts:.3f} s (the file "
              f"read, placed and solved; in-process warm TTS {warm_tts:.3f} "
              f"s)", rc, out, N, launches)
    rc, out, tts, launches = _cli([*CLI_FUSED, "--device", str(dev)])
    _cli_gate(f"--fused Clement N={CLI_FUSED[3]}: {tts:.3f} s", rc, out,
              int(CLI_FUSED[3]), launches)
    out, dt = run_child("cli", [sys.executable, "-m", "chase_tpu_torch",
                                *CLI_MODULE])
    log("cli", f"python -m chase_tpu_torch {' '.join(CLI_MODULE)}: exit 0 "
               f"in {dt:.2f} s (process start, torch import and CUDA "
               f"included)")
    if "[problem 0] converged in" not in out:
        raise AssertionError("cli: the module entry did not converge")


def phase_capi(dev, path: str, warm_tts: float) -> None:
    """libchase_tpu_torch.so built from the checkout, the unchanged C
    demo (f64, N=301) and the C file driver at the slice's shape on the
    ring, each a child process on the card."""
    from chase_tpu_torch import _native
    N, nev, nex, tol = SLICE["N"], SLICE["nev"], SLICE["nex"], SLICE["tol"]
    torch.cuda.empty_cache()          # the children share the card
    t0 = time.perf_counter()
    lib = _native.build_capi()
    t_build = time.perf_counter() - t0
    d = os.path.dirname(lib)
    exes = {}
    for name in ("c_interface_demo", "c_file_demo"):
        exes[name] = os.path.join(d, name)
        subprocess.run(["cc", "-O2", str(ROOT / "examples" / f"{name}.c"),
                        "-L", d, "-lchase_tpu_torch", "-lm",
                        f"-Wl,-rpath,{d}", "-o", exes[name]], check=True)
    log("capi", f"{lib} built in {t_build:.2f} s; "
                f"{', '.join(exes)} compiled against it")
    out, dt = run_child("capi", [exes["c_interface_demo"]])
    if "C-interface demo: PASS" not in out:
        raise AssertionError("capi: c_interface_demo did not pass")
    log("capi", f"c_interface_demo (f64 Clement N=301, two inits): PASS in "
                f"{dt:.2f} s")
    out, dt = run_child("capi", [exes["c_file_demo"], path, N, nev, nex,
                                 tol], CHASE_RING_BACKEND="pallas")
    times = re.search(r"init ([\d.]+) s, readHam ([\d.]+) s, solve ([\d.]+) "
                      r"s, get ([\d.]+) s", out)
    launches = re.search(r"ring_hemm launches in this process: (\d+)", out)
    if not ("c_file_demo: PASS" in out and times and launches
            and int(launches.group(1)) > 0):
        raise AssertionError("capi: c_file_demo did not pass on the ring")
    init, read, solve, get = map(float, times.groups())
    log("capi", f"c_file_demo at the slice's shape on the ring: init "
                f"{init:.3f} s, readHam {read:.3f} s, solve {solve:.3f} s, "
                f"get {get:.3f} s (process {dt:.2f} s); ring_hemm launches "
                f"{launches.group(1)}; in-process warm TTS {warm_tts:.3f} s")


def _north_star_solve(dev, H, phase: str, mixed: bool,
                      backend: str = "xla") -> dict:
    """eigsh of the c128 north star H at tol 1e-10·‖H‖ with
    ``mixed_precision=mixed`` and ``ring_backend=backend`` (False, "xla":
    the windowed path on native ZGEMM; True, "pallas": the ladder on the
    kernel ring through the c64 shadow; True, "xla": the ladder's
    windowed filter on cuBLAS CGEMM), with its gates; launch counts set to
    0 just before the solve, read after."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement_eigenvalues
    from chase_tpu_torch.ops.residuals import residuals
    N, nev, nex = SLICE["N"], SLICE["nev"], SLICE["nex"]
    tol = 1e-10 * (N - 1)
    cfg = ct.ChaseConfig(mixed_precision=mixed, ring_backend=backend)
    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ct.eigsh(H, nev, nex, tol=tol, device=dev, collect_perf=True,
                       config=cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    torch.cuda.reset_peak_memory_stats(dev)
    _zero_ring_counts()
    with launch_widths() as widths:
        tts, res = solve()
    launches = _ring_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    perf, t = res.perf, res.perf.timings
    ev_err = float(np.abs(res.ritzv - clement_eigenvalues(N)[:nev]).max())
    true_res = float(residuals(H, res.V[:, :nev], res.ritzv).max())
    filter_rate = perf.get_filter_flops(N, H.dtype) / t["Filter"]
    low = perf.low_flop_fraction(N, cfg.resolve(H.dtype).lanczos_iter, 4,
                                 H.dtype)
    path = {(False, "xla"): "windowed path (ZGEMM)",
            (True, "pallas"): "ladder (c64 shadow, kernel ring)",
            (True, "xla"): "ladder (c64 shadow, windowed CGEMM)"}[
                (mixed, backend)]
    log(phase, f"eigsh c128 N={N} nev={nev} nex={nex} tol={tol:.4e} "
               f"(1e-10·‖H‖) mixed_precision={mixed}, {path}: "
               f"converged={res.converged} iterations={res.iterations} TTS "
               f"{tts:.2f} s; phases Lanczos {t['Lanczos']:.2f} Filter "
               f"{t['Filter']:.2f} QR {t['Qr']:.2f} RR {t['Rr']:.2f} "
               f"Resids_Locking {t['Resids_Locking']:.2f} InitVecs "
               f"{t['InitVecs']:.2f} s; filter {filter_rate:.0f} GFLOP/s "
               f"(useful FLOP model), window efficiency "
               f"{perf.filter_window_efficiency():.3f}; low-precision FLOP "
               f"share {low:.3f}; max eigenvalue err {ev_err:.3e}; max true "
               f"residual {true_res:.3e}; reported max resid "
               f"{res.resid.max():.3e}; ring_hemm / tf32_split / bf16_pack "
               f"launches {launches}, filter HEMM steps "
               f"{perf.filter_hemm_steps} ({widths_line(widths)}); peak "
               f"device memory {peak:.1f} GiB")
    if not res.converged:
        raise AssertionError(f"{phase}: the DP north star did not converge")
    if not (true_res <= 10 * tol and ev_err <= 10 * tol):
        raise AssertionError(f"{phase}: true residual {true_res:.3e} or "
                             f"eigenvalue error {ev_err:.3e} > "
                             f"{10 * tol:.3e}")
    return dict(tts=tts, iterations=res.iterations, low=low,
                launches=launches, steps=perf.filter_hemm_steps, solve=solve)


def phase_north_star(dev) -> tuple:
    """The repo's north star in double precision: c128 phase-rotated
    Clement at N=30000, nev=2250, nex=750, ‖Av − λv‖ ≤ 1e-10·‖H‖ (the
    port's tol is absolute, ‖H‖ = N − 1), windowed filter on ZGEMM.
    Returns (H, dp's TTS) for the ladder phase."""
    t0 = time.perf_counter()
    H = clement_on_device(SLICE["N"], dev, torch.complex128)
    torch.cuda.synchronize()
    log("dp", f"phase-rotated Clement N={SLICE['N']} c128 built on the card "
              f"in {time.perf_counter() - t0:.2f} s")
    return H, _north_star_solve(dev, H, "dp", mixed=False)["tts"]


def phase_ladder(dev, H, dp_tts: float) -> dict:
    """The DP north star on the precision ladder: dp's H and gates, every
    filter HEMM on the kernel's c64 route (the ladder's classic first
    filter and its refinement filters alike), ≥ 80% of the FLOPs in c64;
    its TTS beside dp's from this run.  Then the ladder once more on the
    windowed path (cuBLAS CGEMM), which decides the default of
    ring_backend="xla", and a torch.profiler trace of one more kernel-ring
    ladder solve."""
    win = _north_star_solve(dev, H, "ladder", mixed=True, backend="xla")
    if not (win["low"] >= 0.80 and win["launches"] == (0, 0, 0)):
        raise AssertionError(f"windowed ladder: low-precision share "
                             f"{win['low']:.3f}, launches {win['launches']}")
    out = _north_star_solve(dev, H, "ladder", mixed=True, backend="pallas")
    hemm, split, pack = out["launches"]
    log("ladder", f"TTS {out['tts']:.2f} s on the ladder (kernel ring), "
                  f"{win['tts']:.2f} s on the windowed ladder, {dp_tts:.2f} "
                  f"s native c128 (dp) in this run: "
                  f"{dp_tts / out['tts']:.2f}x and "
                  f"{dp_tts / win['tts']:.2f}x")
    if not out["low"] >= 0.80:
        raise AssertionError(f"ladder: only {out['low']:.3f} of the FLOPs "
                             f"in c64")
    if not (0 < hemm == split == out["steps"] and pack == 0):
        raise AssertionError(f"ladder: ring_hemm launched {hemm} times, "
                             f"tf32_split {split}, bf16_pack {pack}; the "
                             f"filter ran {out['steps']} HEMM steps")
    trace_solve("ladder", "ladder solve (kernel ring)", out["solve"])
    return out


def hermitian_sequence_on_device(H0: torch.Tensor, count: int, drift: float,
                                 g: torch.Generator, keep: dict):
    """H0 then ``count - 1`` members, each the previous plus a Hermitian
    perturbation of scale drift·‖H0‖_F/N (as models.hermitian_sequence
    builds it in numpy), made on the card one at a time; the member last
    yielded is ``keep["H"]``."""
    N = H0.shape[0]
    scale = float(torch.linalg.matrix_norm(H0)) / N
    H = H0
    for i in range(count):
        if i:
            E = torch.randn((N, N), generator=g, dtype=H.dtype,
                            device=H.device) * np.sqrt(2.0)
            H = H + (drift * scale) * ((E + E.mH) / 2)
            del E
        keep["H"] = H
        yield H


def phase_sequence(dev) -> None:
    """eigsh_sequence over correlated c128 problems (the reference's SCF
    use case) and estimate_spectral_bounds on the first member."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.config import MIXED_PRECISION_ON_CUDA
    from chase_tpu_torch.ops.residuals import residuals
    N, nev, nex = SEQUENCE["N"], SEQUENCE["nev"], SEQUENCE["nex"]
    count = SEQUENCE["count"]
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    A = torch.randn((N, N), generator=g, dtype=torch.complex128,
                    device=dev) * np.sqrt(2.0)
    H0 = (A + A.mH) / 2                      # GUE-like, as random_hermitian
    del A
    w0 = torch.linalg.eigvalsh(H0).cpu().numpy()
    tol = 1e-10 * float(np.abs(w0).max())
    log("sequence", f"member 0 (N={N} c128) and its eigvalsh on the card in "
                    f"{time.perf_counter() - t0:.2f} s; tol = 1e-10·max|λ| = "
                    f"{tol:.4e}")
    keep = {}
    members = hermitian_sequence_on_device(H0, count, SEQUENCE["drift"], g,
                                           keep)
    its, errs, bad = [], {}, []
    # pinned to what mixed_precision=None resolves to for c128 on CUDA with
    # the default ring_backend ("xla")
    mixed = MIXED_PRECISION_ON_CUDA["xla"]
    log("sequence", f"mixed_precision={mixed} (the f64/c128 default on "
                    f"CUDA with ring_backend='xla')")
    t0 = time.perf_counter()
    for i, res in enumerate(ct.eigsh_sequence(
            members, nev, nex, tol=tol, device=dev, collect_perf=True,
            config=ct.ChaseConfig(mixed_precision=mixed))):
        r = float(residuals(keep["H"], res.V[:, :nev], res.ritzv).max())
        its.append(res.iterations)
        if i in (0, count - 1):
            w = w0 if i == 0 else torch.linalg.eigvalsh(keep["H"]).cpu()\
                .numpy()
            errs[i] = float(np.abs(res.ritzv - w[:nev]).max())
        if not (res.converged and r <= 10 * tol):
            bad.append(i)
        log("sequence", f"member {i}: converged={res.converged} iterations "
                        f"{res.iterations} TTS {res.perf.timings['All']:.3f} "
                        f"s; max true residual {r:.3e}"
                        + (f"; max eigenvalue err vs eigvalsh {errs[i]:.3e}"
                           if i in errs else ""))
    total = time.perf_counter() - t0
    keep.clear()
    warm = float(np.mean(its[1:]))
    bounds = ct.estimate_spectral_bounds(H0, nev=nev + nex, device=dev)
    log("sequence", f"{count} members in {total:.2f} s (eigvalsh of the "
                    f"last member included); iterations {its}, warm mean "
                    f"{warm:.2f}; estimate_spectral_bounds(member 0, "
                    f"nev={nev + nex}): {bounds}, eigvalsh [λ_min, λ_max] = "
                    f"[{w0[0]:.6f}, {w0[-1]:.6f}], λ_{nev + nex} = "
                    f"{w0[nev + nex - 1]:.6f}")
    if bad:
        raise AssertionError(f"sequence members {bad} did not converge to "
                             f"a true residual <= {10 * tol:.3e}")
    if not max(errs.values()) <= 10 * tol:
        raise AssertionError(f"sequence eigenvalue errors {errs} > "
                             f"{10 * tol:.3e}")
    if not warm < its[0]:
        raise AssertionError(f"warm members took {warm:.2f} iterations on "
                             f"average, the cold one {its[0]}")
    if not bounds["upperb"] >= w0[-1]:
        raise AssertionError(f"upperb {bounds['upperb']} < λ_max {w0[-1]}")


def structured_bse_on_device(N: int, dev, seed: int = SEED) -> tuple:
    """models.structured_pseudo_hermitian's BSE matrix built on the card in
    f64: H = [[A, B], [−B, −A]], A = Q·diag(a)·Qᵀ, B = Q·diag(b)·Qᵀ, Q from
    torch.linalg.qr of an n×n Gaussian (n = N/2), a = 1 + 2·(i + u_i)/n,
    b = 0.5·(2u' − 1).  Returns (H, lam): lam = √(a² − b²) ascending, H's
    exact positive spectrum."""
    n = N // 2
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    Q, _ = torch.linalg.qr(torch.randn((n, n), generator=g, **f64))
    a = 1.0 + 2.0 * (torch.arange(n, **f64) + torch.rand(n, generator=g,
                                                          **f64)) / n
    b = 0.5 * (2.0 * torch.rand(n, generator=g, **f64) - 1.0)
    H = torch.empty((N, N), **f64)
    for cols, d in ((slice(0, n), a), (slice(n, N), b)):
        M = (Q * d) @ Q.T
        H[:n, cols] = (M + M.T) / 2
    H[n:, :n] = -H[:n, n:]
    H[n:, n:] = -H[:n, :n]
    return H, torch.sort(torch.sqrt(a * a - b * b)).values


def complex_bse_on_device(H: torch.Tensor, seed: int = SEED) -> torch.Tensor:
    """H_c = D·H·D⁻¹ in c128, D = diag(d, conj(d)) with unit phases d
    uniform from ``seed``: the BSE structure kept (A' = dAd* Hermitian,
    B' = dBd complex symmetric), H's spectrum exactly."""
    N, n = H.shape[0], H.shape[0] // 2
    g = torch.Generator(device=H.device).manual_seed(seed)
    d = torch.exp(1j * 2 * np.pi * torch.rand(
        n, generator=g, dtype=torch.float64, device=H.device))
    D = torch.cat([d, d.conj()])
    Hc = torch.empty((N, N), dtype=torch.complex128, device=H.device)
    for r0 in range(0, N, 2048):                 # D·H·D⁻¹ = D·H·conj(D)
        rows = slice(r0, min(r0 + 2048, N))
        Hc[rows] = D[rows, None] * H[rows] * D.conj()[None, :]
    return Hc


def logged(fn):
    """``fn()`` with every message of the port's logger recorded (debug
    level included; what the configured level shows is still printed):
    (result, messages)."""
    from chase_tpu_torch.logger import LEVELS, ChaseLogger, get_logger
    lg = get_logger()
    msgs = []

    def record(level, msg, category="algorithm"):
        msgs.append(msg)
        if LEVELS.get(level, 0) <= lg.level:
            ChaseLogger.log(lg, level, msg, category)

    lg.log = record
    try:
        return fn(), msgs
    finally:
        del lg.log


def iteration0_report(msgs) -> str:
    """Whether the BSE solver's iteration-0 H² degree cap engaged, and
    which QR variant iteration 0 ran, from its log messages."""
    cap = [m for m in msgs if m.startswith("iteration-0 H² degree capped")]
    start = next((i for i, m in enumerate(msgs)
                  if m.startswith("pseudo iteration 0:")), len(msgs))
    qr = next((m for m in msgs[start:]
               if m.startswith("QR:") or "falling back" in m), "not logged")
    return (f"iteration-0 H² degree cap "
            f"{'engaged: ' + cap[0] if cap else 'not engaged'}; "
            f"iteration-0 QR: {qr}")


# per route of the H² ring filter: (operator dtype, window dtype, gate).
# f32 and c64: the filter phase's 1e-5 (the same f32/c64 recurrence, the
# products summed in two orders).  bf16: 1e-2, the CPU tests' bound for a
# bf16 shadow — both sides round every product's input to bf16, and an
# intermediate that differs in its last f32 bit may round to the other
# bf16 neighbour (2^-9 of it), which the polynomial amplifies.
PFILTER_ROUTES = {"f32": (torch.float32, torch.float64, 1e-5),
                  "bf16": (torch.bfloat16, torch.float32, 1e-2),
                  "c64": (torch.complex64, torch.complex128, 1e-5)}


def phase_pfilter(dev, H, lam, route: str) -> dict:
    """The p=1 H² ring filter (two ring_hemm launches per step) against
    the plain H² filter (torch.matmul) at the BSE solves' first window,
    w = nev + nex, on the operator each BSE solve filters with: the f32
    shadow of the f64 H with an f64 window (pseudo's ladder), its bf16
    shadow with an f32 window (bpseudo's rung) or the c64 shadow of the
    complex H with a c128 window (zpseudo's ladder).  The kernel reads no
    symmetry, and the BSE H's halves differ.  Returns the operator, the
    window, the filter's arguments and the plain filter's result, for
    [gridring]'s H² rings."""
    from chase_tpu_torch.config import set_matmul_precision
    from chase_tpu_torch.ops.pseudo import chebyshev_filter_h2
    from chase_tpu_torch.parallel.ring import chebyshev_filter_h2_ring
    t_phase = time.perf_counter()
    set_matmul_precision("highest")
    op_dtype, x_dtype, gate = PFILTER_ROUTES[route]
    H_f = H.to(op_dtype)
    nevex = BSE["nev"] + BSE["nex"]
    N, w, deg_max = H.shape[0], nevex, 10
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    X = torch.randn((N, w), generator=g, device=dev, dtype=x_dtype)
    X /= torch.linalg.vector_norm(X, dim=0)
    deg = np.full(w, deg_max, np.int32)
    deg[:100] = 0                # locked padding
    deg[100:600] = 6             # retired early
    mu = (lam.double() ** 2).cpu().numpy()
    args = (deg, mu[0], mu[nevex], mu[-1] * 1.01, deg_max)
    _zero_ring_counts()
    Yk = chebyshev_filter_h2_ring(H_f, X, *args)
    torch.cuda.synchronize()
    pre, other = (("bf16_pack", "tf32_split") if route == "bf16"
                  else ("tf32_split", "bf16_pack"))
    launches = (_count("ring_hemm"), _count(pre), _count(other))
    Yp = chebyshev_filter_h2(H_f, X, *args)
    wide = torch.complex128 if X.is_complex() else torch.float64
    err = rel_err(Yk, Yp.to(wide))
    exact0 = bool(torch.equal(Yk[:, :100], X[:, :100]))
    del Yk
    plain_ms, kern_ms = time_fns([lambda: chebyshev_filter_h2(H_f, X, *args),
                                  lambda: chebyshev_filter_h2_ring(
                                      H_f, X, *args)], 1)
    gf = (16.0 if X.is_complex() else 4.0) * N * N * int(deg.sum()) / 1e9
    log("pfilter", f"H² filter N={N} w={w} deg_max={deg_max}, {route} route "
                   f"({op_dtype} operator, {x_dtype} window) on the "
                   f"structured BSE H: rel err ring vs plain {err:.3e} "
                   f"(gate {gate:.0e}); degree-0 columns bit-exact: "
                   f"{exact0}; ring_hemm / {pre} / "
                   f"{other} launches {launches} (2·deg_max = "
                   f"{2 * deg_max}); ring {kern_ms:.1f} ms, plain "
                   f"{plain_ms:.1f} ms ({gf:.0f} useful GFLOP); "
                   f"{time.perf_counter() - t_phase:.2f} s")
    if not (err <= gate and exact0
            and launches == (2 * deg_max, 2 * deg_max, 0)):
        raise AssertionError(f"the {route} H² ring filter disagrees with "
                             f"the plain H² filter or did not launch "
                             f"2·deg_max times")
    return dict(H_f=H_f, X=X, args=args, Yp=Yp, gate=gate)


def _bse_solve(dev, H, lam, phase: str, mixed: bool, backend: str,
               what: str, bf16: bool = False, H_ref=None) -> dict:
    """eigsh_pseudo of the BSE H at BSE's shape and tol (absolute; an f32
    H at sp_tol) with ``mixed_precision=mixed``, ``bf16_filter=bf16`` and
    ``ring_backend=backend``; gates: converged, max |θ − exact| and max
    true residual ‖H_ref·v − θv‖ (on the card in H_ref's precision, H_ref
    defaulting to H) ≤ 10·tol; on the ladder or the bf16 rung on the
    ring, every filter HEMM a launch of the route and its pre-pass and
    the low-precision FLOP share ≥ 0.80 (bf16: ≥ 0.75); launch counts set
    to 0 just before the solve and read just after."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.ops.pseudo import residuals_pseudo
    N, nev, nex = H.shape[0], BSE["nev"], BSE["nex"]
    tol = BSE["sp_tol"] if H.dtype == torch.float32 else BSE["tol"]
    H_ref = H if H_ref is None else H_ref
    cfg = ct.ChaseConfig(mixed_precision=mixed, ring_backend=backend,
                         bf16_filter=bf16)

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ct.eigsh_pseudo(H, nev, nex, tol=tol, device=dev,
                              collect_perf=True, config=cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    torch.cuda.reset_peak_memory_stats(dev)
    _zero_ring_counts()
    with launch_widths() as widths:
        (tts, res), msgs = logged(solve)
    launches = _ring_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    perf, t = res.perf, res.perf.timings
    log(phase, f"{what}: {iteration0_report(msgs)}")
    ev_err = float(np.abs(res.ritzv - lam[:nev].cpu().numpy()).max())
    true_res = float(residuals_pseudo(H_ref, res.V[:, :nev].to(H_ref.dtype),
                                      res.ritzv).max())
    low = perf.low_flop_fraction(N, cfg.resolve(H.dtype).lanczos_iter, 4,
                                 H.dtype)
    log(phase, f"eigsh_pseudo {H.dtype} N={N} nev={nev} nex={nex} "
               f"tol={tol:.1e} (absolute) mixed_precision={mixed} "
               f"bf16_filter={bf16}, {what}: "
               f"converged={res.converged} iterations={res.iterations} TTS "
               f"{tts:.2f} s; phases Lanczos {t['Lanczos']:.2f} Filter "
               f"{t['Filter']:.2f} QR {t['Qr']:.2f} RR {t['Rr']:.2f} "
               f"Kconj {t['ApplyKconjugate']:.2f} Resids_Locking "
               f"{t['Resids_Locking']:.2f} InitVecs {t['InitVecs']:.2f} s; "
               f"filter {perf.get_filter_flops(N, H.dtype) / t['Filter']:.0f}"
               f" GFLOP/s (useful FLOP model), window efficiency "
               f"{perf.filter_window_efficiency():.3f}; low-precision FLOP "
               f"share {low:.3f}; max eigenvalue err {ev_err:.3e}; max true "
               f"residual {true_res:.3e}; reported max resid "
               f"{res.resid.max():.3e}; ring_hemm / tf32_split / bf16_pack "
               f"launches {launches}, filter HEMM steps "
               f"{perf.filter_hemm_steps} ({widths_line(widths)}); peak "
               f"device memory {peak:.1f} GiB")
    if not res.converged:
        raise AssertionError(f"{phase}: the BSE solve did not converge")
    if not (true_res <= 10 * tol and ev_err <= 10 * tol):
        raise AssertionError(f"{phase}: true residual {true_res:.3e} or "
                             f"eigenvalue error {ev_err:.3e} > "
                             f"{10 * tol:.3e}")
    if (mixed or bf16) and backend == "pallas":
        hemm, split, pack = launches
        pre, other = (pack, split) if bf16 else (split, pack)
        if not (low >= (0.75 if bf16 else 0.80)
                and 0 < hemm == pre == perf.filter_hemm_steps
                and other == 0):
            raise AssertionError(f"{phase}: low-precision share {low:.3f}, "
                                 f"launches {launches}, filter HEMM steps "
                                 f"{perf.filter_hemm_steps}")
    return dict(tts=tts, iterations=res.iterations, low=low,
                launches=launches, solve=solve)


def phase_pseudo(dev, H, lam) -> dict:
    """The real f64 BSE: natively (windowed filter on DGEMM), then on the
    ladder (f32 shadow, every filter product on the kernel ring), then a
    torch.profiler trace of one more ladder solve."""
    native = _bse_solve(dev, H, lam, "pseudo", False, "xla",
                        "windowed path (DGEMM)")
    ladder = _bse_solve(dev, H, lam, "pseudo", True, "pallas",
                        "ladder (f32 shadow, kernel ring)")
    log("pseudo", f"TTS {ladder['tts']:.2f} s on the ladder (kernel ring), "
                  f"{native['tts']:.2f} s native f64 in this run: "
                  f"{native['tts'] / ladder['tts']:.2f}x")
    trace_solve("pseudo", "BSE ladder solve (kernel ring)", ladder["solve"])
    return ladder


def phase_bpseudo(dev, H32, H, lam) -> dict:
    """The f32 BSE (H's f32 copy) on the bf16 rung on the kernel ring:
    every filter product on the bf16 route; true residuals against the
    f64 H."""
    return _bse_solve(dev, H32, lam, "bpseudo", False, "pallas",
                      "bf16 rung (bf16 shadow, kernel ring)", bf16=True,
                      H_ref=H)


def phase_zpseudo(dev, Hc, lam) -> None:
    """The BSE made complex (complex_bse_on_device), stored in c128 and
    solved on the ladder on the kernel ring (the c64 route)."""
    _bse_solve(dev, Hc, lam, "zpseudo", True, "pallas",
               "ladder (c64 shadow, kernel ring)")


def phase_bslice(dev, H, f32_warm: float) -> dict:
    """The f32 slice on the bf16 rung (one solve after bkernel loaded the
    route), beside the f32 ring slice's warm TTS from this run."""
    out = phase_slice(dev, H, "bslice", bf16=True)
    log("bslice", f"TTS {out['tts']:.3f} s on the bf16 rung; the f32 ring "
                  f"slice's warm TTS in this run {f32_warm:.3f} s")
    return out


def count_syncs(fn):
    """``fn()`` and the host syncs it made: (result, a Counter by site of
    the program's own count, ``perf.COUNTS``' "host_sync:<site>" keys —
    the ``torch.cuda.synchronize`` around a timed call is this script's,
    not the solver's)."""
    import collections
    from chase_tpu_torch.perf import COUNTS, HOST_SYNC
    before = dict(COUNTS)
    out = fn()
    return out, collections.Counter(_since(before, HOST_SYNC))


def debug_syncs(fn):
    """``fn()`` under torch's CUDA sync debug mode: (result, the number of
    synchronizing operations it reported with a frame of the port on the
    stack) — a witness of :func:`count_syncs` that does not rest on the
    program's own count."""
    import os
    import traceback
    import warnings
    port = f"chase_tpu_torch{os.sep}"
    found = []
    orig = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message) and any(
                port in f.filename for f in traceback.extract_stack()):
            found.append(1)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = orig
    return out, len(found)


def timed(fn) -> tuple:
    """(seconds, fn()) on the host clock, the device synchronized before
    and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def fused_runs(fused, p: int = 1) -> dict:
    """``fused(max_iter)`` (max_iter None: the config's) three times: the
    first call, with the kernel launch counts set to 0 just before it and
    read after it (and its ring_hemm calls by route and width,
    :func:`launch_widths`); the warm call, its host syncs counted; and a run
    stopped after one iteration (``max_iter=1``), whose syncs are taken
    off the warm call's, over the iterations left: the syncs of an
    iteration.  On one device that run's syncs are also counted by
    torch's sync debug mode (:func:`debug_syncs`, ``witness``; None on a
    grid, whose ranks share the process's debug mode)."""
    _zero_ring_counts()
    with launch_widths() as widths:
        first, res = timed(lambda: fused(None))
    launches = _ring_counts() + _peer_counts()
    (warm, res2), sites = count_syncs(lambda: timed(lambda: fused(None)))
    witness = None
    if p == 1:
        ((_, res1), sites1), witness = debug_syncs(
            lambda: count_syncs(lambda: timed(lambda: fused(1))))
    else:
        (_, res1), sites1 = count_syncs(lambda: timed(lambda: fused(1)))
    syncs, syncs1 = sum(sites.values()), sum(sites1.values())
    return dict(first=first, warm=warm, res=res, res2=res2, res1=res1,
                launches=launches, widths=widths,
                steps=res.perf.filter_hemm_steps,
                syncs=syncs, syncs1=syncs1, witness=witness, sites=sites,
                p=p,
                per_iter=(syncs - syncs1) / max(res2.iterations - 1, 1))


def launches_ok(counts: tuple, steps: int, p: int = 1,
                bf16_rung: bool = False) -> bool:
    """``counts`` (``_ring_counts() + _peer_counts()``) of a solve of
    ``steps`` HEMM steps on a rank of a (p, 1) grid whose every filter
    operator takes the kernel: one main launch and one pre-pass per step —
    ring_hemm and tf32_split or bf16_pack on one device, ring_hemm_peers,
    peer_gather and peer_publish on p > 1 with no ring_hemm step.  One
    device's pre-passes are of one route, but with ``bf16_rung`` (a fused
    solve on the bf16 rung, which filters on the bf16 shadow while its
    low phase holds and on the f32 H after it) they may be of both, and
    bf16_pack ran at least once."""
    hemm, split, pack, peers, gather, publish = counts
    if p == 1:
        routes_ok = pack > 0 if bf16_rung else min(split, pack) == 0
        return (0 < hemm == split + pack == steps and routes_ok
                and peers == gather == publish == 0)
    return 0 < peers == gather == publish == steps and hemm + split + pack == 0


LAUNCH_NAMES = ("ring_hemm / tf32_split / bf16_pack / ring_hemm_peers / "
                "peer_gather / peer_publish launches")


def check_fused_runs(phase: str, runs: dict, kernel: bool = True,
                     bf16_rung: bool = False) -> None:
    """The gates of :func:`fused_runs`: the sync count works and, where
    torch's sync debug mode witnessed it, agrees with it; at most 3 host
    syncs per iteration; and with ``kernel`` every HEMM step one main
    launch of the kernel and its one pre-pass per rank
    (:func:`launches_ok`, of both routes on the ``bf16_rung``; none
    without)."""
    res1, res2, syncs = runs["res1"], runs["res2"], runs["syncs"]
    launches, steps, p = runs["launches"], runs["steps"], runs["p"]
    if res1.iterations != 1 or syncs < res2.iterations + 1:
        raise AssertionError(f"{phase}: the sync count does not work "
                             f"({syncs} syncs in {res2.iterations} "
                             f"iterations)")
    if runs.get("witness") not in (None, runs.get("syncs1")):
        raise AssertionError(f"{phase}: the program counted "
                             f"{runs.get('syncs1')} host syncs in one "
                             f"iteration's run, torch's sync debug mode "
                             f"{runs['witness']}")
    if runs["per_iter"] > 3:
        raise AssertionError(f"{phase}: {runs['per_iter']:.2f} host syncs "
                             f"per fused iteration (at most 3)")
    if kernel:
        if not launches_ok(launches, steps, p, bf16_rung):
            raise AssertionError(f"{phase}: {LAUNCH_NAMES} {launches} "
                                 f"against {steps} HEMM steps (p = {p}"
                                 f"{', bf16 rung' if bf16_rung else ''})")
    elif any(launches):
        raise AssertionError(f"{phase}: kernel launches {launches} on a "
                             f"path with no kernel operator")


def fused_beside_host(phase: str, what: str, fused, host, gate,
                      host_warm=None, kernel: bool = True,
                      trace: bool = False, bf16_rung: bool = False) -> dict:
    """A fused solve beside the host driver on the same input and config.

    ``fused(max_iter)`` runs the fused entry point (max_iter None: the
    config's); ``host()`` the host-driver one, unless ``host_warm`` gives
    its warm (TTS, iterations) from an earlier phase of this run;
    ``gate(res, who)`` raises on a wrong answer.  The first fused call
    counts the kernel launches (set to 0 just before it) against the
    solver's HEMM-step counter (``bf16_rung``: :func:`launches_ok`'s
    rule for the bf16 rung); the warm call counts the host syncs, and
    those of a run stopped after one iteration (``max_iter=1``) are taken
    off, over the iterations left: the syncs of an iteration.  The peak
    device memory of the three fused calls is logged.  With ``trace`` one
    more warm call of each is traced (busy share, kernel launches per
    iteration)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats(dev)
    runs = fused_runs(fused)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    first, warm, res, res2 = (runs[k] for k in ("first", "warm", "res",
                                                 "res2"))
    launches, steps, per_iter = runs["launches"], runs["steps"], \
        runs["per_iter"]
    syncs, syncs1, sites = runs["syncs"], runs["syncs1"], runs["sites"]
    gate(res, "fused")
    gate(res2, "fused (warm)")
    if host_warm is None:
        h_first, hres = timed(host)
        gate(hres, "host")
        h_warm, hres = timed(host)
        host_warm = (h_warm, hres.iterations)
        host_line = (f"host driver first {h_first:.3f} s, warm "
                     f"{h_warm:.3f} s, {hres.iterations} iterations")
    else:
        host_line = (f"host driver warm {host_warm[0]:.3f} s, "
                     f"{host_warm[1]} iterations (earlier phase, this run)")
    log(phase, f"{what}: fused first {first:.3f} s, warm {warm:.3f} s, "
               f"{res.iterations} / {res2.iterations} iterations; "
               f"{host_line}: warm fused / host {warm / host_warm[0]:.3f}; "
               f"host syncs {syncs} in the warm call, {syncs1} in one "
               f"of 1 iteration: {per_iter:.2f} per iteration (by site: "
               f"{dict(sites.most_common(8))}); {LAUNCH_NAMES} "
               f"{launches}, the solver's HEMM steps {steps} "
               f"({widths_line(runs['widths'])}); filtered vecs "
               f"{res.perf.filtered_vecs} ({res.perf.filtered_vecs_low} on "
               f"the shadow); max resid {res.resid.max():.3e}; peak device "
               f"memory {peak:.2f} GiB")
    check_fused_runs(phase, runs, kernel, bf16_rung)
    if trace:
        trace_solve(phase, "warm fused solve", lambda: timed(
            lambda: fused(None)))
        trace_solve(phase, "warm host-driver solve", lambda: timed(host))
    return dict(first=first, warm=warm, iterations=res2.iterations,
                per_iter=per_iter, launches=launches, steps=steps, res=res,
                peak=peak)


def whole(V, device) -> torch.Tensor:
    """A result's V as one tensor on ``device``: a grid solve's DTensor
    gathered (``full_tensor``, on every rank), a tensor as it is."""
    from torch.distributed.tensor import DTensor
    return V.full_tensor().to(device) if isinstance(V, DTensor) else V


def clement_gate(phase: str, H, nev: int, ev_tol: float, res_tol: float):
    """The Clement gates of a solve: converged, eigenvalues within
    ``ev_tol`` of the exact spectrum, true residuals ≤ ``res_tol``."""
    from chase_tpu_torch.models import clement_eigenvalues
    exact = clement_eigenvalues(H.shape[0])[:nev]

    def gate(res, who):
        V = whole(res.V, H.device)[:, :nev]
        lam = torch.as_tensor(res.ritzv, device=H.device).to(H.dtype)
        true_res = float(torch.linalg.vector_norm(H @ V - V * lam,
                                                  dim=0).max())
        ev_err = float(np.abs(res.ritzv - exact).max())
        if not (res.converged and ev_err <= ev_tol
                and true_res <= res_tol):
            raise AssertionError(f"{phase} ({who}): converged="
                                 f"{res.converged}, eigenvalue err "
                                 f"{ev_err:.3e} (gate {ev_tol}), true "
                                 f"residual {true_res:.3e} (gate {res_tol})")
    return gate


def phase_fused_clement(dev, H, phase: str, nev: int, nex, tol,
                        host_warm=None, bf16: bool = False) -> dict:
    """eigsh_fused beside eigsh on a (phase-rotated, for c64) Clement H
    with ring_backend="pallas" (mixed_precision pinned off; ``bf16``: an
    f32 H on the bf16 rung, both pre-passes allowed); tol None is the f32
    default 1e-5, whose gates allow the early lock's 100·tol."""
    import chase_tpu_torch as ct
    cfg = ct.ChaseConfig(ring_backend="pallas", mixed_precision=False,
                         bf16_filter=bf16)
    t = 1e-5 if tol is None else tol
    gate = (clement_gate(phase, H, nev, 1e-2, 100 * t) if tol is None
            else clement_gate(phase, H, nev, 0.5, 10 * t))

    def fused(max_iter):
        c = cfg if max_iter is None else dataclasses.replace(
            cfg, max_iter=max_iter)
        return ct.eigsh_fused(H, nev, nex, tol=tol, config=c, device=dev,
                              collect_perf=True)

    return fused_beside_host(
        phase, f"Clement N={H.shape[0]} nev={nev} nex={nex} {H.dtype} "
               f"tol={t} pallas{' bf16_filter=True' if bf16 else ''}", fused,
        lambda: ct.eigsh(H, nev, nex, tol=tol, config=cfg, device=dev),
        gate, host_warm, trace=host_warm is None, bf16_rung=bf16)


def north_star_gate(phase: str, H, nev: int, tol: float):
    """dp's and ladder's gates of a solve of the c128 north star:
    converged, true residuals and eigenvalue errors against Clement's
    spectrum ≤ 10·tol."""
    from chase_tpu_torch.models import clement_eigenvalues
    from chase_tpu_torch.ops.residuals import residuals
    exact = clement_eigenvalues(H.shape[0])[:nev]

    def gate(res, who):
        true_res = float(residuals(H, res.V[:, :nev], res.ritzv).max())
        ev_err = float(np.abs(res.ritzv - exact).max())
        if not (res.converged and true_res <= 10 * tol
                and ev_err <= 10 * tol):
            raise AssertionError(f"{phase} ({who}): converged="
                                 f"{res.converged}, true residual "
                                 f"{true_res:.3e}, eigenvalue err "
                                 f"{ev_err:.3e} (gates {10 * tol:.3e})")
    return gate


def low_share_gate(phase: str, out: dict, N: int, dtype, floor) -> float:
    """The fused solve's low-precision FLOP share (its PerfData counts
    the vectors filtered on the shadow), logged and, with ``floor``,
    held to at least it."""
    low = out["res"].perf.low_flop_fraction(N, 25, 4, dtype)
    log(phase, f"fused low-precision FLOP share {low:.3f}"
               + (f" (gate ≥ {floor:.2f})" if floor else ""))
    if floor and not low >= floor:
        raise AssertionError(f"{phase}: only {low:.3f} of the fused solve's "
                             f"FLOPs on the shadow (≥ {floor:.2f})")
    return low


def phase_fladder(dev, H, ladder: dict) -> dict:
    """eigsh_fused on the c128 north star on the ladder with the kernel
    ring — the route a c128 eigsh_fused takes by default on the card
    (MIXED_PRECISION_ON_CUDA["pallas"]): every filter product on the c64
    shadow's kernel route, beside [ladder]'s kernel-ring solve of this
    run; dp's gates and ≥ 80% of the FLOPs in c64."""
    import chase_tpu_torch as ct
    N, nev, nex = SLICE["N"], SLICE["nev"], SLICE["nex"]
    tol = 1e-10 * (N - 1)
    cfg = ct.ChaseConfig(mixed_precision=True, ring_backend="pallas")

    def fused(max_iter):
        c = cfg if max_iter is None else dataclasses.replace(
            cfg, max_iter=max_iter)
        return ct.eigsh_fused(H, nev, nex, tol=tol, config=c, device=dev,
                              collect_perf=True)

    out = fused_beside_host(
        "fladder", f"c128 N={N} nev={nev} nex={nex} tol={tol:.4e} "
                   f"(1e-10·‖H‖) ladder, pallas (c64 shadow)", fused, None,
        north_star_gate("fladder", H, nev, tol),
        (ladder["tts"], ladder["iterations"]))
    low_share_gate("fladder", out, N, H.dtype, 0.80)
    return out


def bse_gate(phase: str, H, lam, nev: int, tol: float):
    """The BSE gates: converged, eigenvalues and true residuals (in H's
    precision, a solve of H's f32 copy too) within 10·tol."""
    from chase_tpu_torch.ops.pseudo import residuals_pseudo

    def gate(res, who):
        ev_err = float(np.abs(res.ritzv - lam[:nev].cpu().numpy()).max())
        true_res = float(residuals_pseudo(
            H, whole(res.V, H.device)[:, :nev].to(H.dtype),
            res.ritzv).max())
        if not (res.converged and ev_err <= 10 * tol
                and true_res <= 10 * tol):
            raise AssertionError(f"{phase} ({who}): converged="
                                 f"{res.converged}, eigenvalue err "
                                 f"{ev_err:.3e}, true residual "
                                 f"{true_res:.3e} (gates {10 * tol:.1e})")
    return gate


def phase_fpseudo(dev, H, lam, ladder: dict) -> dict:
    """eigsh_pseudo_fused on pseudo's f64 BSE H on the ladder with the
    kernel ring, beside pseudo's ladder solve of this run."""
    import chase_tpu_torch as ct
    nev, nex, tol = BSE["nev"], BSE["nex"], BSE["tol"]

    def fused(max_iter):
        cfg = ct.ChaseConfig(mixed_precision=True, ring_backend="pallas",
                             **({} if max_iter is None
                                else {"max_iter": max_iter}))
        return ct.eigsh_pseudo_fused(H, nev, nex, tol=tol, config=cfg,
                                     device=dev, collect_perf=True)

    return fused_beside_host(
        "fpseudo", f"BSE f64 N={H.shape[0]} nev={nev} nex={nex} tol={tol} "
                   f"ladder, pallas", fused, None,
        bse_gate("fpseudo", H, lam, nev, tol),
        (ladder["tts"], ladder["iterations"]))


def phase_fbpseudo(dev, H32, H, lam, bpseudo: dict) -> dict:
    """eigsh_pseudo_fused on bpseudo's f32 BSE on the bf16 rung with the
    kernel ring beside bpseudo's solve of this run: bpseudo's accuracy
    gates (true residuals against the f64 H), both pre-passes allowed,
    bf16_pack at least once.  The fused rung hands the filter back to
    the f32 H when its low phase ends (as the JAX package's does; the
    host driver refines on the bf16 shadow instead), so its
    low-precision share is logged, not held to bpseudo's 0.75."""
    import chase_tpu_torch as ct
    nev, nex, tol = BSE["nev"], BSE["nex"], BSE["sp_tol"]
    cfg = ct.ChaseConfig(bf16_filter=True, mixed_precision=False,
                         ring_backend="pallas")

    def fused(max_iter):
        c = cfg if max_iter is None else dataclasses.replace(
            cfg, max_iter=max_iter)
        return ct.eigsh_pseudo_fused(H32, nev, nex, tol=tol, config=c,
                                     device=dev, collect_perf=True)

    out = fused_beside_host(
        "fbpseudo", f"BSE f32 N={H32.shape[0]} nev={nev} nex={nex} tol={tol} "
                    f"bf16 rung, pallas", fused, None,
        bse_gate("fbpseudo", H, lam, nev, tol),
        (bpseudo["tts"], bpseudo["iterations"]), bf16_rung=True)
    low_share_gate("fbpseudo", out, H32.shape[0], H32.dtype, None)
    return out


def phase_zfused(dev) -> tuple:
    """The c128 BSE at the JAX package's fused BSE shape (N=4096, nev=200,
    nex=56): eigsh_pseudo and eigsh_pseudo_fused natively
    (mixed_precision=False, no kernel operator: [zfused]), then both on
    the ladder with the kernel ring (every filter product on the c64
    shadow's kernel route: [zfladder])."""
    import chase_tpu_torch as ct
    N, nev, nex, tol = ZFUSED["N"], ZFUSED["nev"], ZFUSED["nex"], BSE["tol"]
    H, lam = structured_bse_on_device(N, dev, SEED + 11)
    Hc = complex_bse_on_device(H, SEED + 12)
    del H
    out = {}
    for phase, mixed, backend, what in (
            ("zfused", False, "xla", "native"),
            ("zfladder", True, "pallas", "ladder, pallas (c64 shadow)")):
        cfg = ct.ChaseConfig(mixed_precision=mixed, ring_backend=backend)

        def fused(max_iter, cfg=cfg):
            c = cfg if max_iter is None else dataclasses.replace(
                cfg, max_iter=max_iter)
            return ct.eigsh_pseudo_fused(Hc, nev, nex, tol=tol, config=c,
                                         device=dev, collect_perf=True)

        def host(cfg=cfg, phase=phase, what=what):
            res, msgs = logged(lambda: ct.eigsh_pseudo(
                Hc, nev, nex, tol=tol, config=cfg, device=dev))
            log(phase, f"c128 eigsh_pseudo ({what}): "
                       f"{iteration0_report(msgs)}")
            return res

        out[phase] = fused_beside_host(
            phase, f"BSE c128 N={N} nev={nev} nex={nex} tol={tol} {what}",
            fused, host, bse_gate(phase, Hc, lam, nev, tol), kernel=mixed)
        if mixed:
            low_share_gate(phase, out[phase], N, Hc.dtype, None)
    return out["zfused"], out["zfladder"]


# the Python examples, each a child process on the card at its default
# size: (file under examples/, the gate's key in its PASS line)
EXAMPLES = (("torch_hello_world", "max eigenvalue error"),
            ("torch_interface_demo", "max eigenvalue error"),
            ("torch_bse_benchmark", "max true residual"))


def phase_examples() -> dict:
    """The port's Python examples as child processes on the card: each
    must exit 0 with its PASS line, whose error (against Clement's exact
    spectrum, or the BSE's true residual) is held here too, ≤ 1e-9 (10×
    the examples' tol 1e-10)."""
    torch.cuda.empty_cache()          # the children share the card
    out = {}
    for name, key in EXAMPLES:
        stdout, dt = run_child("examples", [sys.executable,
                                            ROOT / "examples" / f"{name}.py"])
        m = re.search(rf"^{name}: PASS .*{key} ([-+.\deE]+)", stdout,
                      re.MULTILINE)
        if not (m and float(m.group(1)) <= 1e-9):
            raise AssertionError(f"examples: {name} printed no PASS line "
                                 f"within 1e-9")
        out[name] = (dt, float(m.group(1)))
        log("examples", f"{name}: PASS in {dt:.2f} s (process start, torch "
                        f"import and CUDA included), {key} "
                        f"{float(m.group(1)):.3e}")
    return out


GRID_P = (2, 4)
# the kernel's routes on the (p, 1) stripes: (route, widths k)
GRIDRING = {"f32": (3000,), "bf16": (3000, 1500), "c64": (3000,)}
NVLINK_GBS = 450.0          # GB/s each way between two H100 SXM cards
MISSING_TIMEOUT_S = 2.0     # the wait bound of the missing-publish case


class _SimRequests:
    """A finished exchange: the simulated ranks' copy is queued at once."""

    @staticmethod
    def wait() -> None:
        pass


def _ring_all(stripes, chunks, step=None) -> torch.Tensor:
    """Every simulated rank's chunk-ring product (:func:`sim_ranks`: the
    p-step loop ``ring_steps`` with the simulated ranks' exchange; its
    kernel step unless ``step`` is given), stacked: H·V."""
    from chase_tpu_torch.parallel.ring import ring_steps
    p = len(chunks)
    return torch.cat(sim_ranks(p, lambda g: ring_steps(
        stripes[g.me], chunks[g.me], me=g.me, p=p, exchange=g.exchange(),
        step=step)))


def _peer_ring_all(stripes, chunks, peers) -> torch.Tensor:
    """Every simulated rank's (p, 1) ring product on the production route
    (``parallel.ring.ring_hemm`` with the simulated ranks as its grid: on
    the card ``ops.ring_hemm.ring_hemm_peers`` over ``peers``), stacked."""
    from chase_tpu_torch.parallel.ring import ring_hemm
    return torch.cat(sim_ranks(len(chunks), lambda g: ring_hemm(
        g, stripes[g.me], chunks[g.me]), peers=peers))


def sim_peers(p: int, dev, **kw) -> list:
    """p ``PeerChunks`` of simulated ranks on one card: their all-gather a
    board between two barriers of their own, their meet a barrier (every
    rank's publish queued before any rank's gather on the one stream), a
    peer's memory its pointer (one process)."""
    from chase_tpu_torch.parallel.peers import PeerChunks
    board, barrier = [None] * p, threading.Barrier(p, timeout=300)

    def allgather(me):
        def run(obj):
            board[me] = obj
            barrier.wait()
            got = list(board)
            barrier.wait()
            return got
        return run

    return [PeerChunks(i, p, dev, allgather(i), meet=barrier.wait, **kw)
            for i in range(p)]


def close_sim_peers(peers: list) -> None:
    """``PeerChunks.close`` on every simulated rank (collective: each its
    thread)."""
    sim_ranks(len(peers), lambda g: peers[g.me].close())


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b (f32 or c64, one shape) equal bit for bit."""
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _peer_times(stripes, chunks, peers, reps: int) -> dict:
    """Rank 0's publish, gather and whole product (publish, then gather
    and main kernel) in ms, each the mean over ``reps`` products of the
    simulated ranks driven from this thread after one warm-up: every rank
    publishes and gathers, rank 0 in the product runs also multiplies;
    CUDA events around rank 0's launches.  Also rank 0's last gathered B
    and |its slot − its chunk| after the gather runs (bitwise checks)."""
    from chase_tpu_torch.ops import ring_hemm as rh
    p, h_dtype = len(peers), stripes[0].dtype
    (b, k), v_dtype = chunks[0].shape, chunks[0].dtype
    ldh = rh.tma_row_stride(stripes[0])
    # the slots, sized by the widest product so far, grow collectively:
    # every rank's thread at once, before this thread drives them all (a
    # filter whose live suffix never spanned the window left them short)
    sim_ranks(p, lambda g: peers[g.me].reserve(b * k * chunks[0]
                                               .element_size()))
    spans = {"publish": [], "gather": [], "product": []}
    B = slot_err = None
    for what in ("gather", "product"):
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            rh.peer_publish(chunks[0], peers[0])
            ev[1].record()
            for q in range(1, p):
                rh.peer_publish(chunks[q], peers[q])
            ev[2].record()
            if what == "gather":
                B = rh.peer_gather(chunks[0], peers[0], h_dtype)
            else:
                rh._peer_product(stripes[0], chunks[0], peers[0], ldh, None)
            ev[3].record()
            for q in range(1, p):
                rh.peer_gather(chunks[q], peers[q], h_dtype)
            if rep:                               # 0 is the warm-up
                spans["publish"].append((ev[0], ev[1]))
                spans[what].append((ev[0], ev[1], ev[2], ev[3]))
        if what == "gather":
            torch.cuda.synchronize()
            slot = peers[0].slot(peers[0].product - 1, (b, k), v_dtype)
            slot_err = 0.0 if _bitwise(slot, chunks[0]) else float(
                (slot - chunks[0]).abs().max())
            del slot
    torch.cuda.synchronize()
    ms = {"publish": statistics.mean(a.elapsed_time(b_)
                                     for a, b_ in spans["publish"]),
          "gather": statistics.mean(c.elapsed_time(d)
                                    for _, _, c, d in spans["gather"]),
          "product": statistics.mean(a.elapsed_time(b_) + c.elapsed_time(d)
                                     for a, b_, c, d in spans["product"])}
    return dict(ms=ms, B=B, slot_err=slot_err)


def _publish_ms(chunks, peers, h_dtype, reps: int) -> tuple:
    """(publish ms, ``copy_`` ms, what they are) on the same chunk, timed
    the same way: every publish of ``reps`` products of the simulated
    ranks driven from this thread (every rank publishes, then every rank
    gathers, which frees the slots), and ``reps`` copies of rank 0's chunk
    into a slot of its own — kernel durations from torch.profiler traces
    (:func:`device_ms`), or, should a trace come back empty (three in a
    row held no device activity in one run on an H100), both as CUDA-event
    spans queued behind a spinning kernel (:func:`queued_ms`)."""
    from chase_tpu_torch.ops import ring_hemm as rh
    p = len(peers)

    def product(timed):
        for q in range(p):
            timed(lambda: rh.peer_publish(chunks[q], peers[q]))
        for q in range(p):
            rh.peer_gather(chunks[q], peers[q], h_dtype)

    slot = torch.empty_like(chunks[0])

    def copy(timed):
        timed(lambda: slot.copy_(chunks[0]))

    def run(op):
        op()

    try:
        return (device_ms(lambda: product(run), reps, "publish")[0],
                device_ms(lambda: copy(run), reps)[0], "kernel")
    except EmptyTrace as e:
        log("gridring", f"{e}: the publish and copy_ timed as queued event "
                        f"spans")
        return queued_ms(product, reps), queued_ms(copy, reps), "queued span"


def _peer_cases(stripes, chunks, peers, V, Vr, reps: int) -> dict:
    """The peer route's three kernels for rank 0 at this (p, k): the
    product beside its plain version (``ring_hemm_peers_reference``), the
    library call (torch.matmul of the stripe by the whole V; for a bf16
    stripe torch.mm(out_dtype=f32) of V rounded) and its bound, max abs
    error against the wide product ``Vr``; the gather bitwise against its
    plain version, the publish's slot bitwise against the chunk, each
    beside its plain version and its bytes bound, the publish's kernel
    time beside the library call's (``copy_`` of the chunk into a slot of
    its own), both timed the same way (:func:`_publish_ms`; the CUDA
    event span around the publish's launch beside, as ``event_ms``); no
    one torch call splits or packs and transposes as the gather does."""
    from chase_tpu_torch.ops.ring_hemm import (gather_layout,
                                               peer_gather_reference,
                                               ring_hemm_peers_reference)
    p, (b, k) = len(chunks), chunks[0].shape
    Hs, h_dtype = stripes[0], stripes[0].dtype
    t = _peer_times(stripes, chunks, peers, reps)
    publish_err = t["slot_err"]
    Bp = peer_gather_reference(chunks, h_dtype)
    gather_err = float((t.pop("B").float() - Bp.float()).abs().max())

    def library():
        if h_dtype == torch.bfloat16:
            return torch.mm(Hs, V.to(torch.bfloat16),
                            out_dtype=torch.float32)
        return torch.matmul(Hs, V)

    W0 = ring_hemm_peers_reference(Hs, chunks, 0)
    prod_plain, lib_ms, gather_plain, publish_plain = time_fns(
        [lambda: ring_hemm_peers_reference(Hs, chunks, 0, out=W0), library,
         lambda: peer_gather_reference(chunks, h_dtype),
         lambda: chunks[0].clone()], 3)
    del W0
    publish_ms, publish_lib, timed_as = _publish_ms(chunks, peers, h_dtype,
                                                    5)
    N = p * b
    bound_ms, bound_by = (bf16_hemm_bound(b, N, k) if h_dtype ==
                          torch.bfloat16 else hemm_bound(b, N, k, h_dtype))
    b_pad, w_pad, _ = gather_layout(h_dtype, p, b, k)
    chunk_bytes = b * k * chunks[0].element_size()
    out_bytes = Bp.numel() * Bp.element_size()
    del Bp
    g_bound = bound(0.0, p * chunk_bytes + out_bytes)
    p_bound = bound(0.0, 2 * chunk_bytes)
    ref = Hs.to(Vr.dtype) @ Vr
    W = _peer_product_once(stripes, chunks, peers)
    abs_err = float((W.to(Vr.dtype) - ref).abs().max())
    del ref, W
    return {
        "product": dict(abs_err=abs_err, ms=t["ms"]["product"],
                        plain_ms=prod_plain, library_ms=lib_ms,
                        bound_ms=bound_ms, bound_by=bound_by),
        "gather": dict(abs_err=gather_err, ms=t["ms"]["gather"],
                       plain_ms=gather_plain, library_ms=None,
                       bound_ms=g_bound[0], bound_by=g_bound[1]),
        "publish": dict(abs_err=publish_err, ms=publish_ms,
                        event_ms=t["ms"]["publish"], timed_as=timed_as,
                        plain_ms=publish_plain,
                        library_ms=publish_lib, bound_ms=p_bound[0],
                        bound_by=p_bound[1])}


def _peer_product_once(stripes, chunks, peers) -> torch.Tensor:
    """One product of the simulated ranks driven from this thread; rank
    0's W."""
    from chase_tpu_torch.ops import ring_hemm as rh
    for q in range(len(peers)):
        rh.peer_publish(chunks[q], peers[q])
    W = rh._peer_product(stripes[0], chunks[0], peers[0],
                         rh.tma_row_stride(stripes[0]), None)
    for q in range(1, len(peers)):
        rh.peer_gather(chunks[q], peers[q], stripes[0].dtype)
    return W


def _peer_line(route: str, label: str, cases: dict) -> str:
    """The three peer kernels' numbers, one log line."""
    pr, ga, pu = cases["product"], cases["gather"], cases["publish"]
    return (f"{route} {label}: ring_hemm_peers (publish + gather + main "
            f"kernel, rank 0) {pr['ms']:.3f} ms, plain {pr['plain_ms']:.3f}"
            f" ms, library {pr['library_ms']:.3f} ms, bound "
            f"{pr['bound_ms']:.3f} ms ({pr['bound_by']}), max abs err "
            f"{pr['abs_err']:.3e}; peer_gather {ga['ms']:.3f} ms (plain "
            f"{ga['plain_ms']:.3f} ms, bound {ga['bound_ms']:.3f} ms, "
            f"|kernel - plain| {ga['abs_err']}); peer_publish "
            f"{pu['timed_as']} {pu['ms']:.4f} ms (event span "
            f"{pu['event_ms']:.3f} ms, plain {pu['plain_ms']:.3f} ms, "
            f"library copy_ {pu['timed_as']} {pu['library_ms']:.4f} ms, "
            f"bound {pu['bound_ms']:.4f} ms, "
            f"{pu['bound_ms'] / pu['ms']:.1%} of it; |slot - chunk| "
            f"{pu['abs_err']}); local memory of one card, not NVLink")


def _missing_publish(dev, stripes, chunks) -> str:
    """Rank 1 of two simulated ranks never publishes: rank 0's product
    must come out NaN (the missing chunk's part of its B poisoned) and end
    in a RuntimeError naming rank 1 within its wait bound
    (MISSING_TIMEOUT_S), not hang; the phase goes on."""
    from chase_tpu_torch.ops.ring_hemm import ring_hemm_peers
    peers = sim_peers(2, dev, timeout_s=MISSING_TIMEOUT_S)
    nbytes = chunks[0].numel() * chunks[0].element_size()

    def rank(g):
        pc = peers[g.me]
        if g.me == 1:
            pc.reserve(nbytes)
            pc.meet()
            return None
        t0, W = time.perf_counter(), None
        try:
            W = ring_hemm_peers(stripes[0], chunks[0], pc)
            pc.check(sync=True)
        except RuntimeError as e:
            nan = W is not None and not bool(torch.isfinite(W).any())
            return time.perf_counter() - t0, str(e), nan
        return None

    got = sim_ranks(2, rank)[0]
    close_sim_peers(peers)
    if got is None or "rank 0 waited" not in got[1] or "rank 1" not in \
            got[1] or got[0] > MISSING_TIMEOUT_S + 30 or not got[2]:
        raise AssertionError(f"gridring: a missing publish did not end in "
                             f"a NaN product and a RuntimeError in time: "
                             f"{got}")
    return (f"a simulated rank that never publishes: the other's product "
            f"came out NaN and raised in {got[0]:.2f} s (bound "
            f"{MISSING_TIMEOUT_S:g} s): {got[1]}")


def _busy_slot(dev, chunks) -> str:
    """Rank 0 of two simulated ranks publishes product 0 into slot 0, then
    product 2 into the same slot while rank 1 has never read the first:
    the publish must give up within its wait bound (MISSING_TIMEOUT_S)
    with a RuntimeError naming SLOT_BUSY, the slot left holding product
    0's chunk bit for bit; the phase goes on."""
    from chase_tpu_torch.ops.ring_hemm import peer_publish
    peers = sim_peers(2, dev, timeout_s=MISSING_TIMEOUT_S)
    A = chunks[0]
    C = torch.neg(A)
    sim_ranks(2, lambda g: peers[g.me].reserve(A.numel() * A.element_size()))
    pc, why = peers[0], None
    peer_publish(A, pc)
    torch.cuda.synchronize()
    pc.product = 2
    t0 = time.perf_counter()
    try:
        peer_publish(C, pc)
        pc.check(sync=True)
    except RuntimeError as e:
        why = str(e)
    dt = time.perf_counter() - t0
    kept = _bitwise(pc.slot(0, tuple(A.shape), A.dtype), A)
    close_sim_peers(peers)
    if why is None or "SLOT_BUSY" not in why or not kept or \
            dt > MISSING_TIMEOUT_S + 30:
        raise AssertionError(f"gridring: a publish into a slot its readers "
                             f"never counted did not end in a SLOT_BUSY "
                             f"RuntimeError in time with the slot kept: "
                             f"{why!r} after {dt:.2f} s, slot kept {kept}")
    return (f"a publish into a slot whose reader never counted raised in "
            f"{dt:.2f} s (bound {MISSING_TIMEOUT_S:g} s), the slot bitwise "
            f"its earlier chunk: {why}")


def _publish_layouts(dev, b: int) -> list:
    """The publish on the layouts the main path's chunks do not show at
    k = 3000, two simulated ranks of b rows each: an odd f32 width (k =
    2999, contiguous: its flat range), a strided column window
    (V[:, 1:3000] of a (2b, 3001) f32 buffer: its row path, the source
    off the slot's 16-byte alignment) and c64 at k = 2999.  One product
    each, every rank's slot bitwise its chunk and every rank's gathered B
    bitwise the plain gather; the publish's and ``copy_``'s kernel times
    (:func:`_publish_ms`).  Log lines; raises on a difference."""
    from chase_tpu_torch.ops.ring_hemm import peer_gather_reference
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    p, k = 2, 2999
    cases = (("f32 k=2999", torch.randn((p * b, k), generator=g, device=dev)),
             ("f32 window [:, 1:3000] of 3001", torch.randn(
                 (p * b, 3001), generator=g, device=dev)[:, 1:3000]),
             ("c64 k=2999", torch.randn((p * b, k), generator=g, device=dev,
                                        dtype=torch.complex64)))
    peers = sim_peers(p, dev)
    sim_ranks(p, lambda q: peers[q.me].reserve(b * k * 8))
    lines = []
    for label, V in cases:
        chunks = [V[i * b:(i + 1) * b] for i in range(p)]
        Bs = sim_ranks(p, lambda q: _layout_product(peers[q.me],
                                                    chunks[q.me], V.dtype))
        torch.cuda.synchronize()
        slots = all(_bitwise(peers[q].slot(peers[q].product - 1,
                                           tuple(chunks[q].shape), V.dtype),
                             chunks[q]) for q in range(p))
        plain = peer_gather_reference(chunks, V.dtype)
        gathered = all(_bitwise(B, plain) for B in Bs)
        del Bs, plain
        ms, lib_ms, timed_as = _publish_ms(chunks, peers, V.dtype, 3)
        lines.append(f"publish layouts, {label}, chunks {tuple(chunks[0].shape)}"
                     f" (row stride {chunks[0].stride(0)}): every slot "
                     f"bitwise its chunk: {slots}; every gathered B bitwise "
                     f"the plain gather: {gathered}; peer_publish "
                     f"{timed_as} {ms:.4f} ms, copy_ {timed_as} "
                     f"{lib_ms:.4f} ms")
        if not (slots and gathered):
            close_sim_peers(peers)
            raise AssertionError(f"gridring: {lines[-1]}")
        del chunks, V
    close_sim_peers(peers)
    return lines


def _layout_product(pc, chunk, dtype) -> torch.Tensor:
    """One rank's publish and gather of one product (its thread)."""
    from chase_tpu_torch.ops.ring_hemm import peer_gather, peer_publish
    peer_publish(chunk, pc)
    pc.meet()
    return peer_gather(chunk, pc, dtype)


def phase_gridring(dev, H, route: str) -> dict:
    """The (p, 1) ring of an N × N H on one card, for p = 2 and 4
    simulated ranks: each rank's stripe laid out as DenseOperator(grid=…)
    lays it out (``operator.block_of``), on the kernel's ``route`` (f32,
    bf16 — the f32 H's shadow — or c64).  The main path: every rank's
    product through ``parallel.ring.ring_hemm`` with the simulated ranks
    as its grid — the peer route, ``ring_hemm_peers`` over
    :func:`sim_peers` — with the launch counts set to 0 just before it and
    read after it (one publish, gather and main launch per rank, no
    ring_hemm step); each rank's H·V held against a wide product at the
    kernel gate beside the plain chunk ring's and the library's (and the
    chunk ring on the kernel, today's p launches, beside); rank 0's
    product, gather and publish timed beside their plain versions, the
    library call and their bounds (:func:`_peer_cases`), the p-launch
    chunk ring's time per rank beside (its in-memory exchange).  The times
    are of one card's local memory.  On the f32 route also the missing
    publish (:func:`_missing_publish`)."""
    from chase_tpu_torch.ops.ring_hemm import ring_hemm_reference
    from chase_tpu_torch.parallel.operator import block_of
    from chase_tpu_torch.parallel.ring import matmul_step
    t_phase = time.perf_counter()
    N = H.shape[0]
    h_dtype = torch.bfloat16 if route == "bf16" else H.dtype
    v_dtype = torch.float32 if route == "bf16" else H.dtype
    wide = torch.complex128 if v_dtype.is_complex else torch.float64
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {}
    for p in GRID_P:
        b = N // p
        stripes = [block_of(H, (i * b, b), (0, N), N, dtype=h_dtype,
                            device=dev) for i in range(p)]
        peers = sim_peers(p, dev)
        for k in GRIDRING[route]:
            V = torch.randn((N, k), generator=g, device=dev, dtype=v_dtype)
            chunks = [V[i * b:(i + 1) * b].contiguous() for i in range(p)]
            Vr = (V.to(torch.bfloat16) if route == "bf16" else V).to(wide)
            _zero_ring_counts()
            torch.cuda.synchronize()
            W = _peer_ring_all(stripes, chunks, peers)
            torch.cuda.synchronize()
            launches = _ring_counts() + _peer_counts()
            # the plain chunk ring, the library's (matmul_step: torch.matmul,
            # or torch.mm(out_dtype=f32) of a bf16 H) and today's p-launch
            # chunk ring on the kernel
            Wp = _ring_all(stripes, chunks, step=ring_hemm_reference)
            Wl = _ring_all(stripes, chunks, step=matmul_step)
            before = _count("ring_hemm")
            Wk = _ring_all(stripes, chunks)
            chunk_launches = _count("ring_hemm") - before
            err = errp = errl = errk = abs_err = 0.0
            for i in range(p):
                ref = stripes[i].to(wide) @ Vr
                rows = slice(i * b, (i + 1) * b)
                err = max(err, rel_err(W[rows], ref))
                errp = max(errp, rel_err(Wp[rows], ref))
                errl = max(errl, rel_err(Wl[rows], ref))
                errk = max(errk, rel_err(Wk[rows], ref))
                abs_err = max(abs_err,
                              float((W[rows].to(wide) - ref).abs().max()))
                del ref
            del W, Wp, Wl, Wk
            chunk_ms = time_ms(lambda: _ring_all(stripes, chunks), 2) / p
            cases = _peer_cases(stripes, chunks, peers, V, Vr, 3)
            log("gridring", f"{route} p={p} (m, N, k)=({b}, {N}, {k}): ring "
                            f"of {p} simulated ranks on the peer route, rel "
                            f"err {err:.3e} (plain chunk ring {errp:.3e}, "
                            f"library {errl:.3e}, the chunk ring on the "
                            f"kernel {errk:.3e}), max abs err "
                            f"{abs_err:.3e}; {LAUNCH_NAMES} {launches} "
                            f"(the chunk ring's ring_hemm steps "
                            f"{chunk_launches}); the chunk ring on the "
                            f"kernel (p launches, in-memory exchange) "
                            f"{chunk_ms:.3f} ms per rank")
            log("gridring", _peer_line(route, f"p={p} k={k}", cases))
            # the kernel gate (PERF.md §2): 4× the plain version's error,
            # the library's for bf16; one main launch per product and rank
            gate = 4 * (errl if route == "bf16" else errp)
            if not (err <= 1e-5 and err <= gate and errk <= 1e-5
                    and launches == (0, 0, 0, p, p, p)
                    and chunk_launches == p * p
                    and cases["gather"]["abs_err"] == 0.0
                    and cases["publish"]["abs_err"] == 0.0):
                raise AssertionError(f"gridring {route} p={p} k={k}: error "
                                     f"{err:.3e} (gate 1e-5 and {gate:.3e}),"
                                     f" chunk ring {errk:.3e}, launches "
                                     f"{launches} (want {p} of each peer "
                                     f"kernel), chunk ring launches "
                                     f"{chunk_launches}, gather / publish "
                                     f"|kernel - plain| "
                                     f"{cases['gather']['abs_err']} / "
                                     f"{cases['publish']['abs_err']}")
            for kind in cases.values():
                kind["launches"] = None
            cases["product"]["launches"] = launches[3]
            cases["gather"]["launches"] = launches[4]
            cases["publish"]["launches"] = launches[5]
            out[(p, k)] = cases
            if route == "f32" and p == 2:
                log("gridring", _missing_publish(dev, stripes, chunks))
                log("gridring", _busy_slot(dev, chunks))
                for msg in _publish_layouts(dev, b):
                    log("gridring", msg)
            del V, Vr, chunks
        close_sim_peers(peers)
        del stripes, peers
        torch.cuda.empty_cache()
    log("gridring", f"{route} phase ok in "
                    f"{time.perf_counter() - t_phase:.2f} s")
    return out


class _SimRank:
    """Rank ``me`` of p simulated ranks, each a thread of this process:
    what the ring reads of a (p, 1) grid (``shape``, ``size``, ``index``,
    ``exchange``, and on the card ``peers``).  Its exchange hands chunks
    through a shared board between two barriers, as NCCL hands them from
    card to card: the call of rank ``me`` receives rank (me + 1) mod p's
    send.  Its peers are rank ``me``'s of ``peers`` (:func:`sim_peers`).
    Every thread queues its work on the card's one default stream, so a
    copy queued after the first barrier reads a send whose producers were
    queued before it."""

    def __init__(self, me: int, p: int, board: list, barrier, peers=None):
        self.me, self.p, self.board, self.barrier = me, p, board, barrier
        self._peers = peers

    @property
    def shape(self) -> dict:
        return {"r": self.p, "c": 1}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.me if axis == "r" else 0

    def exchange(self, axis: str = "r"):
        def swap(send, recv):
            self.board[self.me] = send
            self.barrier.wait()
            recv.copy_(self.board[(self.me + 1) % self.p])
            self.barrier.wait()
            return _SimRequests
        return swap

    def peers(self, axis: str = "r"):
        if self._peers is None:
            raise AssertionError("these simulated ranks were given no peer "
                                 "memory (sim_ranks(..., peers=))")
        return self._peers[self.me]


def sim_ranks(p: int, fn, shape=None, peers=None) -> list:
    """``fn(rank)`` for p simulated ranks (:class:`_SimRank` with
    ``peers``, or on an r×c ``shape`` :class:`_SimRank2D`), one thread
    each, their results in rank order; a rank that raises breaks the
    others' barrier, and the first error is raised here."""
    board, barrier = [None] * p, threading.Barrier(p, timeout=300)
    out, errors = [None] * p, []

    def rank(i):
        return (_SimRank(i, p, board, barrier, peers) if shape is None
                else _SimRank2D(i, shape, board, barrier))

    def run(i):
        try:
            out[i] = fn(rank(i))
        except BaseException as e:              # noqa: BLE001
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(p)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    return out


def phase_gridring_h2(dev, ctx: dict, route: str) -> dict:
    """The H² ring filter on a (p, 1) grid, p = 2 and 4 simulated ranks:
    each rank's stripe of [pfilter]'s operator laid out as
    DenseOperator(grid=…) lays it out, and its rows of [pfilter]'s window
    (w = nev + nex = 1500, degree 10), through the production filter
    (``parallel.ring.chebyshev_filter_h2_ring(grid=…)``: both products of
    every H² step a ``ring_hemm_peers`` product over :func:`sim_peers`);
    the stacked result held against the plain H² filter on the whole H
    ([pfilter]'s result) at [pfilter]'s gate, degree-0 columns bit-exact,
    one publish, gather and main launch per product and rank (2·p per H²
    step over the ranks), no ring_hemm step.  Rank 0's product, gather and
    publish at (m, N, k) = (N/p, N, w) timed beside their plain versions,
    the library call and their bounds (:func:`_peer_cases`)."""
    from chase_tpu_torch.ops.ring_hemm import _v_dtype
    from chase_tpu_torch.parallel.operator import block_of
    from chase_tpu_torch.parallel.ring import chebyshev_filter_h2_ring
    t_phase = time.perf_counter()
    H_f, X, args, Yp, gate = (ctx[k] for k in ("H_f", "X", "args", "Yp",
                                                  "gate"))
    N, w = X.shape
    deg, deg_max = args[0], args[-1]
    wide = torch.complex128 if X.is_complex() else torch.float64
    v_dtype = _v_dtype(H_f.dtype)
    out = {}
    for p in GRID_P:
        b = N // p
        stripes = [block_of(H_f, (i * b, b), (0, N), N, dtype=H_f.dtype,
                            device=dev) for i in range(p)]
        peers = sim_peers(p, dev)
        _zero_ring_counts()
        torch.cuda.synchronize()
        Y = torch.cat(sim_ranks(p, lambda g: chebyshev_filter_h2_ring(
            stripes[g.me], X[g.me * b:(g.me + 1) * b], *args, grid=g),
            peers=peers))
        launches = _ring_counts() + _peer_counts()
        err = rel_err(Y, Yp.to(wide))
        exact0 = bool(torch.equal(Y[:, deg == 0], X[:, deg == 0]))
        del Y
        steps = 1 + max(deg_max - 1, 0)
        want = 2 * p * steps
        V = X.to(v_dtype)
        chunks = [V[i * b:(i + 1) * b].contiguous() for i in range(p)]
        Vr = (V.to(torch.bfloat16) if route == "bf16" else V).to(wide)
        cases = _peer_cases(stripes, chunks, peers, V, Vr, 3)
        for name, n in zip(("product", "gather", "publish"), launches[3:]):
            cases[name]["launches"] = n
        out[(p, w)] = cases
        log("gridring", f"{route} H² ring filter p={p} (stripes ({b}, {N}), "
                        f"window {w}, deg_max {deg_max}) over {p} simulated "
                        f"ranks on the peer route: rel err against the "
                        f"plain H² filter {err:.3e} (gate {gate:.0e}); "
                        f"degree-0 columns bit-exact: {exact0}; "
                        f"{LAUNCH_NAMES} {launches} (2·p·{steps} = {want} "
                        f"of each peer kernel)")
        log("gridring", _peer_line(route, f"H² p={p} k={w}", cases))
        close_sim_peers(peers)
        del stripes, peers, V, Vr, chunks
        torch.cuda.empty_cache()
        if not (err <= gate and exact0
                and launches == (0, 0, 0, want, want, want)
                and cases["gather"]["abs_err"] == 0.0
                and cases["publish"]["abs_err"] == 0.0):
            raise AssertionError(f"gridring H² {route} p={p}: error "
                                 f"{err:.3e} (gate {gate:.0e}), degree-0 "
                                 f"exact {exact0}, launches {launches} "
                                 f"(want {want} of each peer kernel), "
                                 f"gather / publish |kernel - plain| "
                                 f"{cases['gather']['abs_err']} / "
                                 f"{cases['publish']['abs_err']}")
    log("gridring", f"{route} H² rings ok in "
                    f"{time.perf_counter() - t_phase:.2f} s")
    return out


# the 2-D ping-pong ring's simulated grids
GRID_2D = ((2, 2), (2, 4))
# the 2-D ring's stripe calls, by pass
STRIPE_2D = {"A": "ring_A block stripe", "B": "ring_B trans stripe"}


class _SimRank2D:
    """Rank (i, j) of an r×c grid of simulated ranks, each a thread of
    this process (rank ``me = i·c + j``): what the 2-D rings read of a
    ``Grid2D`` (``size``, ``index``, ``coords``, ``exchange``,
    ``reduce_scatter``, ``all_gather``, ``flip``).  Every collective
    posts this rank's tensor on a shared board and reads its peers'
    between two barriers of all ranks — the 2-D rings are SPMD, every
    rank issuing the same collectives in the same order — and queues its
    copies and sums on the card's one default stream after the producers'
    work, as :class:`_SimRank` does."""

    def __init__(self, me: int, shape: tuple, board: list, barrier):
        self.me, (self.r, self.c) = me, shape
        self.board, self.barrier = board, barrier
        self.coords = divmod(me, self.c)

    @property
    def shape(self) -> dict:
        return {"r": self.r, "c": self.c}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[0 if axis == "r" else 1]

    def _members(self, axis: str) -> list:
        i, j = self.coords
        return ([q * self.c + j for q in range(self.r)] if axis == "r"
                else [i * self.c + q for q in range(self.c)])

    def _swap(self, t, read):
        self.board[self.me] = t
        self.barrier.wait()
        out = read()
        self.barrier.wait()
        return out

    def exchange(self, axis: str = "r"):
        nxt = self._members(axis)[(self.index(axis) + 1) % self.size(axis)]

        def swap(send, recv):
            self._swap(send, lambda: recv.copy_(self.board[nxt]))
            return _SimRequests
        return swap

    def reduce_scatter(self, t, axis: str):
        m = t.shape[0] // self.size(axis)
        k = self.index(axis)

        def read():
            parts = [self.board[q][k * m:(k + 1) * m]
                     for q in self._members(axis)]
            out = parts[0].clone()
            for x in parts[1:]:
                out += x
            return out
        return self._swap(t, read)

    def all_gather(self, t, axis: str = "r"):
        return self._swap(t, lambda: torch.cat(
            [self.board[q] for q in self._members(axis)]))

    def flip(self, t, to: str):
        """Grid2D.flip's chunk orders, as the grid computes them."""
        from chase_tpu_torch.parallel.mesh import Grid2D
        frm = "B" if to == "A" else "A"
        i, j = Grid2D._holder(self, Grid2D.parity_chunk(self, to), frm)
        src = i * self.c + j
        return self._swap(t, lambda: t if src == self.me
                          else self.board[src].clone())


def _sim_tiles(A, shape: tuple, dtype, dev) -> list:
    """Every simulated rank's block of A (rank order i·c + j), laid out
    as DenseOperator(grid=…) lays it out (``operator.block_of``)."""
    from chase_tpu_torch.parallel.operator import block_of
    r, c = shape
    N = A.shape[0]
    return [block_of(A, (i * (N // r), N // r), (j * (N // c), N // c), N,
                     dtype=dtype, device=dev)
            for i in range(r) for j in range(c)]


def _ring2d_bytes(tiles, shape: tuple) -> tuple:
    """(bytes allocated on the card before, and after, a Ring2D is built
    on every simulated rank's block): the rings read the blocks
    themselves, so nothing is allocated."""
    from chase_tpu_torch.parallel.ring import Ring2D
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rings = [Ring2D(_SimRank2D(q, shape, [None] * len(tiles), None), t, True)
             for q, t in enumerate(tiles)]
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    del rings
    return before, after


def _stripe_calls(route: str, tile, Vc, nch: int, h_dtype) -> dict:
    """One ring_A stripe call (``tile[:, nch:2·nch]·V``) and one ring_B
    stripe call (``tile[nch:2·nch, :]ᴴ·V`` on the trans route) on the
    rank's block, each timed beside its plain version and the library
    call (torch.matmul of the block, of its conjugate-transposed view for
    ring_B — cuBLAS with ConjTrans, no copy; torch.mm with f32 out for
    bf16) and its bound; ring_B also beside the kernel's untransposed
    route at its (m, b, k) (``ring_hemm`` on the block's first N/c rows,
    ``same_ms``), so that the transposed read's cost shows in one call."""
    from chase_tpu_torch.ops.ring_hemm import ring_hemm, ring_hemm_reference
    out = {}
    k = Vc.shape[1]
    for label, trans, blk in (("A", False, tile[:, nch:2 * nch]),
                              ("B", True, tile[nch:2 * nch, :].mH)):
        m = blk.shape[0]
        W = torch.empty((m, k), dtype=Vc.dtype, device=Vc.device)

        def library(blk=blk):
            if route == "bf16":
                return torch.mm(blk, Vc.to(torch.bfloat16),
                                out_dtype=torch.float32)
            return torch.matmul(blk, Vc)

        fns = [lambda trans=trans: ring_hemm_reference(
                   tile, Vc, col0=nch, out=W, trans=trans),
               lambda trans=trans: ring_hemm(tile, Vc, col0=nch, out=W,
                                             trans=trans), library]
        if trans:
            fns.append(lambda: ring_hemm(tile[:m], Vc, col0=nch, out=W))
        times = time_fns(fns, 3)
        bound_ms, bound_by = (bf16_hemm_bound(m, nch, k) if route == "bf16"
                              else hemm_bound(m, nch, k, h_dtype))
        out[label] = dict(ms=times[1], plain_ms=times[0],
                          library_ms=times[2], bound_ms=bound_ms,
                          bound_by=bound_by, shape=(m, nch, k))
        if trans:
            out[label]["same_ms"] = times[3]
        del W
    return out


def _stripe_line(cl: dict) -> str:
    """A stripe call's times, for the log."""
    line = (f"stripe call {cl['shape']} {cl['ms']:.3f} ms, plain "
            f"{cl['plain_ms']:.3f} ms, library {cl['library_ms']:.3f} ms, "
            f"bound {cl['bound_ms']:.3f} ms ({cl['bound_by']})")
    if "same_ms" in cl:
        line += (f", the untransposed route at its shape "
                 f"{cl['same_ms']:.3f} ms")
    return line


def _row_blocks(res: list, c: int) -> torch.Tensor:
    """The whole multivector from the simulated ranks' rows of their
    block row (each grid row's first rank), after checking that the
    ranks of a grid row hold the same bits."""
    for q, y in enumerate(res):
        if not torch.equal(y, res[q - q % c]):
            raise AssertionError("2-D ring: ranks of a grid row disagree")
    return torch.cat(res[::c])


def phase_gridring2d(dev, H, route: str) -> dict:
    """The 2-D ping-pong ring of an N × N H on one card at simulated
    (r, c) grids (GRID_2D, one thread per rank, :class:`_SimRank2D`):
    each rank's block laid out as DenseOperator(grid=…) lays it out (the
    bytes allocated before and after a Ring2D is built on each: no copy),
    then ``parallel.ring.Ring2D``'s passes on the kernel's ``route`` —
    ring_A (H·V: r kernel steps on the block, the reduce-scatter over 'c')
    and ring_B (Hᴴ·V: c kernel steps on the block's trans route, over
    'r') — each rank's parity chunk against a wide product at the kernel
    gate beside the plain version's passes, launches r and c per rank;
    one stripe call of each pass (N/r or N/c, N/(r·c), k) timed beside
    its plain version, the library call and its bound (ring_B also beside
    the untransposed route at its shape; on c64 also ring_B's pre-pass,
    :func:`_conj_split_case`).  Then the Hermitian 2-D ring filter
    (``chebyshev_filter_ring2d``) on the Hermitian part of H against the
    plain filter at [filter]'s width, degrees and gate (1e-2 on the bf16
    shadow), degree-0 columns bit-exact, ⌈n/2⌉·r + ⌊n/2⌋·c launches per
    rank.  The launch counts are set to 0 just before each ring run and
    read after it."""
    from chase_tpu_torch.config import set_matmul_precision
    from chase_tpu_torch.ops.ring_hemm import ring_hemm_reference
    from chase_tpu_torch.parallel.ring import Ring2D
    t_phase = time.perf_counter()
    set_matmul_precision("highest")
    N = H.shape[0]
    h_dtype = torch.bfloat16 if route == "bf16" else H.dtype
    v_dtype = torch.float32 if route == "bf16" else H.dtype
    wide = torch.complex128 if v_dtype.is_complex else torch.float64
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    out = {}
    for shape in GRID_2D:
        r, c = shape
        n, nch = r * c, N // (r * c)
        tiles = _sim_tiles(H, shape, h_dtype, dev)
        before, after = _ring2d_bytes(tiles, shape)
        log("gridring", f"{route} 2-D {shape}: {n} blocks ({N // r}, "
                        f"{N // c}), {tiles[0].untyped_storage().nbytes() / 1e9:.3f} GB "
                        f"each; torch.cuda.memory_allocated {before} B "
                        f"before the {n} Ring2D are built, {after} B after")
        if after != before:
            raise AssertionError(f"gridring 2-D {route} {shape}: building "
                                 f"the rings allocated {after - before} B")
        for k in GRIDRING[route]:
            V = torch.randn((N, k), generator=g, device=dev, dtype=v_dtype)
            Vr = (V.to(torch.bfloat16) if route == "bf16" else V).to(wide)

            def chunk(q, parity):
                i, j = divmod(q, c)
                m = j * r + i if parity == "A" else i * c + j
                return V[m * nch:(m + 1) * nch], m

            errs, launches = {}, {}
            for label, parity in (("A", "A"), ("B", "B")):
                res = {}
                for name, step in (("kernel", None),
                                   ("plain", ring_hemm_reference)):
                    def rank(g2, step=step):
                        ring = Ring2D(g2, tiles[g2.me], True)
                        ring.step = step
                        w = chunk(g2.me, parity)[0]
                        return (ring.ring_A(w) if parity == "A"
                                else ring.ring_B(w))
                    _zero_ring_counts()
                    torch.cuda.synchronize()
                    res[name] = sim_ranks(n, rank, shape)
                    if name == "kernel":
                        launches[label] = _ring_counts()
                err = errp = abs_err = 0.0
                for q in range(n):
                    # the chunk of the product this rank's pass lands:
                    # ring_A's in B, ring_B's (Hᴴ·V) in A
                    m = chunk(q, "B" if parity == "A" else "A")[1]
                    rows = slice(m * nch, (m + 1) * nch)
                    blk = H[rows] if parity == "A" else H[:, rows].mH
                    ref = blk.to(h_dtype).to(wide) @ Vr
                    err = max(err, rel_err(res["kernel"][q], ref))
                    errp = max(errp, rel_err(res["plain"][q], ref))
                    abs_err = max(abs_err, float(
                        (res["kernel"][q].to(wide) - ref).abs().max()))
                    del ref
                errs[label] = (err, errp, abs_err)
                del res
            calls = _stripe_calls(route, tiles[0],
                                  V[nch:2 * nch].contiguous(), nch, h_dtype)
            for label in ("A", "B"):
                err, errp, abs_err = errs[label]
                steps = r if label == "A" else c
                cl = calls[label]
                log("gridring", f"{route} 2-D {shape} ring_{label} "
                                f"({'block' if label == 'A' else 'trans'}"
                                f") k={k}: rel err kernel {err:.3e} "
                                f"plain {errp:.3e}, max abs err "
                                f"{abs_err:.3e}; launches "
                                f"{launches[label]} ({steps} per rank); "
                                f"{_stripe_line(cl)}")
                gate = 4 * errp
                want = steps * n
                if not (err <= 1e-5 and err <= gate
                        and launches[label][0] == want
                        and sum(launches[label][1:]) == want):
                    raise AssertionError(
                        f"gridring 2-D {route} {shape} ring_{label} k={k}: "
                        f"error {err:.3e} (gate 1e-5 and {gate:.3e}) or "
                        f"launches {launches[label]} != {want}")
                out[(label, shape, k)] = dict(
                    abs_err=abs_err, launches=launches[label][0], **cl)
            if route == "c64":
                out[("split", shape, k)] = _conj_split_case(
                    V[nch:2 * nch].contiguous(), launches["B"][1],
                    f"c64 2-D {shape}")
            del V, Vr
        del tiles
        torch.cuda.empty_cache()
        _hermitian_filter2d(dev, H, route, shape, h_dtype, v_dtype, wide)
    log("gridring", f"{route} 2-D phase ok in "
                    f"{time.perf_counter() - t_phase:.2f} s")
    return out


def _conj_split_case(Vc, launches: int, what: str) -> dict:
    """ring_B's c64 pre-pass (``tf32_split(conj=True)``, the C entry
    ``ring_hemm_split_c64_conj``) on one chunk: bit-exact against its
    plain version, timed beside it and its bytes bound."""
    from chase_tpu_torch.ops.ring_hemm import tf32_split, tf32_split_reference
    b, k = Vc.shape
    err = float((tf32_split(Vc, conj=True)
                 - tf32_split_reference(Vc, conj=True)).abs().max())
    plain_ms, ms = time_fns([lambda: tf32_split_reference(Vc, conj=True),
                             lambda: tf32_split(Vc, conj=True)], 3)
    bound_ms, bound_by = split_bound(b, k, Vc.dtype)
    log("gridring", f"{what} ring_B's pre-pass tf32_split(conj=True) ({b}, "
                    f"{k}): |kernel - plain| {err}; {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
                    f"({bound_by}); launches {launches}")
    if err != 0.0:
        raise AssertionError(f"gridring {what}: tf32_split(conj=True) "
                             f"disagrees with its plain version")
    return dict(abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, launches=launches)


def ring2d_entries(rings: dict, tag: str) -> list:
    """The kernels-line entries of [gridring]'s 2-D rings (``rings``:
    route → (label, shape, k) → case): each pass's stripe call, and c64
    ring_B's pre-pass."""
    out = []
    for route, cases in rings.items():
        for (label, shape, k), case in cases.items():
            if label == "split":
                out.append(_kernel_entry(
                    f"tf32_split[{route} conj{tag} 2-D ring_B {shape} "
                    f"k={k}]", case["launches"], case))
            else:
                out.append(_kernel_entry(
                    f"ring_hemm[{route}{tag} 2-D {STRIPE_2D[label]} "
                    f"{shape} k={k}]", case["launches"], case))
    return out


def _hermitian_filter2d(dev, H, route, shape, h_dtype, v_dtype, wide):
    """[gridring] 2-D's filter check on the Hermitian part (H + Hᴴ)/2."""
    from chase_tpu_torch.ops.filter import chebyshev_filter
    from chase_tpu_torch.parallel.ring import chebyshev_filter_ring2d
    r, c = shape
    n = r * c
    N = H.shape[0]
    Hs = H.clone()
    Hs += H.mH
    Hs *= 0.5
    tiles = _sim_tiles(Hs, shape, h_dtype, dev)
    Hs = Hs.to(h_dtype)
    w, deg_max = 750, 10
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    X = torch.randn((N, w), generator=g, device=dev, dtype=v_dtype)
    X /= torch.linalg.vector_norm(X, dim=0)
    deg = np.full(w, deg_max, np.int32)
    deg[:50] = 0
    deg[50:300] = 6
    rad = 2.0 * np.sqrt(N / 2.0) * 1.05   # the semicircle's radius, widened
    args = (deg, -rad, -rad + 0.1 * rad, rad, deg_max)
    b = N // r
    _zero_ring_counts()
    torch.cuda.synchronize()
    res = sim_ranks(n, lambda g2: chebyshev_filter_ring2d(
        g2, tiles[g2.me], X[g2.coords[0] * b:(g2.coords[0] + 1) * b],
        *args, kernel=True), shape)
    launches = _ring_counts()
    Y = _row_blocks(res, c)
    del res, tiles
    Yp = chebyshev_filter(Hs, X, *args)
    err = rel_err(Y, Yp.to(wide))
    exact0 = bool(torch.equal(Y[:, :50], X[:, :50]))
    del Y, Yp, Hs
    torch.cuda.empty_cache()
    gate = 1e-2 if route == "bf16" else 1e-5
    want = n * ((deg_max + 1) // 2 * r + deg_max // 2 * c)
    log("gridring", f"{route} 2-D {shape} Hermitian ring filter (window "
                    f"{w}, deg_max {deg_max}) on the Hermitian part of H "
                    f"over {n} simulated ranks: rel err against the plain "
                    f"filter {err:.3e} (gate {gate:.0e}); degree-0 columns "
                    f"bit-exact: {exact0}; ring_hemm launches "
                    f"{launches[0]} ({want}), pre-pass "
                    f"{launches[1] + launches[2]}")
    if not (err <= gate and exact0 and launches[0] == want
            and launches[1] + launches[2] == want):
        raise AssertionError(f"gridring 2-D {route} {shape} filter: error "
                             f"{err:.3e} (gate {gate:.0e}), degree-0 exact "
                             f"{exact0}, launches {launches} (want {want})")


def phase_gridring2d_h2(dev, ctx: dict, route: str) -> dict:
    """The 2-D H² ring filter (``chebyshev_filter_h2_ring2d``: every H²
    step a ring_B pass on the block's trans route and a ring_A pass on
    the block) at the simulated GRID_2D grids, on [pfilter]'s operator and
    window: each rank's block laid out as DenseOperator(grid=…,
    pseudo_hermitian=True) lays it out (N/2 a multiple of r·c: no pad)
    and its rows of the window; the stacked result against the plain H² filter at
    [pfilter]'s gate, degree-0 columns bit-exact, launches (r + c) per H²
    step and rank.  On the f32 and c64 routes one stripe call of each
    pass (N/r, N/(r·c), w) timed beside its plain version, the library
    call and its bound."""
    from chase_tpu_torch.ops.ring_hemm import ring_hemm
    from chase_tpu_torch.parallel.ring import chebyshev_filter_h2_ring2d
    t_phase = time.perf_counter()
    H_f, X, args, Yp, gate = (ctx[k] for k in ("H_f", "X", "args", "Yp",
                                                  "gate"))
    N, w = X.shape
    deg, deg_max = args[0], args[-1]
    wide = torch.complex128 if X.is_complex() else torch.float64
    out = {}
    for shape in GRID_2D:
        r, c = shape
        n, nch, b = r * c, N // (r * c), N // r
        tiles = _sim_tiles(H_f, shape, H_f.dtype, dev)
        before, after = _ring2d_bytes(tiles, shape)
        _zero_ring_counts()
        torch.cuda.synchronize()
        res = sim_ranks(n, lambda g2: chebyshev_filter_h2_ring2d(
            g2, tiles[g2.me],
            X[g2.coords[0] * b:(g2.coords[0] + 1) * b], *args,
            kernel=True), shape)
        launches = _ring_counts()
        Y = _row_blocks(res, c)
        del res
        err = rel_err(Y, Yp.to(wide))
        exact0 = bool(torch.equal(Y[:, deg == 0], X[:, deg == 0]))
        del Y
        steps = 1 + max(deg_max - 1, 0)
        want = n * (r + c) * steps
        line = (f"{route} 2-D {shape} H² ring filter (blocks "
                f"({b}, {N // c}), memory_allocated {before} B before the "
                f"Ring2D are built, {after} B after; window "
                f"{w}, deg_max {deg_max}) over {n} simulated ranks: rel "
                f"err against the plain H² filter {err:.3e} (gate "
                f"{gate:.0e}); degree-0 columns bit-exact: {exact0}; "
                f"ring_hemm launches {launches[0]} (n·(r+c)·{steps} = "
                f"{want}), pre-pass {launches[1] + launches[2]}")
        if route != "bf16":
            Vc = X[nch:2 * nch].to(H_f.dtype).contiguous()
            calls = _stripe_calls(route, tiles[0], Vc, nch, H_f.dtype)
            for label in ("A", "B"):
                cl = calls[label]
                trans = label == "B"
                blk = (tiles[0][nch:2 * nch, :].mH if trans
                       else tiles[0][:, nch:2 * nch])
                ref = blk.to(wide) @ Vc.to(wide)
                abs_err = float((ring_hemm(tiles[0], Vc, col0=nch,
                                           trans=trans).to(wide) - ref)
                                .abs().max())
                del ref
                out[(label, shape, w)] = dict(abs_err=abs_err,
                                              launches=launches[0], **cl)
                line += (f"; ring_{label} {_stripe_line(cl)}, max abs err "
                         f"{abs_err:.3e}")
        log("gridring", line)
        del tiles
        torch.cuda.empty_cache()
        if not (err <= gate and exact0 and launches[0] == want
                and launches[1] + launches[2] == want and after == before):
            raise AssertionError(f"gridring 2-D H² {route} {shape}: error "
                                 f"{err:.3e} (gate {gate:.0e}), degree-0 "
                                 f"exact {exact0}, launches {launches} "
                                 f"(want {want})")
    log("gridring", f"{route} 2-D H² rings ok in "
                    f"{time.perf_counter() - t_phase:.2f} s")
    return out


def free_port() -> int:
    """A free TCP port on this machine's loopback (the rendezvous of
    the children's process group)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(rank: int, world: int, port: int, **extra) -> dict:
    """torchrun's variables for rank ``rank`` of ``world`` on this host."""
    return dict(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), **extra)


def _check_wiring(grid) -> str:
    """The NCCL calls the grid issues, run once on its groups even where
    they have one member (an f32 and a complex64 all_reduce, an
    all_gather_into_tensor, a broadcast, and the ring's chunk exchange —
    ``Grid2D.exchange``'s batch_isend_irecv, here a send to and a receive
    from the rank itself), each checked."""
    import torch.distributed as dist
    dev, n = grid.device, grid.size("r")
    x = torch.full((4, 3), 1.0 + 2.0j, dtype=torch.complex64, device=dev)
    dist.all_reduce(torch.view_as_real(x), group=grid.group("r"))
    y = torch.ones(5, device=dev)
    dist.all_reduce(y, group=grid.group("c"))
    z = torch.empty((n * 2, 3), device=dev)
    dist.all_gather_into_tensor(z, torch.full((2, 3), 3.0, device=dev),
                                group=grid.group("r"))
    dist.broadcast(y, src=grid.global_rank("c", 0), group=grid.group("c"))
    send = torch.arange(24, dtype=torch.float32, device=dev).reshape(6, 4)
    send = send + 100.0 * grid.index("r")
    recv = torch.empty_like(send)
    grid.exchange("r")(send, recv).wait()
    sendc = torch.full((3, 2), 1.0 - 1.0j, dtype=torch.complex64, device=dev)
    recvc = torch.empty_like(sendc)
    grid.exchange("r")(sendc, recvc).wait()
    torch.cuda.synchronize(dev)
    nxt = (grid.index("r") + 1) % n
    ok = (bool(torch.all(x == n * (1.0 + 2.0j)))
          and bool(torch.all(y == grid.size("c")))
          and bool(torch.all(z == 3.0))
          and bool(torch.equal(recv, send + 100.0 * (nxt - grid.index("r"))))
          and bool(torch.equal(recvc, sendc)))
    if not ok:
        raise AssertionError("NCCL wiring check failed")
    return (f"NCCL all_reduce (f32, c64 as its real view), "
            f"all_gather_into_tensor, broadcast and the ring's chunk "
            f"exchange (batch_isend_irecv, f32 and c64; {n} member(s) along "
            f"'r') on the grid's groups: ok")


def _grid_solve(grid, solve, gate, runs: int = 2) -> dict:
    """``solve()`` on ``grid`` ``runs`` times (cold, then warm), each
    timed with the grid's collectives and the kernel launch counts set to
    0 just before it; the last run's numbers, its cold TTS beside, gated
    by ``gate(res, who)`` and one main launch per HEMM step and rank on
    every kernel route (:func:`launches_ok`), on p > 1 each product
    counted once under "peer" and no chunk exchanged by NCCL
    ("sendrecv")."""
    import torch.distributed as dist
    out = []
    for _ in range(runs):
        grid.stats.reset()
        _zero_ring_counts()
        torch.cuda.synchronize(grid.device)
        dist.barrier()
        tts, res = timed(solve)
        out.append((tts, res, _ring_counts() + _peer_counts(),
                    grid.stats.summary()))
    tts, res, launches, stats = out[-1]
    gate(res, f"grid {grid.shape}")
    steps = res.perf.filter_hemm_steps
    p = grid.size("r")
    peer_ok = p == 1 or ("sendrecv" not in stats
                         and stats.get("peer", (0, 0))[0] == steps)
    if not (launches_ok(launches, steps, p) and peer_ok):
        raise AssertionError(f"grid {grid.shape}: {LAUNCH_NAMES} "
                             f"{launches} against {steps} HEMM steps, "
                             f"collectives {stats}")
    return dict(tts_cold=out[0][0], tts=tts, iterations=res.iterations,
                launches=list(launches), hemm_steps=steps,
                executed=res.perf.filtered_vecs_executed,
                collectives={k: list(v) for k, v in stats.items()})


def _grid_fused(grid, fused, gate) -> dict:
    """:func:`fused_runs` of ``fused`` on ``grid`` with its gates
    (:func:`check_fused_runs`: one main launch per HEMM step and rank; no
    NCCL chunk exchange) and ``gate`` on both solves; the collectives of
    the three calls."""
    grid.stats.reset()
    runs = fused_runs(fused, grid.size("r"))
    check_fused_runs(f"grid {grid.shape} fused", runs)
    if "sendrecv" in grid.stats.summary():
        raise AssertionError(f"grid {grid.shape} fused: chunks exchanged "
                             f"by NCCL: {grid.stats.summary()}")
    gate(runs["res"], "fused")
    gate(runs["res2"], "fused (warm)")
    return dict(tts_cold=runs["first"], tts=runs["warm"],
                iterations=runs["res2"].iterations,
                per_iter=runs["per_iter"], launches=list(runs["launches"]),
                hemm_steps=runs["steps"],
                collectives={k: list(v) for k, v in
                             grid.stats.summary().items()})


def _grid_io(grid, H, path: str, gate, cfg) -> dict:
    """[grid1]'s (and [gridnccl]'s) sharded I/O at the slice's size on a
    (p, 1) grid: H from the ChASE file [io] wrote through
    io.load_matrix_sharded (this rank's block bitwise against H's), eigsh
    of that DTensor on the kernel ring (the slice's gates, one main
    launch per HEMM step and rank), its V through save_state(sharded=True) and
    load_state(grid=) (bitwise) and a warm start from that checkpoint (no
    more iterations than the cold solve), then
    interface.init_blockcyclic(mb = nb = 64) on the grid's shape, solve
    and get_eigenpairs (the slice's gates on the returned V, in the user's
    row order)."""
    from types import SimpleNamespace
    import torch.distributed as dist
    import chase_tpu_torch as ct
    from chase_tpu_torch import _native, interface, io as cio
    from chase_tpu_torch.io import _even_block
    N, nev, nex, tol = SLICE["N"], SLICE["nev"], SLICE["nex"], SLICE["tol"]
    p = grid.size("r")
    r0, rn = _even_block(N, p, grid.index("r"))
    dist.barrier()
    t0 = time.perf_counter()
    _native.read_block(path, N, np.float32, r0, rn, 0, N)
    t_native = time.perf_counter() - t0
    t_read, Hd = timed(lambda: cio.load_matrix_sharded(path, N, np.float32,
                                                       grid))
    same = bool(torch.equal(Hd.to_local(), H[r0:r0 + rn]))
    _zero_ring_counts()
    cold, res = timed(lambda: ct.eigsh(Hd, nev, nex, tol=tol, config=cfg,
                                       grid=grid, collect_perf=True))
    launches = _ring_counts() + _peer_counts()
    del Hd
    gate(res, "eigsh of the sharded file")
    steps = res.perf.filter_hemm_steps
    state = path + ".grid_state"
    t_save, _ = timed(lambda: cio.save_state(state, res.V, res.ritzv_full,
                                             {"N": N}, sharded=True))
    t_load, (V, ritzv, meta) = timed(lambda: cio.load_state(state,
                                                            grid=grid))
    same_state = (bool(torch.equal(V.to_local(), res.V.to_local()))
                  and V.placements == res.V.placements
                  and np.array_equal(ritzv, res.ritzv_full)
                  and meta == {"N": N})
    warm, res2 = timed(lambda: ct.eigsh(H, nev, nex, tol=tol, config=cfg,
                                        grid=grid, v0=V, ritzv0=ritzv,
                                        approx=True))
    gate(res2, "warm start from the sharded checkpoint")
    warm_its = res2.iterations
    dist.barrier()
    if grid.coords == (0, 0):
        os.remove(state + ".npz")
        os.remove(state + ".V.bin")
    del V, res2

    def blockcyclic():
        interface.init_blockcyclic(N, nev, nex, 64, 64, H,
                                   grid_shape=(p, 1), device=grid.device)
        interface.set_tol(tol)
        rc = interface.solve()
        return rc, interface._require().result.iterations, \
            interface.get_eigenpairs()

    _zero_ring_counts()
    with ring_backend_env("pallas"):
        t_bc, (rc, bc_its, (ev, Vh)) = timed(blockcyclic)
    bc_launches = _main_counts()
    interface.finalize()
    gate(SimpleNamespace(V=torch.from_numpy(Vh).to(grid.device), ritzv=ev,
                         converged=rc == 0), "interface.init_blockcyclic")
    ok = (same and same_state and warm_its <= res.iterations
          and launches_ok(launches, steps, p) and bc_launches[0] > 0)
    return dict(ok=ok, native_s=t_native, read_s=t_read,
                read_gb=rn * N * 4 / 1e9,
                bitwise=same, tts=cold, iterations=res.iterations,
                launches=list(launches), hemm_steps=steps, save_s=t_save,
                load_s=t_load, state_bitwise=same_state, warm_tts=warm,
                warm_iterations=warm_its, bc_tts=t_bc,
                bc_iterations=bc_its, bc_launches=list(bc_launches))


def grid_child() -> int:
    """One rank of [grid1] / [gridnccl], started with torchrun's
    variables: multihost.init_grid() on NCCL, the (GRID_R, 1) grid, the
    NCCL wiring, then on the kernel ring with each phase's gates: the f32
    slice (cold, warm), the slice's sharded I/O (:func:`_grid_io`, from
    the file CHASE_SMOKE_FILE names), the f64 BSE ladder of [pseudo]
    (eigsh_pseudo, cold, warm), eigsh_fused at [fslice]'s shape and
    eigsh_pseudo_fused at [fpseudo]'s (first, warm with its host syncs,
    one iteration); each rank prints one line ``GRID_RESULT {json}``
    (``_run_ranks`` reads every rank's; the phases log rank 0's)."""
    import torch.distributed as dist
    import chase_tpu_torch as ct
    from chase_tpu_torch.parallel import multihost
    r = int(os.environ["GRID_R"])
    t0 = time.perf_counter()
    grid = multihost.init_grid((r, 1), timeout=300)
    t_init = time.perf_counter() - t0
    wiring = _check_wiring(grid)
    dev = grid.device
    out = dict(shape=[r, 1], init_s=t_init, wiring=wiring)
    N, nev, nex, tol = SLICE["N"], SLICE["nev"], SLICE["nex"], SLICE["tol"]
    H = clement_on_device(N, dev)
    cfg = ct.ChaseConfig(ring_backend="pallas", mixed_precision=False)
    op = ct.DenseOperator(H, grid=grid)
    gate = clement_gate("grid", H, nev, 0.5, 10 * tol)
    out["slice"] = _grid_solve(grid, lambda: ct.eigsh(
        op, nev, nex, tol=tol, config=cfg, collect_perf=True), gate)

    def fslice(max_iter):
        c = cfg if max_iter is None else ct.ChaseConfig(
            ring_backend="pallas", mixed_precision=False, max_iter=max_iter)
        return ct.eigsh_fused(H, nev, nex, tol=tol, config=c, grid=grid,
                              collect_perf=True)

    out["fslice"] = _grid_fused(grid, fslice, gate)
    del op
    out["io"] = _grid_io(grid, H, os.environ["CHASE_SMOKE_FILE"], gate, cfg)
    del H
    torch.cuda.empty_cache()
    H, lam = structured_bse_on_device(BSE["N"], dev)
    nev, nex, tol = BSE["nev"], BSE["nex"], BSE["tol"]
    bgate = bse_gate("grid", H, lam, nev, tol)
    ladder = ct.ChaseConfig(mixed_precision=True, ring_backend="pallas")
    out["pseudo"] = _grid_solve(grid, lambda: ct.eigsh_pseudo(
        H, nev, nex, tol=tol, config=ladder, grid=grid, collect_perf=True),
        bgate)

    def fpseudo(max_iter):
        c = ladder if max_iter is None else ct.ChaseConfig(
            mixed_precision=True, ring_backend="pallas", max_iter=max_iter)
        return ct.eigsh_pseudo_fused(H, nev, nex, tol=tol, config=c,
                                     grid=grid, collect_perf=True)

    out["fpseudo"] = _grid_fused(grid, fpseudo, bgate)
    print("GRID_RESULT " + json.dumps(out), flush=True)
    grid.close()
    dist.destroy_process_group()
    return 0


def host_child() -> int:
    """One rank of [gridhost] (and [gridnccl]'s 2-D run): torchrun's
    variables, the grid of GRIDHOST_SHAPE ("2,1" by default) and the
    solves of GRIDHOST (GRIDHOST_2D on a 2-D grid) with their gates.
    With GRID_BACKEND="host" (the default) a gloo group and a grid of
    :class:`HostStagedGrid` whose ranks share card 0; with "nccl" an
    NCCL grid, one card per rank.  Each rank prints one line
    ``HOST_RESULT {json}`` (its results' bits as hex, the rows and col0
    of every ring_hemm launch and the operators they read)."""
    import torch.distributed as dist
    import chase_tpu_torch as ct
    from chase_tpu_torch.ops import ring_hemm as rh
    from chase_tpu_torch.parallel import multihost
    shape = tuple(int(x) for x in os.environ.get("GRIDHOST_SHAPE",
                                                 "2,1").split(","))
    if os.environ.get("GRID_BACKEND", "host") == "nccl":
        grid = multihost.init_grid(shape, timeout=300)
    else:
        cpu_grid = multihost.init_grid(shape, device="cpu", timeout=300)
        grid = host_staged_grid(cpu_grid.mesh, torch.device("cuda", 0))
    real, stripes, operators = rh.ring_hemm, set(), set()

    def recording(H, V, *, col0=0, **kw):
        stripes.add((H.shape[0], col0))
        operators.add(H.data_ptr())
        recording.trans += bool(kw.get("trans"))
        return real(H, V, col0=col0, **kw)

    real_peers = rh.ring_hemm_peers

    def recording_peers(H, V, peers, **kw):
        stripes.add((H.shape[0], 0))
        operators.add(H.data_ptr())
        return real_peers(H, V, peers, **kw)

    # every ring step looks ring_hemm (a (p, 1) product on the card
    # ring_hemm_peers) up on its module at call time: these functions
    # record what it reads (the launches are counted where they are made)
    rh.ring_hemm, rh.ring_hemm_peers = recording, recording_peers
    dev = grid.device
    results = {}
    solves = GRIDHOST if shape[1] == 1 else GRIDHOST_2D
    for name, (kind, N, nev, nex, tol, cfg) in solves.items():
        if kind == "clement":
            H = clement_on_device(N, dev)
            gate = clement_gate("gridhost", H, nev, 0.5, 10 * tol)
            solve = ct.eigsh_fused if "fused" in name else ct.eigsh
        else:
            H, lam = structured_bse_on_device(N, dev)
            gate = bse_gate("gridhost", H, lam, nev, tol)
            solve = (ct.eigsh_pseudo_fused if "fused" in name
                     else ct.eigsh_pseudo)
        stripes.clear()
        operators.clear()
        grid.stats.reset()
        recording.trans = 0
        _zero_ring_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        tts, res = timed(lambda: solve(H, nev, nex, tol=tol, grid=grid,
                                       collect_perf=True,
                                       config=ct.ChaseConfig(**cfg)))
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        gate(res, f"rank {dist.get_rank()}")
        results[name] = dict(
            tts=tts, iterations=res.iterations, locked=res.locked,
            ritzv=np.asarray(res.ritzv, np.float64).tobytes().hex(),
            resid=np.asarray(res.resid, np.float64).tobytes().hex(),
            launches=[_count("ring_hemm"), _count("tf32_split"),
                      _count("ring_hemm_peers"), _count("peer_gather"),
                      _count("peer_publish")],
            hemm_steps=res.perf.filter_hemm_steps, N=N, peak_mib=peak,
            trans=recording.trans,
            stripes=sorted(stripes), operators=len(operators),
            collectives={k: list(v) for k, v in
                         grid.stats.summary().items()})
        del H, res
        torch.cuda.empty_cache()
    if shape[1] > 1 and "CHASE_SMOKE_FILE" in os.environ:
        results["io"] = _gridhost_io(grid, os.environ["CHASE_SMOKE_FILE"],
                                     stripes)
    print("HOST_RESULT " + json.dumps(results), flush=True)
    grid.close()
    dist.destroy_process_group()
    return 0


def _gridhost_io(grid, path: str, stripes: set) -> dict:
    """[gridhost]'s (2, 2) checks of the distributed I/O and bindings on
    one rank: its block of the slice's ChASE file (N = 30000) read with
    io.load_matrix_sharded and io.load_matrix_blockcyclic(mb = 64), each
    bitwise against the matching (permuted) block of H built on the card,
    with the native read alone timed first (bytes, seconds); then at
    GRIDHOST's Clement shape (N = 8192, nev 512, nex 256, f32, tol 0.1) on
    the kernel ring, interface.init_blockcyclic(64, 64) with the whole H
    and interface.init_dist_local with this rank's block, each with solve
    and get_eigenpairs at the Clement gates in the user's row order (the
    per-rank rows gathered over 'r'); the per-rank result through
    save_state(sharded=True) and load_state(grid=) (bitwise) and a warm
    start from it.  The interface is handed this grid by replacing
    interface._grid_for."""
    from types import SimpleNamespace
    import torch.distributed as dist
    import chase_tpu_torch as ct
    from chase_tpu_torch import _native, interface, io as cio
    from chase_tpu_torch.io import _even_block
    from chase_tpu_torch.parallel.layouts import BlockCyclicLayout
    N, dev = SLICE["N"], grid.device
    (r, c), (i, j) = (grid.size("r"), grid.size("c")), grid.coords
    (r0, rn), (c0, cn) = _even_block(N, r, i), _even_block(N, c, j)
    H = clement_on_device(N, dev)
    out = {}
    dist.barrier()
    t0 = time.perf_counter()
    _native.read_block(path, N, np.float32, r0, rn, c0, cn)
    out["native_s"] = time.perf_counter() - t0
    out["native_gb"] = rn * cn * 4 / 1e9
    dist.barrier()
    out["sharded_s"], Hd = timed(lambda: cio.load_matrix_sharded(
        path, N, np.float32, grid))
    out["sharded_bitwise"] = bool(torch.equal(Hd.to_local().to(dev),
                                              H[r0:r0 + rn, c0:c0 + cn]))
    del Hd
    perm = BlockCyclicLayout(N, 64, r, c).row_perm
    rows, cols = perm[r0:r0 + rn], perm[c0:c0 + cn]
    dist.barrier()
    t0 = time.perf_counter()
    _native.read_gather(path, N, np.float32, rows, cols)
    out["gather_s"] = time.perf_counter() - t0
    out["gather_gb"] = (int(rows.max() - rows.min()) + 1) * cn * 4 / 1e9
    dist.barrier()
    out["bc_read_s"], (Hb, _) = timed(lambda: cio.load_matrix_blockcyclic(
        path, N, np.float32, grid, 64))
    P = H.index_select(0, torch.as_tensor(rows, device=dev)).index_select(
        1, torch.as_tensor(cols, device=dev))
    out["bc_bitwise"] = bool(torch.equal(Hb.to_local().to(dev), P))
    del Hb, P, H
    torch.cuda.empty_cache()

    kind, N, nev, nex, tol, cfg = GRIDHOST["clement"]
    H = clement_on_device(N, dev)
    gate = clement_gate("gridhost", H, nev, 0.5, 10 * tol)
    interface._grid_for = lambda *a, **k: grid
    m, n = N // r, N // c

    def session(name, init, per_rank=False):
        stripes.clear()
        _zero_ring_counts()
        dist.barrier()

        def run():
            init()
            interface.set_tol(tol)
            return interface.solve(), interface.get_eigenpairs()
        tts, (rc, (ev, V)) = timed(run)
        V = torch.from_numpy(V).to(dev)
        if per_rank:
            V = grid.all_gather(V.contiguous(), "r")
        gate(SimpleNamespace(V=V, ritzv=ev, converged=rc == 0),
             f"{name}, rank {dist.get_rank()}")
        out[name] = dict(
            tts=tts, iterations=interface._require().result.iterations,
            ritzv=np.asarray(ev, np.float64).tobytes().hex(),
            launches=[_count("ring_hemm"), _count("tf32_split")],
            stripes=sorted(stripes))

    with ring_backend_env("pallas"):
        session("blockcyclic", lambda: interface.init_blockcyclic(
            N, nev, nex, 64, 64, H, grid_shape=(r, c)))
        session("dist_local", lambda: interface.init_dist_local(
            N, nev, nex, m, n, H[i * m:(i + 1) * m, j * n:(j + 1) * n],
            grid_shape=(r, c)), per_rank=True)
    s = interface._require()
    state = path + ".host_state"
    out["save_s"], _ = timed(lambda: cio.save_state(
        state, s.result.V, s.result.ritzv_full, sharded=True))
    out["load_s"], (V, ritzv, _) = timed(lambda: cio.load_state(state,
                                                                grid=grid))
    out["state_bitwise"] = (bool(torch.equal(V.to_local(),
                                             s.result.V.to_local()))
                            and np.array_equal(ritzv, s.result.ritzv_full))
    warm = ct.eigsh(s.op, nev, nex, tol=tol, v0=V, ritzv0=ritzv,
                    approx=True, config=ct.ChaseConfig(**cfg))
    gate(warm, "warm start from the sharded checkpoint")
    out["warm_iterations"] = warm.iterations
    interface.finalize()
    dist.barrier()
    if dist.get_rank() == 0:
        os.remove(state + ".npz")
        os.remove(state + ".V.bin")
    return out


def host_staged_grid(mesh, device):
    """A :class:`chase_tpu_torch.parallel.mesh.Grid2D` on ``mesh`` (a CPU
    mesh of a gloo group) whose tensors live on ``device``, a card that
    its ranks may share: its collectives copy CUDA tensors to pinned host
    memory, run gloo there and copy the result back."""
    import torch.distributed as dist
    from chase_tpu_torch.parallel.mesh import Grid2D

    def pinned(t):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return h.copy_(t)

    class _Staged:
        def __init__(self, work, recv, host):
            self.work, self.recv, self.host = work, recv, host

        def wait(self):
            self.work.wait()
            self.recv.copy_(self.host)

    class HostStagedGrid(Grid2D):
        """Grid2D with its collectives staged through pinned host memory
        (gloo): p ranks of one card, which NCCL refuses."""

        def all_reduce(self, t, axis, op=dist.ReduceOp.SUM):
            if t.device.type == "cpu" or self.size(axis) == 1:
                return super().all_reduce(t, axis, op)
            h = pinned(t)
            super().all_reduce(h, axis, op)
            return t.copy_(h)

        def sum_rows(self, t):
            if t.device.type == "cpu":
                return super().sum_rows(t)
            h = pinned(t)
            super().sum_rows(h)
            return t.copy_(h)

        def all_gather(self, t, axis="r"):
            if t.device.type == "cpu" or self.size(axis) == 1:
                return super().all_gather(t, axis)
            return super().all_gather(pinned(t), axis).to(t.device)

        def rotate_rows(self, t, shift, axis="r"):
            if t.device.type == "cpu" or self.size(axis) == 1:
                return super().rotate_rows(t, shift, axis)
            return super().rotate_rows(pinned(t), shift, axis).to(t.device)

        def exchange(self, axis="r"):
            swap = super().exchange(axis)

            def staged(send, recv):
                host = torch.empty(recv.shape, dtype=recv.dtype,
                                   pin_memory=True)
                return _Staged(swap(pinned(send), host), recv, host)
            return staged

        def reduce_scatter(self, t, axis):
            if t.device.type == "cpu" or self.size(axis) == 1:
                return super().reduce_scatter(t, axis)
            return super().reduce_scatter(pinned(t.contiguous()),
                                          axis).to(t.device)

        def flip(self, t, to):
            if t.device.type == "cpu":
                return super().flip(t, to)
            h = pinned(t.contiguous())
            out = super().flip(h, to)
            return t if out is h else out.to(t.device)

    return HostStagedGrid(mesh, device)


def _run_ranks(phase: str, entry: str, r: int, prefix: str,
               timeout: float = 300, **env) -> list:
    """The r ranks of a (r, 1) grid as child processes running
    ``chip_smoke.<entry>()`` (torchrun's variables for cards 0…r−1, a
    loopback rendezvous), each killed after ``timeout`` seconds; each
    rank's ``prefix`` line parsed (rank order), its other last lines
    logged."""
    port = free_port()
    cmd = [sys.executable, "-c",
           f"import sys, chip_smoke; sys.exit(chip_smoke.{entry}())"]
    with tempfile.TemporaryDirectory(prefix="chase_grid_") as tmp:
        logs = [open(os.path.join(tmp, f"rank{k}.log"), "w+")
                for k in range(r)]
        procs = [subprocess.Popen(cmd, cwd=ROOT, env=child_env(
            **torchrun_env(k, r, port, **env)), stdout=logs[k],
            stderr=subprocess.STDOUT, text=True) for k in range(r)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    for k, text in enumerate(outs):
        for line in text.splitlines()[-8:]:
            if not line.startswith(prefix):
                log(phase, f"  rank {k}: {line}")
    codes = [p.returncode for p in procs]
    found = [[ln for ln in text.splitlines() if ln.startswith(prefix + " ")]
             for text in outs]
    if any(codes) or not all(found):
        raise AssertionError(f"{phase}: ranks exited {codes}")
    return [json.loads(f[-1][len(prefix) + 1:]) for f in found]


def _per_iteration(out: dict) -> dict:
    """The collectives a grid solve issued, (calls, bytes) per
    iteration, by kind."""
    n = max(out["iterations"], 1)
    return {k: (round(c / n, 2), round(b / n))
            for k, (c, b) in out["collectives"].items()}


def _grid_line(what: str, out: dict, ref=None) -> str:
    """One solve of a grid child, beside the one-device phase's warm
    (TTS, iterations) ``ref``."""
    line = (f"{what}: {out['iterations']} iterations, TTS cold "
            f"{out['tts_cold']:.3f} s, warm "
            f"{out['tts']:.3f} s")
    if ref is not None:
        line += (f" (one device: {ref[1]} iterations, warm {ref[0]:.3f} s, "
                 f"{out['tts'] / ref[0] - 1:+.1%})")
    if "per_iter" in out:
        line += f"; {out['per_iter']:.2f} host syncs per iteration"
    return (line + f"; {LAUNCH_NAMES} "
            f"{out['launches']}, HEMM steps {out['hemm_steps']}; "
            f"collectives per iteration (calls, bytes) "
            f"{_per_iteration(out) or 'none'}")


def _grid_io_line(out: dict) -> str:
    """:func:`_grid_io`'s numbers, one line."""
    gb = out["read_gb"]
    return (f"sharded I/O: this rank's {gb:.2f} GB block, the native read "
            f"alone {out['native_s']:.3f} s ({gb / out['native_s']:.2f} "
            f"GB/s), "
            f"then load_matrix_sharded {out['read_s']:.3f} s "
            f"({gb / out['read_s']:.2f} GB/s, read + placement on the "
            f"card), bitwise {out['bitwise']}; eigsh of the DTensor: "
            f"TTS {out['tts']:.3f} s, {out['iterations']} iterations, "
            f"{LAUNCH_NAMES} {out['launches']}, HEMM steps {out['hemm_steps']}; "
            f"save_state(sharded=True) {out['save_s']:.3f} s, "
            f"load_state(grid=) {out['load_s']:.3f} s, bitwise "
            f"{out['state_bitwise']}; warm start from it: TTS "
            f"{out['warm_tts']:.3f} s, {out['warm_iterations']} iterations; "
            f"interface.init_blockcyclic(mb=nb=64) + solve + "
            f"get_eigenpairs {out['bc_tts']:.3f} s, {out['bc_iterations']} "
            f"iterations, main kernel launches {out['bc_launches'][0]}")


def phase_grid1(refs: dict, path: str) -> None:
    """[grid_child] on an NCCL (1, 1) grid in a child process with
    torchrun's variables at WORLD_SIZE=1: each solve at its one-device
    phase's gates, its iteration count and its warm TTS within ±5% of
    the phase's (``refs``: name → (warm TTS, iterations)), no collective
    issued; the slice's sharded I/O from the ChASE file at ``path``
    (:func:`_grid_io`)."""
    t0 = time.perf_counter()
    out = _run_ranks("grid1", "grid_child", 1, "GRID_RESULT", 540,
                     GRID_R="1", CHASE_SMOKE_FILE=path)[0]
    log("grid1", f"{out['wiring']}; init_grid {out['init_s']:.2f} s")
    log("grid1", _grid_io_line(out["io"]))
    if not out["io"]["ok"]:
        raise AssertionError("grid1: the sharded I/O checks failed")
    bad = []
    for name, what in (("slice", "f32 slice (eigsh)"),
                       ("fslice", "eigsh_fused at [fslice]'s shape"),
                       ("pseudo", "f64 BSE ladder (eigsh_pseudo)"),
                       ("fpseudo", "eigsh_pseudo_fused at [fpseudo]'s "
                                   "shape")):
        o, ref = out[name], refs[name]
        log("grid1", _grid_line(f"{what} on the (1, 1) grid", o, ref))
        if (o["iterations"] != ref[1] or abs(o["tts"] / ref[0] - 1) > 0.05
                or o["collectives"]):
            bad.append(name)
    # the chunk ring's model (probes/grid_collectives.py checks it on
    # the CPU): each rank sends (p − 1)/p · N · 4 bytes per executed
    # filter column-step
    sl = out["slice"]
    its = max(sl["iterations"], 1)
    sent = [(p, (p - 1) / p * SLICE["N"] * 4 * sl["executed"] / its)
            for p in GRID_P]
    model = ", ".join(f"p={p}: {nb / 1e9:.2f} GB per iteration and rank, "
                      f"{nb / (NVLINK_GBS * 1e6):.0f} ms at "
                      f"{NVLINK_GBS:.0f} GB/s" for p, nb in sent)
    log("grid1", f"the slice's chunk ring on a (p, 1) grid, from its "
                 f"{sl['executed']} executed filter column-steps (a model, "
                 f"not measured): {model}; "
                 f"{time.perf_counter() - t0:.2f} s")
    if bad:
        raise AssertionError(f"grid1: {bad} differ from their one-device "
                             f"phase in iterations or warm TTS (±5%) or "
                             f"issued collectives")


def _c_dist_demo(name: str, world: int, passed: str) -> float:
    """The unchanged examples/<name>.c compiled against the C ABI library
    and run as ``world`` ranks of an NCCL group (torchrun's variables and
    JAX_PROCESS_ID, one card each); every rank must print ``passed``.
    Returns the seconds of the run."""
    from chase_tpu_torch import _native
    lib = _native.build_capi()
    d = os.path.dirname(lib)
    exe = os.path.join(d, name)
    subprocess.run(["cc", "-O2", str(ROOT / "examples" / f"{name}.c"), "-L",
                    d, "-lchase_tpu_torch", "-lm", f"-Wl,-rpath,{d}", "-o",
                    exe], check=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([exe], cwd=ROOT, env=child_env(
        **torchrun_env(k, world, port, JAX_PROCESS_ID=str(k))),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dt = time.perf_counter() - t0
    for k, text in enumerate(outs):
        for line in text.splitlines()[-4:]:
            log("gridnccl", f"  {name} rank {k}: {line}")
    if any(p.returncode for p in procs) or not all(passed in o
                                                   for o in outs):
        raise AssertionError(f"gridnccl: {name} failed on {world} ranks")
    return dt


def phase_gridnccl(dev, path: str) -> None:
    """[grid_child] on a (p, 1) NCCL grid, p = min(cards, 4) — only on a
    machine with two cards or more — with the sharded I/O of the file at
    ``path``; the unchanged examples/c_dist_2proc_demo.c on two ranks;
    with four cards or more, GRIDHOST_2D's solves on a (2, 2) NCCL grid
    too (:func:`host_child` on NCCL, [gridhost]'s checks) and
    examples/c_dist_interface_demo.c on four ranks."""
    count = torch.cuda.device_count()
    if count < 2:
        log("gridnccl", f"not run: {count} device")
        return
    p = min(count, 4)
    t0 = time.perf_counter()
    out = _run_ranks("gridnccl", "grid_child", p, "GRID_RESULT", 600,
                     GRID_R=str(p), CHASE_SMOKE_FILE=path)[0]
    for name in ("slice", "fslice", "pseudo", "fpseudo"):
        log("gridnccl", _grid_line(f"{name} on the ({p}, 1) NCCL grid "
                                   f"(rank 0)", out[name]))
    log("gridnccl", _grid_io_line(out["io"]))
    if not out["io"]["ok"]:
        raise AssertionError("gridnccl: the sharded I/O checks failed")
    dt = _c_dist_demo("c_dist_2proc_demo", 2, "C-dist-2proc demo: PASS")
    log("gridnccl", f"c_dist_2proc_demo on 2 NCCL ranks: PASS in "
                    f"{dt:.2f} s")
    if count >= 4:
        ranks = _run_ranks("gridnccl", "host_child", 4, "HOST_RESULT", 600,
                           GRIDHOST_SHAPE="2,2", GRID_BACKEND="nccl",
                           CHASE_SMOKE_FILE=path)
        ref = _one_device_refs(dev, GRIDHOST_2D)
        bad = _check_grid_solves("gridnccl", (2, 2), ranks, GRIDHOST_2D,
                                 ref, False)
        bad += _check_host_io("gridnccl", ranks, ref)
        if bad:
            raise AssertionError(f"gridnccl: {bad} failed their gates")
        dt = _c_dist_demo("c_dist_interface_demo", 4,
                          "C-dist-interface demo: PASS")
        log("gridnccl", f"c_dist_interface_demo on 4 NCCL ranks: PASS in "
                        f"{dt:.2f} s")
    log("gridnccl", f"{time.perf_counter() - t0:.2f} s")


# [gridhost]'s solves: name → (matrix, N, nev, nex, tol, config); "slice"
# is the f32 slice at full width on (2, 1) (not on the 2-D grid)
GRIDHOST = {
    "slice": ("clement", SLICE["N"], SLICE["nev"], SLICE["nex"],
              SLICE["tol"], dict(ring_backend="pallas",
                                 mixed_precision=False)),
    "clement": ("clement", 8192, 512, 256, 0.1,
                dict(ring_backend="pallas", mixed_precision=False)),
    "clement_fused": ("clement", 8192, 512, 256, 0.1,
                      dict(ring_backend="pallas", mixed_precision=False)),
    "bse": ("bse", 8192, 256, 128, 1e-10,
            dict(ring_backend="pallas", mixed_precision=True)),
    "bse_fused": ("bse", 8192, 256, 128, 1e-10,
                  dict(ring_backend="pallas", mixed_precision=True)),
}
# its 2-D grid's: the host drivers, which take the 2-D ring (the fused
# solvers take dist.hemm on such a grid)
GRIDHOST_2D = {name: GRIDHOST[name] for name in ("clement", "bse")}


def _one_device_refs(dev, solves: dict) -> dict:
    """name → (TTS, iterations) of each solve on one device."""
    import chase_tpu_torch as ct
    ref = {}
    for name, (kind, N, nev, nex, tol, cfg) in solves.items():
        H = (clement_on_device(N, dev) if kind == "clement"
             else structured_bse_on_device(N, dev)[0])
        solve = {("clement", False): ct.eigsh,
                 ("clement", True): ct.eigsh_fused,
                 ("bse", False): ct.eigsh_pseudo,
                 ("bse", True): ct.eigsh_pseudo_fused}[
            (kind, "fused" in name)]
        tts, res = timed(lambda: solve(H, nev, nex, tol=tol, device=dev,
                                       config=ct.ChaseConfig(**cfg)))
        ref[name] = (tts, res.iterations)
        del H, res
        torch.cuda.empty_cache()
    return ref


def _check_grid_solves(phase: str, shape: tuple, ranks: list, solves: dict,
                       ref: dict, shared: bool) -> list:
    """Each solve of the ranks' HOST_RESULT lines: iterations within ±1
    of one device's, ritzv, resid, iterations and locked bitwise equal on
    every rank; on an (r, 1) grid one ring_hemm_peers, peer_gather and
    peer_publish launch per HEMM step and rank, no ring_hemm step, each
    product counted under "peer" and no NCCL chunk exchange ("sendrecv");
    on (2, 2) ring_hemm (and tf32_split) launches = 2 per HEMM step (r =
    c = 2), none on the peer route; every launch on a block's stripe: N/r
    rows, col0 a multiple of N/(r·c) below N/c (0 for a whole stripe), of
    one operator (the filter's; on the 2-D ring ring_B's launches read it
    on the trans route, none off it); each rank's peak device memory
    around the solve logged.  Returns the failed names."""
    r, c = shape
    bad = []
    what = (f"{r * c} ranks sharing the card, host-staged gloo "
            f"collectives (times not performance numbers)" if shared
            else "NCCL, one card per rank")
    for name, (kind, N, nev, nex, tol, cfg) in solves.items():
        o = [rk[name] for rk in ranks]
        same = all(x[k] == o[0][k] for x in o
                   for k in ("ritzv", "resid", "iterations", "locked"))
        stripes = {tuple(x) for rk in o for x in rk["stripes"]}
        nch = N // (r * c)
        allowed = {(N // r, q * nch) for q in range(max(r, c))}
        on_stripes = stripes <= allowed and all(
            rk["operators"] == 1 and (rk["trans"] > 0) == (c > 1)
            for rk in o)
        launches = [rk["launches"] for rk in o]

        def counted(ln, rk):
            steps = rk["hemm_steps"]
            if c > 1:
                return ln[0] == ln[1] == 2 * steps > 0 and not any(ln[2:])
            coll = rk["collectives"]
            return (ln[0] == ln[1] == 0 and ln[2] == ln[3] == ln[4] ==
                    steps > 0 and "sendrecv" not in coll
                    and coll.get("peer", [0])[0] == steps)

        ok = (same and on_stripes
              and abs(o[0]["iterations"] - ref[name][1]) <= 1
              and all(counted(ln, rk) for ln, rk in zip(launches, o)))
        log(phase, f"{name} ({kind} N={N} nev={nev} nex={nex} tol={tol}, "
                   f"{cfg}) on a {shape} grid, {what}: iterations "
                   f"{[rk['iterations'] for rk in o]} (one device "
                   f"{ref[name][1]}), TTS "
                   f"{[round(rk['tts'], 3) for rk in o]} s (one device "
                   f"{ref[name][0]:.3f} s); results bitwise equal on all "
                   f"{len(o)} ranks: {same}; ring_hemm / tf32_split / "
                   f"ring_hemm_peers / peer_gather / peer_publish "
                   f"launches {launches} (on the trans route "
                   f"{[rk['trans'] for rk in o]}), HEMM steps "
                   f"{[rk['hemm_steps'] for rk in o]}; launch (rows, col0) "
                   f"{sorted(stripes)} on {[rk['operators'] for rk in o]} "
                   f"operators; peak device memory per rank "
                   f"{[round(rk['peak_mib'], 1) for rk in o]} MiB; rank 0's "
                   f"collectives per iteration {_per_iteration(o[0])}")
        if not ok:
            bad.append(f"{shape} {name}")
    return bad


def _check_host_io(phase: str, ranks: list, ref: dict) -> list:
    """:func:`_gridhost_io`'s results of the (2, 2) ranks: every block
    and checkpoint bitwise, the warm start in no more iterations than the
    per-rank solve, each interface solve's ritzv bitwise equal on all
    ranks, its ring_hemm (and tf32_split) launches equal and above 0 on
    every rank, every launch on a 2-D ring stripe (N/2 rows, col0 0 or
    N/4); the per-rank read numbers logged.  Returns the failed names."""
    bad = []
    io = [rk["io"] for rk in ranks]
    for k, o in enumerate(io):
        rate, grate = (o["native_gb"] / o["native_s"],
                       o["gather_gb"] / o["gather_s"])
        log(phase, f"rank {k}: native read of its block {o['native_gb']:.2f} "
                   f"GB in {o['native_s']:.3f} s ({rate:.2f} GB/s), "
                   f"load_matrix_sharded {o['sharded_s']:.3f} s (read + "
                   f"placement), bitwise {o['sharded_bitwise']}; "
                   f"block-cyclic (mb=64): one native gather reading each "
                   f"of its columns' row span, {o['gather_gb']:.2f} GB in "
                   f"{o['gather_s']:.3f} s ({grate:.2f} GB/s), "
                   f"load_matrix_blockcyclic {o['bc_read_s']:.3f} s, bitwise "
                   f"{o['bc_bitwise']}")
        if not (o["sharded_bitwise"] and o["bc_bitwise"]
                and o["state_bitwise"]
                and o["warm_iterations"] <= o["dist_local"]["iterations"]):
            bad.append(f"io rank {k}")
    kind, N, nev, nex, tol, cfg = GRIDHOST["clement"]
    allowed = {(N // 2, 0), (N // 2, N // 4)}
    for name in ("blockcyclic", "dist_local"):
        o = [x[name] for x in io]
        same = all(x["ritzv"] == o[0]["ritzv"] for x in o)
        launches = [x["launches"] for x in o]
        on_ring = all({tuple(st) for st in x["stripes"]} <= allowed
                      for x in o)
        log(phase, f"interface {name} (Clement N={N} nev={nev} nex={nex} "
                   f"tol={tol}, the 2-D ring): iterations "
                   f"{[x['iterations'] for x in o]} (one device "
                   f"{ref['clement'][1]}), TTS "
                   f"{[round(x['tts'], 3) for x in o]} s; ritzv bitwise "
                   f"equal on all ranks: {same}; ring_hemm / tf32_split "
                   f"launches {launches}, every launch on a 2-D stripe "
                   f"{sorted(allowed)}: {on_ring}")
        if not (same and on_ring and all(ln == launches[0] for ln in launches)
                and launches[0][0] == launches[0][1] > 0):
            bad.append(f"interface {name}")
    log(phase, f"per-rank result through save_state(sharded=True) "
               f"{[round(x['save_s'], 3) for x in io]} s and "
               f"load_state(grid=) {[round(x['load_s'], 3) for x in io]} s, "
               f"bitwise {[x['state_bitwise'] for x in io]}; warm start "
               f"{[x['warm_iterations'] for x in io]} iterations (cold "
               f"{[x['dist_local']['iterations'] for x in io]})")
    return bad


def phase_gridhost(dev, path: str) -> None:
    """p ranks sharing card 0 on a grid of HostStagedGrid (gloo through
    pinned host memory; not NCCL): a (2, 1) grid running GRIDHOST's
    solves (the host and fused drivers, and the f32 slice at full width;
    every (p, 1) ring product on ring_hemm_peers, the ranks' chunks pulled
    over CUDA IPC, the other collectives host-staged), then a (2, 2) grid of
    four ranks running GRIDHOST_2D's (the 2-D ring: ring_A on each rank's
    block, ring_B on its trans route), each at its gates, checked by
    :func:`_check_grid_solves` against the same solves on one device,
    run here first; the (2, 2) ranks then read their blocks of the ChASE
    file at ``path`` and solve through the distributed interface
    (:func:`_gridhost_io`, :func:`_check_host_io`).  The times are of
    ranks sharing one card with host-staged collectives: not performance
    numbers."""
    t0 = time.perf_counter()
    ref = _one_device_refs(dev, GRIDHOST)
    bad = []
    for shape, solves in (((2, 1), GRIDHOST), ((2, 2), GRIDHOST_2D)):
        t1 = time.perf_counter()
        n = shape[0] * shape[1]
        ranks = _run_ranks("gridhost", "host_child", n, "HOST_RESULT", 420,
                           GRIDHOST_SHAPE=f"{shape[0]},{shape[1]}",
                           CHASE_SMOKE_FILE=path)
        bad += _check_grid_solves("gridhost", shape, ranks, solves, ref,
                                  True)
        if shape[1] > 1:
            bad += _check_host_io("gridhost", ranks, ref)
        log("gridhost", f"{shape}: {time.perf_counter() - t1:.2f} s")
    log("gridhost", f"{time.perf_counter() - t0:.2f} s")
    if bad:
        raise AssertionError(f"gridhost: {bad} failed their gates")


def _kernel_entry(name: str, launches: int, case: dict,
                  source: str = "chase_tpu_torch/csrc/ring_hemm.cu") -> dict:
    return dict(name=name, route="cuda", source=source,
                replaces="chase_tpu/ops/pallas_ring.py:34",
                launches=launches, max_abs_err=case["abs_err"],
                ms=case["ms"], plain_ms=case["plain_ms"],
                bound_ms=case["bound_ms"], bound_by=case["bound_by"],
                library_ms=case["library_ms"])


PEER_KERNELS = (("ring_hemm_peers", "product",
                 "chase_tpu_torch/csrc/ring_hemm.cu"),
                ("peer_gather", "gather", "chase_tpu_torch/csrc/ring_peers.cu"),
                ("peer_publish", "publish",
                 "chase_tpu_torch/csrc/ring_peers.cu"))


def peer_entries(rings: dict, tag: str) -> list:
    """The kernels-line entries of [gridring]'s (p, 1) peer products
    (``rings``: route → (p, k) → :func:`_peer_cases`' cases): the
    product (its main kernel's launches), the gather and the publish."""
    return [_kernel_entry(f"{name}[{route}{tag} p={p} k={k}]",
                          cases[kind]["launches"], cases[kind], source)
            for route, by_shape in rings.items()
            for (p, k), cases in by_shape.items()
            for name, kind, source in PEER_KERNELS]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this check "
              "needs an NVIDIA GPU and has no CPU fallback", file=sys.stderr)
        return 2
    import chase_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    info = phase_device()
    phase_build()
    kern = phase_kernel(dev)
    t0 = time.perf_counter()
    H = clement_on_device(SLICE["N"], dev)
    torch.cuda.synchronize()
    log("setup", f"Clement N={SLICE['N']} built on the card in "
                 f"{time.perf_counter() - t0:.2f} s")
    phase_filter(dev, H)
    launches = phase_slice(dev, H)
    warm = phase_profile(dev, H)
    Hr = dense_on_device(SLICE["N"], dev, torch.float32)
    gring = {route: phase_gridring(dev, Hr, route) for route in ("f32",
                                                                "bf16")}
    gring2d = {route: phase_gridring2d(dev, Hr, route)
               for route in ("f32", "bf16")}
    del Hr, H
    torch.cuda.empty_cache()
    # the slice's ChASE file, written by [io] and kept until [gridhost]
    with tempfile.TemporaryDirectory(prefix="chase_smoke_") as tmp:
        return _phases_from_io(dev, info, kern, launches, warm, gring,
                               gring2d, tmp, t_all)


def _phases_from_io(dev, info, kern, launches, warm, gring, gring2d, tmp,
                    t_all) -> int:
    """main() from [io] on, the slice's ChASE file in ``tmp``; the slice's
    H is built again (main drops its copy, so that no frame holds it
    through the later phases)."""
    H = clement_on_device(SLICE["N"], dev)
    path = os.path.join(tmp, f"clement{SLICE['N']}_f32.bin")
    phase_io(dev, H, path)
    phase_cli(dev, path, warm["pallas"])
    phase_capi(dev, path, warm["pallas"])
    fslice = phase_fused_clement(dev, H, "fslice", SLICE["nev"],
                                 SLICE["nex"], SLICE["tol"],
                                 (warm["pallas"], warm["pallas_iterations"]))
    bkern = phase_bf16_kernel(dev)
    blaunches = phase_bslice(dev, H, warm["pallas"])
    phase_fused_clement(dev, H, "fbslice", SLICE["nev"], SLICE["nex"],
                        SLICE["tol"], (blaunches["tts"],
                                       blaunches["iterations"]), bf16=True)
    del H
    torch.cuda.empty_cache()
    for phase, N, nev, nex, tol in FUSED_CLEMENT:
        phase_fused_clement(dev, clement_on_device(N, dev), phase, nev, nex,
                            tol)
    torch.cuda.empty_cache()

    ckern = phase_complex_kernel(dev)
    t0 = time.perf_counter()
    H = clement_on_device(SLICE["N"], dev, torch.complex64)
    torch.cuda.synchronize()
    log("setup", f"phase-rotated Clement N={SLICE['N']} c64 built on the "
                 f"card in {time.perf_counter() - t0:.2f} s")
    claunches = phase_slice(dev, H, "cslice")
    phase_profile(dev, H, "cprofile")
    del H
    torch.cuda.empty_cache()
    _, N, nev, nex, tol = FUSED_CLEMENT[1]            # fmid's shape in c64
    phase_fused_clement(dev, clement_on_device(N, dev, torch.complex64),
                        "fcmid", nev, nex, tol)
    torch.cuda.empty_cache()
    H = dense_on_device(SLICE["N"], dev, torch.complex64)
    gring["c64"] = phase_gridring(dev, H, "c64")
    gring2d["c64"] = phase_gridring2d(dev, H, "c64")
    del H
    torch.cuda.empty_cache()

    H, dp_tts = phase_north_star(dev)
    phase_fladder(dev, H, phase_ladder(dev, H, dp_tts))
    del H
    torch.cuda.empty_cache()
    phase_sequence(dev)

    t0 = time.perf_counter()
    H, lam = structured_bse_on_device(BSE["N"], dev)
    H32 = H.float()
    torch.cuda.synchronize()
    log("setup", f"structured BSE N={BSE['N']} (f64, and its f32 copy) "
                 f"built on the card in {time.perf_counter() - t0:.2f} s")
    h2ring, h2ring2d = {}, {}
    for route in ("f32", "bf16"):
        ctx = phase_pfilter(dev, H32, lam, route)
        h2ring[route] = phase_gridring_h2(dev, ctx, route)
        h2ring2d[route] = phase_gridring2d_h2(dev, ctx, route)
        del ctx
        torch.cuda.empty_cache()
    phase_fbpseudo(dev, H32, H, lam, phase_bpseudo(dev, H32, H, lam))
    del H32
    torch.cuda.empty_cache()
    ladder = phase_pseudo(dev, H, lam)
    fpseudo = phase_fpseudo(dev, H, lam, ladder)
    t0 = time.perf_counter()
    Hc = complex_bse_on_device(H)
    del H
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log("setup", f"H_c = D·H·D⁻¹ (c128) built on the card in "
                 f"{time.perf_counter() - t0:.2f} s")
    ctx = phase_pfilter(dev, Hc, lam, "c64")
    h2ring["c64"] = phase_gridring_h2(dev, ctx, "c64")
    h2ring2d["c64"] = phase_gridring2d_h2(dev, ctx, "c64")
    del ctx
    torch.cuda.empty_cache()
    phase_zpseudo(dev, Hc, lam)
    del Hc
    torch.cuda.empty_cache()
    phase_zfused(dev)
    phase_examples()

    phase_grid1({"slice": (warm["pallas"], launches["iterations"]),
                 "fslice": (fslice["warm"], fslice["iterations"]),
                 "pseudo": (ladder["tts"], ladder["iterations"]),
                 "fpseudo": (fpseudo["warm"], fpseudo["iterations"])}, path)
    phase_gridnccl(dev, path)
    phase_gridhost(dev, path)

    big, cbig = kern[KERNEL_SHAPES[-1]], ckern[C64_SHAPES[-1]]
    print(json.dumps({"kernels": [
        _kernel_entry("ring_hemm", launches["ring_hemm"], big),
        _kernel_entry("tf32_split", launches["prepass"], kern["split"]),
        _kernel_entry("ring_hemm[c64]", claunches["ring_hemm"], cbig),
        _kernel_entry("tf32_split[c64]", claunches["prepass"],
                      ckern["split"]),
        _kernel_entry("ring_hemm[bf16]", blaunches["ring_hemm"],
                      bkern[(SLICE["N"], 3000)]),
        _kernel_entry("bf16_pack", blaunches["prepass"], bkern["pack"])]
        + peer_entries(gring, "")
        + peer_entries(h2ring, " H²")
        + ring2d_entries(gring2d, "") + ring2d_entries(h2ring2d, " H²")}),
          flush=True)
    log("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
