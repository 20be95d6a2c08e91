"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives chase_tpu_torch's main paths on the card and fails (non-zero exit,
no result line) on any fault:

  device   require CUDA; print the card's name and power limit
  build    compile the port's CUDA kernels from csrc/ (nvcc, sm_90a)
  kernel   ring_hemm (TMA + wgmma, 3xTF32) against its plain version
           (torch.matmul) at the filter's shapes, both held against an f64
           product at (N, k) = (1000, 37), (30000, 750/1500/2250/3000),
           timed, with TFLOP/s and the share of the 165 TFLOP/s 3xTF32
           ceiling; its TF32 split pre-pass against its plain
           version (bit-exact); a strided window, a two-chunk ring step and
           an N=1001 operator whose row stride DenseOperator pads to 1004
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
           and accumulate) with an in-memory exchange standing in for
           NCCL, on the f32 and bf16 routes here (k = 3000; 1500 too for
           bf16) and on the c64 route after cprofile; H·V against a wide
           product per rank and the plain version's loop at the kernel
           gate, launches = p² per ring run; one stripe call (N/p, N/p, k)
           timed beside its plain version, the library call and its
           bound; the pre-pass of a received chunk beside what sending
           the chunk in the pre-pass's layout would add (f32, c64: hi and
           lo) or save (bf16: half the bytes) at 450 GB/s of NVLink
  grid1    a child process with torchrun's variables at WORLD_SIZE=1:
           multihost.init_grid() on NCCL, the grid's collectives once
           (all_reduce f32 and c64, all_gather_into_tensor, broadcast),
           then the f32 slice on the (1, 1) grid with ring_backend=
           "pallas", cold and warm: [slice]'s gates and iteration count,
           ring_hemm launches = the filter's HEMM steps, the collectives
           issued per iteration, the warm TTS beside [profile]'s
  gridnccl with two cards or more, p = min(cards, 4) ranks solve the f32
           slice on a (p, 1) NCCL grid with the same gates (each rank's
           ring_hemm launches = p × its HEMM steps); with one card it
           prints "not run: 1 device" and counts nothing as passed
  io       the slice's H written with io.save_matrix to a ChASE file in a
           temporary directory (removed at the end of capi), read back by
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
  ckernel  complex64 ring_hemm (the f32 kernel on the float views, with
           the complex pre-pass) against its plain version (complex
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
           bit-exact
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
           launches = 2·10, degree-0 columns bit-exact
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
           (torch.cuda.set_sync_debug_mode, at most 3) and, on the kernel
           ring, ring_hemm and pre-pass launches against the solver's HEMM
           steps (equal); the phase's gates hold for both solvers

Each phase prints lines with its numbers and seconds.  A full run then
prints the kernels' JSON summary and, last, {"ok": true, "device": {...}}.
There is no CPU fallback: without a GPU the script exits non-zero before
any phase.
"""

from __future__ import annotations

import contextlib
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
PEAK_3XTF32 = 495.0 / 3     # TFLOP/s: the H100's dense TF32 rate, 3 passes
PEAK_BF16 = 989.0           # TFLOP/s: the H100's dense bf16 rate
HBM_TBS = 3.35              # TB/s: the H100 SXM's device-memory rate


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


def bound(flop: float, nbytes: float, peak: float = PEAK_3XTF32) -> tuple:
    """(ms, "operations" | "bytes"): the least time the card could take —
    the larger of the operations over ``peak`` TFLOP/s (the 3xTF32 ceiling
    of the kernels' f32-accuracy route, or the bf16 rate) and the bytes
    over HBM's rate."""
    t_ops = flop / (peak * 1e9)
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
    return bound(2.0 * m * b * k, 2 * m * b + 4 * (b * k + m * k), PEAK_BF16)


def pack_bound(b: int, k: int) -> tuple:
    """The bf16 pre-pass's bound: V (b × k) f32 read once, the (w_pad ×
    b_pad) bf16 output written once."""
    from chase_tpu_torch.ops.ring_hemm import pack_shape
    b_pad, w_pad = pack_shape(b, k)
    return bound(0.0, 4 * b * k + 2 * w_pad * b_pad)


def split_bound(b: int, k: int, dtype) -> tuple:
    """The pre-pass's bound: V read once, the (2, w_pad, b_pad) f32 output
    written once (of the real (2b × 2k) B for complex V)."""
    from chase_tpu_torch.ops.ring_hemm import split_shape
    w = dtype.itemsize // 4                  # floats per element
    b_pad, w_pad = split_shape(w * b, w * k)
    return bound(0.0, dtype.itemsize * b * k + 8 * w_pad * b_pad)


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


def phase_build() -> float:
    from chase_tpu_torch import _build
    t0 = time.perf_counter()
    _build.load_library("ring_hemm")
    dt = time.perf_counter() - t0
    release = subprocess.run([_build.nvcc_path(), "--version"],
                             capture_output=True, text=True).stdout
    release = [ln for ln in release.splitlines() if "release" in ln]
    log("build", f"ring_hemm built and loaded in {dt:.2f} s "
                 f"(nvcc {_build.nvcc_path()}: "
                 f"{release[0].strip() if release else 'version unknown'}; "
                 f"{_build.BUILD_DIR})")
    for line in _build.build_log("ring_hemm").splitlines():
        if "registers" in line or "spill" in line or "Function" in line:
            log("build", line.strip())
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
               f"{rate / PEAK_3XTF32:.1%} of the {PEAK_3XTF32:.0f} TFLOP/s "
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
    hi + lo within 2^-22 of the matrix it splits; timed."""
    from chase_tpu_torch.ops.ring_hemm import (real_rows, tf32_split,
                                               tf32_split_reference)
    b, k = V.shape
    Vt, Vr = tf32_split(V), tf32_split_reference(V)
    torch.cuda.synchronize()
    split_err = float((Vt - Vr).abs().max())
    B = real_rows(V) if V.is_complex() else V
    rebuild = float(((Vt[0] + Vt[1])[:B.shape[1], :B.shape[0]] - B.T)
                    .abs().max() / B.abs().max())
    del Vt, Vr, B
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
    del H, H64, Hs
    torch.cuda.empty_cache()

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
    before = ring_hemm.launches
    try:
        ring_hemm(torch.as_tensor(H1, device=dev), V)
        refused = False
    except ValueError:
        refused = ring_hemm.launches == before
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
    del H, H128, Hs
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
               f"({rate:.1f} TFLOP/s, {rate / PEAK_BF16:.1%} of the "
               f"{PEAK_BF16:.0f} TFLOP/s bf16 peak), plain {plain_ms:.3f} "
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

    # the pre-pass alone at (30000, 3000): bit-exact against V.to(bf16)
    Vb, Vr = bf16_pack(V), bf16_pack_reference(V)
    torch.cuda.synchronize()
    exact = bool(torch.equal(Vb, Vr))
    del Vb, Vr
    pk_plain, pk_ms = time_fns([lambda: bf16_pack_reference(V),
                                lambda: bf16_pack(V)], 3)
    pk_bound, pk_by = pack_bound(N, 3000)
    log("bkernel", f"bf16_pack ({N}, 3000): bit-exact against "
                   f"V.to(bfloat16): {exact}; kernel {pk_ms:.3f} ms, plain "
                   f"{pk_plain:.3f} ms, bound {pk_bound:.3f} ms ({pk_by})")
    if not exact:
        raise AssertionError("bf16_pack disagrees with V.to(bfloat16)")
    summary["pack"] = dict(abs_err=0.0, ms=pk_ms, plain_ms=pk_plain,
                           library_ms=None, bound_ms=pk_bound,
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
    del H, Hs, Vfull, Wfull, Wbefore, ref
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
    from chase_tpu_torch.ops.ring_hemm import bf16_pack, ring_hemm, tf32_split
    N, nev, nex, tol = SLICE["N"], SLICE["nev"], SLICE["nex"], SLICE["tol"]
    cfg = ct.ChaseConfig(ring_backend="pallas", bf16_filter=bf16,
                         mixed_precision=False)
    torch.cuda.reset_peak_memory_stats(dev)
    ring_hemm.launches = tf32_split.launches = bf16_pack.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ct.eigsh(H, nev, nex, tol=tol, config=cfg, device=dev,
                   collect_perf=True)
    torch.cuda.synchronize()
    tts = time.perf_counter() - t0
    launches = ring_hemm.launches
    # the pre-pass of the route the slice runs, and the other one's
    split_launches, other = tf32_split.launches, bf16_pack.launches
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
               f"{perf.filter_hemm_steps}; low-precision FLOP share "
               f"{low:.3f}; peak device memory {peak:.1f} GiB")
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


def _ring_counts() -> tuple:
    from chase_tpu_torch.ops.ring_hemm import bf16_pack, ring_hemm, tf32_split
    return ring_hemm.launches, tf32_split.launches, bf16_pack.launches


def _zero_ring_counts() -> None:
    from chase_tpu_torch.ops.ring_hemm import bf16_pack, ring_hemm, tf32_split
    ring_hemm.launches = tf32_split.launches = bf16_pack.launches = 0


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
    from chase_tpu_torch.ops.ring_hemm import bf16_pack, ring_hemm, tf32_split
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
    ring_hemm.launches = tf32_split.launches = bf16_pack.launches = 0
    tts, res = solve()
    launches = (ring_hemm.launches, tf32_split.launches, bf16_pack.launches)
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
               f"{perf.filter_hemm_steps}; peak device memory {peak:.1f} GiB")
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


def phase_pfilter(dev, H, lam, route: str) -> None:
    """The p=1 H² ring filter (two ring_hemm launches per step) against
    the plain H² filter (torch.matmul) at the BSE solves' first window,
    w = nev + nex, on the operator each BSE solve filters with: the f32
    shadow of the f64 H with an f64 window (pseudo's ladder), its bf16
    shadow with an f32 window (bpseudo's rung) or the c64 shadow of the
    complex H with a c128 window (zpseudo's ladder).  The kernel reads no
    symmetry, and the BSE H's halves differ."""
    from chase_tpu_torch.config import set_matmul_precision
    from chase_tpu_torch.ops.pseudo import chebyshev_filter_h2
    from chase_tpu_torch.ops.ring_hemm import bf16_pack, ring_hemm, tf32_split
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
    ring_hemm.launches = tf32_split.launches = bf16_pack.launches = 0
    Yk = chebyshev_filter_h2_ring(H_f, X, *args)
    torch.cuda.synchronize()
    pre, other = ((bf16_pack, tf32_split) if route == "bf16"
                  else (tf32_split, bf16_pack))
    launches = (ring_hemm.launches, pre.launches, other.launches)
    Yp = chebyshev_filter_h2(H_f, X, *args)
    wide = torch.complex128 if X.is_complex() else torch.float64
    err = rel_err(Yk, Yp.to(wide))
    exact0 = bool(torch.equal(Yk[:, :100], X[:, :100]))
    del Yk, Yp
    plain_ms, kern_ms = time_fns([lambda: chebyshev_filter_h2(H_f, X, *args),
                                  lambda: chebyshev_filter_h2_ring(
                                      H_f, X, *args)], 1)
    gf = (16.0 if X.is_complex() else 4.0) * N * N * int(deg.sum()) / 1e9
    log("pfilter", f"H² filter N={N} w={w} deg_max={deg_max}, {route} route "
                   f"({op_dtype} operator, {x_dtype} window) on the "
                   f"structured BSE H: rel err ring vs plain {err:.3e} "
                   f"(gate {gate:.0e}); degree-0 columns bit-exact: "
                   f"{exact0}; ring_hemm / {pre.__name__} / "
                   f"{other.__name__} launches {launches} (2·deg_max = "
                   f"{2 * deg_max}); ring {kern_ms:.1f} ms, plain "
                   f"{plain_ms:.1f} ms ({gf:.0f} useful GFLOP); "
                   f"{time.perf_counter() - t_phase:.2f} s")
    del H_f
    torch.cuda.empty_cache()
    if not (err <= gate and exact0
            and launches == (2 * deg_max, 2 * deg_max, 0)):
        raise AssertionError(f"the {route} H² ring filter disagrees with "
                             f"the plain H² filter or did not launch "
                             f"2·deg_max times")


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
    from chase_tpu_torch.ops.ring_hemm import bf16_pack, ring_hemm, tf32_split
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
    ring_hemm.launches = tf32_split.launches = bf16_pack.launches = 0
    (tts, res), msgs = logged(solve)
    launches = (ring_hemm.launches, tf32_split.launches, bf16_pack.launches)
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
               f"{perf.filter_hemm_steps}; peak device memory {peak:.1f} GiB")
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


def phase_bpseudo(dev, H32, H, lam) -> None:
    """The f32 BSE (H's f32 copy) on the bf16 rung on the kernel ring:
    every filter product on the bf16 route; true residuals against the
    f64 H."""
    _bse_solve(dev, H32, lam, "bpseudo", False, "pallas",
               "bf16 rung (bf16 shadow, kernel ring)", bf16=True, H_ref=H)


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
    """``fn()`` with torch's CUDA sync debug mode on: (result, a Counter
    by source line of the synchronizing operations it reported from the
    port's own lines — the ``torch.cuda.synchronize`` around a timed call
    is this script's, not the solver's)."""
    import collections
    import os
    import warnings
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in rec
        if "synchroniz" in str(w.message)
        and f"chase_tpu_torch{os.sep}" in w.filename)


def timed(fn) -> tuple:
    """(seconds, fn()) on the host clock, the device synchronized before
    and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def fused_beside_host(phase: str, what: str, fused, host, gate,
                      host_warm=None, kernel: bool = True,
                      trace: bool = False) -> dict:
    """A fused solve beside the host driver on the same input and config.

    ``fused(max_iter)`` runs the fused entry point (max_iter None: the
    config's); ``host()`` the host-driver one, unless ``host_warm`` gives
    its warm (TTS, iterations) from an earlier phase of this run;
    ``gate(res, who)`` raises on a wrong answer.  The first fused call
    counts the kernel launches (set to 0 just before it) against the
    solver's HEMM-step counter; the warm call counts the host syncs, and
    those of a run stopped after one iteration (``max_iter=1``) are taken
    off, over the iterations left: the syncs of an iteration.  With
    ``trace`` one more warm call of each is traced (busy share, kernel
    launches per iteration)."""
    from chase_tpu_torch.ops.ring_hemm import bf16_pack, ring_hemm, tf32_split
    ring_hemm.launches = tf32_split.launches = bf16_pack.launches = 0
    first, res = timed(lambda: fused(None))
    launches = (ring_hemm.launches, tf32_split.launches, bf16_pack.launches)
    steps = res.perf.filter_hemm_steps
    gate(res, "fused")
    (warm, res2), sites = count_syncs(lambda: timed(lambda: fused(None)))
    (_, res1), sites1 = count_syncs(lambda: timed(lambda: fused(1)))
    syncs, syncs1 = sum(sites.values()), sum(sites1.values())
    per_iter = (syncs - syncs1) / max(res2.iterations - 1, 1)
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
               f"of 1 iteration: {per_iter:.2f} per iteration (by line: "
               f"{dict(sites.most_common(8))}); ring_hemm / "
               f"tf32_split / bf16_pack launches {launches}, the solver's "
               f"HEMM steps {steps}; filtered vecs "
               f"{res.perf.filtered_vecs}; max resid {res.resid.max():.3e}")
    if res1.iterations != 1 or syncs < res2.iterations + 1:
        raise AssertionError(f"{phase}: the sync count does not work "
                             f"({syncs} syncs in {res2.iterations} "
                             f"iterations)")
    if per_iter > 3:
        raise AssertionError(f"{phase}: {per_iter:.2f} host syncs per fused "
                             f"iteration (at most 3)")
    if kernel:
        hemm, split, pack = launches
        pre = pack if split == 0 else split
        if not (0 < hemm == pre == steps and min(split, pack) == 0):
            raise AssertionError(f"{phase}: launches {launches} against "
                                 f"{steps} HEMM steps")
    elif launches != (0, 0, 0):
        raise AssertionError(f"{phase}: kernel launches {launches} on a "
                             f"path with no kernel operator")
    if trace:
        trace_solve(phase, "warm fused solve", lambda: timed(
            lambda: fused(None)))
        trace_solve(phase, "warm host-driver solve", lambda: timed(host))
    return dict(first=first, warm=warm, iterations=res2.iterations,
                per_iter=per_iter, launches=launches, steps=steps)


def clement_gate(phase: str, H, nev: int, ev_tol: float, res_tol: float):
    """The Clement gates of a solve: converged, eigenvalues within
    ``ev_tol`` of the exact spectrum, true residuals ≤ ``res_tol``."""
    from chase_tpu_torch.models import clement_eigenvalues
    exact = clement_eigenvalues(H.shape[0])[:nev]

    def gate(res, who):
        V = res.V[:, :nev]
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
                        host_warm=None) -> dict:
    """eigsh_fused beside eigsh on an f32 Clement H with
    ring_backend="pallas" (mixed_precision pinned off); tol None is the
    f32 default 1e-5, whose gates allow the early lock's 100·tol."""
    import chase_tpu_torch as ct
    cfg = ct.ChaseConfig(ring_backend="pallas", mixed_precision=False)
    t = 1e-5 if tol is None else tol
    gate = (clement_gate(phase, H, nev, 1e-2, 100 * t) if tol is None
            else clement_gate(phase, H, nev, 0.5, 10 * t))

    def fused(max_iter):
        c = cfg if max_iter is None else ct.ChaseConfig(
            ring_backend="pallas", mixed_precision=False, max_iter=max_iter)
        return ct.eigsh_fused(H, nev, nex, tol=tol, config=c, device=dev,
                              collect_perf=True)

    return fused_beside_host(
        phase, f"Clement N={H.shape[0]} nev={nev} nex={nex} f32 tol={t} "
               f"pallas", fused,
        lambda: ct.eigsh(H, nev, nex, tol=tol, config=cfg, device=dev),
        gate, host_warm, trace=host_warm is None)


def bse_gate(phase: str, H, lam, nev: int, tol: float):
    """The BSE gates: converged, eigenvalues and true residuals (in H's
    precision) within 10·tol."""
    from chase_tpu_torch.ops.pseudo import residuals_pseudo

    def gate(res, who):
        ev_err = float(np.abs(res.ritzv - lam[:nev].cpu().numpy()).max())
        true_res = float(residuals_pseudo(H, res.V[:, :nev],
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


def phase_zfused(dev) -> dict:
    """The c128 BSE at the JAX package's fused BSE shape (N=4096, nev=200,
    nex=56), natively (mixed_precision=False, no kernel operator):
    eigsh_pseudo and eigsh_pseudo_fused."""
    import chase_tpu_torch as ct
    N, nev, nex, tol = ZFUSED["N"], ZFUSED["nev"], ZFUSED["nex"], BSE["tol"]
    H, lam = structured_bse_on_device(N, dev, SEED + 11)
    Hc = complex_bse_on_device(H, SEED + 12)
    del H
    cfg = ct.ChaseConfig(mixed_precision=False)

    def fused(max_iter):
        c = cfg if max_iter is None else ct.ChaseConfig(
            mixed_precision=False, max_iter=max_iter)
        return ct.eigsh_pseudo_fused(Hc, nev, nex, tol=tol, config=c,
                                     device=dev, collect_perf=True)

    def host():
        res, msgs = logged(lambda: ct.eigsh_pseudo(
            Hc, nev, nex, tol=tol, config=cfg, device=dev))
        log("zfused", f"native c128 eigsh_pseudo: "
                      f"{iteration0_report(msgs)}")
        return res

    return fused_beside_host(
        "zfused", f"BSE c128 N={N} nev={nev} nex={nex} tol={tol} native",
        fused, host, bse_gate("zfused", Hc, lam, nev, tol), kernel=False)


GRID_P = (2, 4)
# the kernel's routes on the (p, 1) stripes: (route, widths k)
GRIDRING = {"f32": (3000,), "bf16": (3000, 1500), "c64": (3000,)}
NVLINK_GBS = 450.0          # GB/s each way between two H100 SXM cards


class _SimRequests:
    """A finished exchange: the in-memory rotation copies at once."""

    @staticmethod
    def wait() -> None:
        pass


def sim_exchange(chunks, me: int):
    """The ring's exchange over len(chunks) simulated ranks in one process:
    the call before step s hands rank ``me`` the chunk of rank (me + s +
    1) mod p, as the NCCL exchange does on p cards."""
    p, step = len(chunks), [0]

    def swap(send, recv):
        step[0] += 1
        recv.copy_(chunks[(me + step[0]) % p])
        return _SimRequests
    return swap


def _ring_all(stripes, chunks, **step) -> torch.Tensor:
    """Every simulated rank's ring product (the production step loop with
    the in-memory exchange; its kernel step unless ``step=`` is given),
    stacked: H·V."""
    from chase_tpu_torch.parallel.ring import ring_steps
    p = len(chunks)
    return torch.cat([ring_steps(stripes[i], chunks[i], me=i, p=p,
                                 exchange=sim_exchange(chunks, i), **step)
                      for i in range(p)])


def phase_gridring(dev, H, route: str) -> dict:
    """The (p, 1) ring's stripes of an N × N H on one card: for p = 2 and
    4 simulated ranks, each rank's stripe laid out as
    DenseOperator(grid=…) lays it out (``operator.block_of``), the
    production step loop (``parallel.ring.ring_steps``) with an in-memory
    exchange, on the kernel's ``route`` (f32, bf16 — the f32 H's shadow
    — or c64); H·V held against a wide product per rank at the kernel
    gate (the plain version's and the library call's rings beside it);
    one stripe call (m, b, k) = (N/p, N/p, k) timed beside its plain
    version, the library call and its bound, and the pre-pass of one
    received chunk beside the time the chunk in the pre-pass's layout
    would add to (f32, c64) or save on (bf16) the wire at NVLink's
    rate.  The launch counts are set to 0 just before each
    ring run and read after it."""
    from chase_tpu_torch.ops.ring_hemm import (bf16_pack, float_view_args,
                                               pack_shape, ring_hemm,
                                               ring_hemm_reference,
                                               split_shape, tf32_split)
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
        for k in GRIDRING[route]:
            V = torch.randn((N, k), generator=g, device=dev, dtype=v_dtype)
            chunks = [V[i * b:(i + 1) * b].contiguous() for i in range(p)]
            Vr = (V.to(torch.bfloat16) if route == "bf16" else V).to(wide)
            _zero_ring_counts()
            torch.cuda.synchronize()
            W = _ring_all(stripes, chunks)
            torch.cuda.synchronize()
            launches = _ring_counts()
            # the plain version's ring, and the library call's (matmul_step:
            # torch.matmul, or torch.mm(out_dtype=f32) of a bf16 H)
            Wp = _ring_all(stripes, chunks, step=ring_hemm_reference)
            Wl = _ring_all(stripes, chunks, step=matmul_step)
            err = errp = errl = abs_err = 0.0
            for i in range(p):
                ref = stripes[i].to(wide) @ Vr
                rows = slice(i * b, (i + 1) * b)
                err = max(err, rel_err(W[rows], ref))
                errp = max(errp, rel_err(Wp[rows], ref))
                errl = max(errl, rel_err(Wl[rows], ref))
                abs_err = max(abs_err,
                              float((W[rows].to(wide) - ref).abs().max()))
                del ref
            del W, Wp, Wl
            # one stripe call at the second chunk (col0 = b)
            Hs, Vc = stripes[0], chunks[1]
            Hb = Hs[:, b:2 * b]
            Wc = torch.empty((b, k), dtype=v_dtype, device=dev)

            def library():
                if route == "bf16":
                    return torch.mm(Hb, Vc.to(torch.bfloat16),
                                    out_dtype=torch.float32)
                return torch.matmul(Hb, Vc)

            plain_ms, kern_ms, lib_ms = time_fns(
                [lambda: ring_hemm_reference(Hs, Vc, col0=b, out=Wc),
                 lambda: ring_hemm(Hs, Vc, col0=b, out=Wc), library], 3)
            prepass = bf16_pack if route == "bf16" else tf32_split
            off = float_view_args(Hs, Vc, b, k)[2]
            pre_ms = time_fns([lambda: prepass(Vc, off)], 3)[0]
            bound_ms, bound_by = (bf16_hemm_bound(b, b, k) if route == "bf16"
                                  else hemm_bound(b, b, k, h_dtype))
            # the chunk on the wire raw (each receiver runs the pre-pass)
            # or in the pre-pass's layout (the owner runs it once): the
            # f32 split holds hi and lo, the bf16 pack half the bytes
            raw = Vc.numel() * Vc.element_size()
            w = 2 if v_dtype.is_complex else 1
            if route == "bf16":
                b_pad, w_pad = pack_shape(b, k)
                split = 2 * w_pad * b_pad
            else:
                b_pad, w_pad = split_shape(w * b, w * k)
                split = 2 * w_pad * b_pad * 4
            extra_ms = (split - raw) / (NVLINK_GBS * 1e6)
            log("gridring", f"{route} p={p} (m, b, k)=({b}, {b}, {k}): ring "
                            f"of {p} simulated ranks rel err kernel "
                            f"{err:.3e} plain {errp:.3e} library "
                            f"{errl:.3e}, max abs err "
                            f"{abs_err:.3e}; launches {launches[0]} "
                            f"(pre-pass {launches[1] + launches[2]}); "
                            f"stripe call {kern_ms:.3f} ms, plain "
                            f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms, "
                            f"bound {bound_ms:.3f} ms "
                            f"({bound_by}); pre-pass of a received chunk "
                            f"{pre_ms:.3f} ms; chunk {raw / 1e6:.1f} MB raw, "
                            f"{split / 1e6:.1f} MB in the pre-pass's "
                            f"layout: {extra_ms:+.3f} ms at "
                            f"{NVLINK_GBS:.0f} GB/s of NVLink")
            # the kernel gate (PERF.md §2): 4× the plain version's error,
            # the library's for bf16
            gate = 4 * (errl if route == "bf16" else errp)
            if not (err <= 1e-5 and err <= gate
                    and launches[0] == p * p
                    and launches[1] + launches[2] == p * p):
                raise AssertionError(f"gridring {route} p={p} k={k}: error "
                                     f"{err:.3e} (gate 1e-5 and {gate:.3e})"
                                     f" or launches {launches} != {p * p}")
            out[(p, k)] = dict(abs_err=abs_err, ms=kern_ms,
                               plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               launches=launches[0], prepass_ms=pre_ms)
            del V, Vr, chunks, Wc, Hb, Hs, Vc
        del stripes
        torch.cuda.empty_cache()
    log("gridring", f"{route} phase ok in "
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


def grid_child() -> int:
    """One rank of [grid1] / [gridnccl], started with torchrun's
    variables: multihost.init_grid() on NCCL, the (GRID_R, 1) grid, the
    f32 slice on the kernel ring with its gates, twice (cold, warm); rank
    0 prints one line ``GRID_RESULT {json}``."""
    import torch.distributed as dist
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement_eigenvalues
    from chase_tpu_torch.ops.residuals import residuals
    from chase_tpu_torch.parallel import multihost
    r = int(os.environ["GRID_R"])
    t0 = time.perf_counter()
    grid = multihost.init_grid((r, 1), timeout=300)
    t_init = time.perf_counter() - t0
    wiring = _check_wiring(grid)
    dev = grid.device
    N, nev, nex, tol = SLICE["N"], SLICE["nev"], SLICE["nex"], SLICE["tol"]
    H = clement_on_device(N, dev)
    cfg = ct.ChaseConfig(ring_backend="pallas", mixed_precision=False)
    op = ct.DenseOperator(H, grid=grid)
    runs = []
    for _ in range(2):
        grid.stats.reset()
        _zero_ring_counts()
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        res = ct.eigsh(op, nev, nex, tol=tol, config=cfg, collect_perf=True)
        torch.cuda.synchronize(dev)
        tts = time.perf_counter() - t0
        runs.append((tts, res, _ring_counts(), grid.stats.summary()))
    tts, res, launches, stats = runs[-1]
    V = res.V.full_tensor()[:, :nev]
    ev_err = float(np.abs(res.ritzv - clement_eigenvalues(N)[:nev]).max())
    true_res = float(residuals(H, V, res.ritzv).max())
    steps = res.perf.filter_hemm_steps
    ok = (res.converged and ev_err <= 0.5 and true_res <= 10 * tol
          and launches[0] == launches[1] == r * steps and launches[2] == 0)
    if grid.coords == (0, 0):
        print("GRID_RESULT " + json.dumps(dict(
            shape=[r, 1], init_s=t_init, wiring=wiring, tts_cold=runs[0][0],
            tts=tts, iterations=res.iterations, converged=res.converged,
            ev_err=ev_err, true_res=true_res, launches=list(launches),
            hemm_steps=steps, executed=res.perf.filtered_vecs_executed,
            collectives={k: list(v) for k, v in
                                           stats.items()},
            ok=bool(ok))), flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


def _run_grid(phase: str, r: int) -> dict:
    """The r ranks of a (r, 1) grid as child processes on cards 0…r−1
    (torchrun's variables, a loopback rendezvous), each killed after the
    phase's time limit; rank 0's result."""
    port = free_port()
    cmd = [sys.executable, "-c",
           "import sys, chip_smoke; sys.exit(chip_smoke.grid_child())"]
    with tempfile.TemporaryDirectory(prefix="chase_grid_") as tmp:
        logs = [open(os.path.join(tmp, f"rank{k}.log"), "w+")
                for k in range(r)]
        procs = [subprocess.Popen(cmd, cwd=ROOT, env=child_env(
            **torchrun_env(k, r, port, GRID_R=str(r))), stdout=logs[k],
            stderr=subprocess.STDOUT, text=True) for k in range(r)]
        deadline = time.monotonic() + 300
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
            if not line.startswith("GRID_RESULT"):
                log(phase, f"  rank {k}: {line}")
    codes = [p.returncode for p in procs]
    found = [ln for ln in outs[0].splitlines()
             if ln.startswith("GRID_RESULT ")]
    if any(codes) or not found:
        raise AssertionError(f"{phase}: ranks exited {codes}")
    return json.loads(found[-1][len("GRID_RESULT "):])


def _per_iteration(out: dict) -> dict:
    """The collectives a grid solve issued, (calls, bytes) per
    iteration, by kind."""
    n = max(out["iterations"], 1)
    return {k: (round(c / n, 2), round(b / n))
            for k, (c, b) in out["collectives"].items()}


def phase_grid1(slice_iterations: int, warm_tts: float) -> None:
    """The f32 slice on an NCCL (1, 1) grid in a child process with
    torchrun's variables at WORLD_SIZE=1: [slice]'s gates and its
    iteration count; ring_hemm launches = the filter's HEMM steps."""
    t0 = time.perf_counter()
    out = _run_grid("grid1", 1)
    per_it = _per_iteration(out)
    log("grid1", f"{out['wiring']}; init_grid {out['init_s']:.2f} s; f32 "
                 f"slice on the (1, 1) grid: converged={out['converged']} "
                 f"iterations={out['iterations']} ([slice]: "
                 f"{slice_iterations}); TTS cold {out['tts_cold']:.3f} s, "
                 f"warm {out['tts']:.3f} s ([profile] warm on one device "
                 f"{warm_tts:.3f} s); max eigenvalue err "
                 f"{out['ev_err']:.3e}, max true residual "
                 f"{out['true_res']:.3e}; ring_hemm / tf32_split / bf16_pack "
                 f"launches {out['launches']}, filter HEMM steps "
                 f"{out['hemm_steps']}; collectives issued per iteration "
                 f"(calls, bytes) "
                 f"{per_it or 'none (every axis has one member)'}; "
                 f"{time.perf_counter() - t0:.2f} s")
    # the chunk ring's model (probes/grid_collectives.py checks it on
    # the CPU): each rank sends (p − 1)/p · N · 4 bytes per executed
    # filter column-step
    its = max(out["iterations"], 1)
    sent = [(p, (p - 1) / p * SLICE["N"] * 4 * out["executed"] / its)
            for p in GRID_P]
    model = ", ".join(f"p={p}: {nb / 1e9:.2f} GB per iteration and rank, "
                      f"{nb / (NVLINK_GBS * 1e6):.0f} ms at "
                      f"{NVLINK_GBS:.0f} GB/s" for p, nb in sent)
    log("grid1", f"this solve's chunk ring on a (p, 1) grid, from its "
                 f"{out['executed']} executed filter column-steps (a model, "
                 f"not measured): {model}")
    if not (out["ok"] and out["iterations"] == slice_iterations):
        raise AssertionError(f"grid1: gates failed or iterations "
                             f"{out['iterations']} != [slice]'s "
                             f"{slice_iterations}")


def phase_gridnccl() -> None:
    """The f32 slice on a (p, 1) NCCL grid, p = min(cards, 4) — only on
    a machine with two cards or more."""
    count = torch.cuda.device_count()
    if count < 2:
        log("gridnccl", f"not run: {count} device")
        return
    p = min(count, 4)
    t0 = time.perf_counter()
    out = _run_grid("gridnccl", p)
    per_it = _per_iteration(out)
    log("gridnccl", f"f32 slice on the ({p}, 1) NCCL grid: converged="
                    f"{out['converged']} iterations={out['iterations']}; TTS "
                    f"cold {out['tts_cold']:.3f} s, warm {out['tts']:.3f} s; "
                    f"max eigenvalue err {out['ev_err']:.3e}, max true "
                    f"residual {out['true_res']:.3e}; rank 0's ring_hemm / "
                    f"tf32_split launches {out['launches']} = {p} × "
                    f"{out['hemm_steps']} HEMM steps; collectives per "
                    f"iteration on rank 0 (calls, bytes) {per_it}; "
                    f"{time.perf_counter() - t0:.2f} s")
    if not out["ok"]:
        raise AssertionError("gridnccl: gates failed")


def _kernel_entry(name: str, launches: int, case: dict) -> dict:
    return dict(name=name, route="cuda",
                source="chase_tpu_torch/csrc/ring_hemm.cu",
                replaces="chase_tpu/ops/pallas_ring.py:34",
                launches=launches, max_abs_err=case["abs_err"],
                ms=case["ms"], plain_ms=case["plain_ms"],
                bound_ms=case["bound_ms"], bound_by=case["bound_by"],
                library_ms=case["library_ms"])


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
    del Hr
    torch.cuda.empty_cache()
    phase_grid1(launches["iterations"], warm["pallas"])
    phase_gridnccl()
    with tempfile.TemporaryDirectory(prefix="chase_smoke_") as tmp:
        path = os.path.join(tmp, f"clement{SLICE['N']}_f32.bin")
        phase_io(dev, H, path)
        phase_cli(dev, path, warm["pallas"])
        phase_capi(dev, path, warm["pallas"])
    phase_fused_clement(dev, H, "fslice", SLICE["nev"], SLICE["nex"],
                        SLICE["tol"], (warm["pallas"],
                                       warm["pallas_iterations"]))
    bkern = phase_bf16_kernel(dev)
    blaunches = phase_bslice(dev, H, warm["pallas"])
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
    H = dense_on_device(SLICE["N"], dev, torch.complex64)
    gring["c64"] = phase_gridring(dev, H, "c64")
    del H
    torch.cuda.empty_cache()

    H, dp_tts = phase_north_star(dev)
    phase_ladder(dev, H, dp_tts)
    del H
    torch.cuda.empty_cache()
    phase_sequence(dev)

    t0 = time.perf_counter()
    H, lam = structured_bse_on_device(BSE["N"], dev)
    H32 = H.float()
    torch.cuda.synchronize()
    log("setup", f"structured BSE N={BSE['N']} (f64, and its f32 copy) "
                 f"built on the card in {time.perf_counter() - t0:.2f} s")
    phase_pfilter(dev, H32, lam, "f32")
    phase_pfilter(dev, H32, lam, "bf16")
    phase_bpseudo(dev, H32, H, lam)
    del H32
    torch.cuda.empty_cache()
    ladder = phase_pseudo(dev, H, lam)
    phase_fpseudo(dev, H, lam, ladder)
    t0 = time.perf_counter()
    Hc = complex_bse_on_device(H)
    del H
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log("setup", f"H_c = D·H·D⁻¹ (c128) built on the card in "
                 f"{time.perf_counter() - t0:.2f} s")
    phase_pfilter(dev, Hc, lam, "c64")
    phase_zpseudo(dev, Hc, lam)
    del Hc
    torch.cuda.empty_cache()
    phase_zfused(dev)

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
        + [_kernel_entry(f"ring_hemm[{route} stripe p={p} k={k}]",
                         case["launches"], case)
           for route, cases in gring.items()
           for (p, k), case in cases.items()]}), flush=True)
    log("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
