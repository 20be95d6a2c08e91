"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives chase_tpu_torch's main path on the card and fails (non-zero exit,
no result line) on any fault:

  device  require CUDA; print the card's name and power limit
  build   compile the port's CUDA kernels from csrc/ (nvcc, sm_90a)
  kernel  ring_hemm against its plain version (torch.matmul) at the
          filter's shapes, both held against an f64 product; times both
  filter  the p=1 ring Chebyshev filter (every HEMM on the kernel)
          against the plain filter at N=30000, width 750, degree 10
  slice   eigsh on the Clement matrix at the solver's reference scale
          (N=30000, nev=2250, nex=750, f32, ring_backend="pallas"):
          convergence, eigenvalues against the exact spectrum, true
          residuals, and ring_hemm launches == the filter's HEMM steps

Each phase prints one line with its numbers and seconds.  A full run
then prints the kernels' JSON summary and, last,
{"ok": true, "device": {...}}.  There is no CPU fallback: without a GPU
the script exits non-zero before any phase.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# slice configuration: the repo's north-star shape, f32 at an absolute
# tolerance of ~1e-5·‖H‖ (‖H‖ = N - 1 for Clement)
SLICE = dict(N=30000, nev=2250, nex=750, tol=0.3)
KERNEL_SHAPES = ((1000, 37), (30000, 750), (30000, 3000))
SEED = 20261016


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


def time_pair(fn_plain, fn_kernel, reps: int):
    """Plain, kernel, kernel, plain after one warm-up each; returns the
    mean ms of each."""
    fn_plain()
    fn_kernel()
    torch.cuda.synchronize()
    p1 = time_ms(fn_plain, reps)
    k1 = time_ms(fn_kernel, reps)
    k2 = time_ms(fn_kernel, reps)
    p2 = time_ms(fn_plain, reps)
    return (p1 + p2) / 2, (k1 + k2) / 2


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.double() - ref).abs().max() / ref.abs().max())


def clement_on_device(N: int, dev) -> torch.Tensor:
    """The Clement matrix (tridiagonal, exact spectrum ±(N-1), ±(N-3),
    ...) built on the card in f32."""
    i = torch.arange(N - 1, dtype=torch.float64, device=dev)
    off = torch.sqrt((i + 1) * (N - i - 1)).float()
    H = torch.zeros((N, N), dtype=torch.float32, device=dev)
    idx = torch.arange(N - 1, device=dev)
    H[idx, idx + 1] = off
    H[idx + 1, idx] = off
    return H


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
    log("build", f"ring_hemm built and loaded in {dt:.2f} s "
                 f"(nvcc {_build.nvcc_path()}, {_build.BUILD_DIR})")
    return dt


def phase_kernel(dev) -> dict:
    from chase_tpu_torch.ops.ring_hemm import ring_hemm, ring_hemm_reference
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    summary = {}
    H = H64 = None
    for N, k in KERNEL_SHAPES:
        t0 = time.perf_counter()
        if H is None or H.shape[0] != N:
            H = H64 = None
            torch.cuda.empty_cache()
            H = torch.randn((N, N), generator=g, device=dev)
            H64 = H.double()
        V = torch.randn((N, k), generator=g, device=dev)
        ref = H64 @ V.double()
        W = ring_hemm(H, V)
        torch.cuda.synchronize()
        Wp = ring_hemm_reference(H, V)
        err, errp = rel_err(W, ref), rel_err(Wp, ref)
        abs_err = float((W.double() - ref).abs().max())
        reps = 20 if N * N * k < 1e11 else 3
        plain_ms, kern_ms = time_pair(lambda: ring_hemm_reference(H, V),
                                      lambda: ring_hemm(H, V), reps)
        mflop = 2.0 * N * N * k / 1e6        # MFLOP / ms = GFLOP/s
        log("kernel", f"(N, k)=({N}, {k}): rel err kernel {err:.3e} plain "
                      f"{errp:.3e}; max abs err {abs_err:.3e}; kernel "
                      f"{kern_ms:.3f} ms ({mflop / kern_ms:.0f} GFLOP/s), "
                      f"plain {plain_ms:.3f} ms ({mflop / plain_ms:.0f} "
                      f"GFLOP/s); {time.perf_counter() - t0:.2f} s")
        # f32 sums over K terms in two orders: 1e-5 of the largest entry,
        # and no worse than 4x the plain version's own error
        if not (err <= 1e-5 and err <= 4 * errp):
            raise AssertionError(f"ring_hemm error {err:.3e} at ({N}, {k}) "
                                 f"exceeds 1e-5 or 4x plain ({errp:.3e})")
        summary[(N, k)] = dict(err=err, errp=errp, abs_err=abs_err,
                               ms=kern_ms, plain_ms=plain_ms)
        del W, Wp, ref

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
    del H, H64
    torch.cuda.empty_cache()
    log("kernel", f"phase ok in {time.perf_counter() - t_phase:.2f} s")
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
    plain_ms, kern_ms = time_pair(lambda: chebyshev_filter(H, X, *args),
                                  lambda: chebyshev_filter_ring_pallas(
                                      H, X, *args), 1)
    gf = 2.0 * N * N * (int(deg.sum())) / 1e9
    log("filter", f"N={N} w={w} deg_max={deg_max}: rel err ring vs plain "
                  f"{err:.3e}; degree-0 columns bit-exact: {exact0}; ring "
                  f"{kern_ms:.1f} ms, plain {plain_ms:.1f} ms "
                  f"({gf:.0f} useful GFLOP); "
                  f"{time.perf_counter() - t_phase:.2f} s")
    # same f32 recurrence, HEMMs summed in two orders
    if not (err <= 1e-5 and exact0):
        raise AssertionError("ring filter disagrees with the plain filter")


def phase_slice(dev, H) -> int:
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement_eigenvalues
    from chase_tpu_torch.ops.ring_hemm import ring_hemm
    N, nev, nex, tol = SLICE["N"], SLICE["nev"], SLICE["nex"], SLICE["tol"]
    cfg = ct.ChaseConfig(ring_backend="pallas")
    torch.cuda.reset_peak_memory_stats(dev)
    ring_hemm.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ct.eigsh(H, nev, nex, tol=tol, config=cfg, device=dev,
                   collect_perf=True)
    torch.cuda.synchronize()
    tts = time.perf_counter() - t0
    launches = ring_hemm.launches
    perf = res.perf
    ev_err = float(np.abs(res.ritzv - clement_eigenvalues(N)[:nev]).max())
    V = res.V[:, :nev]
    lam = torch.as_tensor(res.ritzv, dtype=torch.float32, device=dev)
    true_res = float(torch.linalg.vector_norm(H @ V - V * lam, dim=0).max())
    t = perf.timings
    filter_rate = perf.get_filter_flops(N, torch.float32) / t["Filter"]
    log("slice", f"eigsh Clement N={N} nev={nev} nex={nex} f32 tol={tol} "
                 f"ring_backend=pallas: converged={res.converged} "
                 f"iterations={res.iterations} TTS {tts:.2f} s; phases "
                 f"Lanczos {t['Lanczos']:.2f} Filter {t['Filter']:.2f} "
                 f"QR {t['Qr']:.2f} RR {t['Rr']:.2f} Resids_Locking "
                 f"{t['Resids_Locking']:.2f} InitVecs {t['InitVecs']:.2f} s; "
                 f"filter {filter_rate:.0f} GFLOP/s (useful FLOP model); "
                 f"max eigenvalue err {ev_err:.3e}; max true residual "
                 f"{true_res:.3e}; reported max resid {res.resid.max():.3e}; "
                 f"ring_hemm launches {launches}, filter HEMM steps "
                 f"{perf.filter_hemm_steps}; peak device memory "
                 f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    if not res.converged:
        raise AssertionError("slice did not converge")
    if not ev_err <= 0.5:
        raise AssertionError(f"eigenvalue error {ev_err} > 0.5")
    if not true_res <= 10 * tol:
        raise AssertionError(f"true residual {true_res} > {10 * tol}")
    if launches == 0 or launches != perf.filter_hemm_steps:
        raise AssertionError(f"ring_hemm launched {launches} times, the "
                             f"filter ran {perf.filter_hemm_steps} HEMM steps")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this check "
              "needs an NVIDIA GPU and has no CPU fallback", file=sys.stderr)
        return 2
    import chase_tpu_torch  # noqa: F401  (fails outside a checkout)

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
    big = kern[KERNEL_SHAPES[-1]]
    print(json.dumps({"kernels": [{
        "name": "ring_hemm", "route": "cuda",
        "source": "chase_tpu_torch/csrc/ring_hemm.cu",
        "replaces": "chase_tpu/ops/pallas_ring.py:34",
        "launches": launches, "max_abs_err": big["abs_err"],
        "ms": big["ms"], "plain_ms": big["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
