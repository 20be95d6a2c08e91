"""Probe of the bf16 route's design on the card: the shapes of
csrc/ring_hemm.cu's bf16 kernel side by side, in one process on one card.

    python probes/bf16_route_design.py [--baseline DIR] [--widths 750,1500,3000]
                                       [--variants NAME,...] [--out FILE]
    python probes/bf16_route_design.py --summary FILE

Each variant is the kept source built with -D flags (RING_HEMM_BF16_BN:
the W column tile, _CM / _CN: the cluster's CTAs along W's rows, which
share V's tile, and along its columns, which share H's; _PROMOTE: K tiles
per IEEE promotion, 0 = one accumulator over all of K; _GROUP: row
stripes per raster group; _SPLIT: column parts each consumer computes in
turn; n192_2x1_p2 is the kept shape) into
build/probe_design/, all built at once, each with one more function that
reports how many of its clusters the card holds at once.  The card-only
tests' second bound (4x the f32 product's error, at least 4e-7) is
flagged ">4x" where a variant misses it.  ``--baseline DIR`` adds an earlier
source (DIR holds its ring_hemm.cu and hopper_tf32.cuh), e.g. the parent
commit's:

    git archive <commit> chase_tpu_torch/csrc | tar -x -C build/base
    python probes/bf16_route_design.py \
        --baseline build/base/chase_tpu_torch/csrc

It prints each build's registers and spills (ptxas), checks every variant
on ragged shapes (an odd row-tile count, k past the column tile, col0 % 8
from 1 to 7 with inf just left of the block, a strided W with
accumulate), then at (N, k) = (30000, w) for each width times the main
kernel alone (the pre-pass's output made once) for every variant in turns
(forward, then reverse order), with its error against an f64 product of
the bf16-rounded operands, the SM clock and power draw sampled by
nvidia-smi while it ran, beside cuBLAS's bf16 GEMM (torch.mm, f32 out),
whose kernel name one torch.profiler trace records.  With a baseline it
last times the f32 route (ring_hemm_f32, which the bf16 variants leave
alone) of the kept library and of the baseline in turns at (30000, 3000).
The results also go to ``--out`` as JSON (default
build/probe_design/bf16_route_design.json).  ``--summary FILE`` prints
the timing lines of such a file again, on any machine.  Each timing line
gives the call's L2 → shared-memory reads as a rate: per CTA and 64-deep
K tile, its share of the H tile (128 rows of 128 bytes) and of the V tile
(BN rows), a multicast tile counted once per cluster, over the grid the
launch rounds up to whole clusters.
"""
import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from chase_tpu_torch import _build  # noqa: E402
from chase_tpu_torch.ops.ring_hemm import bf16_pack  # noqa: E402
from chip_smoke import sampled, time_ms  # noqa: E402

PEAK_BF16 = 989.0            # TFLOP/s, H100 SXM dense bf16
# name: (BN, CM, CN, PROMOTE[, GROUP[, SPLIT]]); GROUP: row stripes per
# raster group (RING_HEMM_BF16_GROUP, default 8); SPLIT: column parts a
# consumer computes in turn (RING_HEMM_BF16_SPLIT, default 1)
VARIANTS = {
    # the tile and A from shared memory, without clusters
    "n128_1x1_p1": (128, 1, 1, 1),
    "n128_1x1_p2": (128, 1, 1, 2),
    "n128_1x1_p4": (128, 1, 1, 4),
    "n192_1x1_p1": (192, 1, 1, 1),
    "n192_1x1_p2": (192, 1, 1, 2),
    "n192_1x1_p4": (192, 1, 1, 4),
    "n256_1x1_p0": (256, 1, 1, 0),
    # clusters: 2x1 multicasts V, 1x2 multicasts H, 2x2 both
    "n128_2x1_p1": (128, 2, 1, 1),
    "n128_1x2_p1": (128, 1, 2, 1),
    "n128_2x2_p1": (128, 2, 2, 1),
    "n128_2x2_p2": (128, 2, 2, 2),
    "n192_2x1_p1": (192, 2, 1, 1),
    "n192_1x2_p2": (192, 1, 2, 2),
    "n192_2x2_p1": (192, 2, 2, 1),
    "n192_2x2_p2": (192, 2, 2, 2),
    "n192_2x2_p4": (192, 2, 2, 4),
    "n192_2x2_p8": (192, 2, 2, 8),
    "n256_2x1_p0": (256, 2, 1, 0),
    # the promotion interval and the raster group on the kept shape
    "n192_2x1_p0": (192, 2, 1, 0),
    "n192_2x1_p2": (192, 2, 1, 2),
    "n192_2x1_p4": (192, 2, 1, 4),
    "n192_2x1_p8": (192, 2, 1, 8),
    "n192_2x1_p16": (192, 2, 1, 16),
    "n192_2x1_p32": (192, 2, 1, 32),
    "n192_2x1_p2_g4": (192, 2, 1, 2, 4),
    "n192_2x1_p2_g16": (192, 2, 1, 2, 16),
    "n192_2x1_p8_g4": (192, 2, 1, 8, 4),
    "n192_2x1_p8_g16": (192, 2, 1, 8, 16),
    # 128x256 tiles, each consumer's 64x256 run as two 64x128 parts in turn
    "n256s2_1x1_p2": (256, 1, 1, 2, 8, 2),
    "n256s2_2x1_p2": (256, 2, 1, 2, 8, 2),
    "n256s2_2x1_p4": (256, 2, 1, 4, 8, 2),
    "n256s2_2x2_p2": (256, 2, 2, 2, 8, 2),
}
BASELINE = (128, 1, 1, 1)    # the replaced route's tile: 128x128, no cluster
ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


# the kept source plus one query: how many clusters of the bf16 kernel
# the card holds at once (cudaOccupancyMaxActiveClusters)
OCCUPANCY = r"""#include "%s"
extern "C" int ring_hemm_bf16_max_clusters(int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      ring_hemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bf16r::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bf16r::CN * 16, bf16r::CM * 118);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = bf16r::SMEM_BYTES;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = bf16r::CN;
  attr[0].val.clusterDim.y = bf16r::CM;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(ring_hemm_bf16_kernel), &cfg);
}
"""


def build_all(variants: dict, baseline, out_dir: pathlib.Path) -> dict:
    """nvcc every variant at once; {name: (path, ptxas lines of the bf16
    kernel)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "ring_hemm_occupancy.cu"
    src.write_text(OCCUPANCY % (_build.CSRC_DIR / "ring_hemm.cu"))
    jobs = {}
    for name, (bn, cm, cn, p, *rest) in variants.items():
        defs = [f"-DRING_HEMM_BF16_BN={bn}", f"-DRING_HEMM_BF16_CM={cm}",
                f"-DRING_HEMM_BF16_CN={cn}", f"-DRING_HEMM_BF16_PROMOTE={p}"]
        defs += [f"-DRING_HEMM_BF16_{key}={v}"
                 for key, v in zip(("GROUP", "SPLIT"), rest)]
        jobs[name] = (defs, src)
    if baseline:
        jobs["baseline"] = ([], pathlib.Path(baseline) / "ring_hemm.cu")
    procs = {}
    t0 = time.time()
    for name, (defs, path) in jobs.items():
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *defs, "-o", str(lib),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"[build] {name} FAILED (rc {proc.returncode}):\n{log}",
                  flush=True)
            continue
        built[name] = (lib, ptxas_bf16(log))
    print(f"[build] {len(built)}/{len(jobs)} built in {time.time() - t0:.1f} s",
          flush=True)
    for name, (_, lines) in built.items():
        print(f"[build] {name}: " + " | ".join(lines), flush=True)
    return built


def ptxas_bf16(log: str) -> list:
    """ptxas's registers and spills of each main kernel (the bf16 one and
    the f32 one, which must not move), and any warning."""
    out, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            fn = ("bf16" if "bf16_kernel" in name else
                  "f32" if "ring_hemm_kernel" in name else None)
            continue
        if "warning" in line.lower() or "(C7" in line:
            out.append(line.strip())
        elif fn and ("registers" in line or "spill" in line):
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
    return out


def load(lib: pathlib.Path):
    fn = ctypes.CDLL(str(lib)).ring_hemm_bf16
    fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
    return fn


def max_clusters(lib: pathlib.Path):
    """Clusters of the variant's kernel resident at once, or None."""
    q = getattr(ctypes.CDLL(str(lib)), "ring_hemm_bf16_max_clusters", None)
    if q is None:
        return None
    q.argtypes, q.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    n = ctypes.c_int(0)
    err = q(ctypes.byref(n))
    return n.value if err == 0 else f"error {err}"


def call(fn, H, Vb, W, col0, b, accumulate=False):
    """W (=|+=) H[:, col0:col0+b] · Vb on variant ``fn`` (one launch)."""
    err = fn(H.data_ptr(), H.stride(0), col0, Vb.data_ptr(), Vb.shape[1],
             Vb.shape[0], W.data_ptr(), W.stride(0), H.shape[0], W.shape[1],
             b, int(accumulate), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return W


def timed(fn, reps):
    """(ms per call, median SM MHz, median W, samples) over ``reps``."""
    return sampled(lambda: time_ms(fn, reps))


def l2_tbs(name: str, N: int, k: int, ms: float):
    """TB/s of L2 -> shared-memory reads of variant ``name``'s call at
    (N, k) (K = N) in ``ms``; None for cuBLAS."""
    if name == "cublas":
        return None
    bn, cm, cn = VARIANTS.get(name, BASELINE)[:3]
    gx = -(-(-(-k // bn)) // cn) * cn
    gy = -(-(-(-N // 128)) // cm) * cm
    per_tile = 128 * 128 // cn + bn * 128 // cm
    return gx * gy * -(-N // 64) * per_tile / ms / 1e9


def report(N: int, k: int, name: str, r: dict) -> None:
    """One timing line of a variant (or cuBLAS) at (N, k)."""
    gflop = 2.0 * N * N * k / 1e9
    ms = r["ms"]
    l2 = l2_tbs(name, N, k, ms)
    print(f"[time] ({N}, {k}) {name:12s} {ms:8.3f} ms (fwd "
          f"{r['fwd']['ms']:.3f}, rev {r['rev']['ms']:.3f}) "
          f"{gflop / ms:6.1f} TFLOP/s {gflop / ms / PEAK_BF16:6.1%} "
          f"L2 {'-' if l2 is None else f'{l2:.2f}'} TB/s "
          f"err {r['err']:.3e} {'ok' if r['err'] <= 1e-5 else 'over'}"
          f"; SM {r['fwd']['mhz']}/{r['rev']['mhz']} MHz, "
          f"{r['fwd']['w']}/{r['rev']['w']} W", flush=True)


def rel(x, ref):
    return float((x.double() - ref).abs().max() / ref.abs().max())


def edge_checks(fns: dict, dev) -> int:
    """Every variant on ragged shapes against the f64 product; the number
    of (variant, shape) pairs past 1e-5 or touching W outside its
    window."""
    failed = 0
    g = torch.Generator(device=dev).manual_seed(3)
    cases = [(257, 40, 0, 300), (130, 3, 0, 17), (390, 200, 0, 100),
             (1000, 37, 0, 1000), (257, 40, 0, 700), (385, 193, 0, 700)] + [
        (200, 64 + c, c, 77 + 13 * c) for c in range(1, 8)]
    for m, k, col0, b in cases:
        # a row stride of whole 16 bytes (8 bf16), as TMA needs
        Hf = torch.randn((m, max(512, -(-(col0 + b + 8) // 8) * 8)),
                         generator=g, device=dev)
        if col0:
            Hf[:, col0 - 1] = float("inf")
            Hf[::2, col0 - 1] = float("nan")
        H = Hf.bfloat16()
        V = torch.randn((b, k), generator=g, device=dev)
        off = col0 % 8
        Vb = bf16_pack(V, off)
        ref = H[:, col0:col0 + b].double() @ V.bfloat16().double()
        Wfull = torch.randn((m, k + 30), generator=g, device=dev)
        prior = Wfull[:, 10:10 + k].double()
        ep = rel(H[:, col0:col0 + b].float() @ V.bfloat16().float(), ref)
        line = []
        for name, fn in fns.items():
            W = torch.empty((m, k), device=dev)
            call(fn, H, Vb, W, col0, b)
            Ws = Wfull.clone()
            call(fn, H, Vb, Ws[:, 10:10 + k], col0, b, accumulate=True)
            torch.cuda.synchronize()
            e1 = rel(W, ref)
            e2 = rel(Ws[:, 10:10 + k], ref + prior)
            outside = bool(torch.equal(Ws[:, :10], Wfull[:, :10])
                           and torch.equal(Ws[:, 10 + k:], Wfull[:, 10 + k:]))
            ok = e1 <= 1e-5 and e2 <= 1e-5 and outside
            failed += not ok
            # the card-only tests' second bound: 4x the plain version's
            # error (f32 sums of the rounded operands), at least 4e-7
            x4 = e1 <= 4 * max(ep, 1e-7)
            line.append(f"{name} {'ok' if ok else 'FAIL'} {max(e1, e2):.1e}"
                        f"{'' if x4 else ' >4x'}")
        print(f"[edge] (m, k, col0, b)=({m}, {k}, {col0}, {b}) plain "
              f"{ep:.1e}: " + "; ".join(line), flush=True)
    return failed


def f32_beside_baseline(base_lib, N: int, k: int, dev) -> dict:
    """The f32 route, which this probe's variants leave alone: the kept
    library's ring_hemm_f32 and the baseline's at (N, k), same inputs,
    timed in turns (baseline, kept, kept, baseline)."""
    from chase_tpu_torch.ops.ring_hemm import _lib, tf32_split
    old = ctypes.CDLL(str(base_lib)).ring_hemm_f32
    old.argtypes, old.restype = ARGTYPES, ctypes.c_int
    fns = {"baseline": old, "kept": _lib().main[torch.float32]}
    g = torch.Generator(device=dev).manual_seed(2)
    H = torch.randn((N, N), generator=g, device=dev)
    V = torch.randn((N, k), generator=g, device=dev)
    Vt = tf32_split(V, 0)
    W = torch.empty((N, k), device=dev)

    def run(fn):
        err = fn(H.data_ptr(), H.stride(0), 0, Vt.data_ptr(), Vt.shape[-1],
                 Vt.shape[-2], W.data_ptr(), W.stride(0), N, k, N, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")

    for fn in fns.values():
        run(fn)
    torch.cuda.synchronize()
    ms = {n: [] for n in fns}
    for n in ("baseline", "kept", "kept", "baseline"):
        ms[n].append(timed(lambda: run(fns[n]), 5))
    out = {n: dict(ms=statistics.mean(r[0] for r in v),
                   mhz=[r[1] for r in v], w=[r[2] for r in v])
           for n, v in ms.items()}
    print(f"[f32] ({N}, {k}) ring_hemm_f32: baseline "
          f"{out['baseline']['ms']:.3f} ms, kept {out['kept']['ms']:.3f} ms "
          f"(kept / baseline {out['kept']['ms'] / out['baseline']['ms']:.4f});"
          f" SM MHz baseline {out['baseline']['mhz']}, kept "
          f"{out['kept']['mhz']}", flush=True)
    return out


def cublas_kernel_names(Hb, Vb16) -> list:
    from torch.profiler import ProfilerActivity, profile
    torch.mm(Hb, Vb16, out_dtype=torch.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.mm(Hb, Vb16, out_dtype=torch.float32)
        torch.cuda.synchronize()
    return [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_time_total > 0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline")
    ap.add_argument("--widths", default="750,1500,3000")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--N", type=int, default=30000)
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "probe_design"
                                         / "bf16_route_design.json"))
    ap.add_argument("--summary")
    args = ap.parse_args()
    if args.summary:
        saved = json.loads(pathlib.Path(args.summary).read_text())
        print(saved["device"])
        for k, rows in saved["widths"].items():
            for name, r in rows.items():
                report(saved.get("N", args.N), int(k), name, r)
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    print(smi("name,power.limit"), flush=True)
    variants = {n: VARIANTS[n] for n in args.variants.split(",") if n}
    built = build_all(variants, args.baseline,
                      _build.BUILD_DIR / "probe_design")
    fns = {name: load(lib) for name, (lib, _) in built.items()}
    occupancy = {name: max_clusters(lib) for name, (lib, _) in built.items()}
    for name, n in occupancy.items():
        cm, cn = VARIANTS.get(name, (0, 1, 1, 0))[1:3]
        print(f"[occupancy] {name}: {n} clusters of {cm}x{cn} resident",
              flush=True)
    failed = edge_checks(fns, dev)

    results = {"device": smi("name,power.limit"), "N": args.N, "ptxas": {
        n: lines for n, (_, lines) in built.items()},
        "max_clusters": occupancy, "widths": {}}
    g = torch.Generator(device=dev).manual_seed(1)
    N = args.N
    H = torch.randn((N, N), generator=g, device=dev).bfloat16()
    H64 = H.double()
    for k in (int(w) for w in args.widths.split(",")):
        V = torch.randn((N, k), generator=g, device=dev)
        Vb = bf16_pack(V, 0)
        Vb16 = V.bfloat16()
        ref = H64 @ Vb16.double()
        W = torch.empty((N, k), device=dev)
        gflop = 2.0 * N * N * k / 1e9
        rows = {}
        for name, fn in fns.items():
            rows[name] = dict(err=rel(call(fn, H, Vb, W, 0, N), ref))
        rows["cublas"] = dict(err=rel(torch.mm(H, Vb16,
                                               out_dtype=torch.float32), ref))
        runs = {name: (lambda fn=fn: call(fn, H, Vb, W, 0, N))
                for name, fn in fns.items()}
        runs["cublas"] = lambda: torch.mm(H, Vb16, out_dtype=torch.float32)
        for fn in runs.values():
            fn()
        torch.cuda.synchronize()
        est = {n: timed(fn, 2)[0] for n, fn in runs.items()}
        order = list(runs)
        for rnd, names in (("fwd", order), ("rev", order[::-1])):
            for n in names:
                reps = max(5, int(400 / est[n]))
                ms, mhz, watt, ns = timed(runs[n], reps)
                rows[n][rnd] = dict(ms=ms, mhz=mhz, w=watt, samples=ns,
                                    reps=reps)
        for n, r in rows.items():
            r["ms"] = (r["fwd"]["ms"] + r["rev"]["ms"]) / 2
            r["tflops"] = gflop / r["ms"]
            report(N, k, n, r)
        results["widths"][k] = rows
        if k == max(int(w) for w in args.widths.split(",")):
            names = cublas_kernel_names(H, Vb16)
            results["cublas_kernels"] = names
            for key, ms in names:
                print(f"[cublas] kernel {key}: {ms:.3f} ms", flush=True)
        del V, Vb, Vb16, ref, W
        torch.cuda.empty_cache()
    if args.baseline:
        del H, H64
        torch.cuda.empty_cache()
        results["f32"] = f32_beside_baseline(built["baseline"][0], N, 3000,
                                             dev)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"results in {out}", flush=True)
    if failed:
        print(f"[edge] {failed} variant and shape pairs FAILED", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
