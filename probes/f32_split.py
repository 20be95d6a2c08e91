"""Probe of the f32 route's TF32 split on the card: the kept source's f32
kernel of csrc/ring_hemm.cu beside the same kernel with its split done by
``cvt.rna.tf32.f32``, and without the split's NaN guard, in one process
on one card.

    python probes/f32_split.py [--baseline DIR] [--widths 1500,1024,512,3000]
                               [--passes 4] [--reps 4] [--variants NAME,...]
                               [--out FILE]

Each variant is a copy of the kept sources with ``hopper::split_tf32``
(hopper_tf32.cuh) replaced, built into build/probe_f32/:

  kept      the sources as they are: hi and lo rounded to TF32 (nearest,
            ties away) by integer arithmetic, lo's bits held at most
            0x7FFFEFFF (the NaN guard) where the caller asks for it
  cvt       both roundings by cvt.rna.tf32.f32, everywhere
  noguard   the integer rounding without the NaN guard (a NaN with its top
            mantissa bits set reaches no product: it times the guard)
  addmax    the guard folded into lo's rounding add: max(r + 0x1000, r)
            (__viaddmax_s32, one VIADDMNMX on sm_90), which keeps the
            canonical NaN 0x7FFFFFFF where the add wraps

``--baseline DIR`` adds an earlier csrc/ (DIR holds its ring_hemm.cu and
hopper_tf32.cuh), e.g. the parent commit's:

    git archive <commit> chase_tpu_torch/csrc | tar -x -C build/base
    python probes/f32_split.py --baseline build/base/chase_tpu_torch/csrc

It prints each build's registers and spills of the 3xTF32 main kernels and
their instructions by opcode (cuobjdump -sass); checks that every build's
f32 pre-pass gives the kept bits for every finite value of a V of ties,
subnormals, zeros, FLT_MAX and random entries, and what each makes of
NaNs of either sign and of infinities; that every build's f32 product of
an H holding such values, and at each timed shape, is bitwise the kept
one; then at (N, k) = (30000, w) for each width it times the f32 main
kernel alone (its pre-pass output made once) and the f32 pre-pass in
turns, forward then reverse order, ``--passes`` times (each ``--reps``
calls at k >= 1500, twice as many below), with TFLOP/s at
2·N²·k and the SM clock and power draw that nvidia-smi sampled while it
ran; the c64 pre-pass (30000, 3000) too.  The results also go to
``--out`` as JSON (default build/probe_f32/f32_split.json).
"""

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chase_tpu_torch import _build  # noqa: E402
from chip_smoke import (MAIN_KERNELS, kernel_registers, sampled,  # noqa: E402
                        time_ms)

PEAK_3XTF32 = 165.0          # TFLOP/s, H100 SXM: TF32 495 / 3
OUT_DIR = ROOT / "build" / "probe_f32"
BK, BN = 32, 128             # the f32 kernel's K tile and W column tile
ARGS_SPLIT = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p]
ARGS_MAIN = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]

SPLIT_BODY = """  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  int r = __float_as_int(x - __uint_as_float(hi));
  if (KEEP_NAN) r = min(r, 0x7FFFEFFF);
  lo = (static_cast<uint32_t>(r) + 0x1000u) & 0xFFFFE000u;
"""
BODIES = {
    "cvt": """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
""",
    "noguard": SPLIT_BODY.replace(
        "  if (KEEP_NAN) r = min(r, 0x7FFFEFFF);\n", ""),
    "addmax": """  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  const int r = __float_as_int(x - __uint_as_float(hi));
  lo = (KEEP_NAN ? static_cast<uint32_t>(__viaddmax_s32(r, 0x1000, r))
                 : static_cast<uint32_t>(r) + 0x1000u) & 0xFFFFE000u;
""",
}
VARIANTS = ("kept", "cvt", "noguard", "addmax")
# f32 bit patterns of the edge values: ties (low 13 bits 0x1000) of both
# signs, one carrying into the exponent, zeros, subnormals, FLT_MAX; then
# the non-finite ones
EDGES = (0x3F801000, 0xBF801000, 0x3FFFF000, 0xC7001000, 0x00000000,
         0x80000000, 0x00000001, 0x00001000, 0x007FFFFF, 0x80003001,
         0x7F7FFFFF, 0xFF7FFFFF, 0x3F800FFF, 0x3F803000)
NON_FINITE = (0x7F800000, 0xFF800000, 0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000,
              0x7F800001)


def variant_sources(name: str) -> tuple:
    """(ring_hemm.cu, hopper_tf32.cuh) texts of variant ``name``; the .cu
    includes the variant's header by its path under OUT_DIR."""
    cu = (_build.CSRC_DIR / "ring_hemm.cu").read_text()
    cuh = (_build.CSRC_DIR / "hopper_tf32.cuh").read_text()
    if name != "kept":
        assert cuh.count(SPLIT_BODY) == 1, "split_tf32 changed"
        cuh = cuh.replace(SPLIT_BODY, BODIES[name])
    header = OUT_DIR / f"hopper_tf32_{name}.cuh"
    return (cu.replace('#include "hopper_tf32.cuh"',
                       f'#include "{header}"'), cuh, header)


def build_all(names, baseline) -> dict:
    """nvcc every variant at once; {name: (lib, ptxas log)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        cu, cuh, header = variant_sources(name)
        header.write_text(cuh)
        src = OUT_DIR / f"ring_hemm_{name}.cu"
        src.write_text(cu)
        jobs[name] = src
    if baseline:
        jobs["baseline"] = pathlib.Path(baseline) / "ring_hemm.cu"
    procs, t0 = {}, time.time()
    for name, src in jobs.items():
        lib = OUT_DIR / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"[build] {name} FAILED (rc {proc.returncode}):\n{log}",
                  flush=True)
            continue
        built[name] = (lib, log)
    print(f"[build] {len(built)}/{len(jobs)} built in "
          f"{time.time() - t0:.1f} s", flush=True)
    return built


def sass_counts(lib: pathlib.Path) -> dict:
    """{kernel: (instructions, the 12 commonest opcodes)} of the 3xTF32
    main kernels (cuobjdump -sass)."""
    exe = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(exe), "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = next((n for n, pat in MAIN_KERNELS.items()
                       if re.search(pat, line)), None)
            if fn:
                counts[fn] = {}
            continue
        if fn and "/*" in line and ";" in line:
            words = line.split("*/", 1)[1].strip().split()
            op = words[1] if words[0].startswith("@") else words[0]
            op = op.rstrip(";").split(".")[0]
            counts[fn][op] = counts[fn].get(op, 0) + 1
    return {fn: (sum(c.values()),
                 dict(sorted(c.items(), key=lambda kv: -kv[1])[:12]))
            for fn, c in sorted(counts.items())}


class Route:
    """A build's f32 pre-pass, f32 main kernel and c64 pre-pass."""

    def __init__(self, lib: pathlib.Path):
        dll = ctypes.CDLL(str(lib))
        self.split, self.main, self.csplit = (
            dll.ring_hemm_split_f32, dll.ring_hemm_f32,
            dll.ring_hemm_split_c64)
        for f, a in ((self.split, ARGS_SPLIT), (self.main, ARGS_MAIN),
                     (self.csplit, ARGS_SPLIT)):
            f.argtypes, f.restype = a, ctypes.c_int

    @staticmethod
    def shape(b: int, k: int, bk: int = BK, bn: int = BN) -> tuple:
        return bk * max(1, -(-b // bk)), bn * max(1, -(-k // bn))

    def prepass(self, V, Vt=None):
        """The f32 pre-pass of V (b × k) into Vt (2 × w_pad × b_pad)."""
        b, k = V.shape
        b_pad, w_pad = self.shape(b, k)
        if Vt is None:
            Vt = torch.empty((2, w_pad, b_pad), dtype=torch.float32,
                             device=V.device)
        err = self.split(V.data_ptr(), V.stride(0), Vt.data_ptr(), b, k, 0,
                         b_pad, w_pad, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pre-pass failed: {err}")
        return Vt

    def cprepass(self, V, Vt):
        """The c64 pre-pass of V (b × k c64) into Vt (6 × w_pad × b_pad)."""
        b, k = V.shape
        err = self.csplit(V.data_ptr(), V.stride(0), Vt.data_ptr(), b, k, 0,
                          Vt.shape[2], Vt.shape[1],
                          torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"c64 pre-pass failed: {err}")

    def product(self, H, Vt, W):
        """W = H · V (one main launch), V given as its pre-pass ``Vt``."""
        m, b = H.shape
        err = self.main(H.data_ptr(), H.stride(0), 0, Vt.data_ptr(),
                        Vt.shape[2], Vt.shape[1], W.data_ptr(), W.stride(0),
                        m, W.shape[1], b, 0,
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return W


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def edge_checks(routes: dict, dev, g) -> dict:
    """Each build's pre-pass and product on edge values against the kept
    build's: bitwise on every finite value, and which of hi, lo is NaN for
    each non-finite one."""
    def f32(patterns):
        return torch.tensor(patterns, dtype=torch.int64).to(
            torch.int32).view(torch.float32).to(dev)
    b, k, ne = 256, 160, len(EDGES)
    V = torch.randn((b, k), generator=g, device=dev)
    V[:32, :ne] = f32(EDGES)
    V[40, ne:2 * ne] = f32(EDGES)
    V[b - 1, :len(NON_FINITE)] = f32(NON_FINITE)
    finite = torch.isfinite(V).T
    ref = routes["kept"].prepass(V)
    # H holds the edge values in its first columns, bar FLT_MAX (10, 11),
    # whose TF32 rounding is inf and whose products are NaN
    H = torch.randn((200, b), generator=g, device=dev)
    H[:, :ne] = f32(EDGES)
    H[:, 10:12] = f32((0x7E801000, 0xFE801000)) * 2.0 ** -120
    Vf = V.masked_fill(~torch.isfinite(V), 1.0)
    Vf[10:12] = 1.0
    Wref = routes["kept"].product(H, routes["kept"].prepass(Vf),
                                  torch.empty((200, k), device=dev))
    out = {}
    for name, r in routes.items():
        Vt = r.prepass(V)
        same = bool(torch.equal(bits(Vt[:, :k, :b])[:, finite],
                                bits(ref[:, :k, :b])[:, finite]))
        nonfin = {f"{x:#010x}": (bool(torch.isnan(Vt[0, i, b - 1])),
                                 bool(torch.isnan(Vt[1, i, b - 1])))
                  for i, x in enumerate(NON_FINITE)}
        W = r.product(H, r.prepass(Vf), torch.empty((200, k), device=dev))
        torch.cuda.synchronize()
        prod = bool(torch.equal(bits(W), bits(Wref)))
        print(f"[edge] {name:8s} pre-pass bits of every finite value as "
              f"kept: {same}; product of H holding the edge values bitwise "
              f"as kept: {prod}; (hi NaN, lo NaN) of "
              + ", ".join(f"{x} {v}" for x, v in nonfin.items()),
              flush=True)
        out[name] = dict(prepass_bitwise=same, product_bitwise=prod,
                         non_finite=nonfin)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline")
    ap.add_argument("--widths", default="1500,1024,512,3000")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=str(OUT_DIR / "f32_split.json"))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__}", flush=True)
    names = args.variants.split(",")
    assert names[0] == "kept", "the kept build comes first"
    built = build_all(names, args.baseline)
    results = {"device": smi, "registers": {}, "sass": {}, "times": {}}
    for name, (lib, log) in built.items():
        regs = kernel_registers(log)
        sass = sass_counts(lib)
        results["registers"][name], results["sass"][name] = regs, sass
        print(f"[build] {name}: (registers, spill store / load bytes) "
              + "; ".join(f"{n} {v}" for n, v in regs.items()), flush=True)
        for fn, (total, ops) in sass.items():
            print(f"[sass] {name} {fn}: {total} instructions; {ops}",
                  flush=True)
    dev = torch.device("cuda", 0)
    routes = {name: Route(lib) for name, (lib, _) in built.items()}
    g = torch.Generator(device=dev).manual_seed(20261018)
    results["edges"] = edge_checks(routes, dev, g)
    N = 30000
    H = torch.randn((N, N), generator=g, device=dev)
    names = list(routes)
    for k in (int(w) for w in args.widths.split(",")):
        V = torch.randn((N, k), generator=g, device=dev)
        Vts = {n: r.prepass(V) for n, r in routes.items()}
        W = torch.empty((N, k), device=dev)
        Wk = routes["kept"].product(H, Vts["kept"], W).clone()
        same = {}
        for n in names:
            routes[n].product(H, Vts[n], W)
            torch.cuda.synchronize()
            same[n] = bool(torch.equal(bits(W), bits(Wk)))
        del Wk
        reps = args.reps if k >= 1500 else 2 * args.reps
        runs = {n: [] for n in names}
        pre = {n: [] for n in names}
        for order in [names, names[::-1]] * (args.passes // 2):
            for n in order:
                ms, mhz, w, _ = sampled(lambda: time_ms(
                    lambda: routes[n].product(H, Vts[n], W), reps))
                runs[n].append((ms, mhz, w))
                pre[n].append(time_ms(lambda: routes[n].prepass(V, Vts[n]),
                                      20))
        gflop = 2.0 * N * N * k / 1e9
        for n in names:
            ms = sum(r[0] for r in runs[n]) / len(runs[n])
            pms = sum(pre[n]) / len(pre[n])
            print(f"[time] ({N}, {k}) {n:8s} {ms:8.3f} ms "
                  f"({' / '.join(f'{r[0]:.3f}' for r in runs[n])}) "
                  f"{gflop / ms:6.1f} TFLOP/s {gflop / ms / PEAK_3XTF32:6.1%}"
                  f"; bitwise as kept {same[n]}; SM "
                  f"{'/'.join(f'{r[1]:.0f}' for r in runs[n])} MHz, "
                  f"{'/'.join(f'{r[2]:.0f}' for r in runs[n])} W; "
                  f"pre-pass {pms:.4f} ms", flush=True)
            results["times"][f"{k}:{n}"] = dict(
                ms=ms, runs=runs[n], bitwise=same[n], prepass_ms=pms,
                prepass_runs=pre[n])
        del Vts, V, W
        torch.cuda.empty_cache()
    del H
    V = torch.randn((N, 3000), generator=g, device=dev, dtype=torch.complex64)
    b_pad, w_pad = Route.shape(N, 3000, 16, 64)
    Vt = torch.empty((6, w_pad, b_pad), device=dev)
    Vk = torch.empty_like(Vt)
    routes["kept"].cprepass(V, Vk)
    for order in [names, names[::-1]] * (args.passes // 2):
        for n in order:
            results["times"].setdefault(f"c64 pre-pass:{n}", []).append(
                time_ms(lambda: routes[n].cprepass(V, Vt), 20))
            results.setdefault("c64_prepass_bitwise", {})[n] = bool(
                torch.equal(bits(Vt), bits(Vk)))
    for n in names:
        t = results["times"][f"c64 pre-pass:{n}"]
        print(f"[time] c64 pre-pass ({N}, 3000) {n:8s} "
              f"{sum(t) / len(t):.4f} ms ({' / '.join(f'{x:.4f}' for x in t)})"
              f"; bitwise as kept {results['c64_prepass_bitwise'][n]}",
              flush=True)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
