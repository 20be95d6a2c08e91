"""Probe of the c64 route's design on the card: the kept c64 kernel of
csrc/ring_hemm.cu (the complex product in three real products, 3M)
beside variants of it and beside an earlier source's c64 route, in one
process on one card.

    python probes/c64_route_design.py [--baseline DIR] [--widths 750,3000]
                                      [--passes 4] [--variants NAME,...]
                                      [--out FILE]

Each variant is a copy of the kept source with one part of the c64
kernel replaced, built into build/probe_c64/:

  kept        the source as it is
  gauss       Gauss's form, T1 = Hr·Vr, T2 = Hi·Vi, T3 = Hs·(Vr + Vi), Re =
              T1 − T2, Im = T3 − T1 − T2 (five adds a promotion where the
              kept form takes four; the probe makes its planes in torch)
  p1          promotion after every 8-deep k-step (fresh accumulators for
              each), the next k-step's fragments read while one runs
  stages4     4 pipeline stages instead of 5
  pingpong    the consumers take turns on the tensor pipe, as CUTLASS's
              ping-pong kernels do: one issues its tile's wgmma only after
              the other has issued its own (named barriers 1 and 2)
  lds128      16-byte fragment loads: K permuted inside each k-step, here
              and in the pre-pass output (by the probe), so that a
              thread's two complex columns of a row are neighbours
  prefetch    the second k-step's (re, im) pairs read before the first
              k-step's wgmma are issued, split after
  noclamp     Hs split without the NaN clamp of its bits
  addsat      Hs's rounding add saturating (add.sat.s32) in place of the
              clamp
  cvt2, int_rawlo, cvt_rawlo, veltkamp_rawlo, cvthi_intlo, trunc_rawlo
              the A fragments' TF32 split done otherwise (SPLITS below):
              cvt2 by two cvt.rna (split_tf32); the _rawlo ones leave lo
              as the exact f32 remainder x − hi, which the tensor core
              reads as TF32; trunc_ truncates hi
  no_reload   the kept loop, but the A fragments read once, at the first
              tile (wrong products: it times the loop without its
              fragment loads and TF32 splits)
  no_promote  the kept loop without the per-tile IEEE promotion (wrong
              products: the loop without the promotion's FP32 adds)
  mma_only    the wgmma alone: fragments read once, one accumulator chain
              over all of K, one group in flight, stages released as the
              next group's wait retires them (wrong products: the tensor
              pipe's rate at this tile)

``--baseline DIR`` adds an earlier source (DIR holds its ring_hemm.cu and
hopper_tf32.cuh) whose c64 route is the f32 kernel on the float views
with the real-expansion pre-pass (``ring_hemm_split_c64`` then
``ring_hemm_f32``), e.g. the parent commit's:

    git archive <commit> chase_tpu_torch/csrc | tar -x -C build/base
    python probes/c64_route_design.py --baseline build/base/chase_tpu_torch/csrc

It prints each build's registers, spills and ptxas warnings and the c64
kernels' instructions by opcode (cuobjdump -sass), then at (N, k) =
(30000, w) for each width times every main kernel alone (its pre-pass
output made once) in turns, forward then reverse order, ``--passes``
times, with its error against a c128 product, TFLOP/s at the complex
product's 8·N²·k and the SM clock and power draw that nvidia-smi
sampled while it ran.  The results also go to ``--out`` as JSON
(default build/probe_c64/c64_route_design.json).
"""

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chase_tpu_torch import _build  # noqa: E402
from chip_smoke import sampled, time_ms  # noqa: E402

PEAK_3XTF32 = 165.0          # TFLOP/s, H100 SXM: TF32 495 / 3
OUT_DIR = ROOT / "build" / "probe_c64"
ARGS_SPLIT = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p]
ARGS_MAIN = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]

LOOP_START = "    Frag f0, f1;\n    if (ntiles > 0) load_a(0, 0, f0);\n"
LOOP_END = ("    // epilogue: d[4j + 2h + e] is row tile_row(arow + 8h), "
            "complex column")
FENCE_T = "fence_regs(k1); fence_regs(k2); fence_regs(k3);"
PROMOTE = """#pragma unroll
      for (int i = 0; i < 32; ++i) {
        re[i] += k1[i] - k3[i];
        im[i] += k1[i] + k2[i];
      }"""
LOOPS = {
    "p1": f"""    Frag f0, f1;
    if (ntiles > 0) load_a(0, 0, f0);
    for (int t = 0; t < ntiles; ++t) {{
      {FENCE_T}
      wgmma_fence();
      mma(t, 0, f0, 0);
      wgmma_commit();
      load_a(t, 1, f1);
      wgmma_wait<0>();
      {FENCE_T}
      c64r::fence(f0);
      {PROMOTE}
      {FENCE_T}
      wgmma_fence();
      mma(t, 1, f1, 0);
      wgmma_commit();
      if (t + 1 < ntiles) load_a(t + 1, 0, f0);
      wgmma_wait<0>();
      {FENCE_T}
      c64r::fence(f0);
      c64r::fence(f1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[t % STAGES]);
      {PROMOTE}
    }}
""",
    "mma_only": f"""    Frag f0, f1;
    if (ntiles > 0) {{
      load_a(0, 0, f0);
      load_a(0, 1, f1);
    }}
    {FENCE_T}
    for (int t = 0; t < ntiles; ++t) {{
      if (t > 0) mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
      wgmma_fence();
      mma(t, 0, f0, t > 0);
      mma(t, 1, f1, 1);
      wgmma_commit();
      if (t > 0) {{
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
      }}
    }}
    wgmma_wait<0>();
    {FENCE_T}
    c64r::fence(f0);
    c64r::fence(f1);
    __syncwarp();
    if (ntiles > 0 && lane == 0) mbar_arrive(&empty[(ntiles - 1) % STAGES]);
    {PROMOTE}
""",
}


SET = """__device__ __forceinline__ void set(Frag& f, int v, float2 h) {
  const float s = __int_as_float(min(__float_as_int(h.x + h.y), 0x7FFFEFFF));
  split_rna(s, f.hi[0][v], f.lo[0][v]);
  split_rna(h.x, f.hi[1][v], f.lo[1][v]);
  split_rna(h.y, f.hi[2][v], f.lo[2][v]);
}"""
# the A fragments' TF32 split (x = hi + lo) done otherwise than the kept
# split_rna (both rounded to nearest, ties away, by integer arithmetic):
# both by cvt.rna (split_tf32), hi by cvt.rna, by integer rounding, by
# Veltkamp's FP32 split (t = x·(2^13 + 1), hi = t − (t − x): nearest even)
# or by truncation, lo by integer rounding or left as the exact f32 x − hi
# for the tensor core to read as TF32
SPLITS = {
    "cvt2": "split_tf32(x, hi, lo);",
    "int_rawlo": "hi = (__float_as_uint(x) + 0x1000u) & ~0x1FFFu; "
                 "lo = __float_as_uint(x - __uint_as_float(hi));",
    "cvt_rawlo": "hi = tf32_rna(x); lo = __float_as_uint(x - "
                 "__uint_as_float(hi));",
    "veltkamp_rawlo": "float t = __fmul_rn(x, 8193.0f); "
                      "float y = __fsub_rn(t, __fsub_rn(t, x)); "
                      "hi = __float_as_uint(y); "
                      "lo = __float_as_uint(__fsub_rn(x, y));",
    "cvthi_intlo": "hi = tf32_rna(x); float r = x - __uint_as_float(hi); "
                   "lo = (__float_as_uint(r) + 0x1000u) & ~0x1FFFu;",
    "trunc_rawlo": "hi = __float_as_uint(x) & ~0x1FFFu; "
                   "lo = __float_as_uint(x - __uint_as_float(hi));",
}
# addsat: Hs's rounding add saturating (add.sat.s32: a positive NaN's
# bits stay below the sign) in place of the clamp
ADDSAT = ("""  split_rna(s, f.hi[0][v], f.lo[0][v]);""", """  {
    int hb;
    asm("add.sat.s32 %0, %1, 4096;" : "=r"(hb) : "r"(__float_as_int(h.x + h.y)));
    f.hi[0][v] = static_cast<uint32_t>(hb) & 0xFFFFE000u;
    const float r = (h.x + h.y) - __uint_as_float(f.hi[0][v]);
    f.lo[0][v] = (__float_as_uint(r) + 0x1000u) & 0xFFFFE000u;
  }""")
# prefetch: the second k-step's (re, im) pairs read into registers before
# the first k-step's wgmma are issued, split after
PREFETCH_LOOP = f"""    auto raw = [&](int t, int ks, float2 (&x)[4]) {{
      const float* Ht =
          reinterpret_cast<const float*>(smem + (t % STAGES) * STAGE_BYTES);
#pragma unroll
      for (int v = 0; v < 4; ++v) {{
        const int h = v & 1, hv = v >> 1;
        const int i = TU == 0
            ? base[h] + (key[h] ^ ((4 * ks + 2 * hv) << 2))
            : base[h] + 32 * (8 * ks + 4 * hv) + (key[h] ^ (hv << 4));
        x[v] = *reinterpret_cast<const float2*>(Ht + i);
      }}
    }};
    Frag f0, f1;
    float2 x1[4];
    if (ntiles > 0) load_a(0, 0, f0);
    for (int t = 0; t < ntiles; ++t) {{
      raw(t, 1, x1);
      {FENCE_T}
      wgmma_fence();
      mma(t, 0, f0, 0);
      wgmma_commit();
#pragma unroll
      for (int v = 0; v < 4; ++v) c64r::set(f1, v, x1[v]);
      wgmma_fence();
      mma(t, 1, f1, 1);
      wgmma_commit();
      if (t + 1 < ntiles) {{
        wgmma_wait<1>();
        c64r::fence(f0);
        load_a(t + 1, 0, f0);
      }}
      wgmma_wait<0>();
      {FENCE_T}
      c64r::fence(f0);
      c64r::fence(f1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[t % STAGES]);
      {PROMOTE}
    }}
"""
NOCLAMP = ("  const float s = __int_as_float(min(__float_as_int(h.x + h.y), "
           "0x7FFFEFFF));", "  const float s = h.x + h.y;")
# gauss: fragment slots Hr, Hi, Hs against planes Vr, Vi, Vs
GAUSS = (("""  split_rna(s, f.hi[0][v], f.lo[0][v]);
  split_rna(h.x, f.hi[1][v], f.lo[1][v]);
  split_rna(h.y, f.hi[2][v], f.lo[2][v]);""", """  split_rna(h.x, f.hi[0][v], f.lo[0][v]);
  split_rna(h.y, f.hi[1][v], f.lo[1][v]);
  split_rna(s, f.hi[2][v], f.lo[2][v]);"""), ("""        re[i] += k1[i] - k3[i];
        im[i] += k1[i] + k2[i];""", """        re[i] += k1[i] - k2[i];
        im[i] += k3[i] - (k1[i] + k2[i]);"""))
# lds128: each thread's two complex K columns of a row, q and q + 4, read
# as one 16-byte load, K permuted inside each 8-deep k-step so that they
# are neighbours (B row kk of a k-step holds V row 2 (kk % 4) + kk / 4);
# rows permuted so that a quarter-warp's 16-byte loads meet 8 distinct
# chunks (swizzle keys r, r + 4 for its two rows); untransposed only
LDS128_ROW = ("    return (L & ~7) | ((L & 3) << 1) | ((L >> 2) & 1);",
              "    return (L & ~7) | ((L & 1) << 2) | ((L >> 1) & 3);")
LDS128_LOAD = ("""#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int h = v & 1, hv = v >> 1;
        const int i = TU == 0
            ? base[h] + (key[h] ^ ((4 * ks + 2 * hv) << 2))
            : base[h] + 32 * (8 * ks + 4 * hv) + (key[h] ^ (hv << 4));
        float2 x = *reinterpret_cast<const float2*>(Ht + i);
        if (hv == 0 && left) x = make_float2(0.0f, 0.0f);
        c64r::set(f, v, x);
      }""", """#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int P = c64r::tile_row<TU>(arow + 8 * h);
        const int i = P * 32 + ((((4 * ks + q) ^ (P & 7))) << 2);
        const float4 x = *reinterpret_cast<const float4*>(Ht + i);
        c64r::set(f, h, make_float2(x.x, x.y));
        c64r::set(f, h + 2, make_float2(x.z, x.w));
      }""")
PINGPONG = f"""    Frag f0, f1;
    if (ntiles > 0) load_a(0, 0, f0);
    const int wait_bar = 1 + wg, signal_bar = 2 - wg;
    for (int t = 0; t < ntiles; ++t) {{
      if (wg == 1 || t > 0)
        asm volatile("bar.sync %0, 256;" :: "r"(wait_bar) : "memory");
      {FENCE_T}
      wgmma_fence();
      mma(t, 0, f0, 0);
      wgmma_commit();
      load_a(t, 1, f1);
      wgmma_fence();
      mma(t, 1, f1, 1);
      wgmma_commit();
      asm volatile("bar.arrive %0, 256;" :: "r"(signal_bar) : "memory");
      if (t + 1 < ntiles) {{
        wgmma_wait<1>();
        c64r::fence(f0);
        load_a(t + 1, 0, f0);
      }}
      wgmma_wait<0>();
      {FENCE_T}
      c64r::fence(f0);
      c64r::fence(f1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[t % STAGES]);
      {PROMOTE}
    }}
    if (wg == 0 && ntiles > 0)
      asm volatile("bar.sync %0, 256;" :: "r"(wait_bar) : "memory");
"""


def replaced(src: str, *pairs) -> str:
    for old, new in pairs:
        assert src.count(old) == 1, old[:60]
        src = src.replace(old, new)
    return src


def variant_source(name: str, kept: str) -> str:
    """The kept source with variant ``name``'s change."""
    if name == "kept":
        return kept
    if name == "gauss":
        return replaced(kept, *GAUSS)
    if name == "noclamp":
        return replaced(kept, NOCLAMP)
    if name == "addsat":
        return replaced(kept, NOCLAMP, ADDSAT)
    if name == "lds128":
        return replaced(kept, LDS128_ROW, LDS128_LOAD)
    if name == "stages4":
        return replaced(kept, ("constexpr int STAGES = 5;",
                               "constexpr int STAGES = 4;"))
    if name in SPLITS:
        body = ("__device__ __forceinline__ void split_v(float x, "
                "uint32_t& hi, uint32_t& lo) {\n  " + SPLITS[name] +
                "\n}\n" + SET.replace("split_rna", "split_v"))
        return replaced(kept, (SET, body))
    a = kept.index(LOOP_START)
    b = kept.index(LOOP_END, a)
    loop = kept[a:b]
    if name in LOOPS:
        loop = LOOPS[name]
    elif name == "pingpong":
        loop = PINGPONG
    elif name == "prefetch":
        loop = PREFETCH_LOOP
    elif name == "no_reload":
        loop = replaced(loop, ("      load_a(t, 1, f1);",
                               "      if (t == 0) load_a(t, 1, f1);"),
                        ("        load_a(t + 1, 0, f0);",
                         "        mbar_wait(&full[(t + 1) % STAGES], "
                         "((t + 1) / STAGES) & 1);"))
    elif name == "no_promote":
        head = loop.index("#pragma unroll")
        loop = loop[:head] + "      if (t == ntiles - 1) {\n" + \
            loop[head:].replace("\n    }\n", "\n      }\n    }\n", 1)
    else:
        raise SystemExit(f"unknown variant {name}")
    return kept[:a] + loop + kept[b:]


VARIANTS = ("kept", "gauss", "p1", "stages4", "pingpong", "lds128",
            "prefetch", "noclamp", "addsat", *SPLITS, "no_reload",
            "no_promote", "mma_only")


def build_all(names, baseline) -> dict:
    """nvcc every variant at once; {name: (lib, ptxas lines)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    kept = (_build.CSRC_DIR / "ring_hemm.cu").read_text()
    jobs = {}
    for name in names:
        src = OUT_DIR / f"ring_hemm_{name}.cu"
        src.write_text(variant_source(name, kept).replace(
            '#include "hopper_tf32.cuh"',
            f'#include "{_build.CSRC_DIR / "hopper_tf32.cuh"}"'))
        jobs[name] = src
    if baseline:
        jobs["baseline"] = pathlib.Path(baseline) / "ring_hemm.cu"
    procs = {}
    t0 = time.time()
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
        built[name] = (lib, ptxas_lines(log))
    print(f"[build] {len(built)}/{len(jobs)} built in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, (lib, lines) in built.items():
        print(f"[build] {name}: " + " | ".join(lines), flush=True)
        if name != "baseline":
            print(f"[sass] {name}: {sass_counts(lib)}", flush=True)
    return built


def sass_counts(lib: pathlib.Path) -> dict:
    """Instructions of each c64 main kernel by opcode (cuobjdump -sass)."""
    exe = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(exe), "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = ("c64 t" if "kernel_c64ILi1" in line else
                  "c64" if "kernel_c64ILi0" in line else None)
            if fn:
                counts[fn] = {}
            continue
        if fn and "/*" in line and ";" in line:
            op = line.split("*/", 1)[1].strip().split()[0]
            if op.startswith("@"):
                op = line.split("*/", 1)[1].strip().split()[1]
            op = op.split(".")[0]
            counts[fn][op] = counts[fn].get(op, 0) + 1
    return {fn: dict(sorted(c.items(), key=lambda kv: -kv[1])[:16])
            for fn, c in counts.items()}


def ptxas_lines(log: str) -> list:
    """Registers and spills of each main kernel, and every warning."""
    out, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            fn = ("c64" if "kernel_c64" in line else
                  "f32" if "ring_hemm_kernel" in line else None)
            continue
        if "warning" in line.lower() or "Performance" in line:
            out.append(line.strip())
        elif fn and ("registers" in line or "spill" in line):
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
    return out


def route(lib: pathlib.Path, name: str):
    """(split, main, planes, tiles) of a library's c64 route: the kept
    form (six planes, ring_hemm_c64) or the baseline's real expansion
    (two planes of the (2b × 2k) B, ring_hemm_f32 on the float views)."""
    dll = ctypes.CDLL(str(lib))
    split = dll.ring_hemm_split_c64
    split.argtypes, split.restype = ARGS_SPLIT, ctypes.c_int
    if name == "baseline":
        main = dll.ring_hemm_f32
        main.argtypes, main.restype = ARGS_MAIN, ctypes.c_int
        return split, main, 2, (32, 128, 2)
    main = dll.ring_hemm_c64
    main.argtypes, main.restype = ARGS_MAIN, ctypes.c_int
    return split, main, 6, (16, 64, 1)


def gauss_planes(V, b_pad, w_pad):
    """gauss's six planes of V: Vr, Vi, fl(Vr + Vi), each TF32 hi then lo
    (nearest, ties away), K-major."""
    def rna(x):
        return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
            torch.float32)
    b, k = V.shape
    Vt = torch.zeros((6, w_pad, b_pad), dtype=torch.float32, device=V.device)
    re, im = V.real.contiguous(), V.imag.contiguous()
    for c, X in enumerate((re, im, re + im)):
        hi = rna(X)
        Vt[2 * c, :k, :b] = hi.T
        Vt[2 * c + 1, :k, :b] = rna(X - hi).T
    return Vt


def prepare(fns, V, permute=False, gauss=False):
    """The route's pre-pass output of V (b × k c64), made once."""
    split, _, planes, (bk, bn, w) = fns
    b, k = V.shape
    b_pad = bk * -(-(w * b) // bk)
    w_pad = bn * -(-(w * k) // bn)
    Vt = torch.empty((planes, w_pad, b_pad), dtype=torch.float32,
                     device=V.device)
    err = split(V.data_ptr(), V.stride(0), Vt.data_ptr(), b, k, 0, b_pad,
                w_pad, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pre-pass failed: {err}")
    if gauss:
        Vt = gauss_planes(V, b_pad, w_pad)
    if permute:                  # lds128's K order inside each k-step
        c = torch.arange(b_pad, device=V.device)
        c = (c & ~7) | (2 * (c & 3) + ((c >> 2) & 1))
        Vt = Vt[:, :, c].contiguous()
    return Vt


def call(fns, H, Vt, W):
    """W = H · V on the route (one main launch), V given as ``Vt``."""
    _, main, _, (_, _, w) = fns
    m, b = H.shape
    k = W.shape[1]
    err = main(H.data_ptr(), 2 * H.stride(0), 0, Vt.data_ptr(), Vt.shape[2],
               Vt.shape[1], W.data_ptr(), 2 * W.stride(0), m, w * k, w * b,
               0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return W


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline")
    ap.add_argument("--widths", default="750,3000")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=str(OUT_DIR / "c64_route_design.json"))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__}", flush=True)
    built = build_all(args.variants.split(","), args.baseline)
    dev = torch.device("cuda", 0)
    fns = {name: route(lib, name) for name, (lib, _) in built.items()}
    g = torch.Generator(device=dev).manual_seed(20261018)
    N = 30000
    H = torch.randn((N, N), generator=g, device=dev, dtype=torch.complex64)
    results = {"device": smi, "ptxas": {n: l for n, (_, l) in built.items()},
               "times": {}}
    for k in (int(w) for w in args.widths.split(",")):
        V = torch.randn((N, k), generator=g, device=dev,
                        dtype=torch.complex64)
        ref = (H.to(torch.complex128) @ V.to(torch.complex128))
        scale = float(ref.abs().max())
        W = torch.empty((N, k), dtype=torch.complex64, device=dev)
        Vts = {name: prepare(f, V, name == "lds128", name == "gauss")
               for name, f in fns.items()}
        errs = {}
        for name, f in fns.items():
            call(f, H, Vts[name], W)
            torch.cuda.synchronize()
            errs[name] = float((W.to(torch.complex128) - ref).abs().max()
                               / scale)
        del ref
        reps = 4 if k >= 1500 else 12
        names = list(fns)
        runs = {n: [] for n in names}
        for order in [names, names[::-1]] * (args.passes // 2):
            for name in order:
                ms, mhz, w, _ = sampled(lambda: time_ms(
                    lambda: call(fns[name], H, Vts[name], W), reps))
                runs[name].append((ms, mhz, w))
        gflop = 8.0 * N * N * k / 1e9
        for name in names:
            ms = sum(r[0] for r in runs[name]) / len(runs[name])
            print(f"[time] ({N}, {k}) {name:10s} {ms:8.3f} ms "
                  f"({' / '.join(f'{r[0]:.3f}' for r in runs[name])}) "
                  f"{gflop / ms:6.1f} TFLOP/s "
                  f"{gflop / ms / PEAK_3XTF32:6.1%} err {errs[name]:.3e}; "
                  f"SM {runs[name][0][1]}/{runs[name][1][1]} MHz, "
                  f"{runs[name][0][2]}/{runs[name][1][2]} W", flush=True)
            results["times"][f"{k}:{name}"] = dict(
                ms=ms, runs=runs[name], err=errs[name])
        del Vts, V, W
        torch.cuda.empty_cache()
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
