"""Probe of ring_hemm's trans route (csrc/ring_hemm.cu) on the card: its
main kernel beside the untransposed route at the same (m, b, k), beside
cuBLAS on the slab's conjugate-transposed view, and beside an earlier
source's trans route, in one process on one card.

    python probes/ring_trans_design.py [--baseline DIR] [--out FILE]

The shapes are the 2-D ring's ring_B stripes at N = 30000 ([gridring]):
(m, b, k) = (15000, 7500, 3000) on (2, 2), (7500, 3750, 3000) on (2, 4)
and the H² stripes (15000, 7500, 1500), (7500, 3750, 1500), on the f32,
c64 and bf16 routes (bf16 at k = 3000 and 1500 on both grids).  For each
it makes a random (2b × m) block and an (m × 2b) one, the chunk V (b ×
k) and its pre-pass output once, then times in turns (forward, then
reverse order) the main kernel alone: the kept library's trans route on
the block's rows [b, 2b) (``trans``), its untransposed route on the other
block at col0 = b (``plain_route``), the library call (torch.matmul of
the slab's ``.mH``: cuBLAS with ConjTrans; torch.mm with f32 out for
bf16) and, with ``--baseline DIR`` (a directory holding an earlier
ring_hemm.cu and hopper_tf32.cuh that has the trans entries), that
source's trans route on the same inputs (``baseline``); each kernel's
error against an f64 (c128) product.  It prints ptxas's registers and
spills of each build, and the card's name and power limit; the numbers
also go to ``--out`` as JSON (default build/probe_trans/trans.json).
"""

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from chase_tpu_torch import _build  # noqa: E402
from chase_tpu_torch.ops import ring_hemm as rh  # noqa: E402
from chip_smoke import phase_device, time_ms  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "probe_trans"
ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
ENTRY = {torch.float32: "ring_hemm_f32_t", torch.complex64: "ring_hemm_c64_t",
         torch.bfloat16: "ring_hemm_bf16_t"}
UNTRANS = {torch.float32: "ring_hemm_f32", torch.complex64: "ring_hemm_f32",
           torch.bfloat16: "ring_hemm_bf16"}
# (route, H dtype, (m, b, k) shapes)
CASES = [("f32", torch.float32, [(15000, 7500, 3000), (7500, 3750, 3000),
                                 (15000, 7500, 1500), (7500, 3750, 1500)]),
         ("c64", torch.complex64, [(15000, 7500, 3000), (7500, 3750, 3000),
                                   (15000, 7500, 1500), (7500, 3750, 1500)]),
         ("bf16", torch.bfloat16, [(15000, 7500, 3000), (7500, 3750, 3000),
                                   (15000, 7500, 1500), (7500, 3750, 1500)])]


def build(src: pathlib.Path, lib: pathlib.Path) -> str:
    """nvcc ``src`` into ``lib``; ptxas's register and spill lines."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    log = proc.stdout + proc.stderr
    return " | ".join(ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln)


def entries(lib) -> dict:
    out = {}
    for dtype in ENTRY:
        for key, name in (("trans", ENTRY[dtype]), ("plain", UNTRANS[dtype])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
            out[dtype, key] = fn
    return out


def padded(rows, cols, g, vdt, dtype):
    """A random (rows × cols) H of ``dtype`` with the row stride TMA
    reads (a whole number of 16 bytes), as DenseOperator lays it out."""
    w = 2 if dtype.is_complex else 1
    ld = rh.tma_ld(w * cols, dtype.itemsize // w) // w
    return torch.randn((rows, ld), generator=g, device="cuda",
                       dtype=vdt).to(dtype)[:, :cols]


def case(route, dtype, shape, libs, g, reps) -> dict:
    m, b, k = shape
    dev = torch.device("cuda")
    vdt = torch.float32 if dtype == torch.bfloat16 else dtype
    wide = torch.complex128 if vdt.is_complex else torch.float64
    w = 2 if dtype.is_complex else 1
    Ht = padded(2 * b, m, g, vdt, dtype)
    Hn = padded(m, 2 * b, g, vdt, dtype)
    V = torch.randn((b, k), generator=g, device=dev, dtype=vdt)
    bf16 = dtype == torch.bfloat16
    # the pre-pass outputs, made once: trans (off 0, c64 conjugated), plain
    Bt = rh.bf16_pack(V) if bf16 else rh.tf32_split(V, 0, conj=True)
    ldh, c0, off, b_k, k_k, _ = rh.float_view_args(Hn, V, b, 0)
    Bn = rh.bf16_pack(V, off) if bf16 else rh.tf32_split(V, off)
    W = torch.empty((m, k), dtype=vdt, device=dev)
    ldw = w * W.stride(0)
    stream = torch.cuda.current_stream().cuda_stream
    slab = Ht[b:2 * b]

    def kernel(fn, H, row_or_col, B):
        def run():
            err = fn(H.data_ptr(), rh.tma_row_stride(H), row_or_col,
                     B.data_ptr(), B.shape[-1], B.shape[-2], W.data_ptr(),
                     ldw, m, w * k, w * b, 0, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        return run

    fns = {"trans": kernel(libs["kept"][dtype, "trans"], Ht, b, Bt),
           "plain_route": kernel(libs["kept"][dtype, "plain"], Hn, c0, Bn)}
    if "baseline" in libs:
        fns["baseline"] = kernel(libs["baseline"][dtype, "trans"], Ht, b, Bt)
    Vb = V.to(torch.bfloat16) if bf16 else V
    fns["library"] = ((lambda: torch.mm(slab.mT, Vb, out_dtype=torch.float32))
                      if bf16 else (lambda: torch.matmul(slab.mH, V)))
    errs = {}
    ref_t = slab.to(wide).mH @ Vb.to(wide)
    ref_n = Hn[:, b:2 * b].to(wide) @ Vb.to(wide)
    for name, fn in fns.items():
        if name == "library":
            continue
        fn()
        torch.cuda.synchronize()
        ref = ref_n if name == "plain_route" else ref_t
        errs[name] = float((W.to(wide) - ref).abs().max() / ref.abs().max())
    del ref_t, ref_n
    names = list(fns)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    fwd = [time_ms(fns[n], reps) for n in names]
    rev = [time_ms(fns[n], reps) for n in reversed(names)][::-1]
    ms = {n: (a + r) / 2 for n, a, r in zip(names, fwd, rev)}
    line = ", ".join(f"{n} {ms[n]:.3f} ms" + (f" (err {errs[n]:.2e})"
                                             if n in errs else "")
                     for n in names)
    print(f"[trans] {route} (m, b, k) = {shape}: {line}; trans / "
          f"plain_route {ms['trans'] / ms['plain_route']:.3f}", flush=True)
    return dict(ms=ms, err=errs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an earlier csrc/ directory")
    ap.add_argument("--out", default=str(OUT_DIR / "trans.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ring_trans_design: no CUDA card", file=sys.stderr)
        return 2
    phase_device()
    t0 = time.time()
    libs = {"kept": (_build.CSRC_DIR / "ring_hemm.cu",
                     OUT_DIR / "libkept.so")}
    if args.baseline:
        libs["baseline"] = (pathlib.Path(args.baseline) / "ring_hemm.cu",
                            OUT_DIR / "libbaseline.so")
    for name, (src, lib) in libs.items():
        print(f"[build] {name}: {build(src, lib)}", flush=True)
    print(f"[build] {time.time() - t0:.1f} s", flush=True)
    loaded = {name: entries(ctypes.CDLL(str(lib)))
              for name, (_, lib) in libs.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for route, dtype, shapes in CASES:
        for shape in shapes:
            out[f"{route} {shape}"] = case(route, dtype, shape, loaded, g, 5)
            torch.cuda.empty_cache()
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
