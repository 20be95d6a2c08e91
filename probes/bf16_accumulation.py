"""Probe of the bf16 route of ring_hemm on the card: does it need the
per-tile promotion of its sums?

    git archive c0351d1 chase_tpu_torch/csrc | tar -x -C build/pr4
    python probes/bf16_accumulation.py build/pr4/chase_tpu_torch/csrc

It pins the bf16 route as commit c0351d1 wrote it (register-A wgmma in the
f32 route's template): the variant it builds is that source patched by
string, which the redesigned route no longer matches
(probes/bf16_route_design.py measures the redesign's promotion intervals).
Builds the port's kernels (printing ptxas's registers and spills), then a
variant of that ring_hemm.cu whose bf16 route keeps one wgmma accumulator
over all of K (into build/probe/), checks that torch.mm takes
``out_dtype=torch.float32`` for bf16 operands, and at (N, k) = (1000,
37), (30000, 750), (30000, 3000) prints the error against an f64 product
of the bf16-rounded operands and the time of: the kernel (per-tile
promotion), the one-accumulator variant, the plain version, cuBLAS bf16
with bf16 out and with f32 out; then the f32 route at (30000, 3000).
"""
import ctypes
import pathlib
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
from chase_tpu_torch import _build  # noqa: E402
from chase_tpu_torch.ops.ring_hemm import (bf16_pack, bf16_pack_reference,  # noqa: E402
                                           ring_hemm, ring_hemm_reference)

print(sys.version, torch.__version__, torch.version.cuda, flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
t = time.time()
_build.load_library("ring_hemm")
print(f"build {time.time() - t:.2f} s", flush=True)
for line in _build.build_log("ring_hemm").splitlines():
    if "registers" in line or "spill" in line or "Function" in line:
        print("  ", line.strip())

pr4 = pathlib.Path(sys.argv[1])
src = (pr4 / "ring_hemm.cu").read_text()
a = "wgmma_m64n128k16_bf16(acc, f.a[ks], db + 2 * ks, ks == 0 ? 0 : 1)"
b = "for (int i = 0; i < 64; ++i) run[i] += acc[i];"
assert a in src and b in src
src = src.replace(a, "wgmma_m64n128k16_bf16(acc, f.a[ks], db + 2 * ks, 1)")
src = src.replace(b, "for (int i = 0; i < 64; ++i) run[i] = acc[i];")
d = pathlib.Path("build/probe")
d.mkdir(parents=True, exist_ok=True)
shutil.copy(pr4 / "hopper_tf32.cuh", d)
(d / "ring_hemm.cu").write_text(src)
t = time.time()
p = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(d / "libprobe.so"), str(d / "ring_hemm.cu")],
                   capture_output=True, text=True)
print(f"probe build rc {p.returncode} {time.time() - t:.2f} s", flush=True)
if p.returncode:
    print(p.stdout, p.stderr)
    sys.exit(1)
plib = ctypes.CDLL(str(d / "libprobe.so"))
pfn = plib.ring_hemm_bf16
pfn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
pfn.restype = ctypes.c_int


def probe(H, V):
    Vb = bf16_pack(V, 0)
    W = torch.empty((H.shape[0], V.shape[1]), device=H.device)
    err = pfn(H.data_ptr(), H.stride(0), 0, Vb.data_ptr(), Vb.shape[1],
              Vb.shape[0], W.data_ptr(), W.stride(0), H.shape[0],
              V.shape[1], V.shape[0], 0,
              torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return W


def tms(fn, reps):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(1)
Hm = torch.randn((2, 2), device=dev).bfloat16()
try:
    r = torch.mm(Hm, Hm, out_dtype=torch.float32)
    print("torch.mm(bf16, bf16, out_dtype=float32):", r.dtype, flush=True)
    has_out = True
except Exception as e:  # noqa: BLE001
    print("torch.mm out_dtype FAILED:", type(e).__name__, str(e)[:200])
    has_out = False


def rel(x, ref):
    return float((x.double() - ref).abs().max() / ref.abs().max())


for N, k in ((1000, 37), (30000, 750), (30000, 3000)):
    H = torch.randn((N, N), generator=g, device=dev).bfloat16()
    V = torch.randn((N, k), generator=g, device=dev)
    Vb = V.bfloat16()
    ref = H.double() @ Vb.double()
    reps = 20 if N < 5000 else 5
    rows = {"kernel": lambda: ring_hemm(H, V), "probe1acc": lambda: probe(H, V),
            "plain": lambda: ring_hemm_reference(H, V),
            "bf16out": lambda: torch.matmul(H, Vb)}
    if has_out:
        rows["mm_out_f32"] = lambda: torch.mm(H, Vb, out_dtype=torch.float32)
    out = []
    for name, fn in rows.items():
        e = rel(fn(), ref)
        torch.cuda.synchronize()
        ms = tms(fn, reps)
        out.append(f"{name} err {e:.3e} {ms:.3f} ms")
    pk = bool(torch.equal(bf16_pack(V), bf16_pack_reference(V)))
    print(f"({N}, {k}): " + "; ".join(out) + f"; pack bit-exact {pk}",
          flush=True)
    del H, V, Vb, ref
    torch.cuda.empty_cache()

# f32 route after the template change
H = torch.randn((30000, 30000), generator=g, device=dev)
V = torch.randn((30000, 3000), generator=g, device=dev)
ref = H.double() @ V.double()
print(f"f32 (30000, 3000): kernel err {rel(ring_hemm(H, V), ref):.3e} "
      f"{tms(lambda: ring_hemm(H, V), 3):.3f} ms; plain err "
      f"{rel(H @ V, ref):.3e}", flush=True)
