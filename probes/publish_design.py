"""Probe of the peer route's publish (``csrc/ring_peers.cu``) on the card:
what bounds the owner's copy of its chunk into its slot, and the kept
design beside variants and beside ``copy_``, in one process on one card.

    python probes/publish_design.py [--out FILE] [--reps R]

Builds ``probes/publish_design.cu`` (the kept source with the variants of
its header note) and times, as kernel durations from a torch.profiler
trace (``chip_smoke.device_ms``; CUDA events around the same calls
beside), at the chunks of [gridring]'s (p, 1) products at N = 30000, k =
3000 — (b, floats) = (15000, 3000) f32 and (15000, 6000) c64 at p = 2,
(7500, 3000) and (7500, 6000) at p = 4:

* ``first`` — the first design (a block per row, min(rows, 1024)
  blocks, 4-byte accesses, every block polling the read count), and
  ``first_nopoll`` without the poll;
* ``scalar_u1`` / ``scalar_u4`` — a flat range grid-strided over the
  card-sized grid's threads with 4-byte accesses, 1 or 4 loads in flight
  a thread; ``vec_u1`` and ``vec_u4_nopoll`` (no poll) with 16-byte ones;
* ``publish_u1`` … ``publish_u8`` — the kept kernel (its flat range in
  contiguous block tiles) at unroll 1–8 on the card-sized grid (SMs ×
  resident blocks), ``publish_u4_<n>_per_sm`` on n blocks an SM,
  ``publish_u4_rows_grid`` on min(rows, 1024) blocks;
* ``hint_u<U>_pf<0|128|256>[_cs][_tiled]`` — the kept copy's flat range
  at unroll 2 or 4 with an L2 prefetch size on its loads, streaming
  (``.cs``) stores, and blocks walking contiguous tiles of 256·U float4s
  instead of the grid-stride;
* ``bulk_<stages>x<tile>_<n>_per_sm`` — Hopper's 1-D bulk copy
  (``cp.async.bulk`` global → shared → global, one thread a block, an
  mbarrier a stage) with the publish's protocol, at several stage counts,
  tile sizes and grids;
* ``bulk_parts_<poll+fence+count…>`` — the 4 × 16 KB bulk copy with its
  read-count poll, its proxy fence and its block counter and ready flag
  each switched on or off, and the counter and flag written without the
  ``__threadfence``, without the ready store, with a release atomic and an
  acquire fence in the last block, or releasing at gpu scope;
* ``wrapper`` — ``ops.ring_hemm.peer_publish`` as the main path calls it
  (a one-rank ``PeerChunks``, so no reader holds a slot);
* ``copy_`` — ``slot.copy_(V)`` into a slot of its own (the library
  call), and ``clone``;

each checked bitwise against the chunk.  At (15000, 3000) f32 also the
wrapper and ``copy_`` on an odd width (k = 2999) and on a strided column
window (V[:, 1:3000] of a (15000, 3001) buffer: the row path, the source
off the slot's alignment), and ``bf16_pack`` at (30000, 3000) beside its
library call (``Vb[:k, :b].copy_(V.mT)`` into a zeroed pack, checked
bitwise).  Prints the card's name and power limit, ptxas's registers and
spills, a line per shape with each variant's kernel time and its share of
HBM's 3.35 TB/s; the numbers also go to ``--out`` as JSON (default
build/probe_publish/publish.json).  About a minute on one H100.
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
from chase_tpu_torch.parallel.peers import PeerChunks  # noqa: E402
from chip_smoke import HBM_TBS, device_ms, phase_device, time_ms  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent / "publish_design.cu"
OUT_DIR = _build.BUILD_DIR / "probe_publish"
# (label, rows, floats a row)
SHAPES = (("f32 p=2", 15000, 3000), ("c64 p=2", 15000, 6000),
          ("f32 p=4", 7500, 3000), ("c64 p=4", 7500, 6000))
P, I, LL, ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                 ctypes.c_ulonglong)


def build() -> tuple:
    """nvcc the probe source; (library, ptxas's register/spill lines)."""
    lib = OUT_DIR / "libpublish_design.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(SRC)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {SRC}:\n{proc.stdout}"
                           f"{proc.stderr}")
    log = proc.stdout + proc.stderr
    regs = " | ".join(ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln)
    dll = ctypes.CDLL(str(lib))
    dll.probe_publish.argtypes = [I, I, P, LL, P, LL, I, I, P, ULL, P, I, P]
    dll.probe_publish.restype = I
    dll.probe_publish_per_sm.argtypes = [P]
    dll.probe_publish_per_sm.restype = I
    dll.probe_hint.argtypes = [I, I, I, I, P, P, LL, P, ULL, P, I, P]
    dll.probe_hint.restype = I
    dll.probe_bulk.argtypes = [I, P, P, LL, P, ULL, P, I, P]
    dll.probe_bulk.restype = I
    dll.probe_bulk_parts.argtypes = [I, P, P, LL, P, ULL, P, I, P]
    dll.probe_bulk_parts.restype = I
    return dll, regs


class Variants:
    """The probe library's launches on one chunk V (rows × cols floats,
    contiguous) into dst, with their own flags block and error record."""

    def __init__(self, dll, V, dst):
        self.dll, self.V, self.dst = dll, V, dst
        self.flags = torch.zeros(4096, dtype=torch.uint8, device=V.device)
        self.err = torch.zeros(8, dtype=torch.int64, device=V.device)
        self.epoch = 0

    def fn(self, variant: int, unroll: int, blocks: int):
        rows, cols = self.V.shape

        def run():
            self.epoch += 1
            err = self.dll.probe_publish(
                variant, unroll, self.V.data_ptr(), cols,
                self.dst.data_ptr(), cols, rows, cols, self.flags.data_ptr(),
                self.epoch, self.err.data_ptr(), blocks,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe variant {variant} launch failed: "
                                   f"{err}")
        return run

    def hint(self, unroll: int, pf: int, cs: int, tiled: int, blocks: int):
        def run():
            self.epoch += 1
            err = self.dll.probe_hint(
                unroll, pf, cs, tiled, self.V.data_ptr(), self.dst.data_ptr(),
                self.V.numel(), self.flags.data_ptr(), self.epoch,
                self.err.data_ptr(), blocks,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe hint launch failed: {err}")
        return run

    def bulk(self, mode: int, blocks: int, parts=None):
        def run():
            self.epoch += 1
            err = (self.dll.probe_bulk if parts is None else
                   self.dll.probe_bulk_parts)(
                mode if parts is None else parts, self.V.data_ptr(),
                self.dst.data_ptr(), self.V.numel(),
                self.flags.data_ptr(), self.epoch, self.err.data_ptr(),
                blocks, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe bulk launch failed: {err}")
        return run


def one_rank_peers(dev, nbytes: int) -> PeerChunks:
    """A PeerChunks of one rank: its publish never waits on a reader."""
    pc = PeerChunks(0, 1, dev, lambda obj: [obj])
    pc.reserve(nbytes)
    return pc


def wrapper_fn(V, pc):
    def run():
        rh.peer_publish(V, pc)
        pc.advance(0)
    return run


def slot_equal(pc, V) -> bool:
    torch.cuda.synchronize()
    pc.check()
    slot = pc.slot(pc.product - 1, tuple(V.shape), V.dtype)
    return bool(torch.equal(slot.view(torch.int32), V.view(torch.int32)))


def measure(fns: dict, checks: dict, nbytes: int, reps: int) -> dict:
    """Each function's kernel ms (profiler) and event ms, one function
    after the other, and its bitwise check (None: none)."""
    out = {}
    for name, (fn, match) in fns.items():
        k_ms, count = device_ms(fn, reps, match)
        out[name] = dict(kernel_ms=k_ms, launches=count,
                         event_ms=time_ms(fn, reps),
                         hbm=nbytes / (k_ms * 1e-3) / (HBM_TBS * 1e12),
                         bitwise=checks.get(name, lambda: None)())
    return out


def device_names(fn) -> list:
    """The names of the device activities of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA})


def line(label: str, res: dict) -> str:
    return f"[publish] {label}: " + ", ".join(
        f"{n} {r['kernel_ms']:.4f} ms ({r['hbm']:.1%}; events "
        f"{r['event_ms']:.4f})" + ("" if r["bitwise"] in (None, True)
                                   else " NOT BITWISE")
        for n, r in res.items())


def shape_case(dll, label, rows, cols, per_sm, sms, g, reps) -> dict:
    dev = torch.device("cuda")
    V = torch.randn((rows, cols), generator=g, device=dev)
    dst = torch.empty_like(V)
    var = Variants(dll, V, dst)
    card = sms * per_sm
    rows_grid = min(rows, 1024)
    fns = {"first": (var.fn(1, 1, rows_grid), "first_kernel"),
           "first_nopoll": (var.fn(2, 1, rows_grid), "first_kernel"),
           "scalar_u1": (var.fn(5, 1, card), "flat_kernel"),
           "scalar_u4": (var.fn(5, 4, card), "flat_kernel"),
           "vec_u1": (var.fn(3, 1, card), "flat_kernel"),
           "vec_u4_nopoll": (var.fn(4, 4, card), "flat_kernel")}
    for u in (1, 2, 4, 8):
        fns[f"publish_u{u}"] = (var.fn(0, u, card), "publish_kernel")
    for n in (1, 2, 4):
        fns[f"publish_u4_{n}_per_sm"] = (var.fn(0, 4, sms * n),
                                         "publish_kernel")
    fns["publish_u4_rows_grid"] = (var.fn(0, 4, rows_grid), "publish_kernel")
    for u in (2, 4):
        for pf in (0, 1, 2):
            for cs in (0, 1):
                for tiled in (0, 1):
                    fns[f"hint_u{u}_pf{(0, 128, 256)[pf]}"
                        f"{'_cs' if cs else ''}{'_tiled' if tiled else ''}"] = (
                        var.hint(u, pf, cs, tiled, card), "hint_kernel")
    # (mode, stages × tile, blocks an SM: those the shared memory holds)
    for mode, config, per in ((0, "4x16K", (1, 2, 3)), (1, "2x32K", (2, 3)),
                              (2, "3x32K", (1, 2)), (3, "6x16K", (1, 2)),
                              (4, "8x8K", (2, 3)), (5, "2x16K", (3, 6))):
        for n in per:
            fns[f"bulk_{config}_{n}_per_sm"] = (var.bulk(mode, sms * n),
                                                "bulk_parts_kernel")
    for poll, fence, count in ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                               (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1),
                               (1, 1, 2), (1, 1, 3), (1, 1, 4), (1, 1, 5)):
        name = "+".join(w for w, on in zip(("poll", "fence"), (poll, fence))
                        if on) or "none"
        if count:
            name += ("+count", "+count_nofence", "+count_noready",
                     "+count_release_atom", "+count_gpu_ready")[count - 1]
        fns[f"bulk_parts_{name}"] = (
            var.bulk(0, sms * 3, poll * 16 + fence * 8 + count),
            "bulk_parts_kernel")
    Vc = V.view(torch.complex64) if label.startswith("c64") else V
    pc = one_rank_peers(dev, V.numel() * 4)
    fns["wrapper"] = (wrapper_fn(Vc, pc), "publish")
    slot = torch.empty_like(V)
    fns["copy_"] = (lambda: slot.copy_(V), "")
    fns["clone"] = (lambda: V.clone(), "")

    def dst_equal():
        torch.cuda.synchronize()
        return bool(torch.equal(dst.view(torch.int32), V.view(torch.int32)))

    checks = {n: dst_equal for n in fns if n not in ("wrapper", "copy_",
                                                       "clone")}
    checks["wrapper"] = lambda: slot_equal(pc, Vc)
    res = measure(fns, checks, 8 * rows * cols, reps)
    pc.close()
    print(f"[publish] copy_'s device activities: "
          f"{device_names(lambda: slot.copy_(V))}", flush=True)
    print(line(f"{label} ({rows}, {cols} floats)", res), flush=True)
    return res


def layout_cases(g, reps) -> dict:
    """The wrapper and copy_ on an odd width and a strided window."""
    dev = torch.device("cuda")
    out = {}
    V = torch.randn((15000, 2999), generator=g, device=dev)
    Vw = torch.randn((15000, 3001), generator=g, device=dev)[:, 1:3000]
    for label, X in (("odd k=2999", V), ("window [:, 1:3000] of 3001", Vw)):
        pc = one_rank_peers(dev, X.shape[0] * X.shape[1] * 4)
        slot = torch.empty(X.shape, device=dev)
        res = measure({"wrapper": (wrapper_fn(X, pc), "publish"),
                       "copy_": (lambda: slot.copy_(X), "")},
                      {"wrapper": lambda: slot_equal(pc, X)},
                      8 * X.shape[0] * X.shape[1], reps)
        pc.close()
        print(line(f"f32 {label} {tuple(X.shape)}", res), flush=True)
        out[f"f32 {label}"] = res
    return out


def pack_case(g, reps) -> dict:
    """bf16_pack beside Vb[:k, :b].copy_(V.mT) into a zeroed pack."""
    dev = torch.device("cuda")
    b, k = 30000, 3000
    V = torch.randn((b, k), generator=g, device=dev)
    b_pad, w_pad = rh.pack_shape(b, k)
    Vb = torch.zeros((w_pad, b_pad), dtype=torch.bfloat16, device=dev)
    Vb[:k, :b].copy_(V.mT)
    torch.cuda.synchronize()
    exact = bool(torch.equal(Vb.view(torch.int16),
                             rh.bf16_pack(V).view(torch.int16)))
    nbytes = 4 * b * k + 2 * w_pad * b_pad
    res = measure({"bf16_pack": (lambda: rh.bf16_pack(V), "bf16_pack_kernel"),
                   "library": (lambda: Vb[:k, :b].copy_(V.mT), "")},
                  {"library": lambda: exact}, nbytes, reps)
    print(line(f"bf16_pack ({b}, {k}) (library Vb[:k, :b].copy_(V.mT))",
               res), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT_DIR / "publish.json"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("publish_design: no CUDA card", file=sys.stderr)
        return 2
    info = phase_device()
    t0 = time.time()
    dll, regs = build()
    per_sm = ctypes.c_int()
    if dll.probe_publish_per_sm(ctypes.byref(per_sm)):
        raise RuntimeError("occupancy query failed")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[build] {time.time() - t0:.1f} s; {sms} SMs, "
          f"{per_sm.value} publish blocks an SM; {regs}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(15)
    out = dict(device=info["smi"], sms=sms, per_sm=per_sm.value)
    for label, rows, cols in SHAPES:
        out[label] = shape_case(dll, label, rows, cols, per_sm.value, sms, g,
                                args.reps)
        torch.cuda.empty_cache()
    out.update(layout_cases(g, args.reps))
    out["bf16_pack"] = pack_case(g, args.reps)
    bad = [(k, n) for k, v in out.items() if isinstance(v, dict)
           for n, r in v.items() if isinstance(r, dict)
           and r.get("bitwise") is False]
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    if bad:
        print(f"[publish] not bitwise: {bad}", file=sys.stderr)
        return 1
    print(f"[publish] done in {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
