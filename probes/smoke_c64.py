"""The c64 route's checks of chip_smoke.py, alone: the phases that run
ring_hemm's c64 kernel (csrc/ring_hemm.cu's ring_hemm_kernel_c64, the
complex product in Gauss's three real products) and its pre-passes, in
one process on one card, with chip_smoke's own gates.

    python probes/smoke_c64.py [--phases build,tests,ckernel,...]

Phases (in this order, those named):
  build     the card's name and power limit; both kernel libraries built,
            ptxas's registers and spills of every kernel ([build])
  tests     the gpu-marked tests of the ring HEMM, its trans route and
            the peer ring (pytest -m gpu, a child process)
  ckernel   [ckernel]: c64 ring_hemm against CGEMM and a c128 product at
            (1001, 37) and (30000, 750 / 1500 / 3000), the pre-pass
            bit-exact, a two-chunk ring step, the trans route
  gridring  [gridring]'s c64 rows on a dense c64 H (N = 30000): the (p, 1)
            stripes and peer products at p = 2, 4, the 2-D ring (ring_A,
            ring_B on the trans route) at (2, 2) and (2, 4)
  h2ring    [pfilter]'s c64 route on the c128 BSE and its H² rings
  zfused    [zfused] and [zfladder]: the c128 BSE at N = 4096 natively and
            on the ladder (the c64 shadow's kernel route), host and fused

A phase raises past its gate, as in chip_smoke.py; the last line is
{"ok": true, ...} when every named phase passed.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

PHASES = ("build", "tests", "ckernel", "gridring", "h2ring", "zfused")
TEST_FILES = ("tests/test_torch_ring_hemm.py",
              "tests/test_torch_ring_hemm_trans.py",
              "tests/test_torch_ring_peers.py")


def run_tests() -> None:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", *TEST_FILES, "-m", "gpu",
         "--noconftest", "-q", "-p", "no:cacheprovider"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-25:]
    for line in tail:
        cs.log("tests", line)
    cs.log("tests", f"exit {proc.returncode} in "
                    f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError("gpu-marked tests failed")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    names = ap.parse_args().phases.split(",")
    unknown = set(names) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("smoke_c64: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    info = cs.phase_device()
    out = {}
    if "build" in names:
        cs.phase_build()
    if "tests" in names:
        run_tests()
    if "ckernel" in names:
        ck = cs.phase_complex_kernel(dev)
        out["ckernel"] = {str(key): val for key, val in ck.items()}
    if "gridring" in names:
        H = cs.dense_on_device(cs.SLICE["N"], dev, torch.complex64)
        g = cs.phase_gridring(dev, H, "c64")
        g2 = cs.phase_gridring2d(dev, H, "c64")
        del H
        torch.cuda.empty_cache()
        out["gridring"] = (cs.peer_entries({"c64": g}, "")
                           + cs.ring2d_entries({"c64": g2}, ""))
    if "h2ring" in names:
        H, lam = cs.structured_bse_on_device(cs.BSE["N"], dev)
        Hc = cs.complex_bse_on_device(H)
        del H
        torch.cuda.empty_cache()
        ctx = cs.phase_pfilter(dev, Hc, lam, "c64")
        h2 = cs.phase_gridring_h2(dev, ctx, "c64")
        h22 = cs.phase_gridring2d_h2(dev, ctx, "c64")
        del ctx, Hc
        torch.cuda.empty_cache()
        out["h2ring"] = (cs.peer_entries({"c64": h2}, " H²")
                         + cs.ring2d_entries({"c64": h22}, " H²"))
    if "zfused" in names:
        cs.phase_zfused(dev)
    print(json.dumps(out, default=str), flush=True)
    print(json.dumps({"ok": True, "phases": names, "device": {
        "kind": info["name"], "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
