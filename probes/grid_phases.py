"""The grid phases of chip_smoke.py alone, on one card — the short call
after a change to the rings or the grid layer.

    python3 probes/grid_phases.py

Runs chip_smoke's device and build phases, then [gridring]'s rings of a
dense N=30000 H — the (p, 1) ring products on the peer route
(ring_hemm_peers) at p = 2 and 4 and the 2-D ring at its simulated grids,
f32 and bf16 on a real H and c64 on a complex one —
[pfilter] and the 1-D and 2-D H² rings on the structured BSE H on each
route, and [gridhost]'s (2, 1) and (2, 2) solves by ranks sharing the
card (the (2, 2) ranks also reading their blocks of the N=30000 Clement
ChASE file written here first, and solving through the distributed
interface), each with chip_smoke's gates.  Prints the kernels' JSON line of
these phases (the peer products and the 2-D stripe calls, in chip_smoke's
names) and exits
non-zero if a phase fails.  Needs the card; it takes about five minutes
on one H100.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("grid_phases: no CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda", 0)
    N = cs.SLICE["N"]
    rings, rings2d, h2, h2d = {}, {}, {}, {}
    for dtype, routes in ((torch.float32, ("f32", "bf16")),
                          (torch.complex64, ("c64",))):
        H = cs.dense_on_device(N, dev, dtype)
        for route in routes:
            rings[route] = cs.phase_gridring(dev, H, route)
            rings2d[route] = cs.phase_gridring2d(dev, H, route)
        del H
        torch.cuda.empty_cache()
    H, lam = cs.structured_bse_on_device(cs.BSE["N"], dev)
    for route in ("f32", "bf16", "c64"):
        Hx = cs.complex_bse_on_device(H) if route == "c64" else H.float()
        ctx = cs.phase_pfilter(dev, Hx, lam, route)
        h2[route] = cs.phase_gridring_h2(dev, ctx, route)
        h2d[route] = cs.phase_gridring2d_h2(dev, ctx, route)
        del ctx, Hx
        torch.cuda.empty_cache()
    del H
    torch.cuda.empty_cache()
    from chase_tpu_torch import io as cio
    with tempfile.TemporaryDirectory(prefix="grid_phases_") as tmp:
        path = os.path.join(tmp, f"clement{N}_f32.bin")
        cio.save_matrix(cs.clement_on_device(N, dev), path)
        torch.cuda.empty_cache()
        cs.phase_gridhost(dev, path)
    entries = (
        cs.peer_entries(rings, "") + cs.peer_entries(h2, " H²")
        + cs.ring2d_entries(rings2d, "") + cs.ring2d_entries(h2d, " H²"))
    print(json.dumps({"kernels": entries}), flush=True)
    cs.log("done", f"grid phases passed in "
                   f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
