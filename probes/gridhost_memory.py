"""Each rank's peak device memory in chip_smoke's [gridhost] (2, 2) solves.

    python3 probes/gridhost_memory.py [--out FILE]

Starts the four ranks of [gridhost]'s (2, 2) grid (``chip_smoke.
host_child``: processes sharing card 0, collectives host-staged through
gloo) on GRIDHOST_2D's solves — Clement N = 8192, nev 512, nex 256, f32
on the 2-D kernel ring, and the structured BSE N = 8192 f64 ladder on its
f32 shadow — without the I/O part, and prints for each solve every rank's
``torch.cuda.max_memory_allocated`` around it beside its iterations, its
ring_hemm launches (those on the trans route apart) and the operators
they read.  It checks no gate: it measures.

The children import the package that lies beside the ``chip_smoke.py``
they run.  To measure another tree (an older commit unpacked with ``git
archive`` into a gitignored directory), copy this checkout's
``chip_smoke.py`` and ``probes/`` into it and run the probe there; the
two trees' numbers are comparable within one call on one card.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the per-rank numbers as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gridhost_memory: no CUDA card", file=sys.stderr)
        return 2
    cs.phase_device()
    cs.phase_build()
    ranks = cs._run_ranks("gridmem", "host_child", 4, "HOST_RESULT", 420,
                          GRIDHOST_SHAPE="2,2")
    out = {}
    for name in cs.GRIDHOST_2D:
        o = [rk[name] for rk in ranks]
        out[name] = {k: [rk.get(k) for rk in o]
                     for k in ("peak_mib", "iterations", "launches", "trans",
                               "operators", "hemm_steps")}
        same = all(rk["ritzv"] == o[0]["ritzv"] for rk in o)
        cs.log("gridmem", f"{cs.ROOT.name or cs.ROOT}: {name} on (2, 2): "
                          f"peak device memory per rank "
                          f"{out[name]['peak_mib']} MiB; iterations "
                          f"{out[name]['iterations']}; ring_hemm / "
                          f"tf32_split launches {out[name]['launches']} "
                          f"(trans {out[name]['trans']}) on "
                          f"{out[name]['operators']} operators; ritzv "
                          f"bitwise equal on all ranks: {same}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
