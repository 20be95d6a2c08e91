"""Hello world on the PyTorch/CUDA port: the Clement matrix, a sequence of
3 warm-started solves.

The port's form of examples/hello_world.py (the reference's
examples/1_hello_world.cpp:42-175): Clement N=1200, nev=100, nex=40, the
same matrix solved three times, each solve after the first warm-started
from the previous one, with each solve's performance table and, last, the
error against Clement's exact spectrum.  It solves on the card unless
asked for the CPU:

    python examples/torch_hello_world.py
    python examples/torch_hello_world.py --device cpu
    torchrun --nproc-per-node=2 examples/torch_hello_world.py

Launched as more than one rank (torchrun's WORLD_SIZE > 1) every rank
joins the process group and solves on ``chase_tpu_torch.make_grid()``;
rank 0 prints.  The last line is ``PASS`` or ``FAIL``: every solve
converged and the eigenvalues lie within 10·tol of the exact spectrum.
"""

import argparse
import os
import sys

import numpy as np

import chase_tpu_torch
from chase_tpu_torch.models import clement, clement_eigenvalues
from chase_tpu_torch.parallel import multihost

N, NEV, NEX, SOLVES = 1200, 100, 40, 3
TOL = 1e-10         # the f64 default, an absolute residual bound


def _grid(device):
    """The grid over every rank when launched as more than one, else
    None (one device)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        multihost.ensure_initialized(device=device)
    if multihost.is_multihost():
        return chase_tpu_torch.make_grid(device=device)
    return None


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for a run "
                        "without a card)")
    args = p.parse_args(argv)
    grid = _grid(args.device)
    out = print if multihost.process_info()["process_index"] == 0 \
        else (lambda *a, **k: None)
    H = clement(N)
    place = dict(grid=grid) if grid is not None else dict(device=args.device)

    v0 = ritzv0 = None
    results = []
    for idx in range(SOLVES):
        # the reference re-solves the same Clement matrix warm-started
        res = chase_tpu_torch.eigsh(H, NEV, NEX, tol=TOL, collect_perf=True,
                                    v0=v0, ritzv0=ritzv0, approx=idx > 0,
                                    **place)
        v0, ritzv0 = res.V, res.ritzv_full
        results.append(res)
        out(f"solve {idx}: converged={res.converged} "
            f"iterations={res.iterations} max_resid={res.resid.max():.2e}")
        out(res.perf.report(N, 25, 4, H.dtype))

    err = float(np.abs(res.ritzv - clement_eigenvalues(N)[:NEV]).max())
    out(f"max eigenvalue error vs exact Clement spectrum: {err:.3e}")
    passed = all(r.converged for r in results) and err <= 10 * TOL
    out(f"torch_hello_world: {'PASS' if passed else 'FAIL'} "
        f"(iterations {[r.iterations for r in results]}, max eigenvalue "
        f"error {err:.3e}, gate {10 * TOL:.0e})")
    if grid is not None:
        grid.close()
    return {"iterations": [r.iterations for r in results],
            "converged": [r.converged for r in results],
            "max_resid": [float(r.resid.max()) for r in results],
            "error": err, "passed": passed, "results": results}


if __name__ == "__main__":
    sys.exit(0 if main()["passed"] else 1)
