"""BSE benchmark on the PyTorch/CUDA port: a pseudo-Hermitian solve (the
reference's examples/5_bse_benchmark).

The port's form of examples/bse_benchmark.py, with its flags: generates a
BSE-structured c128 Hamiltonian (or reads one, a ChASE file, with
``--path``) and computes the nev smallest positive excitation energies.
It solves on the card unless asked for the CPU:

    python examples/torch_bse_benchmark.py
    python examples/torch_bse_benchmark.py --n 400 --device cpu
    python examples/torch_bse_benchmark.py --n 4096 --path H.bin

The last line is ``PASS`` or ``FAIL``: converged, and every true residual
‖H·v − θ·v‖ of the nev pairs (computed here in f64/c128) within 10·tol.
"""

import argparse
import sys
import time

import numpy as np

import chase_tpu_torch
from chase_tpu_torch import io as cio
from chase_tpu_torch.models import random_pseudo_hermitian


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=2000)
    p.add_argument("--nev", type=int, default=100)
    p.add_argument("--nex", type=int, default=40)
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--path", type=str, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for a run "
                        "without a card)")
    args = p.parse_args(argv)

    if args.path:
        H = cio.load_matrix(args.path, args.n, np.complex128)
    else:
        H = random_pseudo_hermitian(args.n, dtype=np.complex128, seed=0)

    t0 = time.perf_counter()
    res = chase_tpu_torch.eigsh_pseudo(H, args.nev, args.nex, tol=args.tol,
                                       collect_perf=True, device=args.device)
    dt = time.perf_counter() - t0
    print(f"converged={res.converged} iterations={res.iterations} "
          f"time={dt:.2f}s")
    print("lowest excitation energies:", res.ritzv[:8])
    print("max residual:", res.resid.max())
    print(res.perf.report(args.n, 25, 4, H.dtype))

    V = res.V[:, :args.nev].cpu().numpy()
    true_resid = np.linalg.norm(H @ V - V * res.ritzv[None, :], axis=0)
    passed = bool(res.converged and true_resid.max() <= 10 * args.tol)
    print(f"torch_bse_benchmark: {'PASS' if passed else 'FAIL'} (N "
          f"{args.n}, {res.iterations} iterations, {dt:.2f} s, max true "
          f"residual {true_resid.max():.3e}, gate {10 * args.tol:.0e})")
    return {"converged": res.converged, "iterations": res.iterations,
            "seconds": dt, "ritzv": res.ritzv,
            "max_resid": float(res.resid.max()),
            "true_resid": float(true_resid.max()), "passed": passed,
            "result": res}


if __name__ == "__main__":
    sys.exit(0 if main()["passed"] else 1)
