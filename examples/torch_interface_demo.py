"""Flat-interface demo on the PyTorch/CUDA port (the reference's
examples/4_interface C/Fortran drivers): the init / set_tol / solve / get
/ warm solve / finalize lifecycle of ``chase_tpu_torch.interface``, for
codes ported from the C ABI.

The port's form of examples/interface_demo.py: Clement N=1001, nev=100,
nex=40, tol 1e-10; a random-start solve (mode 'R'), the eigenpairs read
back, then a warm-started solve (mode 'A') from the first one's vectors.
It solves on the card unless asked for the CPU:

    python examples/torch_interface_demo.py
    python examples/torch_interface_demo.py --device cpu

The last line is ``PASS`` or ``FAIL``: both solves returned 0
(converged) and the eigenvalues lie within 10·tol of Clement's exact
spectrum.
"""

import argparse
import sys

import numpy as np

import chase_tpu_torch.interface as chase
from chase_tpu_torch.models import clement, clement_eigenvalues

N, NEV, NEX = 1001, 100, 40
TOL = 1e-10


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for a run "
                        "without a card)")
    args = p.parse_args(argv)
    H = clement(N)

    chase.init(N, NEV, NEX, H, device=args.device)     # dchase_init_
    chase.set_tol(TOL)
    rc = chase.solve(deg=20, mode="R", opt="S", qr="C")  # dchase_
    print("solve rc:", rc)
    evals, evecs = chase.get_eigenpairs()  # dchase_get_eigenpairs_
    print("eigenvalues[:5]:", evals[:5])

    rc_warm = chase.solve(mode="A")        # warm-started second solve
    print("warm solve rc:", rc_warm)
    evals_warm, _ = chase.get_eigenpairs()
    chase.finalize()                       # dchase_finalize_

    exact = clement_eigenvalues(N)[:NEV]
    err = float(max(np.abs(evals - exact).max(),
                    np.abs(evals_warm - exact).max()))
    passed = rc == 0 and rc_warm == 0 and err <= 10 * TOL
    print(f"torch_interface_demo: {'PASS' if passed else 'FAIL'} (rc "
          f"{rc}, warm rc {rc_warm}, max eigenvalue error {err:.3e}, gate "
          f"{10 * TOL:.0e})")
    return {"rc": rc, "rc_warm": rc_warm, "evals": evals,
            "evals_warm": evals_warm, "evecs": evecs, "error": err,
            "passed": passed}


if __name__ == "__main__":
    sys.exit(0 if main()["passed"] else 1)
