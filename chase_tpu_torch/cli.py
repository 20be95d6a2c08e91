"""Command-line driver.

Port of ``chase_tpu/cli.py``, the equivalent of the reference's
``examples/2_input_output`` (popl-based CLI, 2_input_output.cpp:330-393):
solve problems from ChASE binary files or generated matrices, optionally
as warm-started sequences, printing the perf table.  ``--device`` (default
``cuda``) names the torch device; without a card ``cuda`` raises, as every
entry point of the port does.

``--grid`` solves on the near-square grid over every rank of a
``torch.distributed`` group made from torchrun's variables
(``multihost.init_grid``: NCCL on cards, gloo with ``--device cpu``); every
rank runs the same command and rank 0 alone prints.  ``--mb`` (with
``--grid`` only) shards the operator in block-cyclic ownership order
(``parallel/layouts.py``), reading ``--path_in`` files through
``io.load_matrix_blockcyclic``.

    python -m chase_tpu_torch --n 1200 --nev 100 --nex 40 --isMatGen clement
    python -m chase_tpu_torch --n 4000 --nev 256 --path_in H.bin \
        --dtype complex128 --sequence 3 --mode A
    torchrun --nproc-per-node=4 -m chase_tpu_torch --n 8192 --nev 512 \
        --grid --mb 64 --path_in H.bin --dtype float32
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="chase_tpu_torch",
        description="Chebyshev-accelerated subspace eigensolver (PyTorch/"
                    "CUDA port)")
    p.add_argument("--n", type=int, required=True, help="matrix dimension N")
    p.add_argument("--nev", type=int, required=True, help="wanted eigenpairs")
    p.add_argument("--nex", type=int, default=None, help="extra directions")
    p.add_argument("--deg", type=int, default=None,
                   help="initial filter degree")
    p.add_argument("--maxDeg", type=int, default=None)
    p.add_argument("--maxIter", type=int, default=25)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--mode", choices=["R", "A"], default="R",
                   help="R: random start, A: approximate/warm start")
    p.add_argument("--opt", choices=["S", "N"], default="S",
                   help="S: degree optimization on, N: off")
    p.add_argument("--qr", choices=["C", "H"], default="C",
                   help="C: CholQR, H: Householder")
    p.add_argument("--lanczosIter", type=int, default=None)
    p.add_argument("--numLanczos", type=int, default=4)
    p.add_argument("--sequence", type=int, default=1,
                   help="number of correlated problems to solve")
    p.add_argument("--path_in", type=str, default=None,
                   help="binary matrix file (ChASE column-major format); "
                        "for sequences: a prefix formatted with the index")
    p.add_argument("--isMatGen", choices=["clement", "random", "bse"],
                   default=None, help="generate the test matrix instead")
    p.add_argument("--dtype", default="float64",
                   choices=["float32", "float64", "complex64", "complex128"])
    p.add_argument("--pseudo", action="store_true",
                   help="pseudo-Hermitian (BSE) solve")
    p.add_argument("--fused", action="store_true",
                   help="device-resident solver (eigsh_fused)")
    p.add_argument("--grid", action="store_true",
                   help="2D-shard the operator over every rank of a "
                        "torch.distributed group (torchrun's variables)")
    p.add_argument("--mb", type=int, default=None,
                   help="ScaLAPACK-style block-cyclic block size (with "
                        "--grid): shard the operator in block-cyclic "
                        "ownership order, reading files through the darray "
                        "analogue")
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on (default cuda; cpu)")
    p.add_argument("--seed", type=int, default=1337)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import chase_tpu_torch as ct
    from chase_tpu_torch import io as cio
    from chase_tpu_torch.models import (clement, hermitian_sequence,
                                        random_hermitian,
                                        random_pseudo_hermitian)
    from chase_tpu_torch.parallel.operator import resolve_device

    device = resolve_device(args.device)
    dtype = np.dtype(args.dtype)
    if args.mb and not args.grid:
        raise SystemExit("--mb (block-cyclic) requires --grid")
    cfg = ct.ChaseConfig(
        deg=args.deg, max_deg=args.maxDeg, max_iter=args.maxIter,
        optimization=(args.opt == "S"), cholqr=(args.qr == "C"),
        lanczos_iter=args.lanczosIter, num_lanczos=args.numLanczos,
        approx=(args.mode == "A"), seed=args.seed)

    grid = layout = None
    owns_group = False
    if args.grid:
        import torch.distributed as dist
        from chase_tpu_torch.parallel import multihost
        owns_group = not dist.is_initialized()
        grid = multihost.init_grid(device=device)
        device = None                    # the grid's
    if args.mb:
        from chase_tpu_torch.parallel.layouts import (
            BlockCyclicLayout, PseudoBlockCyclicLayout)
        # pseudo-Hermitian uses the S-metric-preserving per-half variant
        # (PseudoHermitianBlockCyclicMatrix analogue, distMatrix.hpp:3936)
        cls = PseudoBlockCyclicLayout if args.pseudo else BlockCyclicLayout
        layout = cls(args.n, args.mb, grid.size("r"), grid.size("c"))
    rank0 = grid is None or grid.coords == (0, 0)

    def get_matrix(i):
        if args.path_in:
            path = args.path_in.format(i) if "{" in args.path_in \
                else args.path_in
            if layout is not None:
                return cio.load_matrix_blockcyclic(path, args.n, dtype, grid,
                                                   args.mb, layout=layout)[0]
            return cio.load_matrix(path, args.n, dtype)
        gen = args.isMatGen or ("bse" if args.pseudo else "clement")
        if gen == "clement":
            H = clement(args.n, dtype=dtype)
        elif gen == "bse":
            H = random_pseudo_hermitian(args.n, dtype=dtype,
                                        seed=args.seed + i)
        elif args.sequence > 1:
            H = hermitian_sequence(args.n, args.sequence, dtype=dtype,
                                   seed=args.seed)[i]
        else:
            H = random_hermitian(args.n, dtype=dtype, seed=args.seed + i)
        return layout.apply(H) if layout is not None else H

    v0 = ritzv0 = None
    for i in range(args.sequence):
        H = get_matrix(i)
        approx = (args.mode == "A" or i > 0) and v0 is not None
        common = dict(tol=args.tol, config=cfg, device=device, grid=grid,
                      v0=v0 if approx else None, collect_perf=True)
        if args.pseudo:
            res = ct.eigsh_pseudo(H, args.nev, args.nex,
                                  ritzv0=ritzv0 if approx else None,
                                  approx=approx, **common)
        elif args.fused:
            res = ct.eigsh_fused(H, args.nev, args.nex, **common)
        else:
            res = ct.eigsh(H, args.nev, args.nex,
                           ritzv0=ritzv0 if approx else None,
                           approx=approx, **common)
        v0, ritzv0 = res.V, res.ritzv_full
        if not rank0:
            continue
        status = "converged" if res.converged else "NOT converged"
        print(f"[problem {i}] {status} in {res.iterations} iterations; "
              f"locked={res.locked}")
        print(f"  eigenvalues: {res.ritzv[:min(8, args.nev)]}"
              f"{' ...' if args.nev > 8 else ''}")
        print(f"  max residual: {res.resid.max():.3e}")
        if res.perf is not None:
            rcfg = cfg.resolve(dtype, device or grid.device)
            print(res.perf.report(args.n, rcfg.lanczos_iter,
                                  args.numLanczos, dtype))
    if grid is not None:
        grid.close()
    if owns_group:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
