"""Member 1 of the ``herm_c128_n30000_scf.scf10`` cell under several
warm-start lower edges.

    python probes/warm_edge.py [SEED] [VARIANTS]

Builds the configuration's H on the card, solves member 0 cold with the
cell's solver settings, prints its iterations and how many of its Ritz
values lie above lambda_nevex, perturbs H into member 1 as the cell's
traffic does for ``SEED`` (default 3325000101), then solves member 1
warm once per variant (comma-separated, default ``G,A,O,C``), each
from a copy of member 0's block, printing the edge, the iterations and
the seconds.  Variants: G the program's rule (``solver._warm_bounds``),
A the probes' DoS quantile of nevex, O lambda_nevex + 20 (Clement's
exact spectrum; the perturbation moves it by less), C the largest
previous Ritz value at or below the DoS quantile of 2·nevex, M
max(ritzv0) (the JAX package's edge).  ``PROBE_N=<n>
PROBE_DEVICE=cpu`` runs it at a small size on the CPU."""
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chase_tpu_torch as ct
from chase_tpu_torch import solver
from chase_tpu_torch.ops import lanczos as lz
from portbench.matrices import clement_dense
from portbench.seeds import sub_seed, generator
from portbench.traffic.sequence import perturb_

dev = torch.device(os.environ.get("PROBE_DEVICE", "cuda"))
def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()
cfgj = json.load(open(ROOT / "portbench/configs/herm_c128_n30000_scf.json"))
if os.environ.get("PROBE_N"):      # a CPU rehearsal at a small size
    n = int(os.environ["PROBE_N"])
    cfgj.update(N=n, nev=int(0.075 * n), nex=int(0.025 * n), tol=1e-10 * (n - 1))
N, nev, nex, tol = cfgj["N"], cfgj["nev"], cfgj["nex"], cfgj["tol"]
nevex = nev + nex
seed = int(sys.argv[1]) if len(sys.argv) > 1 else 3325000101
variants = sys.argv[2].split(",") if len(sys.argv) > 2 else ["G", "A", "O", "C"]
cc = ct.ChaseConfig(ring_backend="pallas", seed=sub_seed(int(cfgj["matrix_seed"]), "chase"))
t = time.perf_counter()
P = clement_dense.make(cfgj, int(cfgj["matrix_seed"]), dev)
H = P.H
scale = 1e-3 * float(torch.linalg.matrix_norm(H)) / N
print("matrix", time.perf_counter() - t, "scale", scale, flush=True)
t = time.perf_counter()
r0 = ct.eigsh(H, nev, nex, tol=tol, config=cc, device=dev)
sync()
print("member 0: %d iterations, %.2f s, lowerb %.1f" % (r0.iterations, time.perf_counter() - t, r0.lowerb), flush=True)
rv = np.sort(r0.ritzv_full)
lam_nevex = -(N - 1) + 2.0 * (nevex - 1)
print("lambda_nevex %.1f; ritzv0 above it +50: %d; top 8 %s" % (lam_nevex, (rv > lam_nevex + 50).sum(), np.round(rv[-8:], 1)))
print("ritzv0 quantiles of the extras", np.round(np.quantile(np.sort(r0.ritzv_full[nev:]), [0, .25, .5, .75, .9, 1]), 1))
perturb_(H, scale, generator(dev, seed, "member", 1), 2048)
sync()

VARIANT = {}
orig = solver._warm_bounds
def patched(op, ritzv0, m, numvec, nevex_, generator_, log):
    N_ = op.N
    probes = torch.cat([solver._draw(op, 1, generator_), solver._draw(op, numvec - 1, generator_)], dim=1)
    a, b, _ = lz.lanczos_scan(op.H, probes, m=m, want_basis=False, grid=op.grid)
    a_np = solver._host(a, "x"); b_np = solver._host(b, "x")
    theta, tau, _ = lz.lanczos_tridiag_host(a_np, b_np, want_vectors=False)
    upperb = lz.upper_bound(theta[:1], b_np[-1, :1])
    ritzv = np.asarray(ritzv0, np.float64).copy()
    mx = float(np.max(ritzv))
    ceiling = lz.dos_lower_bound(theta, tau, 2 * nevex_, N_)[1]
    q = lz.dos_lower_bound(theta, tau, nevex_, N_)[1]
    below = ritzv[ritzv <= q]
    G = float(np.max(below)) if below.size else q
    belowc = ritzv[ritzv <= ceiling]
    C = float(np.max(belowc)) if belowc.size else q
    v = VARIANT["v"]
    edge = {"G": G if mx > ceiling else mx, "A": q, "O": lam_nevex + 20.0, "C": C, "M": mx}[v]
    print("  edge variant %s: max %.1f ceiling %.1f q %.1f G %.1f C %.1f -> %.1f; upperb %.1f"
          % (v, mx, ceiling, q, G, C, edge, upperb), flush=True)
    return ritzv, upperb, edge
solver._warm_bounds = patched
for v in variants:
    VARIANT["v"] = v
    sync(); t = time.perf_counter()
    r1 = ct.eigsh(H, nev, nex, tol=tol, config=cc, device=dev, v0=r0.V.clone(), ritzv0=r0.ritzv_full, approx=True)
    sync()
    rv1 = np.sort(r1.ritzv_full)
    print("member 1 [%s]: %d iterations, %.2f s, converged %s, max resid %.2e, top extras %s"
          % (v, r1.iterations, time.perf_counter() - t, r1.converged, r1.resid.max(), np.round(rv1[-4:], 1)), flush=True)
    del r1
