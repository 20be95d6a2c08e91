"""Count the collectives of a grid solve, on the CPU.

    python probes/grid_collectives.py [--N 1024] [--nev 60] [--nex 40]

Starts p gloo ranks on this machine (p = 2 and 4, each a (p, 1) grid,
then a (2, 2) grid) that solve an f32 Clement problem with
``ring_backend="pallas"`` (on the CPU every ring step is the kernel's
plain version), and prints rank 0's collectives per iteration by kind —
calls and payload bytes, as ``Grid2D.stats`` counts them — beside the
chunk ring's model: each rank sends p − 1 chunks of (N/p) × w elements
per product of a w-wide window, (p − 1)/p · N · itemsize · E bytes per
solve for E executed filter column-steps (``PerfData.
filtered_vecs_executed``).  Counts, not times: the seconds they take on
cards are not measured here.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def rank_main(r: int, c: int, rank: int, rdv: str, N: int, nev: int,
              nex: int) -> None:
    import numpy as np
    import torch
    torch.set_num_threads(1)
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(r * c)
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement
    from chase_tpu_torch.parallel import multihost
    grid = multihost.init_grid((r, c), f"file://{rdv}", device="cpu",
                               timeout=120)
    H = clement(N).astype(np.float32)
    res = ct.eigsh(H, nev, nex, tol=1e-2 * N / 1024, grid=grid,
                   collect_perf=True,
                   config=ct.ChaseConfig(ring_backend="pallas"))
    if rank == 0:
        print(json.dumps(dict(
            shape=[r, c], iterations=res.iterations,
            converged=res.converged, hemm_steps=res.perf.filter_hemm_steps,
            executed=res.perf.filtered_vecs_executed,
            stats={k: list(v) for k, v in grid.stats.summary().items()})),
            flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()


def run(r: int, c: int, N: int, nev: int, nex: int) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(k), "--shape",
             f"{r},{c}", "--rdv", rdv, "--N", str(N), "--nev", str(nev),
             "--nex", str(nex)], env=env, stdout=subprocess.PIPE, text=True)
            for k in range(r * c)]
        outs = [p.communicate(timeout=600)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise SystemExit(f"grid ({r}, {c}): ranks exited "
                         f"{[p.returncode for p in procs]}")
    return json.loads(outs[0].strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=1024)
    ap.add_argument("--nev", type=int, default=60)
    ap.add_argument("--nex", type=int, default=40)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--shape")
    ap.add_argument("--rdv")
    a = ap.parse_args()
    if a.rank is not None:
        r, c = (int(x) for x in a.shape.split(","))
        rank_main(r, c, a.rank, a.rdv, a.N, a.nev, a.nex)
        return
    for r, c in ((2, 1), (4, 1), (2, 2)):
        out = run(r, c, a.N, a.nev, a.nex)
        it = out["iterations"]
        print(f"grid ({r}, {c}), Clement N={a.N} nev={a.nev} nex={a.nex} "
              f"f32, pallas: converged={out['converged']} iterations={it}, "
              f"filter HEMM steps {out['hemm_steps']}, executed column-"
              f"steps {out['executed']}")
        for kind, (calls, nbytes) in sorted(out["stats"].items()):
            print(f"  {kind:10s} {calls / it:8.1f} calls, "
                  f"{nbytes / it / 1e6:10.3f} MB per iteration (rank 0)")
        if c == 1:
            model = (r - 1) / r * a.N * 4 * out["executed"]
            got = out["stats"].get("sendrecv", [0, 0])[1]
            print(f"  chunk ring model (p-1)/p·N·4·E = {model / 1e6:.3f} MB, "
                  f"counted {got / 1e6:.3f} MB")


if __name__ == "__main__":
    main()
