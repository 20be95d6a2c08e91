"""Count the collectives of a grid solve, on the CPU.

    python probes/grid_collectives.py [--N 1024] [--nev 60] [--nex 40]

Starts p gloo ranks on this machine (p = 2 and 4, each a (p, 1) grid,
then a (2, 2) grid twice: the windowed filter, ``ring_filter=False``, and
the 2-D ring) that solve an f32 Clement problem with
``ring_backend="pallas"`` (on the CPU every ring step is the kernel's
plain version), then an f32 structured BSE problem of the same N with
nev/2 and nex/2 (``eigsh_pseudo``: a block of 2·(nev + nex)/2 columns, the
H² filter's two ring products per step, K-conjugation's row rotation),
and prints rank 0's collectives per iteration by kind — calls and
payload bytes, as ``Grid2D.stats`` counts them; on the 2-D ring rank 1's
too, which flips (rank 0 holds chunk 0 in both parities) — beside the
rings' models.  The (p, 1) chunk ring: each rank sends p − 1 chunks of
(N/p) × w elements per product of a w-wide window, (p − 1)/p · N ·
itemsize · E bytes per solve for E executed filter column-steps
(``PerfData.filtered_vecs_executed``, which counts both products of an
H² step).  The 2-D ring on (r, r): each pass sends r − 1 chunks of
N/r² rows, (r − 1)/r² · N · itemsize · E bytes, and reduce-scatters its
N/r-row partial, N/r · itemsize · E bytes.  Counts, not times: the
seconds they take on cards are not measured here.
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
              nex: int, ring: bool) -> None:
    import numpy as np
    import torch
    torch.set_num_threads(1)
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(r * c)
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement
    from chase_tpu_torch.parallel import multihost
    grid = multihost.init_grid((r, c), f"file://{rdv}", device="cpu",
                               timeout=120)
    from chase_tpu_torch.models import structured_pseudo_hermitian
    cfg = ct.ChaseConfig(ring_backend="pallas",
                         ring_filter=None if ring else False)
    Hb, _ = structured_pseudo_hermitian(N, np.float32, seed=3)
    for what, solve in (
            ("clement", lambda: ct.eigsh(
                clement(N).astype(np.float32), nev, nex,
                tol=1e-2 * N / 1024, grid=grid, collect_perf=True,
                config=cfg)),
            ("bse", lambda: ct.eigsh_pseudo(
                Hb, nev // 2, nex // 2, tol=1e-4, grid=grid,
                collect_perf=True, config=cfg))):
        grid.stats.reset()
        res = solve()
        if rank < 2:
            print(json.dumps(dict(
                rank=rank,
                what=what, shape=[r, c], iterations=res.iterations,
                converged=res.converged,
                hemm_steps=res.perf.filter_hemm_steps,
                executed=res.perf.filtered_vecs_executed,
                stats={k: list(v) for k, v in
                       grid.stats.summary().items()})), flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()


def run(r: int, c: int, N: int, nev: int, nex: int, ring: bool) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(k), "--shape",
             f"{r},{c}", "--rdv", rdv, "--N", str(N), "--nev", str(nev),
             "--nex", str(nex)] + ([] if ring else ["--windowed"]),
            env=env, stdout=subprocess.PIPE, text=True)
            for k in range(r * c)]
        outs = [p.communicate(timeout=600)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise SystemExit(f"grid ({r}, {c}): ranks exited "
                         f"{[p.returncode for p in procs]}")
    return [json.loads(ln) for out in outs[:2]
            for ln in out.strip().splitlines() if ln.startswith("{")]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=1024)
    ap.add_argument("--nev", type=int, default=60)
    ap.add_argument("--nex", type=int, default=40)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--shape")
    ap.add_argument("--rdv")
    ap.add_argument("--windowed", action="store_true")
    a = ap.parse_args()
    if a.rank is not None:
        r, c = (int(x) for x in a.shape.split(","))
        rank_main(r, c, a.rank, a.rdv, a.N, a.nev, a.nex, not a.windowed)
        return
    for r, c, ring in ((2, 1, True), (4, 1, True), (2, 2, False),
                       (2, 2, True)):
        route = ("windowed" if not ring else "1-D ring" if c == 1
                 else "2-D ring")
        for out in run(r, c, a.N, a.nev, a.nex, ring):
            if out["rank"] and (c == 1 or not ring):
                continue
            it = out["iterations"]
            nev, nex = ((a.nev, a.nex) if out["what"] == "clement"
                        else (a.nev // 2, a.nex // 2))
            print(f"grid ({r}, {c}) {route}, {out['what']} N={a.N} "
                  f"nev={nev} nex={nex} f32, pallas: converged="
                  f"{out['converged']} iterations={it}, filter HEMM steps "
                  f"{out['hemm_steps']}, executed column-steps "
                  f"{out['executed']}; rank {out['rank']}")
            for kind, (calls, nbytes) in sorted(out["stats"].items()):
                print(f"  {kind:14s} {calls / it:8.1f} calls, "
                      f"{nbytes / it / 1e6:10.3f} MB per iteration")
            got = out["stats"].get("sendrecv", [0, 0])[1]
            if c == 1:
                model = (r - 1) / r * a.N * 4 * out["executed"]
                print(f"  chunk ring model (p-1)/p·N·4·E = "
                      f"{model / 1e6:.3f} MB, counted {got / 1e6:.3f} MB")
            elif ring and r == c:
                model = (r - 1) / (r * c) * a.N * 4 * out["executed"]
                rs = a.N / r * 4 * out["executed"]
                got_rs = out["stats"].get("reduce_scatter", [0, 0])[1]
                print(f"  2-D ring model: sendrecv (r-1)/r²·N·4·E = "
                      f"{model / 1e6:.3f} MB, counted {got / 1e6:.3f} MB; "
                      f"reduce_scatter N/r·4·E = {rs / 1e6:.3f} MB, "
                      f"counted {got_rs / 1e6:.3f} MB")


if __name__ == "__main__":
    main()
