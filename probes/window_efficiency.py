"""How much of the ring filters' kernel work a benchmark cell's solve
keeps: the degree arrays each ring filter is handed, at the cell's full
size.

    python probes/window_efficiency.py --workload herm_c128_n30000.cold \
        [--out degrees.json]

Builds the cell's matrix as ``portbench/run.py`` does, warms up with a
one-iteration solve, then solves the cell's instance 0 once with
``collect_perf`` on and every call of ``parallel/ring._filter_ring`` and
``_refine_ring`` (the solvers' filters on every route) recorded: its
window's degrees, its products per step, the filter operator's dtype and
its product's column tile (``parallel/ring.filter_product``).
Prints one JSON line: the iterations, the solve's seconds,
``PerfData.filter_window_efficiency()``, and from the recorded degrees
the share of the launched columns that were live (a column is live at
step t while its degree is ≥ t) for two schedules: every step on the
whole padded window, and every step on the window's live suffix rounded
out to whole tiles of the product (the kernel's W tiles, 64 columns for
c64, 128 for f32, 192 for bf16; 1 where the step is ``torch.matmul``).  Where the
program counts ``filter_cols:executed`` and ``filter_cols:useful`` in
``perf.COUNTS``, their increase over the solve is printed too.
``--out`` writes the degree arrays.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chase_tpu_torch as ct  # noqa: E402
from chase_tpu_torch import perf  # noqa: E402
from chase_tpu_torch.parallel import ring as pring  # noqa: E402
from portbench.seeds import generator, sub_seed  # noqa: E402

def schedules(degrees, first: int, deg_max: int, tile: int) -> tuple:
    """(live, whole, suffix) column-steps of steps ``first``…deg_max."""
    d = np.asarray(degrees)
    w = d.size
    live = whole = suffix = 0
    for t in range(first, deg_max + 1):
        on = np.flatnonzero(d >= t)
        if not on.size:
            continue
        live += on.size
        whole += w
        suffix += min(w, -(-(w - int(on[0])) // tile) * tile)
    return live, whole, suffix


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    dev = torch.device("cuda")
    family = importlib.import_module(f"portbench.matrices.{cfg['family']}")
    H = family.make(cfg, int(cfg["matrix_seed"]), dev).H
    H = H.to(getattr(torch, cfg["dtype"]))
    entry = getattr(ct, cfg["entry"])
    chase = ct.ChaseConfig(**cfg["chase_config"],
                           seed=sub_seed(int(cfg["matrix_seed"]), "chase"))

    def solve(config, gen, collect):
        return entry(H, int(cfg["nev"]), int(cfg["nex"]),
                     tol=float(cfg["tol"]), config=config, device=dev,
                     generator=gen, collect_perf=collect)

    solve(dataclasses.replace(chase, max_iter=1), generator(dev, 0, "warm"),
          False)
    torch.cuda.synchronize()

    calls = []
    real = {"_filter_ring": pring._filter_ring,
            "_refine_ring": pring._refine_ring}

    def recorder(name):
        def shim(H, X, *a, **kw):
            degrees = a[0] if name == "_filter_ring" else a[1]
            deg_max, products, prod = (a[4], a[5], a[6]) \
                if name == "_filter_ring" else (a[8], a[9], a[10])
            calls.append({"kind": name, "dtype": str(H.dtype),
                          "deg_max": int(deg_max), "products": int(products),
                          "tile": int(prod.tile),
                          "degrees": [int(x) for x in np.asarray(degrees)]})
            return real[name](H, X, *a, **kw)
        return shim

    before = dict(perf.COUNTS)
    for name in real:
        setattr(pring, name, recorder(name))
    try:
        t0 = time.perf_counter()
        res = solve(chase, generator(dev, 0, "start", 0), True)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(pring, name, fn)
    live = whole = suffix = 0
    for c in calls:
        first = 1 if c["kind"] == "_filter_ring" else 2
        lv, wh, sf = schedules(c["degrees"], first, c["deg_max"],
                               c["tile"])
        live += lv * c["products"]
        whole += wh * c["products"]
        suffix += sf * c["products"]
    grew = {k: n - before.get(k, 0) for k, n in perf.COUNTS.items()
            if k.startswith("filter_cols:")}
    out = {"workload": args.workload, "iterations": int(res.iterations),
           "solve_s": solve_s, "filter_calls": len(calls),
           "perfdata_filter_window_efficiency":
               res.perf.filter_window_efficiency(),
           "live_column_steps": live, "whole_window_column_steps": whole,
           "suffix_column_steps": suffix,
           "whole_window_efficiency": live / whole if whole else None,
           "suffix_efficiency": live / suffix if suffix else None,
           "suffix_over_whole": suffix / whole if whole else None,
           "counted": grew, "card": torch.cuda.get_device_name(dev)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": out, "calls": calls}, f)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
