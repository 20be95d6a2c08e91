"""The program's host-sync count against torch's CUDA sync debug mode, on
one solve of a benchmark cell at its full size.

    python probes/sync_check.py --workload herm_c128_n30000.cold

Builds the cell's matrix as ``portbench/run.py`` does, warms up with a
one-iteration solve, then solves the cell's instance 0 once with
``torch.cuda.set_sync_debug_mode("warn")`` on and reads the increase of
the program's "host_sync:<site>" counts.  Prints one JSON line: the
iterations, both totals and per-iteration figures, the program's count
by site, and the debug mode's by the innermost line of the port on the
stack; besides, what the solve's tracing costs when it is off is made
of — the spans it opened and the increments of every counter
(``perf.COUNTS``, one ``perf.count`` call each), to multiply by
``probes/span_cost.py``'s times a call.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib
import json
import os
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chase_tpu_torch as ct  # noqa: E402
from chase_tpu_torch import perf  # noqa: E402
from portbench.seeds import generator, sub_seed  # noqa: E402

PORT = f"chase_tpu_torch{os.sep}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
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

    def solve(config, gen):
        return entry(H, int(cfg["nev"]), int(cfg["nex"]),
                     tol=float(cfg["tol"]), config=config, device=dev,
                     generator=gen)

    solve(dataclasses.replace(chase, max_iter=1), generator(dev, 0, "warm"))
    torch.cuda.synchronize()

    debug = collections.Counter()
    orig = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        port = [f for f in traceback.extract_stack() if PORT in f.filename]
        if port:
            debug[f"{os.path.basename(port[-1].filename)}:"
                  f"{port[-1].lineno}"] += 1

    spans = collections.Counter()
    real_enter = perf.span.__enter__

    def enter(self):
        spans[self.name] += 1
        return real_enter(self)

    before = dict(perf.COUNTS)
    perf.span.__enter__ = enter
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = solve(chase, generator(dev, 0, "start", 0))
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = orig
            perf.span.__enter__ = real_enter
    increments = {k: n - before.get(k, 0) for k, n in perf.COUNTS.items()
                  if n != before.get(k, 0)}
    counted = {k[len(perf.HOST_SYNC):]: n - before.get(k, 0)
               for k, n in perf.COUNTS.items()
               if k.startswith(perf.HOST_SYNC) and n != before.get(k, 0)}
    its = int(res.iterations)
    out = {"workload": args.workload, "iterations": its,
           "counted": sum(counted.values()), "debug": sum(debug.values()),
           "counted_per_iteration": sum(counted.values()) / its,
           "debug_per_iteration": sum(debug.values()) / its,
           "counted_by_site": dict(sorted(counted.items())),
           "debug_by_line": dict(sorted(debug.items())),
           "spans": sum(spans.values()),
           "spans_by_name": dict(sorted(spans.items())),
           "count_increments": sum(increments.values()),
           "increments_by_key": dict(sorted(increments.items())),
           "card": torch.cuda.get_device_name(dev)}
    print(json.dumps(out))
    return 0 if out["counted"] == out["debug"] else 1


if __name__ == "__main__":
    sys.exit(main())
