"""The cost of the program's spans with tracing off, on this host.

    python probes/span_cost.py [--n 200000]

Times ``perf.span`` entered and left with no profiler recording and no
phase clock running (the untraced program's case), the same with a
phase clock on the CPU, and an unguarded ``torch.profiler.
record_function`` for comparison; the counters' increments as the
program makes them — ``perf.count`` of a fixed key, ``perf.host_sync``
(the count ``perf.to_host``, ``perf.item`` and ``perf.to_device`` add
to their read or copy) and ``ring_hemm``'s two counts of a main launch,
one of them under a formatted route-and-width key; then counts the
spans of one small solve of each host solver on the CPU (``perf.span``
wrapped for the count), so that a span's cost times the spans of a solve
is what the spans add to it (``probes/sync_check.py`` counts a benchmark
cell's spans and increments).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chase_tpu_torch as ct  # noqa: E402
from chase_tpu_torch import perf  # noqa: E402
from chase_tpu_torch.ops import ring_hemm as rh  # noqa: E402
from chase_tpu_torch.models import clement, random_pseudo_hermitian  # noqa


def per_call_us(fn, n: int) -> float:
    """The median over 5 rounds of fn()'s time per call, in µs."""
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        rounds.append((time.perf_counter() - t0) / n * 1e6)
    return sorted(rounds)[2]


def spans_of(solve) -> dict:
    """The spans one call of ``solve`` opens, by name."""
    seen = {}
    real = perf.span.__enter__

    def enter(self):
        seen[self.name] = seen.get(self.name, 0) + 1
        return real(self)

    perf.span.__enter__ = enter
    try:
        solve()
    finally:
        perf.span.__enter__ = real
    return seen


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=200000)
    args = p.parse_args(argv)

    def off():
        with perf.span("chase.filter"):
            pass

    def rf():
        with torch.profiler.record_function("chase.filter"):
            pass

    H = torch.empty((2, 2), dtype=torch.complex64)
    out = {"span_off_us": per_call_us(off, args.n),
           "count_us": per_call_us(lambda: perf.count("ring_hemm"), args.n),
           "host_sync_us": per_call_us(lambda: perf.host_sync("solver.rr"),
                                       args.n),
           "launch_counts_us": per_call_us(
               lambda: rh._launched("ring_hemm", H, 3000), args.n),
           "record_function_unguarded_us": per_call_us(rf, args.n // 10),
           "empty_loop_us": per_call_us(lambda: None, args.n)}
    with perf.PhaseClock(perf.PerfData(), torch.device("cpu")):
        out["span_with_cpu_clock_us"] = per_call_us(off, args.n)
    H = clement(400).astype(np.float32)
    Hp = random_pseudo_hermitian(300, np.float64, seed=5)
    herm = spans_of(lambda: ct.eigsh(
        H, 24, 16, tol=1e-3, device="cpu",
        config=ct.ChaseConfig(ring_backend="pallas")))
    pseudo = spans_of(lambda: ct.eigsh_pseudo(Hp, 12, 8, tol=1e-9,
                                              device="cpu"))
    out.update(spans_eigsh=herm, spans_eigsh_pseudo=pseudo,
               host=os.uname().nodename, torch=torch.__version__)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
