"""Reading a torch.profiler trace of the measured window.

The traced run profiles the whole window (CPU and CUDA activities) and
exports it in Chrome's trace format; :func:`summarize` reduces the events
to what the per-layer readers need:

* ``window_s``: the length of the ``portbench.window`` range;
* ``busy_s``: the union of every device activity (kernels, copies, sets)
  inside the window;
* ``annotated[name]``: how many ``record_function(name)`` ranges there
  were, and the device seconds of every kernel *launched* inside them — a runtime launch event on the
  range's thread, inside its interval, tied to its kernel by the
  correlation id — pre-passes included;
* ``device_ops``: device seconds by kernel name, and ``idle_gaps``: the
  device's idle seconds inside the window by what the host was doing (the
  innermost host event on the window's thread at the gap's midpoint).
"""

from __future__ import annotations

import bisect
import collections
import json

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def load(path: str) -> list:
    """The complete ("X") events of an exported Chrome trace."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(intervals, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def _innermost(host: list, tid, times: list) -> list:
    """For each of the ascending ``times``, the name of the innermost host
    event on thread ``tid`` that holds it ("idle host" where none does):
    one sweep with a stack, as events of one thread nest."""
    seq = sorted((e for e in host if e.get("tid") == tid),
                 key=lambda e: (e["ts"], -e["dur"]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(seq) and seq[i]["ts"] <= t:
            e = seq[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        out.append(stack[-1]["name"] if stack else "idle host")
    return out


def summarize(events: list, annotations=(), top: int = 10) -> dict:
    """The window's summary (module note); times in seconds.  An empty
    dict when the trace holds no window range."""
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        return {}
    win = max(windows, key=lambda e: e["dur"])
    lo, hi = win["ts"], win["ts"] + win["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    dev_iv = _clip([(e["ts"], e["ts"] + e["dur"]) for e in device], lo, hi)
    busy = _union(dev_iv)
    busy_us = sum(b - a for a, b in busy)

    ops = collections.Counter()
    for e in device:
        if e.get("cat") == "kernel" and lo <= e["ts"] < hi:
            ops[e["name"]] += e["dur"] / 1e6

    # device seconds of the kernels launched inside each annotation
    corr_dur = collections.defaultdict(float)
    for e in device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            corr_dur[corr] += e["dur"]
    launches = sorted((e["ts"], e.get("tid"), e.get("args", {})
                       .get("correlation")) for e in events
                      if e.get("cat") in LAUNCH_CATS)
    starts = [t for t, _, _ in launches]
    annotated = {}
    for name in annotations:
        total, ranges = 0.0, 0
        for a in events:
            if a.get("name") != name or a.get("cat") != "user_annotation":
                continue
            ranges += 1
            t0, t1 = a["ts"], a["ts"] + a["dur"]
            i = bisect.bisect_left(starts, t0)
            while i < len(launches) and launches[i][0] <= t1:
                _, tid, corr = launches[i]
                if tid == a.get("tid") and corr is not None:
                    total += corr_dur.get(corr, 0.0)
                i += 1
        annotated[name] = {"ranges": ranges, "device_s": total / 1e6}

    host = [e for e in events if e.get("cat") in HOST_CATS
            and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    spans = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    names = _innermost(host, win.get("tid"), [(a + b) / 2 for a, b in spans])
    gaps = collections.Counter()
    for (a, b), name in zip(spans, names):
        gaps[name] += (b - a) / 1e6
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "annotated": annotated,
        "device_ops": [[n, s] for n, s in ops.most_common(top)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(top)],
    }
