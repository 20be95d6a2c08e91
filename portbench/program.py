"""What the program records about itself, for the per-layer readers: the
device time of the kernels launched inside its spans (``chase.*``
``record_function`` ranges, which ``devtrace.summarize`` ties to their
kernels), and the increase of its counters over the window.

A program without the spans or the counters gives nothing to read: the
readers then return None and raise nothing."""

from __future__ import annotations

import contextlib
from typing import Optional


def span_device_s(run, names: tuple) -> Optional[float]:
    """Device seconds per solve of the kernels launched inside the
    program's spans ``names`` in the traced window, or None (no such
    span, no device time in them, or no solve)."""
    got = [run.trace.get("annotated", {}).get(n, {}) for n in names]
    solves = [s for s in run.solves if s.error is None]
    device_s = sum(g.get("device_s", 0.0) for g in got)
    if not any(g.get("ranges") for g in got) or not device_s or not solves:
        return None
    return device_s / len(solves)


def _registry():
    """The program's counter registry, or None where it keeps none (a
    program without ``perf.COUNTS``)."""
    try:
        from chase_tpu_torch.perf import COUNTS
    except ImportError:
        return None
    return COUNTS


@contextlib.contextmanager
def counts(notes: list):
    """Around the window: the registry's counts before it and after it,
    appended to ``notes`` (nothing where the program keeps none)."""
    registry = _registry()
    if registry is not None:
        notes.append(dict(registry))
    try:
        yield
    finally:
        if registry is not None:
            notes.append(dict(registry))


def increase(notes, prefix: str) -> Optional[int]:
    """How much the counts under keys that start with ``prefix`` grew over
    the window (a key the program never counted grew by 0), or None
    without both snapshots."""
    if not notes or len(notes) != 2:
        return None
    before, after = notes
    return sum(n - before.get(k, 0) for k, n in after.items()
               if k.startswith(prefix))
