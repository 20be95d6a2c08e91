"""ring_hemm_roofline: the ring_hemm products' share of their roofline,
in %: the sum over every ``ops.ring_hemm.ring_hemm`` call in the window
of its least time on this card (``roofline.hemm_bound_s``: FLOPs over the
route's peak or bytes over the memory rate, whichever is larger) over the
device seconds of every kernel launched inside those calls, pre-passes
included (``devtrace``: the calls' ``record_function`` ranges).  Nothing
to read without calls, without device time in them, or on a card the
peak table does not name.

``instrument`` wraps the port's ``ops.ring_hemm.ring_hemm`` for the
traced window (the port looks the wrapper up at call time): each call
records its product's shape (m, b, k, H's dtype) and runs inside a
``record_function(RANGE)`` range, so that the trace ties the kernels it
launches to it."""

import contextlib

import torch

from portbench.roofline import hemm_bound_s

RANGE = "portbench.ring_hemm"
RANGES = (RANGE,)


@contextlib.contextmanager
def instrument(calls: list):
    from chase_tpu_torch.ops import ring_hemm as rh
    real = rh.ring_hemm

    def shim(H, V, **kw):
        m = H.shape[1] if kw.get("trans") else H.shape[0]
        calls.append((m, V.shape[0], V.shape[1], str(H.dtype)))
        with torch.profiler.record_function(RANGE):
            return real(H, V, **kw)

    rh.ring_hemm = shim
    try:
        yield
    finally:
        rh.ring_hemm = real


def read(run):
    calls = run.notes.get("ring_hemm_roofline")
    device_s = run.trace.get("annotated", {}).get(RANGE, {}).get("device_s")
    if not calls or not device_s:
        return None
    bounds = [hemm_bound_s(m, b, k, dtype, run.card["name"])
              for m, b, k, dtype in calls]
    if any(t is None for t in bounds):
        return None
    return 100.0 * sum(bounds) / device_s
