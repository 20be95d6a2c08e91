"""device_idle_share: the share of the window, in %, in which no
operation ran on the device — 1 − (the union of the trace's kernel, copy
and set intervals ÷ the window), from torch.profiler over the window.
Nothing to read where the trace holds no device activity."""


def read(run):
    busy, window = run.trace.get("busy_s"), run.trace.get("window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
