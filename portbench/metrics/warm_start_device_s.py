"""warm_start_device_s: the warm start's device seconds per solve — the
device time of every kernel launched inside the program's
``chase.warm_start`` spans (the caller's block placed, the bounds-only
Lanczos on fresh probes, the damped interval's lower edge), tied to the
spans by ``devtrace``, over the window's solves.  Nothing to read without
the span (a program that opens none, or a window of cold solves) or
without device time in it."""

from portbench.program import span_device_s

RANGES = ("chase.warm_start",)


def read(run):
    return span_device_s(run, RANGES)
