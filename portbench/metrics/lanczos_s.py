"""lanczos_s: the spectral estimate's device seconds per solve — the
device time of every kernel launched inside the program's
``chase.lanczos`` span (the Lanczos scan and the DoS start vectors; the
tridiagonal is solved on the host), tied to the span by ``devtrace``,
over the window's solves.  Nothing to read without the span or without
device time in it."""

from portbench.program import span_device_s

RANGES = ("chase.lanczos",)


def read(run):
    return span_device_s(run, RANGES)
