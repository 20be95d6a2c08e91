"""qr_rr_device_s: the dense linear algebra's device seconds per solve —
the device time of every kernel launched inside the program's ``chase.qr``
and ``chase.rr`` spans (the Cholesky QR chain and its fallbacks, the
Rayleigh–Ritz projection, its eigensolve and the residuals), tied to the
spans by ``devtrace``, over the window's solves.  Nothing to read without
the spans or without device time in them."""

from portbench.program import span_device_s

RANGES = ("chase.qr", "chase.rr")


def read(run):
    return span_device_s(run, RANGES)
