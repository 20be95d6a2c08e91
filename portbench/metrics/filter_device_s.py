"""filter_device_s: the filter's device seconds per solve — the device
time of every kernel launched inside the program's ``chase.filter`` spans
(the degree-sorted filter, its ring_hemm products and their pre-passes),
tied to the spans by ``devtrace`` (a launch on the span's thread, inside
its interval, matched to its kernel by correlation id), over the window's
solves.  Unlike ``filter_s`` it holds no host time.  Nothing to read
without the spans (a program that opens none) or without device time in
them."""

from portbench.program import span_device_s

RANGES = ("chase.filter",)


def read(run):
    return span_device_s(run, RANGES)
