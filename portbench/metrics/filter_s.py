"""filter_s: the filter's seconds per solve — the port's ``PerfData``
phase "Filter" (host clock around work that ends in a device
synchronize, ``collect_perf=True`` in the traced run only), the mean over
the window's solves."""


def read(run):
    t = [s.timings["Filter"] for s in run.solves if s.timings is not None]
    return sum(t) / len(t) if t else None
