"""host_syncs: the host syncs per iteration — the increase over the
window of the program's own count of the points where the host waits for
the device (``perf.COUNTS``' "host_sync:<site>" keys: a read of a device
value, or a copy of a host array onto the device), over the iterations
of the window's solves.  ``instrument`` snapshots the count before and
after the window.  Nothing to read where the program keeps no counts."""

from portbench.program import counts, increase

PREFIX = "host_sync:"


def instrument(notes: list):
    return counts(notes)


def read(run):
    n = increase(run.notes.get("host_syncs"), PREFIX)
    iters = sum(s.iterations for s in run.solves if s.error is None)
    if n is None or not iters:
        return None
    return n / iters
