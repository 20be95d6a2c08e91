"""comm_gib: the payload GiB rank 0's collectives sent or reduced per
solve — the increase over the window of the program's
"comm_bytes:<kind>" counts (``perf.COUNTS``: each collective's local
tensor, as the grid's ``CollectiveStats`` counts it), over the window's
solves.  ``instrument`` snapshots the counts before and after the
window.  Nothing to read where the program keeps no counts or counts no
collective."""

from portbench.program import counts, increase

PREFIX = "comm_bytes:"


def instrument(notes: list):
    return counts(notes)


def read(run):
    n = increase(run.notes.get("comm_gib"), PREFIX)
    solves = [s for s in run.solves if s.error is None]
    if not n or not solves:
        return None
    return n / 2**30 / len(solves)
