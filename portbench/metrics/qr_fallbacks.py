"""qr_fallbacks: the Cholesky QR breakdowns per solve — the increase over
the window of the program's count of QR passes redone by Householder QR
or on the full block (``perf.COUNTS``' "qr_fallback:<to>" keys; none
counted reads 0), over the window's solves.  ``instrument`` snapshots the
count before and after the window.  Nothing to read where the program
keeps no counts."""

from portbench.program import counts, increase

PREFIX = "qr_fallback:"


def instrument(notes: list):
    return counts(notes)


def read(run):
    n = increase(run.notes.get("qr_fallbacks"), PREFIX)
    solves = [s for s in run.solves if s.error is None]
    if n is None or not solves:
        return None
    return n / len(solves)
