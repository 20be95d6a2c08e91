"""filter_window_efficiency: the share of the filter's launched columns
that were live, in % — over the window, the increase of the program's
count of the columns whose degree a filter step had not yet passed
(``perf.COUNTS``' "filter_cols:useful", × the products a step) over the
increase of its count of the summed width of every filter product
launched ("filter_cols:executed").  ``instrument`` snapshots the counts
before and after the window.  Nothing to read where the program keeps no
such counts, or where the window launched no filter product."""

from portbench.program import counts, increase

EXECUTED = "filter_cols:executed"
USEFUL = "filter_cols:useful"


def instrument(notes: list):
    return counts(notes)


def read(run):
    notes = run.notes.get("filter_window_efficiency")
    executed = increase(notes, EXECUTED)
    if not executed:
        return None
    return 100.0 * increase(notes, USEFUL) / executed
