"""warm_dos_lowered_share: the share of the window's warm starts whose
lower edge the program capped by the DoS quantile of fresh probes, in % —
the increase over the window of the program's count of such warm starts
(``perf.COUNTS``' "warm_start:dos_lowered": the previous solve's largest
Ritz value lay deep in the spectrum) over the increase of its count of
warm starts ("warm_start:members").  ``instrument`` snapshots the counts
before and after the window.  Nothing to read where the program keeps no
such counts, or where the window started no solve warm."""

from portbench.program import counts, increase

MEMBERS = "warm_start:members"
LOWERED = "warm_start:dos_lowered"


def instrument(notes: list):
    return counts(notes)


def read(run):
    notes = run.notes.get("warm_dos_lowered_share")
    members = increase(notes, MEMBERS)
    if not members:
        return None
    return 100.0 * increase(notes, LOWERED) / members
