"""comm_device_s: the collectives' device seconds per solve on rank 0 —
the device time of every kernel launched inside the program's
``chase.comm`` spans (each collective's issue and its wait on a process
grid: the 2-D ring's chunk exchanges, reduce-scatters and parity flips,
the all-reduces and broadcasts of QR and RR), over the window's solves,
in run.py's process (rank 0 of the grid).  An NCCL kernel runs beside
the compute on its own stream, so this is the time the collectives'
kernels spent, waits for peers included, not the time they added.
Nothing to read without the spans, or without device time in them (a
run on the CPU)."""

from portbench.program import span_device_s

RANGES = ("chase.comm",)


def read(run):
    return span_device_s(run, RANGES)
