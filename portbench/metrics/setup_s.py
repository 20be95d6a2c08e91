"""setup_s: host-clock seconds from the start of the process to the end
of set-up: imports, the port's kernels built (on a checkout's first run)
and loaded, the matrix made on the card, the warm-up (a sequence's
member 0 solved cold)."""


def read(run):
    return run.setup_s
