"""solve_s: the window's host-clock seconds over the solves (in a
sequence, members) completed in it — the users' time to a solution of
stated accuracy, in a closed loop with one caller."""


def read(run):
    done = [s for s in run.solves if s.error is None]
    return run.window_s / len(done) if done else None
