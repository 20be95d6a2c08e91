"""iterations: the solver loop's iterations per solve (``SolveResult.
iterations``), the mean over the window's solves."""


def read(run):
    its = [s.iterations for s in run.solves if s.error is None]
    return sum(its) / len(its) if its else None
