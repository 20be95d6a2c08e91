"""What every traffic mode shares: the timed call, and the reference's
numbers for one solve.

A traffic file (``traffic/<name>.json``) names a ``mode``, whose generator
is ``traffic/<mode>.py`` (a class ``Mode`` built on :class:`Mode` here),
and its parameters.  A mode drives the configuration's entry point in a
closed loop with one caller: solves run back to back, as a DFT code calls
the solver once per step, and the window ends when the last solve it
started returns.  It offers ``setup()`` (set-up's share: warm-up, or a
sequence's first member), ``window(seconds)`` (the timed solves),
``release()`` (the program's state freed before the reference runs) and
``judge()`` (the reference's numbers of each timed solve).

Every solve is timed on the host clock after a device synchronize, and
the device memory it adds over what was allocated when it was called is
read from the allocator.  Its eigenvalues and eigenvectors are kept for
the reference, which judges them once the window has closed, with the
configuration's judge (``reference/judges/<judge>.py``).
"""

from __future__ import annotations

import dataclasses
import importlib
import time
import traceback
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Solve:
    t0: float
    t1: float
    iterations: int = 0
    converged: bool = False
    timings: Optional[dict] = None   # PerfData's phase seconds (traced run)
    mem_added: Optional[int] = None  # peak bytes over those at the call
    input_bytes: int = 0             # H (and a warm start's V) handed in
    lam: Optional[np.ndarray] = None
    V: Optional[torch.Tensor] = None  # the nev eigenvectors (a view)
    V_bytes: int = 0                  # the whole returned block's bytes
    error: Optional[str] = None


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Mode:
    """What every mode shares: the timed call and the judge."""

    def __init__(self, cell):
        self.cell = cell
        self.solves: list = []
        self.judge_numbers = importlib.import_module(
            f"portbench.reference.judges.{cell.cfg['judge']}").numbers

    def timed(self, fn, input_bytes: int) -> Solve:
        dev = self.cell.device
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            self.cell.note_peak()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        rec = Solve(t0=time.perf_counter(), t1=0.0, input_bytes=input_bytes)
        try:
            res = fn()
            if cuda:
                torch.cuda.synchronize(dev)
        except Exception:
            res = None
            rec.error = traceback.format_exc()
        rec.t1 = time.perf_counter()
        if cuda:
            rec.mem_added = torch.cuda.max_memory_allocated(dev) - base
            self.cell.note_peak()
        if res is not None:
            rec.iterations = int(res.iterations)
            rec.converged = bool(res.converged)
            rec.lam = np.asarray(res.ritzv, dtype=np.float64)
            rec.V = res.V[:, :self.cell.nev]
            rec.V_bytes = nbytes(res.V)
            if res.perf is not None:
                rec.timings = dict(res.perf.timings)
        return rec

    def numbers(self, H, rec: Solve, exact) -> Optional[dict]:
        """The reference's numbers for one solve (None: it raised)."""
        c = self.cell
        if rec.lam is None:
            return None
        return self.judge_numbers(H, rec.lam, rec.V, c.nev, exact, c.cfg,
                                  c.norm)
