"""Independent problems back to back: every solve is a new problem on
the benchmark's H, handed over as a tensor (nothing the port derives from
H carries over), from one of the configuration's ``instances`` = K fixed
start blocks — instance j's drawn by a generator seeded from (0, j).  The
window runs whole passes over the K instances, each pass from instance
``seed mod K`` on, and starts a pass only while ``--seconds`` has not
passed: every run solves each instance equally often, so every seed does
the same work in another order.  Set-up warms up with one solve capped at
``warmup_max_iter`` iterations."""

from __future__ import annotations

import dataclasses
import importlib
import time

from portbench import loop
from portbench.seeds import generator


class Mode(loop.Mode):

    def setup(self) -> None:
        c = self.cell
        self.H = c.problem.H.to(c.solve_dtype)   # the control's copy
        c.call(self.H, config=dataclasses.replace(
            c.chase_config, max_iter=int(c.traffic["warmup_max_iter"])),
            generator=generator(c.device, c.seed, "warmup"))

    def window(self, seconds: float) -> list:
        c = self.cell
        K = int(c.cfg["instances"])
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            for j in range(K):
                g = generator(c.device, 0, "start", (c.seed + j) % K)
                self.solves.append(self.timed(
                    lambda: c.call(self.H, config=c.chase_config,
                                   generator=g),
                    loop.nbytes(self.H)))
        return self.solves

    def release(self) -> None:
        self.H = None

    def judge(self) -> list:
        c = self.cell
        exact = importlib.import_module(
            f"portbench.reference.{c.cfg['family']}").exact(c.problem.inputs)
        return [self.numbers(c.problem.H, rec, exact) for rec in self.solves]
