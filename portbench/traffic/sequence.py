"""An SCF-like sequence: ``eigsh_sequence`` over correlated members, each
warm started from the previous one's V and Ritz values.  Member 0 is
solved cold in set-up; each later member is made in the window, in place:
the previous member plus a Hermitian perturbation of scale
``drift``·‖H₀‖_F/N (the form of ``models.hermitian_sequence``), drawn in
``tile``-sized tiles from a generator seeded from (seed, member) so that
no second N × N buffer is needed.  The window runs whole passes of
``pass_members`` members and starts a pass only while ``--seconds`` has
not passed, so that every run solves the same members 1, 2, …; member 0
and each member's Lanczos probes are drawn from the configuration's seed
(``ChaseConfig.seed``), the same in every run.  Members have no
closed-form spectrum: the judge reads them with no exact one."""

from __future__ import annotations

import math
import time

import torch

from portbench import loop
from portbench.seeds import generator


def perturb_(H: torch.Tensor, scale: float, g: torch.Generator,
             tile: int) -> None:
    """H += scale·(E + Eᴴ)/2 in place, E with standard normal real (and
    imaginary) parts, drawn tile by tile: tiles (i, j) and (j, i) of E
    for each i ≤ j, then both mirrored tiles of the sum written at once."""
    N, cplx = H.shape[0], H.dtype.is_complex
    kw = dict(generator=g, dtype=H.dtype, device=H.device)
    unit = math.sqrt(2.0) if cplx else 1.0   # randn's complex parts: var ½
    for i0 in range(0, N, tile):
        rows = slice(i0, min(i0 + tile, N))
        for j0 in range(i0, N, tile):
            cols = slice(j0, min(j0 + tile, N))
            shape = (rows.stop - rows.start, cols.stop - cols.start)
            E_ij = torch.randn(shape, **kw)
            E_ji = E_ij if i0 == j0 else torch.randn(shape[::-1], **kw)
            P = (E_ij + E_ji.mH) * (0.5 * unit * scale)
            H[rows, cols] += P
            if i0 != j0:
                H[cols, rows] += P.mH
            del E_ij, E_ji, P


class Mode(loop.Mode):

    def _members(self, H):
        """Member 0 (``H`` itself), then each later member made in place
        when the loop asks for it; the control's solves get a copy in its
        dtype."""
        c, i = self.cell, 0
        while True:
            if i:
                perturb_(H, self.scale, generator(c.device, c.seed,
                                                  "member", i),
                         int(c.traffic["tile"]))
            i += 1
            yield H.to(c.solve_dtype)     # H itself, or the control's copy

    def setup(self) -> None:
        c = self.cell
        H = c.problem.H
        self.scale = (float(c.traffic["drift"])
                      * float(torch.linalg.matrix_norm(H)) / H.shape[0])
        self.seq = c.sequence(self._members(H))
        self.v0_bytes = loop.nbytes(next(self.seq).V)   # member 0, cold

    def window(self, seconds: float) -> list:
        c = self.cell
        h_bytes = c.problem.H.numel() * c.solve_dtype.itemsize
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            for _ in range(int(c.traffic["pass_members"])):
                rec = self.timed(lambda: next(self.seq),
                                 h_bytes + self.v0_bytes)
                self.solves.append(rec)
                if rec.error is not None:
                    return self.solves     # the sequence cannot go on
                self.v0_bytes = rec.V_bytes
        return self.solves

    def release(self) -> None:
        self.seq.close()
        self.seq = None
        self.cell.problem.H = None

    def judge(self) -> list:
        """Each member solved in the window, made again from the matrix
        seed and the run's seed in the order the window made them."""
        c = self.cell
        H = c.make_matrix().H
        out = []
        for i, rec in enumerate(self.solves, start=1):
            perturb_(H, self.scale, generator(c.device, c.seed, "member", i),
                     int(c.traffic["tile"]))
            out.append(self.numbers(H, rec, None))
        return out
