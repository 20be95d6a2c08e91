"""The judge of a Bethe–Salpeter solve (``eigsh_pseudo``): its nev
smallest positive pairs' ``resid``, ``jorth`` (the eigenvectors'
independence under the pseudo-Hermitian metric) and ``eig_err`` against
the family's exact spectrum — see ``reference/compare.py``.  A solve that
returned fewer than nev pairs reads ``inf`` everywhere."""

from __future__ import annotations

import math

from portbench.reference import compare


def numbers(H, lam, V, nev: int, exact, cfg: dict, norm: float) -> dict:
    if len(lam) < nev or V.shape[1] < nev:
        return {"resid": math.inf, "jorth": math.inf, "eig_err": math.inf}
    lam, V = list(lam)[:nev], V[:, :nev]
    return {"resid": compare.resid(H, lam, V),
            "jorth": compare.jorth(V, H.dtype),
            "eig_err": compare.eig_err(lam, exact)}
