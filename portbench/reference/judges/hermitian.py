"""The judge of a Hermitian solve (``eigsh``, ``eigsh_sequence``): its nev
lowest pairs' ``resid`` and ``orth``, and ``eig_err`` where the family has
an exact spectrum, else ``missed`` with the configuration's margin
(``deflation_margin``·‖H‖) — see ``reference/compare.py``.  A solve that
returned fewer than nev pairs reads ``inf`` everywhere."""

from __future__ import annotations

import math

from portbench.reference import compare


def numbers(H, lam, V, nev: int, exact, cfg: dict, norm: float) -> dict:
    if len(lam) < nev or V.shape[1] < nev:
        out = {"resid": math.inf, "orth": math.inf}
        out["eig_err" if exact is not None else "missed"] = math.inf
        return out
    lam, V = list(lam)[:nev], V[:, :nev]
    out = {"resid": compare.resid(H, lam, V),
           "orth": compare.orth(V, H.dtype)}
    if exact is not None:
        out["eig_err"] = compare.eig_err(lam, exact)
    else:
        out["missed"] = compare.missed(
            H, lam, V, float(cfg["deflation_margin"]) * norm)
    return out
