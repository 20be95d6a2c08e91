"""The port's flat interface in its distributed modes on gloo process
grids, held against ``chase_tpu.interface`` on a mesh of the same shape.

One group of ``tests/torch_grid_worker.py`` ranks per grid shape — (2, 2),
(2, 1), (1, 2) and (3, 1), where N = 64 is ragged and the per-rank mode
refuses it — started once for the module.  Every rank runs, collectively:
``init(distributed=True)`` row- and column-major, ``init_pseudo``,
``init_blockcyclic`` Hermitian and pseudo, ``init_dist_local`` Hermitian
and pseudo (and a per-rank mode-'A' solve from the init buffers), each
with ``solve``, ``get_eigenpairs`` and (mostly) a mode-'A' solve, then the
refusals.  Held here: eigenvalues within ``conftest.TOLS`` of the JAX
interface's (init, init_pseudo, init_blockcyclic on the same grid shape;
Clement's exact spectrum), bitwise equal on every rank; true residuals of
the returned vectors in the caller's row order (whole on every rank, or
each rank's rows in the per-rank mode); the ranks' grid coordinates for
'R' and 'C' major; warm solves in at most 2 iterations; the JAX
package's ValueErrors for the bad cases; ``has_distribution()`` True on
a group of more than one rank.
"""

import numpy as np
import pytest
import torch

import chase_tpu.interface as jface

from chase_tpu_torch.models import clement, clement_eigenvalues

import torch_grid_worker as gw
from conftest import TOLS

torch.set_num_threads(1)

SHAPES = {"if22": (2, 2), "if21": (2, 1), "if12": (1, 2), "if31": (3, 1)}
IF, BSE = gw.IFACE, gw.IFACE_BSE


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {name: gw.Group(name, r, c, tmp_path_factory.mktemp(name),
                              timeout=300)
               for name, (r, c) in SHAPES.items()}
    yield started
    for g in started.values():
        g.kill()


@pytest.fixture(autouse=True)
def fresh_session():
    yield
    jface.finalize()


def _jax(kind, shape):
    """The JAX interface's eigenvalues for ``kind`` on a ``shape`` mesh."""
    H, B = clement(IF["N"]), gw.iface_bse()
    if kind == "whole":
        jface.init(IF["N"], IF["nev"], IF["nex"], H, distributed=True,
                   grid_shape=shape)
    elif kind == "pseudo":
        jface.init_pseudo(BSE["N"], BSE["nev"], BSE["nex"], B,
                          distributed=True, grid_shape=shape)
    elif kind == "bc":
        jface.init_blockcyclic(IF["N"], IF["nev"], IF["nex"], IF["mb"],
                               IF["mb"], H, grid_shape=shape)
    else:
        jface.init_blockcyclic(BSE["N"], BSE["nev"], BSE["nex"], IF["mb"],
                               IF["mb"], B, pseudo=True, grid_shape=shape)
    jface.set_tol(BSE["tol"] if "pseudo" in kind else IF["tol"])
    assert jface.solve() == 0
    return jface.get_eigenpairs()[0]


def _same_on_every_rank(ranks, key):
    return all(np.array_equal(r[key], ranks[0][key]) for r in ranks[1:])


def _residual(H, V, ev) -> float:
    return float(np.linalg.norm(H @ V - V * ev, axis=0).max())


# (the port's case, the JAX interface's init)
CASES = [("wholeR", "whole"), ("wholeC", "whole"), ("pseudo", "pseudo"),
         ("bc", "bc"), ("bc_pseudo", "bc_pseudo")]


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("case,jkind", CASES, ids=[c for c, _ in CASES])
def test_whole_matrix_modes_match_jax(groups, name, case, jkind):
    """Every whole-matrix mode: converged, eigenvalues within TOLS of the
    JAX interface on the same grid shape (and Clement's exact ones), the
    same bits on every rank, the whole V in the caller's row order with
    true residuals ≤ 1e-8 (1e-7 for BSE) on every rank."""
    shape = SHAPES[name]
    ranks = groups[name].results()
    key = f"iface/{case}"
    pseudo = "pseudo" in case
    jev = _jax(jkind, shape)
    H = gw.iface_bse() if pseudo else clement(IF["N"])
    for k in ("ritzv", "V", "iterations"):
        assert _same_on_every_rank(ranks, f"{key}/{k}"), k
    rec = ranks[0]
    assert int(rec[f"{key}/rc"]) == 0
    ev = rec[f"{key}/ritzv"]
    np.testing.assert_allclose(ev, jev, rtol=0, atol=TOLS[H.dtype])
    if not pseudo:
        np.testing.assert_allclose(ev, clement_eigenvalues(IF["N"])
                                   [:IF["nev"]], rtol=0, atol=1e-8)
    V = rec[f"{key}/V"]
    assert V.shape == (H.shape[0], len(ev))
    assert _residual(H, V, ev) <= (1e-7 if pseudo else 1e-8)
    if f"{key}/warm" in rec:
        assert int(rec[f"{key}/warm"]) <= 2


@pytest.mark.parametrize("name", list(SHAPES))
def test_grid_major_places_the_ranks(groups, name):
    """'R' puts rank i·d1 + j at (i, j), 'C' rank j·d0 + i; the
    block-cyclic layout's permutation (its row permutation on both sides,
    as in the JAX package) is the identity only with one grid row;
    has_distribution() is True."""
    d0, d1 = SHAPES[name]
    for rec in groups[name].results():
        r = int(rec["iface/rank"])
        assert tuple(rec["iface/wholeR/coords"]) == (r // d1, r % d1)
        assert tuple(rec["iface/wholeC/coords"]) == (r % d0, r // d0)
        assert bool(rec["iface/bc/identity"]) == (d0 == 1)
        assert bool(rec["iface/has_distribution"])


@pytest.mark.parametrize("name", list(SHAPES))
def test_per_rank_mode(groups, name):
    """init_dist_local: each rank's (N/d0, nev) rows of eigenvectors with
    the eigenvalues of the whole-matrix solve (within TOLS of the JAX
    interface's), bitwise equal on every rank; assembled by grid row they
    are eigenvectors of H; a mode-'A' solve from the init buffers takes
    at most 2 iterations.  Where d0·d1 does not divide N (the (3, 1)
    group) the JAX package's ValueError."""
    d0, d1 = SHAPES[name]
    ranks = groups[name].results()
    if IF["N"] % (d0 * d1):
        assert all(bool(r["iface/local/raises"]) for r in ranks)
        return
    for case, H, jkind in (("local", clement(IF["N"]), "whole"),
                           ("local_pseudo", gw.iface_bse(), "pseudo")):
        key = f"iface/{case}"
        jev = _jax(jkind, (d0, d1))
        assert _same_on_every_rank(ranks, f"{key}/ritzv")
        ev = ranks[0][f"{key}/ritzv"]
        np.testing.assert_allclose(ev, jev, rtol=0, atol=TOLS[H.dtype])
        m = H.shape[0] // d0
        rows = {}
        for rec in ranks:
            assert int(rec[f"{key}/rc"]) == 0
            V = rec[f"{key}/V"]
            assert V.shape == (m, len(ev))
            i = int(rec["iface/wholeR/coords"][0])
            rows.setdefault(i, V)
            np.testing.assert_array_equal(rows[i], V)
        V = np.concatenate([rows[i] for i in range(d0)])
        assert _residual(H, V, ev) <= 1e-7
    for rec in ranks:
        assert int(rec["iface/local/warm_from_buffers"]) <= 2


@pytest.mark.parametrize("name", list(SHAPES))
def test_distributed_refusals_are_the_jax_packages(groups, name):
    """The ValueErrors: a grid that is not the world size (naming both
    sizes), a local block that is not (N/d0, N/d1), a V block of the
    wrong shape, irsrc/icsrc ≠ 0 — and JAX raises ValueError for the
    same calls in one process."""
    for rec in groups[name].results():
        assert list(rec["iface/refusals"]) == [True] * 4
    H = clement(IF["N"])
    with pytest.raises(ValueError, match="irsrc"):
        jface.init_blockcyclic(IF["N"], 6, 6, 8, 8, H, grid_shape=(2, 1),
                               irsrc=1)
    with pytest.raises(ValueError, match="need 2 jax.distributed"):
        jface.init_dist_local(IF["N"], 6, 6, 32, 64, H[:32],
                              grid_shape=(2, 1))
