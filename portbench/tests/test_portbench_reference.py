"""The plain reference against numpy at tiny N, on the known-spectrum
families, and the comparisons it makes."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (the package portbench on the path)
from portbench.matrices import bse_structured, clement_dense
from portbench.reference import bse_structured as bse_ref
from portbench.reference import clement_dense as clement_ref
from portbench.reference.judges import hermitian as herm_judge
from portbench.reference.judges import pseudo as pseudo_judge
from portbench.seeds import generator, sub_seed
from portbench.traffic import sequence

CPU = torch.device("cpu")


def herm(N=40, seed=2**31 + 5):
    return clement_dense.make({"N": N, "dtype": "complex128"}, seed, CPU)


def test_clement_exact_spectrum_against_numpy():
    p = herm()
    H = p.H.numpy()
    assert np.array_equal(H, H.conj().T) and np.iscomplexobj(H)
    assert (np.abs(H) > 1e-3).mean() > 0.95          # dense, not banded
    w = np.linalg.eigvalsh(H)
    assert np.abs(w - clement_ref.exact(p.inputs).numpy()).max() < 1e-12
    assert p.norm == 39
    again = herm()
    assert torch.equal(p.H, again.H)
    assert not torch.equal(p.H, herm(seed=3).H)


def test_bse_exact_spectrum_against_numpy():
    p = bse_structured.make({"N": 40, "dtype": "float64"}, 9, CPU)
    w = np.sort(np.linalg.eigvals(p.H.numpy()).real)
    exact = bse_ref.exact(p.inputs).numpy()
    assert np.abs(w[20:] - exact).max() < 1e-12
    assert np.abs(w[:20] + exact[::-1]).max() < 1e-12
    assert p.norm == pytest.approx(exact.max())


def test_seeds_differ_and_repeat():
    assert sub_seed(5, "start", 0) == sub_seed(5, "start", 0)
    assert len({sub_seed(5, "start", i) for i in range(50)}) == 50
    assert sub_seed(2**31 + 3, "a") != sub_seed(2**31 + 4, "a")
    assert 0 <= sub_seed(-1, "x") < 2**63
    a = torch.randn(4, generator=generator(CPU, 7, "m", 1))
    assert torch.equal(a, torch.randn(4, generator=generator(CPU, 7, "m", 1)))


def _eigh(p, nev):
    w, V = np.linalg.eigh(p.H.numpy())
    return w, torch.from_numpy(V)


def hermitian(H, lam, V, nev, exact=None, margin=0.0):
    return herm_judge.numbers(H, lam, V, nev, exact,
                              {"deflation_margin": margin}, 1.0)


def test_hermitian_numbers_on_exact_pairs():
    p, nev = herm(), 8
    w, V = _eigh(p, nev)
    exact = clement_ref.exact(p.inputs)
    nums = hermitian(p.H, w[:nev], V, nev, exact=exact)
    assert nums["resid"] < 1e-11 and nums["orth"] < 1e-13
    assert nums["eig_err"] < 1e-11
    assert hermitian(p.H, w[:nev], V, nev, margin=1e-6 * p.norm)[
        "missed"] == 0


def test_a_higher_pair_in_place_of_a_lowest_one_is_caught():
    p, nev = herm(), 8
    w, V = _eigh(p, nev)
    lam, W = w[:nev].copy(), V[:, :nev].clone()
    lam[3], W[:, 3] = w[nev + 2], V[:, nev + 2]     # still an eigenpair
    nums = hermitian(p.H, lam, W, nev, margin=1e-6 * p.norm)
    assert nums["resid"] < 1e-11 and nums["orth"] < 1e-13
    assert nums["missed"] == 1
    exact = clement_ref.exact(p.inputs)
    assert hermitian(p.H, np.sort(lam), W, nev, exact=exact)["eig_err"] > 1


def test_scaled_or_short_answers_fail():
    p, nev = herm(), 8
    w, V = _eigh(p, nev)
    nums = hermitian(p.H, w[:nev], 0 * V, nev, margin=1.0)
    assert not nums["resid"] <= 1.0           # 0/0: NaN reads past a limit
    short = hermitian(p.H, w[:nev - 1], V, nev, margin=1.0)
    assert all(v == math.inf for v in short.values())


def _bse_pairs():
    p = bse_structured.make({"N": 40, "dtype": "float64"}, 9, CPU)
    w, X = np.linalg.eig(p.H.numpy())
    pos = np.argsort(w.real)[20:]
    return p, w.real[pos], torch.from_numpy(X[:, pos].real.copy())


def pseudo(p, lam, V, nev):
    return pseudo_judge.numbers(p.H, lam, V, nev, bse_ref.exact(p.inputs),
                                {}, p.norm)


def test_pseudo_numbers():
    p, lam, V = _bse_pairs()
    nums = pseudo(p, lam[:6], V, 6)
    assert nums["resid"] < 1e-12 and nums["eig_err"] < 1e-12
    assert nums["jorth"] < 1e-12
    lam[2] += 1e-6
    assert pseudo(p, lam[:6], V, 6)["eig_err"] > 9e-7
    assert all(v == math.inf for v in pseudo(p, lam[:5], V, 6).values())


def test_a_vector_returned_twice_is_caught():
    """Two eigenpairs of one eigenvector: their residuals are fine, and
    only the pseudo-Hermitian metric tells the pair apart."""
    p, lam, V = _bse_pairs()
    W = V[:, :6].clone()
    W[:, 4] = -2.0 * W[:, 3]
    nums = pseudo(p, lam[:6], W, 6)
    assert nums["jorth"] > 0.99
    U = V[:, :6].clone()
    U[:, 4] = torch.cat([U[20:, 4], U[:20, 4]])   # vᴴJv < 0
    assert not pseudo(p, lam[:6], U, 6)["jorth"] <= 1.0


def test_perturbation_is_hermitian_and_drawn_by_tile():
    H = torch.zeros((100, 100), dtype=torch.complex128)
    sequence.perturb_(H, 1.0, generator(CPU, 3, "member", 1), 32)
    assert torch.equal(H, H.mH)
    off = H[~torch.eye(100, dtype=torch.bool)]
    assert off.abs().pow(2).mean().item() == pytest.approx(1.0, rel=0.1)
    assert H.diagonal().real.var().item() == pytest.approx(1.0, rel=0.35)
    again = torch.zeros_like(H)
    sequence.perturb_(again, 1.0, generator(CPU, 3, "member", 1), 32)
    assert torch.equal(H, again)
