"""``correct`` at tiny size on the CPU: the program's runs come out
correct, the control (the configuration's lower-precision path in the
program's place) does not, and a run with the timed path broken
underneath does not — once for each fault these cells can have: a solve
that returns its state unchanged, half of the answers left out, an answer
altered where it is produced, a higher eigenpair in place of a lowest
one, and one eigenvector returned for two eigenvalues.  (No cell spans
chips, so no exchange can be left out.)"""

from __future__ import annotations

import importlib.util
import json

import numpy as np
import pytest
import torch

import tiny


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("tiny"))


def run_in_process(tree, workload, capsys, *extra, seconds=0.3):
    spec = importlib.util.spec_from_file_location(
        "portbench_run_tiny", tree / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    rc = mod.main(["--workload", workload, "--seed", str(2**31 + 99),
                   "--seconds", str(seconds), "--trace", "0", "--device",
                   "cpu", *extra])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_program_correct_control_not(tree, workload):
    rc, res, err = tiny.run_cli(tree, workload)
    assert rc == 0 and res["correct"] is True, err[-2000:]
    assert res["attempted"] >= 1 and res["failed"] == 0
    config, traffic = workload.split(".")
    cfg = json.loads((tree / "portbench" / "configs" /
                      f"{config}.json").read_text())
    mix = json.loads((tree / "portbench" / "traffic" /
                      f"{traffic}.json").read_text())
    per_pass = (cfg["instances"] if mix["mode"] == "independent"
                else mix["pass_members"])
    assert res["attempted"] % per_pass == 0       # whole passes
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("[portbench] check ")
    rc, res, err = tiny.run_cli(tree, workload, "--variant", "control")
    assert rc == 0 and res["correct"] is False, err[-2000:]
    assert res["failed"] == res["attempted"] >= 1


def _unchanged(H, res, nev):
    """The start block, orthonormalized, in place of the answer."""
    g = torch.Generator().manual_seed(1)
    Q, _ = torch.linalg.qr(torch.randn(res.V.shape, generator=g,
                                       dtype=res.V.dtype))
    res.V = Q
    return res


def _half(H, res, nev):
    """The answers after nev/2 never computed: the start block's columns."""
    V = res.V.clone()
    V[:, nev // 2:] = _unchanged(H, res, nev).V[:, nev // 2:]
    res.V = V
    return res


def _altered(H, res, nev):
    """One eigenvalue off by 1e-6 of the spectrum's scale."""
    lam = np.array(res.ritzv, dtype=np.float64)
    lam[nev // 3] += 1e-6 * np.abs(lam).max()
    res.ritzv = lam
    return res


def _higher_pair(H, res, nev):
    """A true eigenpair from above the wanted ones in place of the last
    wanted one (its residual and, Hermitian, orthogonality stay fine)."""
    n = res.V.shape[0]
    H = getattr(H, "H", H)[:n, :n]             # a DenseOperator's matrix
    A = H.detach().cpu().resolve_conj().numpy()
    if np.allclose(A, A.conj().T):
        w, X = np.linalg.eigh(A)
    else:                                      # BSE: the positive half
        w, X = np.linalg.eig(A)
        pos = np.argsort(w.real)[n // 2:]
        w, X = w.real[pos], X[:, pos].real
    lam = np.array(res.ritzv, dtype=np.float64)
    V = res.V.clone()
    lam[nev - 1] = w[nev + 2]
    V[:, nev - 1] = torch.from_numpy(np.ascontiguousarray(
        X[:, nev + 2])).to(V.dtype)
    res.ritzv, res.V = lam, V
    return res


def _twice(H, res, nev):
    """The eigenvector of λ_k returned for λ_(k+1) as well, λ_(k+1) kept."""
    V = res.V.clone()
    V[:, nev // 2 + 1] = V[:, nev // 2]
    res.V = V
    return res


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered,
          "higher_pair": _higher_pair, "twice": _twice}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", tiny.CELLS)
def test_faults_come_out_not_correct(tree, workload, fault, capsys,
                                     monkeypatch):
    import chase_tpu_torch as ct
    plant = FAULTS[fault]
    for name in ("eigsh", "eigsh_pseudo"):
        real = getattr(ct.api, name)

        def broken(H, nev, *a, _real=real, **kw):
            return plant(H, _real(H, nev, *a, **kw), nev)
        monkeypatch.setattr(ct, name, broken)
        monkeypatch.setattr(ct.api, name, broken)
    res = run_in_process(tree, workload, capsys)
    assert res["attempted"] >= 1
    assert res["correct"] is False and res["failed"] >= 1, res["checks"]
