"""The port's Python examples (``examples/torch_*.py``) on the CPU against
the JAX package's same calls.

* Each example's ``main([..., "--device", "cpu"])`` at its own size (the
  BSE benchmark at N=400, nev 20, nex 12: at its default nev 100, nex 40
  neither package converges at N=400), PASS, and its Ritz values held
  against ``chase_tpu``'s same call on the same numpy H within
  ``conftest.TOLS``: the hello world's warm solves from the port's
  previous V and Ritz values on both sides (the first solve draws its
  start block from each package's own generator), the interface's
  lifecycle against ``chase_tpu.interface``, the BSE benchmark against
  ``chase_tpu.eigsh_pseudo`` and numpy's spectrum, and again from a
  ChASE file through ``--path``.
* The hello world on a grid: two gloo ranks launched as torchrun would.
* The examples import only the port, numpy and the standard library, and
  default to the card: without one they raise, never solving on the CPU.
"""

import ast
import contextlib
import importlib.util
import io
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chase_tpu
import chase_tpu.interface as jinterface
from chase_tpu import io as jio
from chase_tpu.models import clement, random_pseudo_hermitian

from conftest import TOLS

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = ("torch_hello_world", "torch_interface_demo",
            "torch_bse_benchmark")
BSE_ARGS = ["--n", "400", "--nev", "20", "--nex", "12"]
F64, C128 = TOLS[np.dtype(np.float64)], TOLS[np.dtype(np.complex128)]
# what the port resolves to on the CPU, pinned on the JAX side
JCFG = dict(mixed_precision=False, small_dense_backend="device")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv):
    """(main's result, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _load(name).main(argv)
    return out, buf.getvalue()


def test_hello_world_matches_jax():
    mod = _load("torch_hello_world")
    out, text = _run("torch_hello_world", ["--device", "cpu"])
    assert out["passed"] and all(out["converged"])
    assert "torch_hello_world: PASS" in text.splitlines()[-1]
    assert text.count("| Size") == mod.SOLVES == 3
    H = clement(mod.N)
    cfg = chase_tpu.ChaseConfig(**JCFG)
    prev = None
    for idx, res in enumerate(out["results"]):
        warm = {} if prev is None else dict(
            v0=prev.V.numpy(), ritzv0=prev.ritzv_full, approx=True)
        jres = chase_tpu.eigsh(H, mod.NEV, mod.NEX, tol=mod.TOL, config=cfg,
                               **warm)
        assert jres.converged
        np.testing.assert_allclose(res.ritzv, jres.ritzv, atol=F64)
        prev = res
    # a warm start from the converged subspace needs at most one sweep more
    assert max(out["iterations"][1:]) <= 2 < out["iterations"][0]
    assert out["error"] <= 10 * mod.TOL


def test_interface_demo_matches_jax():
    mod = _load("torch_interface_demo")
    out, text = _run("torch_interface_demo", ["--device", "cpu"])
    assert out["passed"] and out["rc"] == out["rc_warm"] == 0
    assert "torch_interface_demo: PASS" in text.splitlines()[-1]
    H = clement(mod.N)
    jinterface.init(mod.N, mod.NEV, mod.NEX, H)
    try:
        jinterface.set_tol(mod.TOL)
        assert jinterface.solve(deg=20, mode="R", opt="S", qr="C") == 0
        jev, jvec = jinterface.get_eigenpairs()
        assert jinterface.solve(mode="A") == 0
        jev_warm, _ = jinterface.get_eigenpairs()
    finally:
        jinterface.finalize()
    np.testing.assert_allclose(out["evals"], jev, atol=F64)
    np.testing.assert_allclose(out["evals_warm"], jev_warm, atol=F64)
    assert out["evecs"].shape == jvec.shape == (mod.N, mod.NEV)
    # the same invariant subspace, in a Fortran-ordered host array
    assert out["evecs"].flags.f_contiguous
    overlap = np.linalg.svd(out["evecs"].T @ np.asarray(jvec),
                            compute_uv=False)
    assert overlap.min() > 1 - 1e-8


def _bse_reference(H, nev, nex):
    jres = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-10,
                                  config=chase_tpu.ChaseConfig(**JCFG))
    ev = np.sort(np.linalg.eigvals(H).real)
    return jres, ev[ev > 0][:nev]


def test_bse_benchmark_matches_jax():
    out, text = _run("torch_bse_benchmark", BSE_ARGS + ["--device", "cpu"])
    assert out["passed"] and out["converged"]
    assert "torch_bse_benchmark: PASS" in text.splitlines()[-1]
    H = random_pseudo_hermitian(400, dtype=np.complex128, seed=0)
    jres, exact = _bse_reference(H, 20, 12)
    assert jres.converged
    np.testing.assert_allclose(out["ritzv"], jres.ritzv, atol=C128)
    np.testing.assert_allclose(out["ritzv"], exact, atol=C128)
    assert out["true_resid"] <= 1e-9


def test_bse_benchmark_reads_a_chase_file(tmp_path):
    """--path: the same H from a ChASE file written by the JAX package's
    writer gives the generated run's result bit for bit."""
    H = random_pseudo_hermitian(400, dtype=np.complex128, seed=0)
    path = tmp_path / "bse400.bin"
    jio.save_matrix(H, str(path))
    gen, _ = _run("torch_bse_benchmark", BSE_ARGS + ["--device", "cpu"])
    out, _ = _run("torch_bse_benchmark",
                  BSE_ARGS + ["--path", str(path), "--device", "cpu"])
    assert out["passed"] and out["iterations"] == gen["iterations"]
    np.testing.assert_array_equal(out["ritzv"], gen["ritzv"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_hello_world_on_a_grid():
    """Launched as two ranks (torchrun's variables, gloo with --device
    cpu) the example solves on make_grid()'s (2, 1) grid; rank 0 prints
    the PASS line, rank 1 nothing."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "examples" / "torch_hello_world.py"),
             "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:]
                                                      for o in outs]
    lines = outs[0][0].strip().splitlines()
    assert lines[-1].startswith("torch_hello_world: PASS")
    err = float(re.search(r"max eigenvalue error ([-+.\deE]+)",
                          lines[-1]).group(1))
    assert err <= 1e-9
    assert outs[1][0].strip() == ""


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_only_the_port_numpy_and_stdlib(name):
    """Extends test_torch_boundaries' source scan to the examples: no
    jax, no chase_tpu; every import is the port, numpy or the standard
    library."""
    src = (REPO / "examples" / f"{name}.py").read_text()
    stmt = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|chase_tpu)\b",
                      re.MULTILINE)
    assert not stmt.search(src)
    tops = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert "chase_tpu_torch" in tops
    assert tops <= {"chase_tpu_torch", "numpy"} | sys.stdlib_module_names, \
        tops


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name, monkeypatch):
    """Without --device the example solves on the card; without one it
    raises the port's RuntimeError and solves nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = BSE_ARGS if name == "torch_bse_benchmark" else []
    with pytest.raises(RuntimeError, match="does not fall back"):
        _run(name, argv)
