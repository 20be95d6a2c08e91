"""The port's boundaries: it imports neither JAX nor the JAX package, and
``device="cuda"`` never falls back to the CPU.  The chip smoke script
refuses to run without a card."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chase_tpu_torch as ct
from chase_tpu_torch import convert
from chase_tpu_torch import solver as tsolver

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import sys
import chase_tpu_torch, chase_tpu_torch.convert, chase_tpu_torch._build
import chase_tpu_torch.parallel.ring, chase_tpu_torch.ops.ring_hemm
import chase_tpu_torch.parallel.mesh, chase_tpu_torch.parallel.multihost
import chase_tpu_torch.parallel.dist, chase_tpu_torch.parallel.operator
import chase_tpu_torch.models, chase_tpu_torch.utils
import chase_tpu_torch.fused, chase_tpu_torch.fused_pseudo
import chase_tpu_torch.step, chase_tpu_torch.warmup
import chase_tpu_torch.io, chase_tpu_torch.interface, chase_tpu_torch.cli
import chase_tpu_torch._native
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'chase_tpu'))
print(','.join(bad))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_import_pulls_in_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_sources_import_no_jax():
    """No module of the port (the process grid's ``parallel/mesh.py``,
    ``multihost.py`` and ``dist.py`` among them), nor chip_smoke.py, nor
    the grid tests' worker script, nor the Python that the C ABI library
    embeds (``_native/*.cpp``), imports JAX or chase_tpu."""
    stmt = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|chase_tpu)\b",
                      re.MULTILINE)
    paths = list((REPO / "chase_tpu_torch").rglob("*.py"))
    embedded = list((REPO / "chase_tpu_torch" / "_native").glob("*.cpp"))
    assert paths and embedded
    assert any("import chase_tpu_torch" in p.read_text() for p in embedded)
    grid_modules = {p.name for p in paths if p.parent.name == "parallel"}
    assert {"mesh.py", "multihost.py", "dist.py"} <= grid_modules
    for path in paths + embedded + [REPO / "chip_smoke.py",
                                    REPO / "tests" / "torch_grid_worker.py"]:
        assert not stmt.search(path.read_text()), path


def test_module_entry_with_cuda_without_a_card_fails():
    """``python -m chase_tpu_torch --device cuda`` without a card exits
    non-zero with the RuntimeError; it does not solve on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    out = subprocess.run(
        [sys.executable, "-m", "chase_tpu_torch", "--n", "16", "--nev", "2",
         "--isMatGen", "clement", "--device", "cuda"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr and "does not fall back" in out.stderr
    assert "converged" not in out.stdout


def test_cuda_device_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    ran = []
    monkeypatch.setattr(tsolver, "solve",
                        lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="does not fall back"):
        ct.eigsh(np.eye(16), 2, 2, device="cuda")
    with pytest.raises(RuntimeError):
        ct.DenseOperator(np.eye(16), device="cuda")
    with pytest.raises(RuntimeError, match="does not fall back"):
        next(ct.eigsh_sequence(iter([np.eye(16)]), 2, 2))
    with pytest.raises(RuntimeError, match="does not fall back"):
        ct.estimate_spectral_bounds(np.eye(16))
    assert not ran


@pytest.mark.parametrize("fn", ["array_to_torch", "warm_start_from"])
def test_convert_defaults_to_the_card(fn):
    """convert's helpers place on the card unless asked for the CPU, so
    without a card their default raises, as eigsh's does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    H = np.eye(8, dtype=np.complex64)
    if fn == "array_to_torch":
        call = lambda **kw: convert.array_to_torch(H, **kw)  # noqa: E731
    else:
        res = tsolver.SolveResult(
            ritzv=np.zeros(2), V=H[:, :4], resid=np.zeros(2), iterations=1,
            locked=2, converged=True, upperb=1.0, lowerb=0.0,
            ritzv_full=np.zeros(4))
        call = lambda **kw: convert.warm_start_from(res, **kw)[0]  # noqa: E731
    with pytest.raises(RuntimeError, match="does not fall back"):
        call()
    t = call(device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.complex64


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_a_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128],
                         ids=["f32", "f64", "c64", "c128"])
def test_operator_real_dtype_and_free_low_like_jax(dtype):
    """DenseOperator.real_dtype names the JAX operator's real dtype, and
    free_low drops the cached shadow, which the next H_low rebuilds."""
    from chase_tpu.parallel.operator import DenseOperator as JaxOperator
    H = np.eye(12, dtype=dtype) * 2.0
    op = ct.DenseOperator(H, "cpu")
    jop = JaxOperator(H)
    assert np.dtype(str(op.real_dtype).split(".")[1]) == \
        np.dtype(jop.real_dtype)
    low = op.H_low
    assert op.H_low is low                      # cached
    assert op.free_low() is None and jop.free_low() is None
    assert op._H_low is None and jop._H_low is None
    rebuilt = op.H_low
    assert rebuilt.dtype == low.dtype and torch.equal(rebuilt, low)
