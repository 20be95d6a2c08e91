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
from chase_tpu_torch import solver as tsolver

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import sys
import chase_tpu_torch, chase_tpu_torch.convert, chase_tpu_torch._build
import chase_tpu_torch.parallel.ring, chase_tpu_torch.ops.ring_hemm
import chase_tpu_torch.models, chase_tpu_torch.utils
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
    stmt = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|chase_tpu)\b",
                      re.MULTILINE)
    paths = list((REPO / "chase_tpu_torch").rglob("*.py"))
    assert paths
    for path in paths + [REPO / "chip_smoke.py"]:
        assert not stmt.search(path.read_text()), path


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
    assert not ran


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
