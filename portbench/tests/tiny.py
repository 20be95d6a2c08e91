"""A copy of the benchmark with tiny cells, for the CPU tests: the
configurations at N = 240 (their limits scaled with their tolerances),
the scf traffic with small tiles, and a BENCHMARK.json that lists them."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
REPO = PORTBENCH.parent
CELLS = ("herm_tiny.cold", "bse_tiny.cold", "herm_tiny.scf_tiny")
if str(REPO) not in sys.path:          # the package ``portbench``
    sys.path.insert(0, str(REPO))


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _dump(obj, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_tree(root: Path) -> Path:
    """``root``/portbench (a copy) with the tiny cells added, and
    ``root``/BENCHMARK.json listing only them."""
    shutil.copytree(PORTBENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    configs = root / "portbench" / "configs"
    N = 240
    herm = _load(configs / "herm_c128_n30000.json")
    tol = 1e-10 * (N - 1)
    herm.update(name="herm_tiny", N=N, nev=24, nex=16, tol=tol,
                limits={"resid": 10 * tol, "orth": 1e-9, "eig_err": 10 * tol,
                        "missed": 0})
    herm["control"]["tol"] = 1e-5 * (N - 1)
    _dump(herm, configs / "herm_tiny.json")
    bse = _load(configs / "bse_f64_n30000.json")
    bse.update(name="bse_tiny", N=N, nev=12, nex=8)
    _dump(bse, configs / "bse_tiny.json")
    scf = _load(root / "portbench" / "traffic" / "scf.json")
    scf["tile"] = 64
    _dump(scf, root / "portbench" / "traffic" / "scf_tiny.json")
    bench = _load(REPO / "BENCHMARK.json")
    bench["configs"] = [
        dict(name=n, source="tiny copy for the CPU tests",
             file=f"portbench/configs/{n}.json", reduced=[], why="tests")
        for n in ("herm_tiny", "bse_tiny")]
    bench["workloads"] = [
        dict(name=c, config=c.split(".")[0], traffic=c.split(".")[1],
             chips=1, why="tests") for c in CELLS]
    _dump(bench, root / "BENCHMARK.json")
    return root


def run_cli(root: Path, workload: str, *extra, seconds: float = 0.3,
            seed: int = 2**31 + 11, trace: int = 0, device="cpu", env=None):
    """``python3 portbench/run.py`` in a child from ``root`` (on the CPU;
    ``device=None`` leaves the harness's own choice, the card):
    (returncode, the parsed last stdout line or None, stderr)."""
    cmd = [sys.executable, "portbench/run.py", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace), *extra]
    if device is not None:
        cmd += ["--device", device]
    full_env = dict(os.environ, PYTHONPATH=str(REPO))
    full_env.update(env or {})
    p = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       env=full_env, timeout=600)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr


def load_run_module():
    """``portbench/run.py`` as a module of this process (in the repo)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "portbench_run", PORTBENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
