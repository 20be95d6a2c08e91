"""Nothing the harness runs loads jax, jaxlib, flax or chase_tpu (compared
by whole top-level module names), the reference loads nothing of the
program, and nothing reads the JAX package's old benchmark files."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import tiny
from tiny import PORTBENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "chase_tpu"}

CHILD = r"""
import importlib, importlib.util, json, runpy, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.argv = ["portbench/run.py", "--workload", "herm_tiny.cold", "--seed",
            "5", "--seconds", "0.2", "--trace", "1", "--device", "cpu"]
try:
    runpy.run_path(str(root / "portbench" / "run.py"), run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
for path in (root / "portbench").rglob("*.py"):
    rel = path.relative_to(root).with_suffix("")
    if "tests" in rel.parts or rel.name in ("run", "__init__"):
        continue
    if rel.parts[1] == "metrics":          # readers load by file path
        spec = importlib.util.spec_from_file_location(rel.name, path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(".".join(rel.parts))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_forbidden_module_in_a_run(tmp_path):
    root = tiny.make_tree(tmp_path)
    p = subprocess.run([sys.executable, "-c", CHILD, str(root)], cwd=root,
                       capture_output=True, text=True, timeout=600,
                       env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
                            "HOME": str(tmp_path)})
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    result, loaded = json.loads(lines[-2]), set(json.loads(lines[-1]))
    assert result["correct"] is True
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "chase_tpu_torch" in loaded and "portbench" in loaded


def _imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_sources_import_nothing_forbidden():
    for path in PORTBENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
        text = path.read_text()
        for old in ("benchmarks/", "bench.py", "BENCH_r0"):
            assert old not in text or path.parent.name == "tests", (path, old)


def test_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").rglob("*.py"):
        found = _imports(path)
        assert "chase_tpu_torch" not in found, path
        assert found <= {"__future__", "math", "torch", "portbench"}, found


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    run = tiny.load_run_module()
    monkeypatch.setitem(sys.modules, "chase_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "chase_tpu.api", sys)
    assert run.forbidden_modules() == ["chase_tpu"]


def test_no_card_or_no_program_means_no_result(tmp_path):
    import torch
    root = tiny.make_tree(tmp_path)
    if not torch.cuda.is_available():
        rc, out, err = tiny.run_cli(root, "herm_tiny.cold", device=None)
        assert rc != 0 and out is None and "no CUDA card" in err
    rc, out, err = tiny.run_cli(root, "herm_tiny.cold",
                                env={"PYTHONPATH": ""})
    assert rc != 0 and out is None and "cannot be imported" in err
