"""BENCHMARK.json against the benchmark's contract, and every piece a cell
needs found by name under portbench/."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from tiny import PORTBENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(REPO / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        fam = importlib.import_module(f"portbench.matrices.{cfg['family']}")
        assert callable(fam.make)
        ref = importlib.import_module(f"portbench.reference.{cfg['family']}")
        assert callable(ref.exact)
        judge = importlib.import_module(
            f"portbench.reference.judges.{cfg['judge']}")
        assert callable(judge.numbers)
        assert cfg["entry"] in ("eigsh", "eigsh_pseudo", "eigsh_fused",
                                "eigsh_pseudo_fused")
        for key in ("N", "dtype", "nev", "nex", "tol", "chase_config",
                    "matrix_seed", "instances", "limits", "control"):
            assert key in cfg, key
        assert {"dtype", "tol", "chase_config"} <= set(cfg["control"])


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        with open(PORTBENCH / "traffic" / f"{w['traffic']}.json") as f:
            mode = json.load(f)["mode"]
        gen = importlib.import_module(f"portbench.traffic.{mode}")
        assert callable(gen.Mode)


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert LINE.match(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        reader = PORTBENCH / "metrics" / f"{m['name']}.py"
        assert reader.is_file(), reader
    for cell in cells:       # setup_s, another end-to-end, a per-layer one
        for group, least in (("end_to_end", 2), ("per_layer", 1)):
            assert sum(cell in m.get("workloads", [cell])
                       for m in bench[group]) >= least


def test_paths_hold_the_benchmark_only():
    for path in PORTBENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
