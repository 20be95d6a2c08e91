"""The grid cell's pieces on the CPU: the circulant family's blocks
against its FFT reference and Clement's spectrum, the grid traffic on
four gloo ranks through ``run.py --device cpu`` (correct, the control
not, the collectives' readers), a rank killed in the window ending the
run, and the two collectives' readers on synthetic records."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import tiny
from portbench import devtrace
from portbench.matrices import clement_circulant as family
from portbench.reference import clement_circulant as reference
from test_portbench_program import ev, kernel, launch, reader, run_data

N = 96
CELL = "circ_tiny.grid_tiny"


def blocks(dtype, p: int = 2) -> torch.Tensor:
    """H of the family at N from the p × p blocks a (p, p) grid builds."""
    inp = family.inputs(N, 0)
    b = N // p
    return torch.cat([torch.cat([family.block(inp, (i * b, b), (j * b, b),
                                              dtype, "cpu")
                                 for j in range(p)], dim=1)
                      for i in range(p)])


@pytest.mark.parametrize("dtype", (torch.complex128, torch.complex64))
def test_blocks_are_the_reference_operator_and_hermitian(dtype):
    H = blocks(dtype)
    assert torch.equal(H, H.mH)                      # to the bit
    assert torch.equal(H, blocks(dtype, p=1))
    want = reference.operator(family.inputs(N, 0), "cpu") @ torch.eye(
        N, dtype=torch.complex128)
    tol = (1e-12 if dtype == torch.complex128 else 1e-6) * (N - 1)
    assert (H.to(torch.complex128) - want).abs().max() <= tol
    assert (H != 0).sum() == N * N - N               # all but the diagonal


def test_spectrum_is_clements():
    w = torch.linalg.eigvalsh(blocks(torch.complex128))
    exact = reference.exact(family.inputs(N, 0))
    assert (w - exact).abs().max() <= 1e-9 * N
    assert torch.equal(exact, -(N - 1) + 2.0 * torch.arange(
        N, dtype=torch.float64))


def test_inputs_repeat_by_seed_and_differ_between_seeds():
    a, b, c = family.inputs(N, 0), family.inputs(N, 0), family.inputs(N, 1)
    for key in ("mu", "perm", "phase", "c"):
        assert torch.equal(a[key], b[key])
        assert not torch.equal(a[key], c[key])
    assert family.make({"N": N}, 0, "cpu").H is None


def make_grid_tree(root: Path) -> Path:
    """The tiny tree with a grid cell: the N = 76800 configuration at
    N = 96 (limits scaled with the tolerance as ``tiny`` scales its
    herm cell's) on the grid2x2 traffic with a short group timeout."""
    tiny.make_tree(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "herm_c128_n76800.json").read_text())
    tol = 1e-10 * (N - 1)
    cfg.update(name="circ_tiny", N=N, nev=12, nex=8, tol=tol,
               limits={"resid": 10 * tol, "orth": 1e-9, "eig_err": 10 * tol})
    cfg["control"]["tol"] = 1e-5 * (N - 1)
    (pb / "configs" / "circ_tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "grid2x2.json").read_text())
    mix["timeout_s"] = 120
    (pb / "traffic" / "grid_tiny.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name="circ_tiny", source="tiny copy for the CPU tests",
        file="portbench/configs/circ_tiny.json", reduced=[], why="tests"))
    bench["workloads"].append(dict(name=CELL, config="circ_tiny",
                                   traffic="grid_tiny", chips=4,
                                   why="tests"))
    for m in bench["per_layer"]:
        if m["name"] in ("comm_device_s", "comm_gib"):
            m["workloads"] = [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_grid_tree(tmp_path_factory.mktemp("grid"))


def test_grid_cell_on_four_gloo_ranks(tree):
    rc, res, err = tiny.run_cli(tree, CELL, trace=1)
    assert rc == 0 and res["correct"] is True, err[-3000:]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"]["count"] == 4
    m = res["metrics"]
    assert m["iterations"]["value"] > 0 and m["comm_gib"]["value"] > 0
    assert "comm_device_s" not in m              # no device time on the CPU
    assert "[portbench] chase.comm: " in err
    rc, res, err = tiny.run_cli(tree, CELL, "--variant", "control")
    assert rc == 0 and res["correct"] is False, err[-3000:]
    assert res["failed"] == res["attempted"] >= 1


def _children(pid: int) -> list:
    path = Path(f"/proc/{pid}/task/{pid}/children")
    return [int(x) for x in path.read_text().split()]


def test_a_rank_killed_in_the_window_ends_the_run(tree):
    cmd = [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
           "7", "--seconds", "120", "--trace", "0", "--device", "cpu"]
    p = subprocess.Popen(cmd, cwd=tree, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         env=dict(os.environ, PYTHONPATH=str(tiny.REPO)))
    try:
        for line in p.stderr:
            if "set-up" in line:
                break
        ranks = _children(p.pid)
        assert len(ranks) == 3
        time.sleep(1.0)
        t0 = time.monotonic()
        os.kill(ranks[1], signal.SIGKILL)
        p.wait(timeout=60)
        took = time.monotonic() - t0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode != 0 and took < 30
    assert not p.stdout.read().strip()          # no result line
    for pid in ranks:
        assert not Path(f"/proc/{pid}").exists()


EVENTS = [
    ev("user_annotation", devtrace.WINDOW, 0, 10000),
    ev("user_annotation", "chase.filter", 100, 5000),
    launch(110, 1), kernel("ring_hemm_kernel_c64", 120, 3000, 1),
    ev("user_annotation", "chase.comm", 200, 100),
    launch(210, 2), kernel("ncclDevKernel_SendRecv", 220, 2900, 2),
    ev("user_annotation", "chase.comm", 3200, 300),
    launch(3210, 3), kernel("ncclDevKernel_ReduceScatter", 3220, 400, 3),
    launch(6000, 4), kernel("outside_any_span", 6010, 100, 4),
]


def test_comm_device_s_reads_the_spans_device_time():
    mod = reader("comm_device_s")
    summary = devtrace.summarize(EVENTS, mod.RANGES)
    assert mod.read(run_data(summary)) == pytest.approx(3300e-6 / 2)
    bare = devtrace.summarize([e for e in EVENTS if e["name"] != "chase.comm"],
                              mod.RANGES)
    assert mod.read(run_data(bare)) is None
    assert mod.read(run_data({})) is None


def test_comm_gib_reads_the_byte_counts():
    mod = reader("comm_gib")
    before = {"comm:sendrecv": 4, "comm_bytes:sendrecv": 2**30,
              "host_sync:x": 3}
    after = {"comm:sendrecv": 9, "comm_bytes:sendrecv": 3 * 2**30,
             "comm_bytes:reduce_scatter": 2**29, "host_sync:x": 8}
    got = mod.read(run_data(notes={"comm_gib": [before, after]}))
    assert got == pytest.approx(2.5 / 2)
    parent = [{"host_sync:x": 3}, {"host_sync:x": 8}]   # counts no comm
    assert mod.read(run_data(notes={"comm_gib": parent})) is None
    assert mod.read(run_data(notes={"comm_gib": []})) is None
    assert mod.read(run_data()) is None
