"""The readers of the program's warm start: ``warm_start_device_s`` (the
device time of its ``chase.warm_start`` spans) on a synthetic trace
summarized by ``devtrace``, ``warm_dos_lowered_share`` (its
``warm_start:*`` counts) from snapshots and around the program's own
solves — None where there is nothing to read — and the ``scf10`` traffic
as a tiny cell on the CPU."""

from __future__ import annotations

import json

import pytest

import tiny
from portbench import devtrace
from test_portbench_program import ev, kernel, launch, reader, run_data

SHARE = "warm_dos_lowered_share"

# two warm members' worth of spans in a 10 ms window (µs): the Lanczos
# span nests inside the warm start's, the filter lies outside it
EVENTS = [
    ev("user_annotation", devtrace.WINDOW, 0, 10000),
    ev("user_annotation", "chase.warm_start", 100, 400),
    launch(110, 1), kernel("copy_block", 120, 30, 1),
    ev("user_annotation", "chase.lanczos", 200, 250),
    launch(210, 2), kernel("lanczos_scan", 220, 200, 2),
    ev("user_annotation", "chase.filter", 600, 3000),
    launch(610, 3), kernel("ring_hemm_kernel", 620, 2900, 3),
    ev("user_annotation", "chase.warm_start", 5000, 300),
    launch(5010, 4), kernel("lanczos_scan", 5020, 250, 4),
    launch(5020, 5, tid=2), kernel("other_thread", 5100, 50, 5),
    launch(9100, 6), kernel("outside_any_span", 9110, 100, 6),
]


def test_warm_start_device_s_on_a_synthetic_trace():
    mod = reader("warm_start_device_s")
    assert mod.RANGES == ("chase.warm_start",)
    got = mod.read(run_data(devtrace.summarize(EVENTS, mod.RANGES)))
    assert got == pytest.approx((30 + 200 + 250) * 1e-6 / 2)  # two solves


def test_warm_start_device_s_reads_nothing_without_its_span():
    mod = reader("warm_start_device_s")
    bare = devtrace.summarize([e for e in EVENTS
                               if e["name"] != "chase.warm_start"],
                              mod.RANGES)
    assert bare["annotated"]["chase.warm_start"]["ranges"] == 0
    assert mod.read(run_data(bare)) is None              # cold solves
    assert mod.read(run_data({})) is None                # untraced run
    no_device = devtrace.summarize([e for e in EVENTS
                                    if e["cat"] != "kernel"], mod.RANGES)
    assert mod.read(run_data(no_device)) is None
    assert mod.read(run_data(devtrace.summarize(EVENTS, mod.RANGES),
                             iterations=(2,), errors=("raised",))) is None


BEFORE = {"warm_start:members": 3, "warm_start:dos_lowered": 1,
          "host_sync:solver.rr": 40}
AFTER = {"warm_start:members": 13, "warm_start:dos_lowered": 4,
         "host_sync:solver.rr": 90}


@pytest.mark.parametrize("before,after,want", [
    (BEFORE, AFTER, 30.0),
    ({}, {"warm_start:members": 10}, 0.0),      # never lowered
    ({}, {"warm_start:members": 4, "warm_start:dos_lowered": 4}, 100.0),
], ids=["some", "none", "all"])
def test_warm_dos_lowered_share_from_snapshots(before, after, want):
    got = reader(SHARE).read(run_data(notes={SHARE: [before, after]}))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("notes", [
    None,                                        # no notes at all
    [],                                          # a program without counts
    [BEFORE, BEFORE],                            # no warm start in the window
    [{"host_sync:x": 1}, {"host_sync:x": 9}],    # cold solves only
], ids=["no_notes", "no_registry", "no_growth", "cold"])
def test_warm_dos_lowered_share_reads_nothing_without_a_warm_member(notes):
    run = run_data(notes={} if notes is None else {SHARE: notes})
    assert reader(SHARE).read(run) is None


def test_warm_dos_lowered_share_instruments_the_program():
    """Around a cold solve and a warm one of the program on the CPU: two
    snapshots of its registry, one warm member to read."""
    import numpy as np

    import chase_tpu_torch as ct
    from chase_tpu_torch.models import hermitian_sequence
    mod = reader(SHARE)
    H0, H1 = hermitian_sequence(120, 2, np.complex128, seed=3, drift=0.002)
    r0 = ct.eigsh(H0, 8, 6, tol=1e-8, device="cpu")
    cold = []
    with mod.instrument(cold):
        ct.eigsh(H1, 8, 6, tol=1e-8, device="cpu")
    assert mod.read(run_data(notes={SHARE: cold})) is None
    notes = []
    with mod.instrument(notes):
        r1 = ct.eigsh(H1, 8, 6, tol=1e-8, device="cpu", v0=r0.V,
                      ritzv0=r0.ritzv_full, approx=True)
    assert len(notes) == 2
    got = mod.read(run_data(notes={SHARE: notes},
                            iterations=(r1.iterations,)))
    assert got in (0.0, 100.0)
    assert r1.converged


def test_scf10_traffic_as_a_tiny_cell(tmp_path):
    """The scf10 traffic on the tiny Hermitian configuration (tiles of 64):
    one pass of ten warm members, judged correct, the share reported in
    the traced run (no device time on the CPU, so no span seconds)."""
    root = tiny.make_tree(tmp_path)
    scf10 = json.loads((tiny.PORTBENCH / "traffic" / "scf10.json")
                       .read_text())
    assert scf10["pass_members"] == 10 and scf10["mode"] == "sequence"
    scf10["tile"] = 64
    (root / "portbench" / "traffic" / "scf10_tiny.json").write_text(
        json.dumps(scf10))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = "herm_tiny.scf10_tiny"
    bench["workloads"].append(dict(name=cell, config="herm_tiny",
                                   traffic="scf10_tiny", chips=1,
                                   why="tests"))
    for m in bench["per_layer"]:
        if m["name"] in ("warm_start_device_s", SHARE):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = tiny.run_cli(root, cell, trace=1)
    assert rc == 0, err[-3000:]
    assert out["correct"] is True, err[-3000:]
    assert out["attempted"] == 10 and out["failed"] == 0
    assert "missed" in out["checks"]
    share = out["metrics"][SHARE]
    assert share["unit"] == "%" and 0.0 <= share["value"] <= 100.0
    assert "warm_start_device_s" not in out["metrics"]
