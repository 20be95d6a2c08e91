"""chip_smoke.py's launch gate of the fused phases (``launches_ok``), a
pure function of the kernel launch counts, on the CPU.

One device: one ``ring_hemm`` launch and one pre-pass per HEMM step.  On
every route the pre-passes are of that route alone (``tf32_split`` for
f32 and c64, ``bf16_pack`` for bf16); a fused solve on the bf16 rung
filters on the bf16 shadow while its low phase holds and on the f32 H
after it, so its pre-passes may be of both routes, ``bf16_pack`` at least
once.  On a (p, 1) grid the peer route's three kernels, once per step,
and no ``ring_hemm`` step.
"""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

STEPS = 36
# (ring_hemm, tf32_split, bf16_pack, ring_hemm_peers, peer_gather,
#  peer_publish), p, bf16_rung, accepted
CASES = {
    "rung-both-prepasses": ((36, 26, 10, 0, 0, 0), 1, True, True),
    "rung-bf16-throughout": ((36, 0, 36, 0, 0, 0), 1, True, True),
    "rung-never-on-bf16": ((36, 36, 0, 0, 0, 0), 1, True, False),
    "rung-missing-main-launch": ((35, 26, 10, 0, 0, 0), 1, True, False),
    "rung-missing-prepass": ((36, 25, 10, 0, 0, 0), 1, True, False),
    "rung-extra-prepass": ((36, 27, 10, 0, 0, 0), 1, True, False),
    "rung-peer-launch": ((36, 26, 10, 1, 1, 1), 1, True, False),
    "f32-route": ((36, 36, 0, 0, 0, 0), 1, False, True),
    "bf16-route": ((36, 0, 36, 0, 0, 0), 1, False, True),
    "route-with-both-prepasses": ((36, 26, 10, 0, 0, 0), 1, False, False),
    "route-missing-main-launch": ((35, 35, 0, 0, 0, 0), 1, False, False),
    "route-missing-prepass": ((36, 35, 0, 0, 0, 0), 1, False, False),
    "no-launch": ((0, 0, 0, 0, 0, 0), 1, False, False),
    "peer-route": ((0, 0, 0, 36, 36, 36), 2, False, True),
    "peer-route-missing-gather": ((0, 0, 0, 36, 35, 36), 2, False, False),
    "peer-route-with-a-ring_hemm-step": ((1, 1, 0, 36, 36, 36), 2, False,
                                         False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_launches_ok(case):
    counts, p, rung, accepted = CASES[case]
    assert chip_smoke.launches_ok(counts, STEPS, p, rung) is accepted


def test_no_launch_fails_the_rung_gate():
    assert not chip_smoke.launches_ok((0, 0, 0, 0, 0, 0), 0, 1, True)
    assert not chip_smoke.launches_ok((0, 0, 0, 0, 0, 0), 0, 1, False)


def test_check_fused_runs_takes_the_rung_gate():
    """check_fused_runs passes the phase's rung on: the same counts pass
    a bf16-rung phase and fail any other."""
    class Res:
        def __init__(self, iterations):
            self.iterations = iterations

    runs = dict(res1=Res(1), res2=Res(5), syncs=15, per_iter=2.5,
                launches=(36, 26, 10, 0, 0, 0), steps=36, p=1)
    chip_smoke.check_fused_runs("fbslice", runs, bf16_rung=True)
    with pytest.raises(AssertionError, match="against 36 HEMM steps"):
        chip_smoke.check_fused_runs("fslice", runs)
