"""The tiny cells on the card (``-m gpu``): a traced run of each comes out
correct with device activity in its window, and the roofline share of the
kernel's products stays at or below 100%."""

from __future__ import annotations

import pytest
import torch

import tiny


@pytest.mark.gpu
@pytest.mark.parametrize("workload", tiny.CELLS)
def test_tiny_cells_on_the_card(tmp_path, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny.make_tree(tmp_path)
    rc, res, err = tiny.run_cli(root, workload, trace=1, device=None,
                                seconds=2)
    assert rc == 0 and res["correct"] is True, err[-3000:]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    roof = res["metrics"].get("ring_hemm_roofline")
    assert roof is None or 0 < roof["value"] <= 100
