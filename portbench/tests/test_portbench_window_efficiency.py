"""The reader of ``filter_window_efficiency``: the share of the filter's
launched columns that were live, from two snapshots of the program's
counts ("filter_cols:useful" over "filter_cols:executed") — and None where
there is nothing to read."""

from __future__ import annotations

import pytest
import torch

from test_portbench_program import (COUNTS_AFTER, COUNTS_BEFORE, reader,
                                    run_data)

NAME = "filter_window_efficiency"


def test_filter_window_efficiency_is_the_live_share():
    before = dict(COUNTS_BEFORE, **{"filter_cols:executed": 1000,
                                    "filter_cols:useful": 700})
    after = dict(COUNTS_AFTER, **{"filter_cols:executed": 1000 + 6400,
                                  "filter_cols:useful": 700 + 6016})
    notes = {NAME: [before, after]}
    got = reader(NAME).read(run_data(notes=notes))
    assert got == pytest.approx(100.0 * 6016 / 6400)
    # counted before the window only (warm-up): no counts
    first = {NAME: [before, dict(before)]}
    assert reader(NAME).read(run_data(notes=first)) is None


@pytest.mark.parametrize("counts", [{}, {"filter_cols:useful": 5}],
                         ids=["no_counts", "no_products"])
def test_filter_window_efficiency_reads_nothing_without_products(counts):
    """A program without the counts (the parent of the metric), or a
    window that launched no filter product: null."""
    notes = {NAME: [dict(COUNTS_BEFORE), dict(COUNTS_AFTER, **counts)]}
    assert reader(NAME).read(run_data(notes=notes)) is None


def test_filter_window_efficiency_reads_nothing_without_notes():
    mod = reader(NAME)
    assert mod.read(run_data()) is None                   # no notes
    assert mod.read(run_data(notes={NAME: []})) is None   # no registry
    full = {NAME: [COUNTS_BEFORE, COUNTS_AFTER]}
    assert mod.read(run_data(notes=full, iterations=(5,),
                             errors=("raised",))) is None


def test_filter_window_efficiency_instruments_the_program():
    """Around a tiny solve of the program on the CPU: two snapshots of its
    registry, and a share to read."""
    import numpy as np

    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement
    mod = reader(NAME)
    notes = []
    with mod.instrument(notes):
        res = ct.eigsh(clement(120), 8, 6, tol=1e-8, device="cpu")
    assert len(notes) == 2
    got = mod.read(run_data(notes={NAME: notes},
                            iterations=(res.iterations,)))
    assert got is not None and 0 < got <= 100
    assert np.all(np.isfinite(res.ritzv))


def test_filter_window_efficiency_notes_nothing_without_counts(monkeypatch):
    import chase_tpu_torch.perf as perf
    monkeypatch.delattr(perf, "COUNTS")
    notes = []
    with reader(NAME).instrument(notes):
        torch.ones(2)
    assert notes == []
    assert reader(NAME).read(run_data(notes={NAME: notes})) is None
