"""A DTensor H's block used in place, and the grid's collectives seen by
the program's tracing, on a (2, 2) gloo group of
``tests/torch_grid_worker.py`` (battery ``c22``, started once for this
module):

* a ``(Shard(0), Shard(1))`` H that the grid does not pad is this rank's
  operator block itself (the DTensor's local storage), where the same H
  with the layout check forced off, or lazily conjugated, is copied; the
  (2, 2) Clement c128 solve and the f64 ladder on ``ring_backend=
  "pallas"`` come out bitwise equal from the block in place and from the
  copy, on every rank;
* a (2, 2) solve raises the program's counts "comm:<kind>" and
  "comm_bytes:<kind>" by exactly the grid's ``CollectiveStats``, the 2-D
  ring's reduce-scatters and exchanges among them;
* the span ``chase.comm`` opens no profiler range in a solve without a
  profiler, with the phase clock off or on, and in a traced solve is a
  range as often as it is opened.
"""

import numpy as np
import pytest
import torch

import torch_grid_worker as gw
from chase_tpu_torch import perf
from chase_tpu_torch.parallel.mesh import CollectiveStats

RESULT_KEYS = ("ritzv", "resid", "iterations", "ritzv_full", "V")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = gw.Group("c22", 2, 2, tmp_path_factory.mktemp("c22"),
                     timeout=300)
    try:
        yield group.results()
    finally:
        group.kill()


@pytest.mark.parametrize("case", [c for c, _ in gw.INPLACE_SOLVES])
def test_unpadded_dtensor_block_is_used_in_place(ranks, case):
    for rec in ranks:
        assert bool(rec[f"inplace/{case}/shares"])
        assert not bool(rec[f"inplace/{case}/copy_shares"])
        for key in RESULT_KEYS:
            np.testing.assert_array_equal(
                rec[f"inplace/{case}/in_place/{key}"],
                rec[f"inplace/{case}/copy/{key}"], err_msg=key)
    assert np.all(np.diff(ranks[0][f"inplace/{case}/in_place/ritzv"]) > 0)


def test_conjugated_dtensor_block_is_copied(ranks):
    for rec in ranks:
        assert not bool(rec["inplace/conj_shares"])
        np.testing.assert_array_equal(rec["inplace/conj_block"],
                                      rec["inplace/conj_block_want"])


def test_comm_counts_equal_the_grid_stats(ranks):
    for rec in ranks:
        kinds = list(rec["comm/kinds"])
        assert {"reduce_scatter", "sendrecv", "all_reduce"} <= set(kinds)
        assert list(rec["comm/grown"]) == kinds
        np.testing.assert_array_equal(rec["comm/counts"], rec["comm/stats"])
        assert np.all(rec["comm/stats"] > 0)


def test_comm_spans_record_only_under_a_profiler(ranks):
    for rec in ranks:
        assert int(rec["spans/untraced/False"]) == 0
        assert int(rec["spans/untraced/True"]) == 0
        assert int(rec["spans/opened"]) > 0
        assert int(rec["spans/traced"]) == int(rec["spans/opened"])


def test_collective_stats_feed_the_program_counts():
    stats = CollectiveStats()
    before = dict(perf.COUNTS)
    stats.add("flip", torch.zeros(3, 4, dtype=torch.complex64))
    stats.count("peer", 100)
    stats.count("peer", 28)
    grown = {k: n - before.get(k, 0) for k, n in perf.COUNTS.items()
             if n != before.get(k, 0)}
    assert grown == {"comm:flip": 1, "comm_bytes:flip": 96,
                     "comm:peer": 2, "comm_bytes:peer": 128}
    assert stats.summary() == {"flip": (1, 96), "peer": (2, 128)}
