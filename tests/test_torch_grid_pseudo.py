"""The port's ``eigsh_pseudo`` (Bethe–Salpeter problems) on process grids
against the JAX package, on (2, 1), (3, 1), (4, 1) and (2, 2) gloo grids.

Each grid shape is one group of ``tests/torch_grid_worker.py`` processes
(one per rank, a hard time limit each), started once for this module, as
in ``tests/test_torch_grid.py``.  Tolerances:

* ``eigsh_pseudo``: spectra within ``conftest.TOLS`` of
  ``chase_tpu.eigsh_pseudo(grid=…)`` on the same shape, true residuals
  ‖Hv − θv‖ ≤ 10·tol, iterations within ±1 of the port's ``grid=None``
  solve with the same seed (of the JAX package's on the same grid where
  the grid pads H: the padded operator is another, larger problem),
  ``ritzv``, ``resid``, iterations, locked count and V bitwise equal on
  every rank, the result's rows DTensor's even split of the unpadded
  rows.  Cases: f32 and c64 with ``ring_backend="pallas"`` and the f64
  ladder (tol 1e-10) on (2, 1), every H² product p ring steps on the
  kernel's step; f64 on (3, 1) at N = 130, whose halves pad to 66 and
  whose rank 1 straddles the S-half, with a warm start from its DTensor
  V; c128 on (4, 1) (the matmul ring); f64 on (2, 2) (the 2-D H² ring
  on ``torch.matmul`` steps);
* ``apply_s``, ``flip_locked_cols`` and ``k_conjugate_cols`` on every
  rank's rows bitwise equal to the whole-block result cut to those rows,
  K-conjugation's row rotation counted (one partner per rank for an even
  row count of the grid, two for three rows);
* the S-preserving pad (N = 130): each rank's block entry for entry the
  JAX package's padded H cut the same way, its ±g phantom diagonal within
  N·ε of it (row sums added in another order), the same (N/2, h_pad); a
  block placed on the operator and unpadded gives back its rows;
* a padded pseudo-Hermitian DTensor H built into blocks without a gather
  (``full_tensor`` barred), equal to the whole H's but for the phantom
  diagonal (N·ε), and a solve from it within ``conftest.TOLS`` of the
  whole H's;
* ``ring_filter`` on (2, 2) for ``eigsh_pseudo`` (a random BSE H, N =
  128, f32 with ``ring_backend="pallas"``): True takes the 2-D H² ring as
  None does (the same Ritz values bitwise, each H² step r + c = 4 kernel
  steps per rank, 2 per HEMM step), False the windowed H² filter (no
  kernel step), all within 1e-2 of the spectrum.
"""

import numpy as np
import pytest
import torch

import jax

import chase_tpu
from chase_tpu_torch.ops import pseudo as tps

import torch_grid_worker as gw
from conftest import TOLS

torch.set_num_threads(1)

SHAPES = {"b21": (2, 1), "b31": (3, 1), "b41": (4, 1), "b22": (2, 2)}
JAX_PINS = dict(complex_backend="native", small_dense_backend="device",
                wide_f64="off")


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {name: gw.Group(name, r, c, tmp_path_factory.mktemp(name))
               for name, (r, c) in SHAPES.items()}
    yield started
    for g in started.values():
        g.kill()


def _jax_grid(shape):
    n = shape[0] * shape[1]
    return chase_tpu.make_grid(jax.devices()[:n], shape=shape)


def _all_equal(ranks, key) -> bool:
    return all(np.array_equal(r[key], ranks[0][key]) for r in ranks[1:])


def _pseudo_cases():
    return [(name, case) for name in SHAPES
            for case, _ in gw.PSEUDO[name]]


@pytest.mark.parametrize("name,case", _pseudo_cases())
def test_eigsh_pseudo_matches_jax(groups, name, case):
    H, nev, nex, tol = gw.bse_problem(case)
    shape = SHAPES[name]
    p = shape[0]
    cfg = dict(gw.PSEUDO[name])[case]
    jres = chase_tpu.eigsh_pseudo(
        H, nev, nex, tol=tol, grid=_jax_grid(shape),
        config=chase_tpu.ChaseConfig(
            mixed_precision=bool(cfg.get("mixed_precision", False)),
            **JAX_PINS))
    ranks = groups[name].results()
    rec = ranks[0]
    assert bool(rec[f"{case}/converged"]) and jres.converged
    ritzv = rec[f"{case}/ritzv"]
    np.testing.assert_allclose(ritzv, jres.ritzv, rtol=0,
                               atol=TOLS[H.dtype])
    V = rec[f"{case}/V"]
    assert V.shape == (H.shape[0], nev)
    Hw = H.astype(np.complex128)
    true_res = np.linalg.norm(Hw @ V - V * ritzv, axis=0)
    assert true_res.max() <= 10 * tol
    padded = (H.shape[0] // 2) % (shape[0] * shape[1]) != 0
    ref_its = jres.iterations if padded else int(rec[f"{case}/iterations0"])
    assert abs(int(rec[f"{case}/iterations"]) - ref_its) <= 1
    for key in ("ritzv", "resid", "iterations", "locked", "ritzv_full",
                "V"):
        assert _all_equal(ranks, f"{case}/{key}"), key
    chunk = -(-H.shape[0] // p)
    sizes = [max(0, min(chunk, H.shape[0] - i * chunk)) for i in range(p)
             for _ in range(shape[1])]
    assert [int(r[f"{case}/local_rows"]) for r in ranks] == sizes
    # both products of every H² step p ring steps on the kernel's step
    # where the filter's operator is one the kernel takes
    kernel = cfg.get("ring_backend") == "pallas" and shape[1] == 1 and (
        H.dtype in (np.float32, np.complex64) or "ladder" in case)
    steps, hemms = int(rec[f"{case}/steps"]), int(rec[f"{case}/hemm_steps"])
    assert hemms > 0 and hemms % 2 == 0
    assert steps == (p * hemms if kernel else 0)


def test_warm_start_from_the_dtensor_result(groups):
    """A warm start (v0 = the padded (3, 1) solve's DTensor V, approx)
    converges at once to the same spectrum."""
    case = "random_float64_N130"
    for rec in groups["b31"].results():
        assert int(rec[f"{case}/warm_iterations"]) <= 1
        np.testing.assert_allclose(rec[f"{case}/warm_ritzv"],
                                   rec[f"{case}/ritzv"], rtol=0, atol=1e-8)


@pytest.mark.parametrize("name", ["b21", "b31", "b41"])
def test_s_ops_on_a_ranks_rows_match_the_whole_block(groups, name):
    p = SHAPES[name][0]
    b = gw.N_SOPS // p
    for dt in (np.float64, np.complex128):
        X, src, wmask = gw.sops_inputs(dt)
        Xt = torch.from_numpy(X)
        whole = {"apply_s": tps.apply_s(Xt).numpy(),
                 "flip": tps.flip_locked_cols(Xt, 4).numpy(),
                 "kconj": tps.k_conjugate_cols(Xt, src, wmask).numpy()}
        dtn = np.dtype(dt).name
        for rec in groups[name].results():
            r0, n = (int(x) for x in rec["sops/rows"])
            assert n == b
            for op, W in whole.items():
                np.testing.assert_array_equal(rec[f"sops/{dtn}/{op}"],
                                              W[r0:r0 + n], err_msg=op)
            # the mirrors' rows come from one partner (p even: N/2 is a
            # whole number of blocks) or two (p = 3)
            calls, nbytes = (int(x) for x in rec[f"sops/{dtn}/rotate"])
            assert calls == (1 if p % 2 == 0 else 2)
            assert nbytes == b * 4 * np.dtype(dt).itemsize


@pytest.mark.parametrize("name", ["b21", "b31", "b41"])
def test_s_preserving_pad_matches_jax(groups, name):
    shape = SHAPES[name]
    V = np.arange(130 * 3, dtype=np.float64).reshape(130, 3)
    for dt in (np.float64, np.complex128):
        dtn = np.dtype(dt).name
        ranks = groups[name].results()
        # the worker's H (random_pseudo_hermitian(130, seed=8)): its BLAS
        # may round the generator's products in other last bits
        H = ranks[0][f"bsepad/{dtn}/H"]
        jop = chase_tpu.DenseOperator(H, grid=_jax_grid(shape),
                                      pseudo_hermitian=True)
        Hj = np.asarray(jop.H)
        n_half, h_pad = jop._pad_half
        Np = Hj.shape[0]
        eps = np.finfo(np.dtype(dt)).eps
        g = abs(Hj[n_half, n_half])
        assert Hj[Np - 1, Np - 1] == -Hj[n_half, n_half]
        assert g >= np.abs(np.linalg.eigvals(H)).max()
        for rec in ranks:
            assert [int(x) for x in rec["bsepad/half"]] == [n_half, h_pad]
            i, j = (int(x) for x in rec["bsepad/coords"])
            A = rec[f"bsepad/{dtn}"]
            nr, nc = Np // shape[0], Np // shape[1]
            B = Hj[i * nr:(i + 1) * nr, j * nc:(j + 1) * nc]
            assert A.shape == B.shape
            rows, cols = np.nonzero(A != B)
            g_r, g_c = rows + i * nr, cols + j * nc
            # only the phantom diagonal differs, by N·ε
            assert np.all(g_r == g_c)
            assert np.all(((g_r >= n_half) & (g_r < h_pad))
                          | (g_r >= h_pad + n_half))
            np.testing.assert_allclose(A[rows, cols], B[rows, cols], rtol=0,
                                       atol=130 * eps * g)
            # a whole block placed on the operator: H's rows where the pad
            # puts them, zeros in the phantom rows; unpadded it is V again
            placed = rec[f"bsepad/{dtn}/placed"]
            np.testing.assert_array_equal(placed[:n_half], V[:n_half])
            np.testing.assert_array_equal(placed[h_pad:h_pad + n_half],
                                          V[n_half:])
            assert not placed[n_half:h_pad].any()
            assert not placed[h_pad + n_half:].any()
        got = np.concatenate([r[f"bsepad/{dtn}/unpad"] for r in ranks
                              if int(r["bsepad/coords"][1]) == 0])
        np.testing.assert_array_equal(got, V)


@pytest.mark.parametrize("name", ["b31", "b22"])
def test_pseudo_dtensor_operator_is_not_gathered(groups, name):
    ranks = groups[name].results()
    for dtype in ("float32", "complex128"):
        eps = np.finfo(np.dtype(dtype)).eps
        pads = set()
        for rec in ranks:
            A, B = rec[f"bsedt/{dtype}"], rec[f"bsedt/{dtype}/whole"]
            assert A.shape == B.shape and A.dtype == B.dtype
            assert np.all(np.abs(A - B) <= 130 * eps * np.abs(B).max())
            rows, cols = np.nonzero(A != B)
            if rows.size:                    # only on the phantom diagonal
                i, j = (int(x) for x in rec["bsedt/coords"])
                assert np.all(rows + i * A.shape[0] == cols + j * A.shape[1])
                pads.update(np.abs(A[rows, cols]).tolist())
        assert len(pads) <= 1
    for rec in ranks:
        np.testing.assert_allclose(rec["bsedt/ritzv"],
                                   rec["bsedt/ritzv/whole"], rtol=0,
                                   atol=TOLS[np.dtype(np.float64)])
    assert _all_equal(ranks, "bsedt/ritzv")


def test_ring_filter_true_on_a_2d_grid_raises_for_bse(groups):
    from test_torch_grid import check_ring_filter_2d
    H, *_ = gw.bse_problem("random_float32")
    lam = np.sort(np.linalg.eigvals(H.astype(np.complex128)).real)
    check_ring_filter_2d(groups["b22"].results(), "pring2d",
                         lam[lam > 0][:4])
