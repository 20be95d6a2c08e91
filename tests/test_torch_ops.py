"""The port's small kernels and host bookkeeping against the JAX
package's, with explicit inputs made by numpy (f64; 1e-12 relative unless
stated):

* Lanczos alphas/betas/basis and the DoS vectors;
* CholQR (1, 2 and shifted passes) — Q up to column signs, and
  orthogonality; Householder QR; the full-block and windowed QR drivers;
* Rayleigh–Ritz with fused residuals — Ritz values and residuals;
* calc_degrees_host and locking_host — identical outputs;
* config resolution and the FLOP model.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chase_tpu
from chase_tpu import solver as jsolver
from chase_tpu.ops import lanczos as jlz
from chase_tpu.ops import qr as jqr
from chase_tpu.ops import rr as jrr
from chase_tpu.perf import PerfData as JPerf

import chase_tpu_torch as ct
from chase_tpu_torch import solver as tsolver
from chase_tpu_torch.ops import blocks as tblocks
from chase_tpu_torch.ops import checks as tchecks
from chase_tpu_torch.ops import lanczos as tlz
from chase_tpu_torch.ops import qr as tqr
from chase_tpu_torch.ops import rr as trr
from chase_tpu_torch.parallel import ring as tring
from chase_tpu_torch.perf import PerfData as TPerf

torch.set_num_threads(1)

TOL = 1e-12


def _sym(N, seed):
    A = np.random.default_rng(seed).standard_normal((N, N))
    return (A + A.T) / 2


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rcfgs(**kw):
    return (chase_tpu.ChaseConfig(**kw).resolve(np.float64),
            ct.ChaseConfig(**kw).resolve(torch.float64))


# -- Lanczos ---------------------------------------------------------------

def test_lanczos_scan_matches_jax():
    N, numvec, m = 150, 4, 12
    H = _sym(N, 0)
    V0 = np.random.default_rng(1).standard_normal((N, numvec))
    aj, bj, basis_j = jlz.lanczos_scan(jnp.asarray(H), jnp.asarray(V0), m=m)
    at, bt, basis_t = tlz.lanczos_scan(_t(H), _t(V0), m=m)
    assert tuple(at.shape) == (m, numvec) and tuple(basis_t.shape) == (m, N)
    assert _rel(at.numpy(), aj) <= TOL
    assert _rel(bt.numpy(), bj) <= TOL
    assert _rel(basis_t.numpy(), basis_j) <= TOL
    _, _, none = tlz.lanczos_scan(_t(H), _t(V0), m=m, want_basis=False)
    assert none is None


def test_lanczos_dos_vectors_and_host_bounds_match_jax():
    N, m = 120, 10
    H = _sym(N, 2)
    V0 = np.random.default_rng(3).standard_normal((N, 4))
    a, b, basis = tlz.lanczos_scan(_t(H), _t(V0), m=m)
    theta, tau, ritzV = tlz.lanczos_tridiag_host(a.numpy(), b.numpy())
    theta_j, tau_j, ritzV_j = jlz.lanczos_tridiag_host(a.numpy(), b.numpy())
    np.testing.assert_array_equal(theta, theta_j)
    assert tlz.dos_lower_bound(theta, tau, 30, N) == \
        jlz.dos_lower_bound(theta_j, tau_j, 30, N)
    assert tlz.upper_bound(theta, b.numpy()[-1]) == \
        jlz.upper_bound(theta_j, b.numpy()[-1])
    mask = np.arange(m) < 4
    Vd_t = tlz.lanczos_dos_vectors(basis, ritzV, mask).numpy()
    Vd_j = np.asarray(jlz.lanczos_dos_vectors(
        jnp.asarray(basis.numpy()), jnp.asarray(ritzV_j), jnp.asarray(mask)))
    assert _rel(Vd_t, Vd_j) <= TOL
    assert np.all(Vd_t[:, 4:] == 0)


# -- QR --------------------------------------------------------------------

def _sign_fix(Q, ref):
    s = np.sign(np.sum(Q * ref, axis=0))
    return Q * np.where(s == 0, 1.0, s)[None, :]


@pytest.mark.parametrize("passes,shifted", [(1, False), (2, False),
                                            (3, True)],
                         ids=["cholqr1", "cholqr2", "shifted"])
def test_cholqr_matches_jax(passes, shifted):
    N, k = 200, 30
    rng = np.random.default_rng(passes)
    V = rng.standard_normal((N, k)) @ np.diag(np.logspace(0, 3, k))
    Qj, okj = jqr.cholqr(jnp.asarray(V), passes=passes, shifted=shifted)
    Qt, okt = tqr.cholqr(_t(V), passes=passes, shifted=shifted)
    assert bool(okj) and okt
    Qt = Qt.numpy()
    assert _rel(_sign_fix(Qt, np.asarray(Qj)), Qj) <= TOL
    assert np.abs(Qt.T @ Qt - np.eye(k)).max() <= 1e-12


def test_cholqr_reports_breakdown():
    V = np.ones((50, 4))                       # rank 1: Gram not PD
    _, ok = tqr.cholqr(_t(V), passes=1)
    assert not ok


def test_householder_qr_matches_jax_up_to_signs():
    V = np.random.default_rng(5).standard_normal((90, 12))
    Qj = np.asarray(jqr.householder_qr(jnp.asarray(V)))
    Qt = tqr.householder_qr(_t(V)).numpy()
    assert _rel(_sign_fix(Qt, Qj), Qj) <= TOL


@pytest.mark.parametrize("cond", [1.0, 50.0, 1e9], ids=["c1", "c2", "shift"])
def test_orthonormalize_full_block_matches_jax(cond):
    N, k, locked = 160, 24, 5
    rng = np.random.default_rng(7)
    Q0, _ = np.linalg.qr(rng.standard_normal((N, locked)))
    V = np.concatenate([Q0, rng.standard_normal((N, k - locked))], axis=1)
    rj, rt = _rcfgs()
    Vj = np.asarray(jqr.orthonormalize(jnp.asarray(V), locked, cond, rj))
    Vt = tqr.orthonormalize(_t(V), locked, cond, rt).numpy()
    np.testing.assert_array_equal(Vt[:, :locked], V[:, :locked])
    assert _rel(_sign_fix(Vt, Vj), Vj) <= 1e-10
    assert np.abs(Vt.T @ Vt - np.eye(k)).max() <= 1e-12


def test_orthonormalize_window_matches_jax():
    N, nevex, locked, B = 160, 32, 10, 8
    w_pad, start = jsolver._window_pad(nevex, locked, B)
    rng = np.random.default_rng(8)
    Q0, _ = np.linalg.qr(rng.standard_normal((N, locked)))
    V = np.concatenate([Q0, rng.standard_normal((N, nevex - locked))], 1)
    rj, rt = _rcfgs()
    Vj = np.asarray(jqr.orthonormalize_window(jnp.asarray(V), start, w_pad,
                                              locked, 30.0, rj))
    Vt = tqr.orthonormalize_window(_t(V.copy()), start, w_pad, locked, 30.0,
                                   rt).numpy()
    np.testing.assert_array_equal(Vt[:, :locked], V[:, :locked])
    assert _rel(_sign_fix(Vt, Vj), Vj) <= 1e-10
    assert np.abs(Vt.T @ Vt - np.eye(nevex)).max() <= 1e-12


def test_mgs_cholqr_orthonormal():
    V = np.random.default_rng(9).standard_normal((120, 30))
    Q, ok = tqr.mgs_cholqr(_t(V))
    Qj, okj = jqr.mgs_cholqr(jnp.asarray(V))
    assert ok and bool(okj)
    assert _rel(_sign_fix(Q.numpy(), np.asarray(Qj)), Qj) <= 1e-10


# -- Rayleigh–Ritz -----------------------------------------------------------

@pytest.mark.parametrize("locked,polish", [(0, 2), (3, 2), (3, 0)],
                         ids=["l0p2", "l3p2", "l3p0"])
def test_rayleigh_ritz_residuals_match_jax(locked, polish):
    N, k = 128, 20
    H = _sym(N, 10)
    V, _ = np.linalg.qr(np.random.default_rng(11).standard_normal((N, k)))
    Vj, rj, resj = jrr.rayleigh_ritz_residuals(
        jnp.asarray(H), jnp.asarray(V), jnp.int32(locked), polish=polish)
    Vt, rt, rest = trr.rayleigh_ritz_residuals(_t(H), _t(V), locked,
                                               polish=polish)
    assert _rel(rt.numpy()[locked:], np.asarray(rj)[locked:]) <= TOL
    assert _rel(rest.numpy()[locked:], np.asarray(resj)[locked:]) <= 1e-10
    np.testing.assert_array_equal(Vt.numpy()[:, :locked], V[:, :locked])
    Vt = Vt.numpy()
    assert _rel(_sign_fix(Vt, np.asarray(Vj)), Vj) <= 1e-10


def test_eigh_polished_matches_jax():
    A = _sym(40, 12)
    wj, Zj = jrr.eigh_polished(jnp.asarray(A), passes=2)
    wt, Zt = trr.eigh_polished(_t(A), passes=2)
    assert _rel(wt.numpy(), wj) <= TOL
    assert _rel(_sign_fix(Zt.numpy(), np.asarray(Zj)), Zj) <= 1e-10


# -- host bookkeeping --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calc_degrees_host_identical(seed):
    rng = np.random.default_rng(seed)
    nevex, nex, unconverged = 40, 10, 33
    ritzv = np.sort(rng.uniform(-10, 5, nevex))
    resid = 10.0 ** rng.uniform(-9, 0, nevex)
    degrees = np.full(nevex, 20, np.int64)
    rcfg_j, rcfg_t = _rcfgs()
    outs = []
    for mod, rcfg in ((jsolver, rcfg_j), (tsolver, rcfg_t)):
        r, s, d = ritzv.copy(), resid.copy(), degrees.copy()
        last, perm = mod.calc_degrees_host(unconverged, nex, 10.0, 2.0,
                                           1e-8, r[7:], s[7:], d[7:], rcfg,
                                           is_sp=False)
        outs.append((last, perm, r, s, d))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_locking_host_identical(seed):
    rng = np.random.default_rng(seed)
    w, n_examine, tol = 30, 22, 1e-6
    ritzv = rng.uniform(-5, 5, w)
    resid = 10.0 ** rng.uniform(-8, -3, w)
    resid_last = resid * rng.uniform(0.5, 2.0, w)
    outs = []
    for mod in (jsolver, tsolver):
        r, s, sl = ritzv.copy(), resid.copy(), resid_last.copy()
        conv, perm, early = mod.locking_host(r, s, sl, n_examine, tol)
        outs.append((conv, perm, early, r, s, sl))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_window_plan_helpers_identical():
    for nevex, locked, B in ((60, 0, 8), (60, 13, 8), (100, 99, 16)):
        assert tsolver._window_pad(nevex, locked, B) == \
            jsolver._window_pad(nevex, locked, B)
    for cb, nevex in ((None, 60), (None, 3000), (7, 60), (500, 60)):
        assert tsolver._col_block(cb, nevex) == jsolver._col_block(cb, nevex)
    # the port's filter runs each step on the window's live suffix; the
    # JAX package's bucket plan never keeps a narrower window
    deg = np.asarray([0, 0, 2, 2, 4, 4, 4, 6, 6, 8, 8, 8, 10, 10, 10, 10])
    plan = jsolver._shrink_plan(deg, 4, 16)
    starts = tring.live_suffixes(deg, 1, 10, 1)
    assert starts == [2, 2, 4, 4, 7, 7, 9, 9, 12, 12]
    for t, s in enumerate(starts, 1):
        assert s >= max([off for step, off in plan if step < t], default=0)


# -- blocks, checks, config, perf ---------------------------------------------

def test_blocks_in_place_and_permute():
    V = torch.arange(24.0).reshape(4, 6)
    P = tblocks.permute_cols(V, np.asarray([5, 4, 3, 2, 1, 0]))
    assert torch.equal(P, V.flip(1))
    view = tblocks.slice_cols(V, 2, 3)
    tblocks.update_cols(V, torch.zeros(4, 3), 2)
    assert torch.equal(view, torch.zeros(4, 3))
    tblocks.set_head_cols(V, torch.ones(4, 2), np.asarray([True, False]))
    assert torch.equal(V[:, 0], torch.ones(4))
    assert torch.equal(V[:, 1], torch.arange(1.0, 24.0, 6))


def test_check_hermitian():
    H = _sym(64, 13)
    assert tchecks.check_hermitian(_t(H))
    H[0, 5] += 1.0
    assert not tchecks.check_hermitian(_t(H))


@pytest.mark.parametrize("np_dt,t_dt", [(np.float32, torch.float32),
                                        (np.float64, torch.float64)],
                         ids=["f32", "f64"])
def test_config_resolution_matches_jax(np_dt, t_dt):
    j = chase_tpu.ChaseConfig(mixed_precision=False).resolve(np_dt)
    t = ct.ChaseConfig().resolve(t_dt)
    for name in ("tol", "deg", "max_deg", "lanczos_iter", "cholqr",
                 "cholqr1_threshold", "cholqr_shift_threshold",
                 "mixed_precision", "is_double"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.polish_passes() == j.polish_passes()
    jfields = {f.name for f in chase_tpu.ChaseConfig.__dataclass_fields__
               .values()}
    assert jfields == set(ct.ChaseConfig.__dataclass_fields__)


def test_perf_flop_model_matches_jax():
    pj, pt = JPerf(), TPerf()
    for p in (pj, pt):
        p.add_filtered_vecs(1234, executed=1500)
        for b in (300, 200, 120):
            p.add_iter_blocksize(b)
    assert pt.get_flops(5000, 12, 4, torch.float32) == \
        pj.get_flops(5000, 12, 4, np.float32)
    assert pt.get_filter_flops(5000, torch.float64) == \
        pj.get_filter_flops(5000, np.float64)
    assert pt.filter_window_efficiency() == pj.filter_window_efficiency()
