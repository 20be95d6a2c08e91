"""Complex Hermitian problems: the port (native c64/c128) against the JAX
package.

The JAX package solves complex problems natively on the CPU, or through
its 2N real-pair embedding (``complex_backend="real_pair"``), the only
route on which its Pallas ring kernel sees complex data.  The port is
native complex everywhere; its ring kernel has a c64 route of its own,
the complex product in three real products (Gauss's 3M form,
``ops/ring_hemm.py``'s module note).

* c128: random Hermitian N=256, nev=24, nex=16, tol 1e-9, same V0,
  against ``chase_tpu.eigsh(complex_backend="native")``: eigenvalues
  within 1e-8 of each other and of eigvalsh.
* c64 ring path: N=128, nev=12, nex=8, tol 1e-3; the port's p=1 ring
  (every HEMM through the c64 ``ring_hemm`` wrapper, its plain version on
  the CPU) against JAX's real-pair Pallas ring on a (2, 1) grid (TPU
  interpreter): eigenvalues within 1e-4 of each other and of eigvalsh,
  true residuals ≤ 10·tol.
* the c64 pre-pass's six planes written out, and the c64 kernel's 3M
  arithmetic emulated on the CPU from the wrapper's arguments (TF32
  splits of fl(Hr + Hi), Hr and Hi, three products small terms first,
  promoted in IEEE f32 per K tile), untransposed and trans: 1e-5 of the
  largest entry of a c128 product, and within 4× the plain c64
  product's error.
* the c64 ring filter against the JAX filter: 1e-5 per column,
  degree-0 columns bit-exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chase_tpu
from chase_tpu.ops.filter import chebyshev_filter as j_filter

import chase_tpu_torch as ct
from chase_tpu_torch.models import random_hermitian
from chase_tpu_torch.ops.ring_hemm import (BK_C64, float_view_args,
                                           ring_hemm, split_shape, tf32_split,
                                           tf32_split_reference, tma_ld,
                                           tma_row_stride)
from chase_tpu_torch.ops import ring_hemm as trh
from chase_tpu_torch.parallel import ring as tring
from chase_tpu_torch.parallel.operator import padded_empty
from chase_tpu_torch.utils import residual_norms, validate_result

torch.set_num_threads(1)

RTOL = 1e-5


def _crandn(rng, *shape, dtype=np.complex64):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


# ---- whole solves -----------------------------------------------------------

def test_c128_matches_jax_native():
    H = random_hermitian(256, np.complex128)
    V0 = _crandn(np.random.default_rng(1), 256, 40, dtype=np.complex128)
    rj = chase_tpu.eigsh(H, 24, 16, tol=1e-9, v0=V0,
                         config=chase_tpu.ChaseConfig(complex_backend="native"))
    rt = ct.eigsh(H, 24, 16, tol=1e-9, v0=V0, device="cpu")
    exact = np.linalg.eigvalsh(H)[:24]
    assert rj.converged and rt.converged
    assert np.abs(rt.ritzv - rj.ritzv).max() <= 1e-8
    assert np.abs(rt.ritzv - exact).max() <= 1e-8
    validate_result(H, rt)
    assert rt.V.dtype == torch.complex128 and rt.V.device.type == "cpu"


@pytest.fixture(scope="module")
def c64_case():
    H = random_hermitian(128, np.complex64)
    V0 = _crandn(np.random.default_rng(2), 128, 20)
    return H, V0, np.linalg.eigvalsh(H.astype(np.complex128))[:12]


def test_c64_ring_path_matches_jax_real_pair_pallas_ring(c64_case,
                                                         monkeypatch):
    H, V0, exact = c64_case
    grid = chase_tpu.make_grid(jax.devices()[:2], shape=(2, 1))
    rj = chase_tpu.eigsh(H, 12, 8, tol=1e-3, v0=V0, grid=grid,
                         config=chase_tpu.ChaseConfig(
                             complex_backend="real_pair",
                             ring_backend="pallas"))
    calls = []
    real = trh.ring_hemm

    def counting(Hm, V, **kw):
        calls.append(V.dtype)
        return real(Hm, V, **kw)

    monkeypatch.setattr(trh, "ring_hemm", counting)
    rt = ct.eigsh(H, 12, 8, tol=1e-3, v0=V0, device="cpu",
                  config=ct.ChaseConfig(ring_backend="pallas"),
                  collect_perf=True)
    assert rj.converged and rt.converged
    assert np.abs(rt.ritzv - rj.ritzv).max() <= 1e-4
    assert np.abs(rt.ritzv - exact).max() <= 1e-4
    assert np.abs(rj.ritzv - exact).max() <= 1e-4
    V = rt.V[:, :12].numpy()
    assert V.dtype == np.complex64
    H128 = H.astype(np.complex128)
    assert residual_norms(H128, V.astype(np.complex128),
                          rt.ritzv).max() <= 10 * 1e-3
    # every filter step went through the ring HEMM wrapper, in c64
    assert len(calls) == rt.perf.filter_hemm_steps > 0
    assert set(calls) == {torch.complex64}


def test_c64_windowed_path_converges_to_the_same_spectrum(c64_case):
    H, V0, exact = c64_case
    rt = ct.eigsh(H, 12, 8, tol=1e-3, v0=V0, device="cpu",
                  config=ct.ChaseConfig(ring_backend="xla"))
    assert rt.converged
    assert np.abs(rt.ritzv - exact).max() <= 1e-4


def test_c128_largest_matches_jax():
    H = random_hermitian(200, np.complex128, seed=3)
    rt = ct.eigsh(H, 10, 10, tol=1e-10, device="cpu", largest=True)
    rj = chase_tpu.eigsh(H, 10, 10, tol=1e-10, largest=True,
                         config=chase_tpu.ChaseConfig(complex_backend="native"))
    assert rt.converged and rj.converged
    np.testing.assert_allclose(rt.ritzv, np.linalg.eigvalsh(H)[-10:],
                               atol=1e-8)
    np.testing.assert_allclose(rt.ritzv, rj.ritzv, atol=1e-8)
    V = rt.V[:, :10].numpy()
    assert residual_norms(H, V, rt.ritzv).max() <= 1e-8


# ---- the c64 route's 3M arithmetic -------------------------------------------

def _split_np(x):
    """TF32 hi/lo by bit arithmetic (cvt.rna: half a TF32 ulp, clear 13
    bits)."""
    def tf32(a):
        bits = np.asarray(a, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000))
                & np.uint32(0xFFFFE000)).view(np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


@pytest.mark.parametrize("conj", [False, True], ids=["plain", "conj"])
@pytest.mark.parametrize("off", [0, 1])
def test_c64_split_plain_version_is_the_written_out_planes(off, conj):
    """The c64 pre-pass's plain version: six planes, Vr, fl(Vi − Vr) and
    fl(Vr + Vi) of V (of conj(V) with ``conj``) each split into TF32 hi
    and lo, transposed, from column ``off``, zero elsewhere."""
    rng = np.random.default_rng(10 + off + 2 * conj)
    Vw = torch.from_numpy(_crandn(rng, 21, 70))[:, 3:68]  # strided window
    V = Vw.numpy()
    b, k = V.shape
    parts = np.empty((3, b, k), np.float32)
    for j in range(b):
        for c in range(k):
            re = V[j, c].real
            im = -V[j, c].imag if conj else V[j, c].imag
            parts[:, j, c] = re, im - re, re + im      # float32 sums
    Vt = tf32_split(Vw, off, conj=conj)
    assert tuple(Vt.shape) == (6, *split_shape(b, k, off,
                                               torch.complex64)[::-1])
    assert Vt.shape[2] % BK_C64 == 0 and Vt.shape[1] % 64 == 0
    for c in range(3):
        hi, lo = _split_np(parts[c])
        np.testing.assert_array_equal(
            Vt[2 * c, :k, off:off + b].numpy(), hi.T)
        np.testing.assert_array_equal(
            Vt[2 * c + 1, :k, off:off + b].numpy(), lo.T)
    zero = torch.ones_like(Vt, dtype=torch.bool)
    zero[:, :k, off:off + b] = False
    assert not Vt[zero].any()
    assert torch.equal(Vt, tf32_split_reference(Vw.contiguous(), off, conj))
    with pytest.raises(ValueError):
        tf32_split(Vw, 2)


def _float_view(H):
    """H's storage as floats (the f32 kernel's view of a c64 H)."""
    return torch.view_as_real(H) if H.is_complex() else H


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _emulate_c64(H, V, col0, out, accumulate, trans):
    """The c64 kernel's arithmetic, driven by the wrapper's arguments: the
    A tile (H's block, or its transpose with ``trans``; columns outside
    [off, off + b) zero) split into TF32 hi/lo for Hs = fl(Hr + Hi), Hr
    and Hi; per K tile of BK_C64 complex, k1 = Hs·Vr, k2 = Hr·Vd, k3 =
    Hi·Vs, each lo·Vhi + hi·Vlo + hi·Vhi against the pre-pass's planes
    (sums in f64, rounded to f32: the accumulator's own rounding is not
    modelled), promoted in IEEE f32 as re += k1 − k3, im += k1 + k2; the
    trans route negates Im (Hᴴ·V = conj(Hᵀ·conj V))."""
    ldh, c0, off, b, k, ldw = float_view_args(H, V, col0, out.stride(0),
                                              trans)
    assert ldh is not None and c0 == col0 and ldw == 2 * out.stride(0)
    Vt = tf32_split(V, off, conj=trans)          # the plain pre-pass
    b_pad = Vt.shape[2]
    A = H[col0:col0 + b, :].T if trans else H[:, col0:col0 + b]
    m = A.shape[0]
    parts = []
    for X in (A.real, A.imag):
        P = torch.zeros((m, b_pad), dtype=torch.float32)
        P[:, off:off + b] = X
        parts.append(P)
    parts.insert(0, parts[0] + parts[1])                 # fl(Hr + Hi)
    splits = [(_tf32(P), _tf32(P - _tf32(P))) for P in parts]
    re = torch.zeros((m, k), dtype=torch.float32)
    im = torch.zeros((m, k), dtype=torch.float32)
    for t0 in range(0, b + off, BK_C64):
        sl = slice(t0, t0 + BK_C64)
        kk = []
        for c, (Ah, Al) in enumerate(splits):
            Bh = Vt[2 * c, :k, sl].T.double()
            Bl = Vt[2 * c + 1, :k, sl].T.double()
            ah, al = Ah[:, sl].double(), Al[:, sl].double()
            kk.append((al @ Bh + ah @ Bl + ah @ Bh).float())
        re = re + (kk[0] - kk[2])
        im = im + (kk[0] + kk[1])
    W = torch.complex(re, -im if trans else im)
    out.copy_(out + W if accumulate else W)


def _emulate_kernel(H, V, col0, out, accumulate, trans=False):
    """The main kernel's arithmetic on the CPU, driven by the wrapper's
    arguments: for c64 :func:`_emulate_c64`; for f32 out (=|+=) H[:, c0 -
    off : c0 - off + b_pad] · (hi + lo)ᵀ over the pre-pass's (w_pad ×
    b_pad) output, H's columns outside [c0, c0 + b) read as zero (the
    first tile's mask and TMA's zero fill past the descriptor's last
    column)."""
    if H.is_complex():
        return _emulate_c64(H, V, col0, out, accumulate, trans)
    m = H.shape[0]
    ldh, c0, off, b_f, k_f, ldw = float_view_args(H, V, col0, out.stride(0))
    assert ldh is not None
    Vt = tf32_split(V, off)                      # the plain pre-pass
    b_pad = Vt.shape[2]
    Hf = torch.as_strided(H, (m, c0 + b_f), (ldh, 1))
    A = torch.zeros((m, b_pad), dtype=torch.float64)
    A[:, off:off + b_f] = Hf[:, c0:].double()
    Wf = (A @ (Vt[0].double() + Vt[1].double()).T)[:, :k_f]
    Of = torch.as_strided(out, (m, k_f), (ldw, 1))
    Of.copy_(Of.double() + Wf if accumulate else Wf)


@pytest.mark.parametrize("trans", [False, True], ids=["untransposed",
                                                     "trans"])
@pytest.mark.parametrize("m,n_cols,b,k,col0", [
    (37, 37, 37, 5, 0),            # odd N, whole H
    (40, 101, 45, 7, 3),           # odd col0: off = 1
    (40, 101, 50, 9, 4),           # even col0
    (21, 64, 17, 1, 47),           # k = 1, odd col0, block up to the edge
], ids=["odd_N", "col0_3", "col0_4", "k1_col0_47"])
def test_c64_3m_emulation_matches_c128(m, n_cols, b, k, col0, trans):
    """The 3M arithmetic from the wrapper's arguments against a c128
    product: within RTOL of the largest entry and 4× the plain c64
    product's error; the wrapper's own CPU route (the plain version) too.
    With ``trans`` H is (n_cols × m) and the product H[col0:col0+b, :]ᴴ·V,
    the trans route's."""
    rng = np.random.default_rng(m + b + col0 + 7 * trans)
    rows, cols = (n_cols, m) if trans else (m, n_cols)
    H = padded_empty(rows, torch.complex64, "cpu", cols)
    H.copy_(torch.from_numpy(_crandn(rng, rows, cols)))
    assert H.stride(0) % 2 == 0 and tma_row_stride(H) == 2 * H.stride(0)
    V = torch.from_numpy(_crandn(rng, b, k))
    Hb = H[col0:col0 + b, :].mH if trans else H[:, col0:col0 + b]
    ref = (Hb.to(torch.complex128) @ V.to(torch.complex128)).numpy()
    errp = _rel((Hb @ V).numpy(), ref)
    out = torch.full((m, k), np.nan, dtype=torch.complex64)
    _emulate_kernel(H, V, col0, out, accumulate=False, trans=trans)
    err = _rel(out.numpy(), ref)
    assert err <= RTOL and err <= 4 * errp, (err, errp)
    assert _rel(ring_hemm(H, V, col0=col0, trans=trans).numpy(),
                ref) <= RTOL


def _c64_tile_row(L):
    """csrc/ring_hemm.cu's c64r::tile_row<0>."""
    return (L & ~7) | ((L & 3) << 1) | ((L >> 2) & 1)


def test_c64_tile_permutation_reads_each_element_conflict_free():
    """The c64 kernel's untransposed A tile (csrc/ring_hemm.cu, load_a):
    one TMA box of 128 H rows × 16 complex (128 bytes), 128-byte swizzled,
    read as (re, im) pairs with 8-byte loads.  For every warp, k-step ks
    and fragment register v, each lane's two words are H(tile_row(L),
    complex column 8 ks + 4 (v >> 1) + lane % 4) — the words the kernel
    computes from a per-thread base and XOR key and a constant per
    register —, tile_row is a bijection of the 128 rows, and each
    half-warp's 32 words lie on 32 distinct banks."""
    assert sorted(_c64_tile_row(L) for L in range(128)) == list(range(128))
    where = {}
    for r in range(128):
        for f in range(32):
            word = r * 32 + ((f >> 2) ^ (r & 7)) * 4 + (f & 3)
            where[word] = (r, f // 2, f % 2)
    for wg, warp, ks, v in np.ndindex(2, 4, 2, 4):
        banks = [set(), set()]
        for lane in range(32):
            q, hv = lane % 4, v >> 1
            L = 64 * wg + 16 * warp + lane // 4 + 8 * (v & 1)
            P = _c64_tile_row(L)
            base = P * 32 + 2 * (q & 1)
            key = ((q >> 1) ^ (P & 7)) << 2
            i = base + (key ^ ((4 * ks + 2 * hv) << 2))
            assert i % 2 == 0
            for e in range(2):
                assert where[i + e] == (P, 8 * ks + 4 * hv + q, e)
                banks[lane // 16].add((i + e) % 32)
        assert [len(b) for b in banks] == [32, 32]


def test_c64_strided_window_accumulates_into_strided_out():
    """The solver's view: V a column window of the (N, nev+nex) block,
    out a window of a wider block; accumulate adds and the rest of the
    block is untouched."""
    rng = np.random.default_rng(20)
    N = 75
    H = padded_empty(N, torch.complex64, "cpu")
    H.copy_(torch.from_numpy(_crandn(rng, N, N)))
    Vfull = torch.from_numpy(_crandn(rng, N, 30))
    V = Vfull[:, 4:19]
    ref = (H.to(torch.complex128) @ V.to(torch.complex128)).numpy()
    for route in ("wrapper", "emulated"):
        Wfull = torch.from_numpy(_crandn(rng, N, 40))
        before = Wfull.clone()
        out = Wfull[:, 11:26]
        if route == "wrapper":
            ring_hemm(H, V, out=out, accumulate=True)
        else:
            _emulate_kernel(H, V, 0, out, accumulate=True)
        assert _rel(out.numpy(), before[:, 11:26].numpy() + ref) <= RTOL
        assert torch.equal(Wfull[:, :11], before[:, :11])
        assert torch.equal(Wfull[:, 26:], before[:, 26:])


def test_f32_kernel_emulation_matches_the_plain_version():
    """The same emulation on the f32 route (float arguments = element
    arguments)."""
    rng = np.random.default_rng(21)
    H = padded_empty(90, torch.float32, "cpu")
    H.copy_(torch.from_numpy(rng.standard_normal((90, 90)).astype(
        np.float32)))
    V = torch.from_numpy(rng.standard_normal((50, 13)).astype(np.float32))
    out = torch.empty((90, 13))
    _emulate_kernel(H, V, 33, out, accumulate=False)
    ref = H[:, 33:83].double() @ V.double()
    assert _rel(out.numpy(), ref.numpy()) <= RTOL
    assert float_view_args(H, V, 33, 13)[:3] == (92, 33, 1)


# ---- the c64 ring filter ------------------------------------------------------

def _col_rel(Y, ref):
    num = np.abs(Y - ref).max(axis=0)
    den = np.maximum(np.abs(ref).max(axis=0), np.finfo(np.float64).tiny)
    return float((num / den).max())


@pytest.mark.parametrize("deg_max", [8, 5], ids=["even", "odd"])
def test_c64_ring_filter_matches_jax_filter(deg_max):
    N, k = 160, 20
    H = random_hermitian(N, np.complex64, seed=4)
    X = _crandn(np.random.default_rng(5), N, k)
    w = np.linalg.eigvalsh(H.astype(np.complex128))
    lam1, lo, up = float(w[0]), float(w[k]), float(w[-1])
    degrees = np.full(k, deg_max, np.int32)
    degrees[:3] = 0                        # locked / padding columns
    degrees[3:8] = 2                       # retired early
    degrees[8:10] = 1
    Yj = np.asarray(j_filter(jnp.asarray(H), jnp.asarray(X),
                             jnp.asarray(degrees), lam1, lo, up,
                             jnp.int32(deg_max)))
    Yt = tring.chebyshev_filter_ring_pallas(
        torch.from_numpy(H), torch.from_numpy(X), degrees, lam1, lo, up,
        deg_max)
    assert Yt.dtype == torch.complex64
    Yt = Yt.numpy()
    assert _col_rel(Yt[:, 3:], Yj[:, 3:]) <= RTOL
    np.testing.assert_array_equal(Yt[:, :3], X[:, :3])


# ---- DenseOperator layout -----------------------------------------------------

@pytest.mark.parametrize("case", ["cpu_contiguous", "rule_odd_n",
                                  "rule_even_n", "c128_contiguous",
                                  "odd_stride_refused"])
def test_c64_operator_layout_rule(case):
    """A CUDA c64 operator gets an even row stride (its float view's is a
    multiple of 4 floats, as TMA needs); the rule is checked here on CPU
    tensors.  On the CPU a c64 operator is stored contiguous."""
    if case == "cpu_contiguous":
        H = random_hermitian(33, np.complex64)
        op = ct.DenseOperator(H, device="cpu")
        assert op.dtype == torch.complex64 and op.H.is_contiguous()
        assert op.H.stride() == (33, 1)
    elif case == "rule_odd_n":
        H = padded_empty(1001, torch.complex64, "cpu")
        assert H.shape == (1001, 1001) and H.stride() == (1002, 1)
        assert tma_row_stride(H) == 2004 == tma_ld(2 * 1001)
    elif case == "rule_even_n":
        H = padded_empty(1000, torch.complex64, "cpu")
        assert H.is_contiguous() and tma_row_stride(H) == 2000
    elif case == "c128_contiguous":
        H = padded_empty(1001, torch.complex128, "cpu")
        assert H.is_contiguous()
    else:
        assert tma_row_stride(torch.zeros((7, 7),
                                          dtype=torch.complex64)) is None
        assert float_view_args(torch.zeros((7, 7), dtype=torch.complex64),
                               torch.zeros((7, 2), dtype=torch.complex64),
                               0, 2)[0] is None


@pytest.mark.parametrize("backend", ["native", "real_pair"])
def test_complex_backend_is_a_logged_no_op(c64_case, backend, capsys,
                                           monkeypatch):
    """The port is native complex: ``complex_backend`` (the JAX package's
    switch to the 2N real-pair embedding) is logged and changes nothing."""
    from chase_tpu_torch.logger import LEVELS, get_logger
    H, V0, _ = c64_case
    monkeypatch.setattr(get_logger(), "level", LEVELS["info"])
    base = ct.eigsh(H, 12, 8, tol=1e-3, v0=V0, device="cpu")
    capsys.readouterr()
    rt = ct.eigsh(H, 12, 8, tol=1e-3, v0=V0, device="cpu",
                  config=ct.ChaseConfig(complex_backend=backend))
    assert f"complex_backend={backend!r} is a no-op" in capsys.readouterr().err
    np.testing.assert_array_equal(rt.ritzv, base.ritzv)
    assert rt.V.dtype == torch.complex64
