"""Complex Hermitian problems: the port (native c64/c128) against the JAX
package.

The JAX package solves complex problems natively on the CPU, or through
its 2N real-pair embedding (``complex_backend="real_pair"``), the only
route on which its Pallas ring kernel sees complex data.  The port is
native complex everywhere; its ring kernel takes c64 through its float
view (``ops/ring_hemm.py``'s module note).

* c128: random Hermitian N=256, nev=24, nex=16, tol 1e-9, same V0,
  against ``chase_tpu.eigsh(complex_backend="native")``: eigenvalues
  within 1e-8 of each other and of eigvalsh.
* c64 ring path: N=128, nev=12, nex=8, tol 1e-3; the port's p=1 ring
  (every HEMM through the c64 ``ring_hemm`` wrapper, its plain version on
  the CPU) against JAX's real-pair Pallas ring on a (2, 1) grid (TPU
  interpreter): eigenvalues within 1e-4 of each other and of eigvalsh,
  true residuals ≤ 10·tol.
* the real-view identity on the plain versions, and the main kernel's
  arithmetic emulated on the CPU from the wrapper's float arguments:
  1e-5 of the largest entry (f32 sums in another order than a c128
  product).
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
from chase_tpu_torch.ops.ring_hemm import (float_view_args, real_rows,
                                           ring_hemm, ring_hemm_reference,
                                           split_shape, tf32_split,
                                           tf32_split_reference, tma_ld,
                                           tma_row_stride)
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
    real = tring.ring_hemm

    def counting(Hm, V, **kw):
        calls.append(V.dtype)
        return real(Hm, V, **kw)

    monkeypatch.setattr(tring, "ring_hemm", counting)
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


# ---- the real-view identity --------------------------------------------------

def _split_np(x):
    """TF32 hi/lo by bit arithmetic (cvt.rna: half a TF32 ulp, clear 13
    bits)."""
    def tf32(a):
        bits = np.asarray(a, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000))
                & np.uint32(0xFFFFE000)).view(np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


@pytest.mark.parametrize("off", [0, 2])
def test_c64_split_plain_version_is_the_written_out_expansion(off):
    rng = np.random.default_rng(10 + off)
    Vw = torch.from_numpy(_crandn(rng, 21, 70))[:, 3:68]  # strided window
    V = Vw.numpy()
    b, k = V.shape
    B = np.empty((2 * b, 2 * k), np.float32)
    for j in range(b):
        for c in range(k):
            re, im = V[j, c].real, V[j, c].imag
            B[2 * j, 2 * c], B[2 * j, 2 * c + 1] = re, im
            B[2 * j + 1, 2 * c], B[2 * j + 1, 2 * c + 1] = -im, re
    Vt = tf32_split(Vw, off)
    assert tuple(Vt.shape) == (2, *split_shape(2 * b, 2 * k, off)[::-1])
    hi, lo = _split_np(B)
    np.testing.assert_array_equal(Vt[0, :2 * k, off:off + 2 * b].numpy(),
                                  hi.T)
    np.testing.assert_array_equal(Vt[1, :2 * k, off:off + 2 * b].numpy(),
                                  lo.T)
    zero = torch.ones_like(Vt, dtype=torch.bool)
    zero[:, :2 * k, off:off + 2 * b] = False
    assert not Vt[zero].any()
    assert torch.equal(Vt, tf32_split_reference(Vw.contiguous(), off))


def _float_view(H):
    """H's storage as floats (the f32 kernel's view of a c64 H)."""
    return torch.view_as_real(H) if H.is_complex() else H


def _emulate_kernel(H, V, col0, out, accumulate):
    """The main kernel's arithmetic on the CPU, driven by the wrapper's
    float arguments: out_f (=|+=) Hf[:, c0 - off : c0 - off + b_pad] ·
    (hi + lo)ᵀ over the pre-pass's (w_pad × b_pad) output, Hf's columns
    outside [c0, c0 + b_f) read as zero (the first tile's mask and TMA's
    zero fill past the descriptor's last column)."""
    m = H.shape[0]
    ldh, c0, off, b_f, k_f, ldw = float_view_args(H, V, col0, out.stride(0))
    assert ldh is not None
    Vt = tf32_split(V, off)                      # the plain pre-pass
    b_pad = Vt.shape[2]
    Hf = torch.as_strided(_float_view(H), (m, c0 + b_f), (ldh, 1))
    koff = c0 % 4          # the kernel's own shift (ring_hemm_f32: col0 % 4)
    A = torch.zeros((m, b_pad), dtype=torch.float64)
    A[:, koff:koff + b_f] = Hf[:, c0:].double()
    Wf = (A @ (Vt[0].double() + Vt[1].double()).T)[:, :k_f]
    Of = torch.as_strided(_float_view(out), (m, k_f), (ldw, 1))
    Of.copy_(Of.double() + Wf if accumulate else Wf)


@pytest.mark.parametrize("m,n_cols,b,k,col0", [
    (37, 37, 37, 5, 0),            # odd N, whole H
    (40, 101, 45, 7, 3),           # odd col0: float column ≡ 2 (mod 4)
    (40, 101, 50, 9, 4),           # even col0
    (21, 64, 17, 1, 47),           # k = 1, odd col0, block up to the edge
], ids=["odd_N", "col0_3", "col0_4", "k1_col0_47"])
def test_c64_real_view_identity(m, n_cols, b, k, col0):
    rng = np.random.default_rng(m + b + col0)
    H = padded_empty(n_cols, torch.complex64, "cpu")[:m]
    H.copy_(torch.from_numpy(_crandn(rng, m, n_cols)))
    assert H.stride(0) % 2 == 0 and tma_row_stride(H) == 2 * H.stride(0)
    V = torch.from_numpy(_crandn(rng, b, k))
    ref = (H[:, col0:col0 + b].to(torch.complex128)
           @ V.to(torch.complex128)).numpy()
    # the plain f32 product of the float view with B, viewed as c64
    Hf = torch.view_as_real(H.contiguous()).flatten(1)
    Wf = ring_hemm_reference(Hf, real_rows(V), col0=2 * col0)
    W = torch.view_as_complex(Wf.reshape(m, k, 2).contiguous())
    assert _rel(W.numpy(), ref) <= RTOL
    # the kernel's arithmetic from the wrapper's float arguments
    out = torch.full((m, k), np.nan, dtype=torch.complex64)
    _emulate_kernel(H, V, col0, out, accumulate=False)
    assert _rel(out.numpy(), ref) <= RTOL
    # and the wrapper's own CPU route (the plain version)
    assert _rel(ring_hemm(H, V, col0=col0).numpy(), ref) <= RTOL


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
