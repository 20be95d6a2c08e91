"""The port's ring HEMM (chase_tpu_torch/ops/ring_hemm.py) against the JAX
package's Pallas ring kernel (chase_tpu/ops/pallas_ring.py), run in the
TPU interpreter as the JAX package's own tests run it off-TPU.

On the CPU the wrapper takes its plain version; the CUDA kernel itself is
checked by the ``gpu``-marked tests at the end (and by chip_smoke.py).
Tolerance: the JAX kernel and torch.matmul are both f32 dots with f32
accumulation in different orders, so 1e-5 relative to the largest entry.

The card's kernel multiplies in 3xTF32 on the tensor cores; the CPU tests
in the middle emulate that numerical design (the split by bit arithmetic,
the three-term product) so it is documented and checked without a card.

JAX is imported only by the parity tests (the ``jx`` fixture), so the
card-only tests also run where JAX is not installed:

    python -m pytest tests/test_torch_ring_hemm.py -m gpu --noconftest
"""

import types

import numpy as np
import pytest
import torch

from chase_tpu_torch.ops.ring_hemm import (LAUNCHES, bf16_pack,
                                           bf16_pack_reference, pack_shape,
                                           ring_hemm, ring_hemm_reference,
                                           split_shape,
                                           tf32_split, tf32_split_reference,
                                           tma_ld, tma_row_stride)
from chase_tpu_torch.parallel.operator import padded_empty

torch.set_num_threads(1)

SHAPES = [(128, 32), (200, 37)]
RTOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    import chase_tpu
    from chase_tpu.ops.pallas_ring import make_hemm_local, pallas_ring_hemm
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, shard_map=shard_map, Mesh=Mesh, P=P,
        make_grid=chase_tpu.make_grid, make_hemm_local=make_hemm_local,
        pallas_ring_hemm=pallas_ring_hemm)


def _inputs(N, k, seed=0, cols=None):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((N, cols or N)).astype(np.float32)
    V = rng.standard_normal((cols or N, k)).astype(np.float32)
    return H, V


def _rel(a, ref):
    return float(np.abs(np.asarray(a) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("N,k", SHAPES, ids=["128x32", "200x37"])
def test_matches_jax_pallas_ring_hemm_one_device(jx, N, k):
    H, V = _inputs(N, k)
    grid = jx.make_grid(jx.jax.devices()[:1], shape=(1, 1))
    Wj = np.asarray(jx.pallas_ring_hemm(grid, jx.jnp.asarray(H),
                                        jx.jnp.asarray(V), interpret=True))
    Wt = ring_hemm(torch.from_numpy(H), torch.from_numpy(V))
    assert Wt.dtype == torch.float32 and tuple(Wt.shape) == (N, k)
    assert _rel(Wt.numpy(), Wj) <= RTOL


@pytest.mark.parametrize("N,k", SHAPES, ids=["128x32", "200x37"])
def test_matches_jax_make_hemm_local_p1(jx, N, k):
    H, V = _inputs(N, k, seed=1)
    mesh = jx.Mesh(np.asarray(jx.jax.devices()[:1]), ("r",))
    local = jx.make_hemm_local(1, "r", N, N, k, jx.jnp.float32,
                               jx.jnp.float32, interpret=True)
    spec = jx.P("r", None)
    fn = jx.shard_map(local, mesh=mesh, in_specs=(spec, spec),
                      out_specs=spec, check_vma=False)
    Wj = np.asarray(fn(jx.jnp.asarray(H), jx.jnp.asarray(V)))
    Wt = ring_hemm(torch.from_numpy(H), torch.from_numpy(V)).numpy()
    assert _rel(Wt, Wj) <= RTOL


def test_accumulate_two_chunks_matches_jax_p2_ring(jx):
    """Ring semantics: chunk 0 stored (col0=0), chunk 1 added (col0=b) —
    the TPU kernel's s == 0 / s > 0 steps — equals the JAX p=2 ring."""
    N, k = 128, 32
    H, V = _inputs(N, k, seed=2)
    grid = jx.make_grid(jx.jax.devices()[:2], shape=(2, 1))
    Hs = jx.jax.device_put(jx.jnp.asarray(H), grid.sharding("r", None))
    Vs = jx.jax.device_put(jx.jnp.asarray(V), grid.sharding("r", None))
    Wj = np.asarray(jx.pallas_ring_hemm(grid, Hs, Vs, interpret=True))
    Ht, Vt = torch.from_numpy(H), torch.from_numpy(V)
    b = N // 2
    W = ring_hemm(Ht, Vt[:b], col0=0)
    out = ring_hemm(Ht, Vt[b:], col0=b, out=W, accumulate=True)
    assert out is W
    assert _rel(W.numpy(), Wj) <= RTOL


def test_windows_and_accumulate_into_prefilled_out():
    """V and out as column windows of wider blocks (row stride > width);
    accumulate adds into out and leaves the rest of the block alone."""
    N = 96
    rng = np.random.default_rng(3)
    H = torch.from_numpy(rng.standard_normal((N, N)).astype(np.float32))
    Vfull = torch.from_numpy(rng.standard_normal((N, 50)).astype(np.float32))
    Wfull = torch.from_numpy(rng.standard_normal((N, 50)).astype(np.float32))
    before = Wfull.clone()
    ring_hemm(H, Vfull[:, 10:27], out=Wfull[:, 10:27], accumulate=True)
    ref = before[:, 10:27].double() + H.double() @ Vfull[:, 10:27].double()
    assert _rel(Wfull[:, 10:27].numpy(), ref.numpy()) <= RTOL
    assert torch.equal(Wfull[:, :10], before[:, :10])
    assert torch.equal(Wfull[:, 27:], before[:, 27:])
    # overwrite (accumulate=False) ignores out's old contents
    ring_hemm(H, Vfull[:, 10:27], out=Wfull[:, 10:27])
    assert _rel(Wfull[:, 10:27].numpy(),
                (H.double() @ Vfull[:, 10:27].double()).numpy()) <= RTOL


def test_cpu_uses_plain_version_without_counting():
    H, V = _inputs(64, 8, seed=4)
    before = LAUNCHES["ring_hemm"]
    Wt = ring_hemm(torch.from_numpy(H), torch.from_numpy(V))
    assert LAUNCHES["ring_hemm"] == before
    np.testing.assert_array_equal(
        Wt.numpy(), ring_hemm_reference(torch.from_numpy(H),
                                        torch.from_numpy(V)).numpy())


@pytest.mark.parametrize("case", ["f64", "complex", "c128", "c64_f32_out",
                                  "col_stride", "out_shape", "acc_no_out",
                                  "col0_range", "ndim", "devices", "bf16_v",
                                  "bf16_h_bf16_out", "f32_h_bf16_v"])
def test_rejects_what_the_kernel_does_not_take(case):
    H = torch.zeros((16, 16))
    V = torch.zeros((16, 4))
    kw = {}
    err = ValueError
    if case.startswith("bf16"):                  # a bf16 H takes f32 V, out
        H, err = H.to(torch.bfloat16), TypeError
    if case == "bf16_v":
        V = V.to(torch.bfloat16)
    elif case == "bf16_h_bf16_out":
        kw = dict(out=torch.zeros((16, 4), dtype=torch.bfloat16))
    elif case == "f32_h_bf16_v":
        V, err = V.to(torch.bfloat16), TypeError
    elif case == "f64":
        H, V, err = H.double(), V.double(), TypeError
    elif case == "complex":                      # mixed f32 H, c64 V
        V, err = V.to(torch.complex64), TypeError
    elif case == "c128":
        H, V = H.to(torch.complex128), V.to(torch.complex128)
        err = TypeError
    elif case == "c64_f32_out":
        H, V = H.to(torch.complex64), V.to(torch.complex64)
        kw, err = dict(out=torch.zeros((16, 4))), TypeError
    elif case == "col_stride":
        V = torch.zeros((4, 16)).T                 # column stride 16
    elif case == "out_shape":
        kw = dict(out=torch.zeros((16, 5)))
    elif case == "acc_no_out":
        kw = dict(accumulate=True)
    elif case == "col0_range":
        kw = dict(col0=1)
    elif case == "ndim":
        V = torch.zeros(16)
    elif case == "devices":
        V = torch.zeros((16, 4), device="meta")
    with pytest.raises(err):
        ring_hemm(H, V, **kw)


def test_non_cpu_non_cuda_tensor_raises_instead_of_falling_back():
    H = torch.zeros((16, 16), device="meta")
    V = torch.zeros((16, 4), device="meta")
    with pytest.raises(RuntimeError):
        ring_hemm(H, V)


def _lazy_views():
    """c64 H, V and out, and their lazy views: V.conj() (conjugate bit)
    and X.conj().imag (a float32 view with the negative bit), which share
    the unconjugated data a kernel would read through data_ptr()."""
    g = torch.Generator().manual_seed(3)
    H = torch.randn((16, 16), generator=g, dtype=torch.complex64)
    V = torch.randn((16, 4), generator=g, dtype=torch.complex64)
    neg = V.conj().imag
    assert V.conj().is_conj() and neg.is_neg()
    assert V.conj().data_ptr() == V.data_ptr()
    return H, V, neg


@pytest.mark.parametrize("case", ["V_conj", "H_conj", "out_conj", "V_neg",
                                  "out_neg", "bf16_V_neg"])
def test_ring_hemm_refuses_lazy_conj_and_neg_views(case):
    """A lazy view raises ValueError on the CPU too (the plain version
    would honour the bit; the card's kernel would not), before any
    launch."""
    H, V, neg = _lazy_views()
    Hf = H.real.contiguous()
    args, kw = {
        "V_conj": ((H, V.conj()), {}),
        "H_conj": ((H.conj(), V), {}),
        "out_conj": ((H, V), dict(out=torch.zeros_like(V).conj())),
        "V_neg": ((Hf, neg), {}),
        "out_neg": ((Hf, V.real.contiguous()), dict(out=neg)),
        "bf16_V_neg": ((Hf.to(torch.bfloat16), neg), {}),
    }[case]
    before = LAUNCHES["ring_hemm"]
    with pytest.raises(ValueError, match="lazy conjugate or negative"):
        ring_hemm(*args, **kw)
    assert LAUNCHES["ring_hemm"] == before
    # resolving the bit is all it takes
    fixed = [a.resolve_conj().resolve_neg() for a in args]
    if "out" in kw:
        kw = dict(out=kw["out"].resolve_conj().resolve_neg())
    ring_hemm(*fixed, **kw)


def test_prepasses_refuse_lazy_conj_and_neg_views():
    _, V, neg = _lazy_views()
    for fn, bad in ((tf32_split, V.conj()), (tf32_split, neg),
                    (bf16_pack, neg)):
        with pytest.raises(ValueError, match="lazy conjugate or negative"):
            fn(bad)
        fn(bad.resolve_conj().resolve_neg())


def test_dense_operator_copies_a_conj_view():
    """A c64 operator given as H.conj() is materialized (its own data, no
    conj bit), so the ring product uses the conjugated matrix."""
    from chase_tpu_torch import DenseOperator
    H, V, _ = _lazy_views()
    op = DenseOperator(H.conj(), "cpu")
    assert not op.H.is_conj() and op.H.data_ptr() != H.data_ptr()
    assert torch.equal(op.H, H.conj().resolve_conj())
    W = ring_hemm(op.H, V)
    ref = H.to(torch.complex128).conj() @ V.to(torch.complex128)
    assert float((W.to(torch.complex128) - ref).abs().max()
                 / ref.abs().max()) <= RTOL
    # a resident operator without the bit is still used as is
    assert DenseOperator(H, "cpu").H is H
    assert not DenseOperator(H.conj(), "cpu", pseudo_hermitian=True) \
        .place_block(V.conj()).is_conj()


# ---- 3xTF32, emulated on the CPU -------------------------------------------

def _tf32_np(x):
    """Round f32 to TF32 (10-bit mantissa), nearest, ties away from zero —
    cvt.rna.tf32.f32 — on the sign-magnitude bits: add half a TF32 ulp,
    clear the 13 dropped bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split_np(x):
    hi = _tf32_np(x)
    return hi, _tf32_np(x - hi)          # x - hi is exact in f32


def test_tf32_split_rebuilds_x_to_2_pow_minus_22():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(20000)
         * 10.0 ** rng.uniform(-6, 6, 20000)).astype(np.float32)
    hi, lo = _split_np(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()      # 10-bit mantissas
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    x64 = x.astype(np.float64)
    assert np.all(np.abs(hi - x64) <= 2.0 ** -11 * np.abs(x64))
    rebuilt = hi.astype(np.float64) + lo.astype(np.float64)
    assert np.all(np.abs(rebuilt - x64) <= 2.0 ** -22 * np.abs(x64))


def _rna_f64(x: np.float32) -> float:
    """x rounded to 11 significant bits (TF32), nearest with ties away from
    zero, in f64 arithmetic, then to f32 (a rounding past FLT_MAX is inf);
    below 2^-126 on TF32's subnormal step, 2^-136."""
    v = float(x)
    if v == 0.0 or not np.isfinite(v):
        return v
    step = 2.0 ** (max(np.frexp(abs(v))[1], -125) - 11)
    with np.errstate(over="ignore"):
        return float(np.float32(np.copysign(
            np.floor(abs(v) / step + 0.5) * step, v)))


SPLIT_EDGES = {
    "tie_pos": 0x3F801000, "tie_neg": 0xBF801000,
    "tie_carries_to_2": 0x3FFFF000, "tie_neg_large": 0xC7001000,
    "zero": 0x00000000, "neg_zero": 0x80000000,
    "subnormal_min": 0x00000001, "subnormal_tie": 0x00001000,
    "subnormal_max": 0x007FFFFF, "neg_subnormal": 0x80003001,
    "flt_max": 0x7F7FFFFF, "neg_flt_max": 0xFF7FFFFF,
    "inf": 0x7F800000, "neg_inf": 0xFF800000,
    "nan_all_bits": 0x7FFFFFFF, "neg_nan_all_bits": 0xFFFFFFFF,
    "nan_quiet": 0x7FC00000, "nan_signalling": 0x7F800001,
}


@pytest.mark.parametrize("name", list(SPLIT_EDGES))
def test_tf32_split_plain_version_edge_values(name):
    """The plain split (the kernel's integer rounding, its NaN guard on the
    remainder) at ties, zeros, subnormals, FLT_MAX, infinities and NaNs of
    both signs with every mantissa bit set: hi is x rounded half away from
    zero to TF32, hi + lo holds x to 2^-22 (plus half TF32's subnormal
    step), an inf keeps hi and gets a NaN lo, and a NaN stays a NaN in hi
    or lo — 0x7FFFFFFF + 0x1000 carries to −0 and 0xFFFFFFFF to +0."""
    from chase_tpu_torch.ops.ring_hemm import _split_tf32
    x = np.array([SPLIT_EDGES[name]], np.uint32).view(np.float32)
    hi, lo = (t.numpy() for t in _split_tf32(torch.from_numpy(x)))
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    if np.isnan(x[0]):
        assert np.isnan(hi[0]) or np.isnan(lo[0])
    elif np.isinf(x[0]):
        assert hi[0] == x[0] and np.isnan(lo[0])
    else:
        assert float(hi[0]) == _rna_f64(x[0])
        if np.isfinite(hi[0]):
            x64 = float(x[0])
            err = abs(float(hi[0]) + float(lo[0]) - x64)
            assert err <= 2.0 ** -22 * abs(x64) + 2.0 ** -137
        else:
            assert lo[0] == -hi[0]      # FLT_MAX rounds to inf, lo to -inf


def test_3xtf32_product_within_4x_of_f32_matmul_at_k4096():
    """lo·Vhi + hi·Vlo + hi·Vhi (small terms first, lo·lo dropped) in f32
    stays within 4x of torch.matmul's own f32 error against f64, as the
    card's gate asks; one TF32 pass alone is ~100x worse."""
    rng = np.random.default_rng(6)
    H = rng.standard_normal((64, 4096)).astype(np.float32)
    V = rng.standard_normal((4096, 48)).astype(np.float32)
    ref = H.astype(np.float64) @ V.astype(np.float64)
    (Hh, Hl), (Vh, Vl) = _split_np(H), _split_np(V)
    t = {n: torch.from_numpy(a) for n, a in
         dict(H=H, V=V, Hh=Hh, Hl=Hl, Vh=Vh, Vl=Vl).items()}
    small = t["Hl"] @ t["Vh"] + t["Hh"] @ t["Vl"]
    w3 = (small + t["Hh"] @ t["Vh"]).numpy()
    err3 = _rel(w3, ref)
    errp = _rel((t["H"] @ t["V"]).numpy(), ref)
    err1 = _rel((t["Hh"] @ t["Vh"]).numpy(), ref)
    assert err3 <= 4 * errp
    assert err1 >= 100 * errp


@pytest.mark.parametrize("off", [0, 3])
def test_tf32_split_plain_version_layout(off):
    """The pre-pass's plain version: Vᵀ split into hi/lo, K-major, starting
    at column ``off``, zero-padded to whole tiles; bit-identical to the
    emulation above."""
    rng = np.random.default_rng(7 + off)
    V = rng.standard_normal((45, 130)).astype(np.float32)
    Vt = tf32_split(torch.from_numpy(V)[:, :129], off)     # CPU: plain
    b_pad, w_pad = split_shape(45, 129, off)
    assert (b_pad, w_pad) == (64, 256) and tuple(Vt.shape) == (2, 256, 64)
    hi, lo = _split_np(V[:, :129])
    np.testing.assert_array_equal(Vt[0, :129, off:off + 45].numpy(), hi.T)
    np.testing.assert_array_equal(Vt[1, :129, off:off + 45].numpy(), lo.T)
    zero = torch.ones_like(Vt, dtype=torch.bool)
    zero[:, :129, off:off + 45] = False
    assert not Vt[zero].any()
    with pytest.raises(ValueError):
        tf32_split(torch.from_numpy(V), 4)


@pytest.mark.parametrize("case", ["padded", "f64_not_padded",
                                  "contiguous_n1001", "unaligned_base",
                                  "one_row", "bf16_padded", "bf16_stride_1004",
                                  "bf16_one_row"])
def test_tma_row_stride_rule(case):
    """What the wrapper demands of a CUDA H, and what DenseOperator pads an
    f32 CUDA H to (checked here on CPU tensors, the rule is the same):
    16-byte base, row stride a multiple of 4 floats — of 8 elements for a
    bf16 H (the bf16 shadow), so a stride of 1004 that f32 takes is not
    enough.  An f64 operator never reaches the kernel and is stored
    contiguous."""
    if case == "bf16_padded":
        H = padded_empty(1001, torch.bfloat16, "cpu")
        assert H.shape == (1001, 1001) and H.stride() == (1008, 1)
        assert tma_row_stride(H) == 1008 == tma_ld(1001, 2)
    elif case == "bf16_stride_1004":
        assert tma_row_stride(torch.zeros((4, 1004),
                                          dtype=torch.bfloat16)) is None
    elif case == "bf16_one_row":
        assert tma_row_stride(torch.zeros((1, 7), dtype=torch.bfloat16)) == 8
    elif case == "padded":
        H = padded_empty(1001, torch.float32, "cpu")
        assert H.shape == (1001, 1001) and H.stride() == (1004, 1)
        assert tma_row_stride(H) == 1004 == tma_ld(1001)
    elif case == "f64_not_padded":
        H = padded_empty(1001, torch.float64, "cpu")
        assert H.shape == (1001, 1001) and H.is_contiguous()
    elif case == "contiguous_n1001":
        assert tma_row_stride(torch.zeros((1001, 1001))) is None
    elif case == "unaligned_base":
        assert tma_row_stride(torch.zeros(16 * 20 + 1)[1:].view(16, 20)) \
            is None
    else:
        assert tma_row_stride(torch.zeros((1, 7))) == 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _padded_randn(m, n_cols, g, dev, dtype=torch.float32):
    """(m, n_cols) with the row stride TMA needs (16 bytes: 4 f32, 2 c64 or
    8 bf16 elements)."""
    if dtype == torch.bfloat16:
        return _padded_randn(m, tma_ld(n_cols, 2), g, dev).to(dtype)[
            :, :n_cols]
    w = 2 if dtype.is_complex else 1
    return torch.randn((m, tma_ld(w * n_cols) // w), generator=g, device=dev,
                       dtype=dtype)[:, :n_cols]


def _wide(t):
    """f64 / c128 copy: the exact-product reference's precision."""
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def _check_against_plain(H, V, col0=0):
    before = LAUNCHES["ring_hemm"]
    W = ring_hemm(H, V, col0=col0)
    torch.cuda.synchronize()
    assert LAUNCHES["ring_hemm"] == before + 1
    assert W.dtype == H.dtype
    Hb = H[:, col0:col0 + V.shape[0]]
    ref = _wide(Hb) @ _wide(V)
    err = float((_wide(W) - ref).abs().max() / ref.abs().max())
    errp = float((_wide(ring_hemm_reference(H, V, col0=col0)) - ref)
                 .abs().max() / ref.abs().max())
    assert err <= RTOL and err <= 4 * max(errp, 1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n_cols,k", [(200, 200, 37), (300, 1000, 129),
                                        (130, 17, 3)],
                         ids=["200x37", "ragged300x129", "tiny"])
def test_cuda_kernel_matches_plain_version(cuda, m, n_cols, k):
    """The hand-written kernel against torch.matmul on the card: error vs
    an f64 product within 1e-5 and within 4x the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(m)
    H = _padded_randn(m, n_cols, g, cuda)
    V = torch.randn((n_cols, k), generator=g, device=cuda)
    _check_against_plain(H, V)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n_cols,k,col0,b", [
    (190, 300, 40, 0, 300), (257, 300, 40, 0, 300),
    (130, 256, 13, 0, 256), (130, 256, 1, 0, 256),
    (200, 512, 64, 0, 45), (200, 512, 64, 0, 1),
    (200, 512, 64, 1, 100), (200, 512, 64, 3, 77), (200, 512, 64, 6, 300),
], ids=["m190", "m257", "k13", "k1", "b45", "b1", "col0_1", "col0_3",
        "col0_6"])
def test_cuda_kernel_ragged_edges(cuda, m, n_cols, k, col0, b):
    """m not a multiple of the 64-row wgmma or the 128-row tile, k not a
    multiple of 8, b not a multiple of the 32-deep K tile, and col0 off
    the 16-byte grid TMA's boxes start on."""
    g = torch.Generator(device=cuda).manual_seed(m + k + col0 + b)
    H = _padded_randn(m, n_cols, g, cuda)
    V = torch.randn((b, k), generator=g, device=cuda)
    _check_against_plain(H, V, col0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,k,off", [(1000, 37, 0), (61, 129, 3),
                                     (300, 256, 1)])
def test_cuda_split_prepass(cuda, b, k, off):
    """The pre-pass on the card: bit-identical to its plain version, NaNs
    of either sign with every mantissa bit set in V included (the integer
    rounding carries them into a zero hi; the guard keeps lo a NaN), and
    Vt_hi + Vt_lo rebuilds the finite Vᵀ to 2^-22."""
    g = torch.Generator(device=cuda).manual_seed(b)
    V = torch.randn((b, 3 * k), generator=g, device=cuda)[:, k:2 * k]
    bits = V.view(torch.int32)
    bits[b // 2, 0] = 0x7FFFFFFF
    bits[b - 1, k - 1] = -1                          # 0xFFFFFFFF
    nan = torch.isnan(V)
    before = LAUNCHES["tf32_split"]
    Vt = tf32_split(V, off)
    torch.cuda.synchronize()
    assert LAUNCHES["tf32_split"] == before + 1
    assert torch.equal(Vt.view(torch.int32),
                       tf32_split_reference(V, off).view(torch.int32))
    assert torch.isnan(Vt[1, :k, off:off + b][nan.T]).all()
    rebuilt = (Vt[0] + Vt[1])[:k, off:off + b]
    Vf = V.masked_fill(nan, 0.0)
    assert float((rebuilt.masked_fill(nan.T, 0.0) - Vf.T).abs().max()
                 / Vf.abs().max()) <= 2.0 ** -22


@pytest.mark.gpu
def test_cuda_f32_non_finite_in_and_left_of_the_block(cuda):
    """The f32 twin of the c64 test below: NaNs of either sign with every
    mantissa bit set (bits 0x7FFFFFFF, 0xFFFFFFFF, which the A split's
    integer rounding carries into a zero hi and its guard keeps a NaN in
    lo), torch's NaN and an inf inside the block make their whole row of W
    NaN, on the plain route and the trans route; inf and NaN left of the
    block (col0 = 3: the first K tile starts three columns early), or
    outside the trans route's slab, reach no entry of W."""
    g = torch.Generator(device=cuda).manual_seed(19)
    col0, b = 3, 250
    H = _padded_randn(200, 300, g, cuda)
    bits = H.view(torch.int32)
    H[:, col0 - 1] = float("inf")
    H[::3, col0 - 3] = float("nan")
    bits[::5, col0 - 2] = -1
    bits[5, col0 + 10] = 0x7FFFFFFF
    bits[7, col0 + 20] = -1
    H[9, col0 + 30] = float("nan")
    H[11, col0 + 40] = float("inf")
    V = torch.randn((b, 50), generator=g, device=cuda)
    W = ring_hemm(H, V, col0=col0)
    torch.cuda.synchronize()
    bad = torch.zeros(200, dtype=torch.bool, device=cuda)
    bad[[5, 7, 9, 11]] = True
    assert torch.isnan(W[bad]).all()
    assert torch.isfinite(W[~bad]).all()
    ref = _wide(H[~bad, col0:col0 + b]) @ _wide(V)
    assert float((_wide(W[~bad]) - ref).abs().max() / ref.abs().max()) <= RTOL

    # trans: W = H[row0:row0+b, :]ᴴ · V, so H[row0 + j, c] meets W's row c
    row0, b = 20, 250
    H = _padded_randn(300, 200, g, cuda)
    bits = H.view(torch.int32)
    H[row0 - 1] = float("nan")
    H[row0 + b] = float("inf")
    bits[row0 + 4, 17] = 0x7FFFFFFF
    bits[row0 + 100, 33] = -1
    H[row0 + b - 1, 40] = float("nan")
    H[row0 + 31, 64] = float("-inf")
    V = torch.randn((b, 50), generator=g, device=cuda)
    W = ring_hemm(H, V, col0=row0, trans=True)
    torch.cuda.synchronize()
    bad = torch.zeros(200, dtype=torch.bool, device=cuda)
    bad[[17, 33, 40, 64]] = True
    assert torch.isnan(W[bad]).all()
    assert torch.isfinite(W[~bad]).all()
    ref = _wide(H[row0:row0 + b, ~bad]).mT @ _wide(V)
    assert float((_wide(W[~bad]) - ref).abs().max() / ref.abs().max()) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["stride_67", "unaligned_base"])
def test_cuda_h_that_tma_cannot_read_raises(cuda, case):
    if case == "stride_67":
        H = torch.randn((64, 67), device=cuda)
    else:
        H = torch.randn(64 * 68 + 1, device=cuda)[1:].view(64, 68)
    V = torch.randn((H.shape[1], 8), device=cuda)
    before = LAUNCHES["ring_hemm"]
    with pytest.raises(ValueError, match="TMA"):
        ring_hemm(H, V)
    assert LAUNCHES["ring_hemm"] == before


@pytest.mark.gpu
def test_cuda_dense_operator_pads_n1001_and_eigsh_runs_on_the_kernel(cuda):
    """DenseOperator stores an N=1001 H with row stride 1004, so the f32
    ring-path eigsh reaches the kernel without a copy and converges."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement, clement_eigenvalues
    op = ct.DenseOperator(clement(1001).astype(np.float32), device=cuda)
    assert op.H.shape == (1001, 1001) and op.H.stride() == (1004, 1)
    LAUNCHES.clear()
    res = ct.eigsh(op, 40, 20, tol=1e-2, collect_perf=True,
                   config=ct.ChaseConfig(ring_backend="pallas"))
    assert res.converged
    assert LAUNCHES["ring_hemm"] == res.perf.filter_hemm_steps > 0
    # f32 at ‖H‖ = 1000: residual tol 1e-2, eigenvalues to ~1e-4·‖H‖
    assert np.abs(res.ritzv - clement_eigenvalues(1001)[:40]).max() <= 0.1


@pytest.mark.gpu
def test_cuda_dense_operator_keeps_f64_as_given(cuda):
    """Only f32 operators are padded: an f64 CUDA H (it never reaches the
    kernel) is used as is when resident, and copied contiguous otherwise."""
    import chase_tpu_torch as ct
    H = torch.randn((1001, 1001), dtype=torch.float64, device=cuda)
    assert ct.DenseOperator(H, device=cuda).H is H
    op = ct.DenseOperator(H.cpu().numpy(), device=cuda)
    assert op.H.is_contiguous() and op.H.stride() == (1001, 1)


@pytest.mark.gpu
def test_cuda_kernel_windows_and_accumulate(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    H = torch.randn((300, 1000), generator=g, device=cuda)
    Vfull = torch.randn((1000, 50), generator=g, device=cuda)
    Wfull = torch.randn((300, 50), generator=g, device=cuda)
    before = Wfull.clone()
    ring_hemm(H, Vfull[:, 5:30], out=Wfull[:, 5:30], accumulate=True)
    W2 = ring_hemm(H[:, 400:], Vfull[:600, :7], col0=0)
    torch.cuda.synchronize()
    ref = before[:, 5:30].double() + H.double() @ Vfull[:, 5:30].double()
    assert float((Wfull[:, 5:30].double() - ref).abs().max()
                 / ref.abs().max()) <= RTOL
    assert torch.equal(Wfull[:, :5], before[:, :5])
    assert torch.equal(Wfull[:, 30:], before[:, 30:])
    ref2 = H[:, 400:].double() @ Vfull[:600, :7].double()
    assert float((W2.double() - ref2).abs().max()
                 / ref2.abs().max()) <= RTOL


@pytest.mark.gpu
def test_cuda_eigsh_filter_runs_on_the_kernel(cuda):
    """The f32 ring-path eigsh on the card: every filter HEMM is one
    kernel launch, and the spectrum is right."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement, clement_eigenvalues
    H = clement(512).astype(np.float32)
    LAUNCHES.clear()
    res = ct.eigsh(H, 40, 20, tol=1e-2, device=cuda, collect_perf=True,
                   config=ct.ChaseConfig(ring_backend="pallas"))
    assert res.converged and res.V.device.type == "cuda"
    assert LAUNCHES["ring_hemm"] == res.perf.filter_hemm_steps > 0
    assert np.abs(res.ritzv - clement_eigenvalues(512)[:40]).max() <= 1e-3


# ---- complex64 on the card: the c64 kernel (Gauss's three products) --------

@pytest.mark.gpu
@pytest.mark.parametrize("m,n_cols,k,col0,b", [
    (200, 200, 37, 0, 200), (257, 300, 40, 0, 300), (130, 17, 3, 0, 17),
    (200, 512, 64, 1, 100), (200, 512, 64, 3, 77), (200, 512, 13, 6, 301),
], ids=["200x37", "m257", "tiny", "col0_1", "col0_3", "col0_6"])
def test_cuda_c64_kernel_matches_plain_version(cuda, m, n_cols, k, col0, b):
    """c64 against a c128 product: within 1e-5 and within 4x the plain
    version's (cuBLAS CGEMM) error; odd col0 shifts the pre-pass by one
    complex column (off = 1)."""
    g = torch.Generator(device=cuda).manual_seed(m + k + col0 + b)
    H = _padded_randn(m, n_cols, g, cuda, torch.complex64)
    V = torch.randn((b, k), generator=g, device=cuda, dtype=torch.complex64)
    _check_against_plain(H, V, col0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,k,off", [(1000, 37, 0), (61, 129, 1)])
def test_cuda_c64_split_prepass(cuda, b, k, off):
    """The complex pre-pass on the card is bit-identical to its plain
    version (the six planes of V), V a strided window holding NaNs of
    either sign with every mantissa bit set, whose lo planes stay NaN."""
    g = torch.Generator(device=cuda).manual_seed(b + 1)
    V = torch.randn((b, 3 * k), generator=g, device=cuda,
                    dtype=torch.complex64)[:, k:2 * k]
    bits = torch.view_as_real(V).view(torch.int32)
    bits[b // 2, 0, 0] = 0x7FFFFFFF
    bits[b - 1, k - 1, 1] = -1                       # 0xFFFFFFFF
    before = LAUNCHES["tf32_split"]
    Vt = tf32_split(V, off)
    torch.cuda.synchronize()
    assert LAUNCHES["tf32_split"] == before + 1
    assert tuple(Vt.shape) == (6, *split_shape(b, k, off,
                                               torch.complex64)[::-1])
    assert torch.equal(Vt.view(torch.int32),
                       tf32_split_reference(V, off).view(torch.int32))
    # Vd = fl(Vi − Vr) and Vs = fl(Vr + Vi) of either NaN: lo planes 3, 5
    for j, n in ((b // 2, 0), (b - 1, k - 1)):
        assert torch.isnan(Vt[[3, 5], n, off + j]).all()


@pytest.mark.gpu
def test_cuda_c64_non_finite_in_and_left_of_the_block(cuda):
    """A NaN or inf inside the block reaches every column of its row of W
    — also CUDA's canonical NaN (bits 0x7FFFFFFF), which the kernel's
    integer rounding of the A split carries into a zero hi (its lo keeps
    the NaN) —; inf and NaN just left of the block (odd col0: the first K
    tile starts one complex column early) stay out."""
    g = torch.Generator(device=cuda).manual_seed(17)
    col0, b = 3, 250
    H = _padded_randn(200, 300, g, cuda, torch.complex64)
    bits = torch.view_as_real(H).view(torch.int32)
    Hf = torch.view_as_real(H)
    Hf[:, col0 - 1, 0] = float("inf")
    Hf[::3, col0 - 1, 1] = float("nan")
    Hf[5, col0 + 10, 0] = float("nan")
    bits[7, col0 + 20, 1] = 0x7FFFFFFF
    Hf[9, col0 + 30, 0] = float("inf")
    V = torch.randn((b, 50), generator=g, device=cuda, dtype=torch.complex64)
    W = ring_hemm(H, V, col0=col0)
    torch.cuda.synchronize()
    bad = torch.zeros(200, dtype=torch.bool, device=cuda)
    bad[[5, 7, 9]] = True
    assert not torch.isfinite(W[bad]).any()
    assert torch.isfinite(W[~bad]).all()
    ref = _wide(H[~bad, col0:col0 + b]) @ _wide(V)
    err = float((_wide(W[~bad]) - ref).abs().max() / ref.abs().max())
    assert err <= RTOL


@pytest.mark.gpu
def test_cuda_c64_two_chunk_ring_step_and_strided_out(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    H = _padded_randn(300, 1001, g, cuda, torch.complex64)
    V = torch.randn((1001, 37), generator=g, device=cuda,
                    dtype=torch.complex64)
    half = 501                                   # odd col0 of chunk 1
    W = ring_hemm(H, V[:half], col0=0)
    ring_hemm(H, V[half:], col0=half, out=W, accumulate=True)
    Wfull = torch.randn((300, 60), generator=g, device=cuda,
                        dtype=torch.complex64)
    before = Wfull.clone()
    ring_hemm(H, V[:, 3:20], out=Wfull[:, 10:27], accumulate=True)
    torch.cuda.synchronize()
    ref = _wide(H) @ _wide(V)
    assert float((_wide(W) - ref).abs().max() / ref.abs().max()) <= RTOL
    ref2 = _wide(before[:, 10:27]) + _wide(H) @ _wide(V[:, 3:20])
    assert float((_wide(Wfull[:, 10:27]) - ref2).abs().max()
                 / ref2.abs().max()) <= RTOL
    assert torch.equal(Wfull[:, :10], before[:, :10])
    assert torch.equal(Wfull[:, 27:], before[:, 27:])


@pytest.mark.gpu
def test_cuda_c64_dense_operator_n1001_and_odd_stride_refused(cuda):
    """DenseOperator stores an N=1001 c64 H with an even row stride
    (1002), which the kernel reads; a contiguous one (odd stride 1001)
    is refused before any launch."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import random_hermitian
    H1 = random_hermitian(1001, np.complex64, seed=1)
    op = ct.DenseOperator(H1, device=cuda)
    assert op.H.shape == (1001, 1001) and op.H.stride() == (1002, 1)
    g = torch.Generator(device=cuda).manual_seed(6)
    V = torch.randn((1001, 37), generator=g, device=cuda,
                    dtype=torch.complex64)
    _check_against_plain(op.H, V)
    before = LAUNCHES["ring_hemm"]
    with pytest.raises(ValueError, match="TMA"):
        ring_hemm(torch.as_tensor(H1, device=cuda), V)
    assert LAUNCHES["ring_hemm"] == before


@pytest.mark.gpu
def test_cuda_conj_views_are_refused_or_materialized(cuda):
    """On the card a lazy conj or neg view raises before any launch; a c64
    operator given as H.conj() is materialized by DenseOperator, and the
    kernel's product with it agrees with the plain version's (which
    honours the bit) on the view."""
    import chase_tpu_torch as ct
    g = torch.Generator(device=cuda).manual_seed(8)
    H = _padded_randn(200, 200, g, cuda, torch.complex64)
    V = torch.randn((200, 37), generator=g, device=cuda,
                    dtype=torch.complex64)
    before = (LAUNCHES["ring_hemm"], LAUNCHES["tf32_split"],
              LAUNCHES["bf16_pack"])
    for args in ((H.conj(), V), (H, V.conj()),
                 (H.real.contiguous(), V.conj().imag)):
        with pytest.raises(ValueError, match="lazy conjugate or negative"):
            ring_hemm(*args)
    with pytest.raises(ValueError, match="lazy conjugate or negative"):
        bf16_pack(V.conj().imag)
    assert (LAUNCHES["ring_hemm"], LAUNCHES["tf32_split"],
            LAUNCHES["bf16_pack"]) == before
    op = ct.DenseOperator(H.conj(), device=cuda)
    assert not op.H.is_conj() and op.H.data_ptr() != H.data_ptr()
    _check_against_plain(op.H, V)
    W = ring_hemm(op.H, V)
    ref = ring_hemm_reference(H.conj(), V)
    assert float((_wide(W) - _wide(ref)).abs().max()
                 / ref.abs().max()) <= RTOL


@pytest.mark.gpu
def test_cuda_c64_eigsh_filter_runs_on_the_kernel(cuda):
    """The c64 ring-path eigsh on the card: every filter HEMM is one
    kernel launch (and one complex pre-pass), and the spectrum is right."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import random_hermitian
    H = random_hermitian(512, np.complex64, seed=2)
    exact = np.linalg.eigvalsh(H.astype(np.complex128))[:40]
    LAUNCHES.clear()
    res = ct.eigsh(H, 40, 20, tol=1e-3, device=cuda, collect_perf=True,
                   config=ct.ChaseConfig(ring_backend="pallas"))
    assert res.converged and res.V.dtype == torch.complex64
    assert LAUNCHES["ring_hemm"] == LAUNCHES["tf32_split"] \
        == res.perf.filter_hemm_steps > 0
    assert np.abs(res.ritzv - exact).max() <= 1e-4


# ---- the bf16 route: bf16 H, f32 V and out ----------------------------------

def test_bf16_plain_version_is_the_product_of_the_rounded_operands():
    """On the CPU a bf16 H takes the plain version: H · bf16(V) with f32
    sums, within f32 summation error of the exact (f64) product of the
    bf16-rounded operands; out is f32."""
    rng = np.random.default_rng(8)
    H = torch.from_numpy(rng.standard_normal((70, 300)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((200, 9)).astype(np.float32))
    Hb = H.to(torch.bfloat16)
    before = LAUNCHES["ring_hemm"]
    W = ring_hemm(Hb, V, col0=13)
    assert LAUNCHES["ring_hemm"] == before and W.dtype == torch.float32
    ref = Hb[:, 13:213].double() @ V.to(torch.bfloat16).double()
    assert _rel(W.numpy(), ref.numpy()) <= 1e-6
    out = torch.ones((70, 9))
    ring_hemm(Hb, V, col0=13, out=out, accumulate=True)
    assert _rel(out.numpy(), (ref + 1).numpy()) <= 1e-6


@pytest.mark.parametrize("off", [0, 5])
def test_bf16_pack_plain_version_layout(off):
    """The bf16 pre-pass's plain version: V rounded to bf16, transposed,
    starting at column ``off``, zero-padded to whole 64-deep tiles and
    whole 192-wide column tiles."""
    rng = np.random.default_rng(9 + off)
    V = torch.from_numpy(rng.standard_normal((45, 130)).astype(np.float32))
    Vb = bf16_pack(V[:, :129], off)
    b_pad, w_pad = pack_shape(45, 129, off)
    assert (b_pad, w_pad) == (64, 192) and tuple(Vb.shape) == (192, 64)
    assert Vb.dtype == torch.bfloat16
    assert torch.equal(Vb[:129, off:off + 45], V[:, :129].T.to(torch.bfloat16))
    zero = torch.ones_like(Vb, dtype=torch.bool)
    zero[:129, off:off + 45] = False
    assert not Vb[zero].any()
    with pytest.raises(ValueError):
        bf16_pack(V, 8)
    with pytest.raises(TypeError):
        bf16_pack(V.double(), 0)


def _check_bf16_against_plain(H, V, col0=0, out=None, accumulate=False):
    """The bf16 route against the exact product of the rounded operands:
    within 1e-5 of the largest entry and 4x the plain version's error."""
    before, packs = LAUNCHES["ring_hemm"], LAUNCHES["bf16_pack"]
    prior = None if out is None else out.double().clone()
    W = ring_hemm(H, V, col0=col0, out=out, accumulate=accumulate)
    torch.cuda.synchronize()
    assert LAUNCHES["ring_hemm"] == before + 1
    assert LAUNCHES["bf16_pack"] == packs + 1
    assert W.dtype == torch.float32
    ref = H[:, col0:col0 + V.shape[0]].double() \
        @ V.to(torch.bfloat16).double()
    if accumulate:
        ref += prior
    err = float((W.double() - ref).abs().max() / ref.abs().max())
    Wp = ring_hemm_reference(H, V, col0=col0)
    if accumulate:
        Wp = Wp.double() + prior
    errp = float((Wp.double() - ref).abs().max() / ref.abs().max())
    assert err <= RTOL and err <= 4 * max(errp, 1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n_cols,k,col0,b", [
    (1000, 1000, 37, 0, 1000), (30000, 30000, 750, 0, 30000),
    (30000, 30000, 3000, 0, 30000), (257, 300, 40, 0, 300),
    (130, 17, 3, 0, 17), (200, 512, 64, 1, 100), (200, 512, 64, 7, 77),
    (200, 512, 13, 9, 301),
], ids=["1000x37", "30000x750", "30000x3000", "m257", "tiny", "col0_1",
        "col0_7", "col0_9"])
def test_cuda_bf16_kernel_matches_plain_version(cuda, m, n_cols, k, col0, b):
    g = torch.Generator(device=cuda).manual_seed(m + k + col0 + b)
    H = _padded_randn(m, n_cols, g, cuda, torch.bfloat16)
    V = torch.randn((b, k), generator=g, device=cuda)
    _check_bf16_against_plain(H, V, col0)


@pytest.mark.gpu
def test_cuda_bf16_strided_window_and_two_chunk_step(cuda):
    """V and out as strided column windows; a two-chunk ring step whose
    second chunk starts at an unaligned col0 (15001 = 1 mod 8)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    N = 30000
    H = _padded_randn(1000, N, g, cuda, torch.bfloat16)
    Vfull = torch.randn((N, 300), generator=g, device=cuda)
    Wfull = torch.randn((1000, 300), generator=g, device=cuda)
    before = Wfull.clone()
    _check_bf16_against_plain(H, Vfull[:, 100:175], out=Wfull[:, 100:175],
                              accumulate=True)
    assert torch.equal(Wfull[:, :100], before[:, :100])
    assert torch.equal(Wfull[:, 175:], before[:, 175:])
    V = Vfull[:, :37]
    half = N // 2 + 1
    W = ring_hemm(H, V[:half], col0=0)
    ring_hemm(H, V[half:], col0=half, out=W, accumulate=True)
    torch.cuda.synchronize()
    ref = H.double() @ V.to(torch.bfloat16).double()
    assert float((W.double() - ref).abs().max() / ref.abs().max()) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("m,k", [(257, 40), (385, 193), (129, 191),
                                 (1000, 385)],
                         ids=["odd_row_tiles", "k193", "k191", "k385"])
def test_cuda_bf16_ragged_tiles(cuda, m, k):
    """m past whole 128-row tiles (257: three row tiles, an odd count
    under a 2-CTA cluster, so one CTA reads rows that are all past m) and
    k past whole 192-column tiles."""
    g = torch.Generator(device=cuda).manual_seed(m * k)
    H = _padded_randn(m, 700, g, cuda, torch.bfloat16)
    V = torch.randn((700, k), generator=g, device=cuda)
    _check_bf16_against_plain(H, V)


@pytest.mark.gpu
@pytest.mark.parametrize("col0", range(1, 8))
def test_cuda_bf16_unaligned_col0_ignores_non_finite_left_of_block(cuda,
                                                                   col0):
    """col0 % 8 from 1 to 7: the first K tile starts 8-aligned, so it
    holds H columns left of the block; inf and nan there stay out of the
    result."""
    g = torch.Generator(device=cuda).manual_seed(20 + col0)
    Hf = torch.randn((300, 520), generator=g, device=cuda)
    Hf[:, col0 - 1] = float("inf")
    Hf[::3, col0 - 1] = float("nan")
    H = Hf.to(torch.bfloat16)
    V = torch.randn((200 + col0, 70), generator=g, device=cuda)
    _check_bf16_against_plain(H, V, col0)
    assert torch.isfinite(ring_hemm(H, V, col0=col0)).all()


@pytest.mark.gpu
def test_cuda_bf16_strided_out_window_accumulates(cuda):
    """out a strided column window of a wider W (row stride 400), added
    into with accumulate=True at a ragged shape; the columns around it
    are untouched."""
    g = torch.Generator(device=cuda).manual_seed(31)
    H = _padded_randn(257, 333, g, cuda, torch.bfloat16)
    V = torch.randn((333, 400), generator=g, device=cuda)[:, 7:200]
    Wfull = torch.randn((257, 400), generator=g, device=cuda)
    before = Wfull.clone()
    _check_bf16_against_plain(H, V, out=Wfull[:, 3:196], accumulate=True)
    assert torch.equal(Wfull[:, :3], before[:, :3])
    assert torch.equal(Wfull[:, 196:], before[:, 196:])


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0.0, 1.0], ids=["centred", "offset"])
def test_cuda_bf16_promotion_holds_the_gate_at_k30000(cuda, shift):
    """K = 30000: the tensor cores' sums are promoted into IEEE f32 at the
    kept interval often enough for 1e-5 of the largest entry, also where
    the partial sums grow (an offset of every entry)."""
    g = torch.Generator(device=cuda).manual_seed(41)
    H = (torch.randn((512, 30000), generator=g, device=cuda)
         + shift).to(torch.bfloat16)
    V = torch.randn((30000, 192), generator=g, device=cuda) + shift
    W = ring_hemm(H, V)
    ref = H.double() @ V.to(torch.bfloat16).double()
    assert float((W.double() - ref).abs().max() / ref.abs().max()) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("b,k,off", [(1000, 37, 0), (61, 129, 3),
                                     (300, 256, 7)])
def test_cuda_bf16_pack_prepass(cuda, b, k, off):
    """The bf16 pre-pass on the card is bit-identical to its plain version
    (V.to(bfloat16), transposed), V a strided window."""
    g = torch.Generator(device=cuda).manual_seed(b + 2)
    V = torch.randn((b, 3 * k), generator=g, device=cuda)[:, k:2 * k]
    before = LAUNCHES["bf16_pack"]
    Vb = bf16_pack(V, off)
    torch.cuda.synchronize()
    assert LAUNCHES["bf16_pack"] == before + 1
    assert torch.equal(Vb, bf16_pack_reference(V, off))


@pytest.mark.gpu
def test_cuda_bf16_h_row_stride_not_multiple_of_8_raises(cuda):
    """A bf16 H with row stride 1004 (a multiple of 4, not of 8) is
    refused before any launch."""
    H = torch.randn((64, 1004), device=cuda).to(torch.bfloat16)
    V = torch.randn((1004, 8), device=cuda)
    before, packs = LAUNCHES["ring_hemm"], LAUNCHES["bf16_pack"]
    with pytest.raises(ValueError, match="TMA"):
        ring_hemm(H, V)
    assert LAUNCHES["ring_hemm"] == before
    assert LAUNCHES["bf16_pack"] == packs


# ---- the BSE H² ring on the card: two launches per step ----------------------

@pytest.mark.gpu
@pytest.mark.parametrize("route", ["f32", "c64", "bf16"])
def test_cuda_h2_ring_on_a_bse_h_matches_plain(cuda, route):
    """The p = 1 H² ring (parallel/ring.chebyshev_filter_h2_ring) on a BSE
    H whose upper and lower halves differ — the kernel reads no symmetry —
    against the plain H² filter on torch.matmul, per column: 1e-5 (1e-2
    on the bf16 route, whose intermediates are rounded to bf16 after f32
    sums in two orders); degree-1 columns against the f64 product
    (σ1/e)·(H·(H·X) − c·X) to 1e-5 (f32, c64).  2·deg_max launches, each
    with one pre-pass of the route; degree-0 columns bit-exact."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import random_pseudo_hermitian
    from chase_tpu_torch.ops.pseudo import chebyshev_filter_h2
    from chase_tpu_torch.parallel.ring import chebyshev_filter_h2_ring
    N, w = 512, 40
    cplx = route == "c64"
    H = random_pseudo_hermitian(N, np.complex64 if cplx else np.float32,
                                seed=9)
    assert np.abs(H[:N // 2, :N // 2] - H[N // 2:, N // 2:]).max() > 0.1
    op = ct.DenseOperator(H, device=cuda, pseudo_hermitian=True)
    Hk = op.H_low if route == "bf16" else op.H
    g = torch.Generator(device=cuda).manual_seed(10)
    X = torch.randn((N, w), generator=g, device=cuda, dtype=op.dtype)
    deg = np.array([0] * 4 + [1] * 6 + [4] * 30, np.int32)
    ev2 = np.sort(np.abs(np.linalg.eigvals(H.astype(np.complex128))) ** 2)
    lam1, lo, up = ev2[0] * 0.9, ev2[N // 3], ev2[-1] * 1.01
    pre = "bf16_pack" if route == "bf16" else "tf32_split"
    LAUNCHES.clear()
    Y = chebyshev_filter_h2_ring(Hk, X, deg, lam1, lo, up, 4)
    torch.cuda.synchronize()
    assert LAUNCHES["ring_hemm"] == LAUNCHES[pre] == 2 * 4
    Yp = chebyshev_filter_h2(Hk, X, deg, lam1, lo, up, 4)
    num = (Y - Yp).abs().amax(dim=0)
    assert float((num / Yp.abs().amax(dim=0))[4:].max()) <= \
        (1e-2 if route == "bf16" else RTOL)
    assert torch.equal(Y[:, :4], X[:, :4])
    if route != "bf16":
        c, e = (up + lo) / 2, (up - lo) / 2
        H64, X64 = _wide(op.H), _wide(X[:, 4:10])
        ref = (1.0 / (lam1 - c)) * (H64 @ (H64 @ X64) - c * X64)
        assert float((_wide(Y[:, 4:10]) - ref).abs().max()
                     / ref.abs().max()) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f32", "c64", "bf16", "bse-ladder",
                                  "bse-bf16"])
def test_cuda_fused_solvers_put_every_filter_product_on_the_kernel(cuda,
                                                                   case):
    """eigsh_fused / eigsh_pseudo_fused with ring_backend="pallas": the
    kernel launches once per HEMM step the solver counts, each with its
    route's pre-pass, and the answer holds (exact Clement spectrum; BSE
    against numpy's eigvals)."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import (clement, clement_eigenvalues,
                                        random_pseudo_hermitian)
    bse = case.startswith("bse")
    cfg = ct.ChaseConfig(ring_backend="pallas",
                         bf16_filter=case.endswith("bf16"),
                         mixed_precision=case == "bse-ladder")
    LAUNCHES.clear()
    if bse:
        H = random_pseudo_hermitian(
            300, np.float64 if case == "bse-ladder" else np.float32, seed=5)
        tol = 1e-9 if case == "bse-ladder" else 1e-4
        res = ct.eigsh_pseudo_fused(H, 10, 8, tol=tol, config=cfg,
                                    device=cuda, collect_perf=True)
        ev = np.sort(np.linalg.eigvals(H.astype(np.float64)).real)
        exact = ev[ev > 0][:10]
    else:
        H = clement(512).astype(np.complex64 if case == "c64"
                                else np.float32)
        tol = 1e-2
        res = ct.eigsh_fused(H, 40, 24, tol=tol, config=cfg, device=cuda,
                             collect_perf=True)
        exact = clement_eigenvalues(512)[:40]
    torch.cuda.synchronize()
    assert res.converged
    # the bf16 rung's far-from-converged iterations take the bf16 route,
    # the others the f32 one
    assert LAUNCHES["ring_hemm"] == \
        LAUNCHES["tf32_split"] + LAUNCHES["bf16_pack"] \
        == res.perf.filter_hemm_steps > 0
    assert (LAUNCHES["bf16_pack"] > 0) == case.endswith("bf16")
    np.testing.assert_allclose(res.ritzv, exact,
                               atol=1e-7 if case == "bse-ladder" else 1e-1)
