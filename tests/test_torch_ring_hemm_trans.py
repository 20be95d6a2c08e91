"""The ring HEMM's conjugate-transposed A route, ``ring_hemm(H, V,
col0=row0, trans=True)`` = ``H[row0:row0+b, :]ᴴ · V``: one ring_B step of
the 2-D ring (the JAX package's ``_mm(h_blk.conj().T, cur)`` in
``chase_tpu/parallel/ring.py::_ring2d_pair``), read from the rank's block
in place.

On the CPU the wrapper takes its plain version; these tests hold it
against numpy and JAX on the same seeded inputs, check what the route
refuses, and check the arithmetic the CUDA kernel is built on without a
card: the c64 float-view identity with the pre-pass's −i·V rows, and the
M-order permutation of the MN-major A tile (a bijection, each fragment
read at the element it stands for, the 32 lanes of a warp on 32 shared
memory banks).  The ``gpu``-marked tests at the end run the kernel:

    python -m pytest tests/test_torch_ring_hemm_trans.py -m gpu --noconftest

Tolerances: f32 and c64 against an f64 (c128) product, 1e-5 of the
largest entry (f32 sums of b terms in another order); bf16 against the
f64 product of the bf16-rounded operands, 1e-5 (exact products, f32
sums); on the card also within 4× the plain version's error (bf16: the
library's bf16 GEMM's).
"""

import numpy as np
import pytest
import torch

from chase_tpu_torch.ops.ring_hemm import (LAUNCHES, real_rows, ring_hemm,
                                           ring_hemm_reference, tf32_split,
                                           tf32_split_reference, tma_ld)
from chase_tpu_torch.parallel.ring import matmul_step, ring_steps

torch.set_num_threads(1)

RTOL = 1e-5
DTYPES = {"f32": torch.float32, "c64": torch.complex64,
          "bf16": torch.bfloat16}
# (rows of H, columns of H = W's rows, k, row0, b): whole, ragged, a
# one-row slab at the last row
SHAPES = [(64, 48, 7, 0, 64), (200, 37, 13, 53, 101), (90, 130, 5, 89, 1)]


def _arrays(dtype, n_rows, n_cols, k, seed):
    """Seeded numpy (H, V) of the route's dtypes: V is f32 for a bf16 H."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((n_rows, n_cols))
    V = rng.standard_normal((n_rows, k))
    if dtype.is_complex:
        H = H + 1j * rng.standard_normal((n_rows, n_cols))
        V = V + 1j * rng.standard_normal((n_rows, k))
        return H.astype(np.complex64), V.astype(np.complex64)
    return H.astype(np.float32), V.astype(np.float32)


def _tensors(dtype, H, V):
    Ht = torch.from_numpy(H)
    return (Ht.to(torch.bfloat16) if dtype == torch.bfloat16 else Ht,
            torch.from_numpy(V))


def _exact(Ht, Vt, row0, b):
    """The f64 (c128) product of the operands as the route reads them
    (bf16: V rounded to bf16)."""
    if Ht.dtype == torch.bfloat16:
        Vt = Vt.to(torch.bfloat16)
    h = Ht[row0:row0 + b].to(torch.float64 if not Ht.is_complex()
                             else torch.complex128).numpy()
    v = Vt[:b].to(torch.float64 if not Vt.is_complex()
                  else torch.complex128).numpy()
    return h.conj().T @ v


def _rel(a, ref):
    return float(np.abs(np.asarray(a) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("shape", SHAPES, ids=["whole", "ragged", "one_row"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_trans_plain_version_matches_numpy(name, shape):
    n_rows, n_cols, k, row0, b = shape
    dtype = DTYPES[name]
    H, V = _arrays(dtype, n_rows, n_cols, k, sum(shape))
    Ht, Vt = _tensors(dtype, H, V[row0:row0 + b])
    before = LAUNCHES["ring_hemm"]
    W = ring_hemm(Ht, Vt, col0=row0, trans=True)
    assert LAUNCHES["ring_hemm"] == before          # the plain version
    assert W.shape == (n_cols, k)
    assert W.dtype == (torch.float32 if name == "bf16" else dtype)
    assert _rel(W.numpy(), _exact(Ht, Vt, row0, b)) <= RTOL
    if name != "bf16":                           # numpy's own product
        ref = H[row0:row0 + b].conj().T.astype(np.complex128) \
            @ V[row0:row0 + b].astype(np.complex128)
        assert _rel(W.numpy(), ref) <= RTOL


@pytest.mark.parametrize("name", list(DTYPES))
def test_trans_accumulates_into_a_prefilled_strided_window(name):
    """out a column window of a wider W (row stride 40): added into with
    accumulate=True; the columns around it untouched."""
    dtype = DTYPES[name]
    H, V = _arrays(dtype, 120, 33, 40, 5)
    Ht, Vt = _tensors(dtype, H, V)
    Vw = Vt[50:95, 3:20]                          # a strided window of V
    Wfull = torch.from_numpy(_arrays(dtype, 33, 33, 40, 6)[1])
    if name == "bf16":
        Wfull = Wfull.float()
    before = Wfull.clone()
    ring_hemm(Ht, Vw, col0=50, out=Wfull[:, 10:27], accumulate=True,
              trans=True)
    ref = before[:, 10:27].numpy() + _exact(Ht[50:95], Vw, 0, 45)
    assert _rel(Wfull[:, 10:27].numpy(), ref) <= RTOL
    assert torch.equal(Wfull[:, :10], before[:, :10])
    assert torch.equal(Wfull[:, 27:], before[:, 27:])


@pytest.mark.parametrize("case", ["H_conj", "V_conj", "out_neg"])
def test_trans_refuses_lazy_conj_and_neg_views(case):
    """The kernel reads data_ptr(): a lazy conjugate or negative view is
    refused on every device, trans or not."""
    H = torch.randn(16, 8, dtype=torch.complex64)
    V = torch.randn(16, 3, dtype=torch.complex64)
    out = torch.empty(8, 3, dtype=torch.complex64)
    if case == "H_conj":
        H = H.conj()
    elif case == "V_conj":
        V = V.conj()
    else:
        out = out._neg_view()
    with pytest.raises(ValueError, match="lazy conjugate or negative"):
        ring_hemm(H, V, out=out, trans=True)


@pytest.mark.parametrize("case", ["rows_past_H", "out_shape", "row0_neg"])
def test_trans_checks_the_slab(case):
    """With trans the block is a slab of H's rows, and out has H's
    columns for rows."""
    H = torch.randn(20, 12)
    V = torch.randn(8, 3)
    kw = dict(trans=True, col0=4)
    if case == "rows_past_H":
        kw["col0"] = 13                          # rows 13..20 of 20
        match = "row block"
    elif case == "out_shape":
        kw["out"] = torch.empty(20, 3)           # H's rows, not columns
        match = "out has shape"
    else:
        kw["col0"] = -1
        match = "row block"
    with pytest.raises(ValueError, match=match):
        ring_hemm(H, V, **kw)
    assert ring_hemm(H, V, col0=12, trans=True).shape == (12, 3)


def test_trans_matches_jax_mm_on_the_block():
    """The JAX 2-D ring's ring_B step, ``_mm(h_blk.conj().T, cur)`` (an
    XLA matmul at the highest precision; for a bf16 h, cur cast to bf16
    with f32 sums), against the port's step on the same inputs."""
    import jax
    import jax.numpy as jnp
    for name, dtype in DTYPES.items():
        H, V = _arrays(dtype, 96, 40, 9, 17)
        Ht, Vt = _tensors(dtype, H, V[32:64])
        h = jnp.asarray(H[32:64])
        cur = jnp.asarray(V[32:64])
        if name == "bf16":
            hb = h.astype(jnp.bfloat16)
            ref = jnp.matmul(hb.conj().T, cur.astype(jnp.bfloat16),
                             precision=jax.lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32)
        else:
            ref = jnp.matmul(h.conj().T, cur,
                             precision=jax.lax.Precision.HIGHEST)
        W = ring_hemm(Ht, Vt, col0=32, trans=True).numpy()
        assert _rel(W, np.asarray(ref, np.complex128)) <= RTOL, name


@pytest.mark.parametrize("name", list(DTYPES))
def test_ring_steps_trans_is_the_block_conjugate_transposed(name):
    """ring_steps(trans=True) on a 3-chunk ring (the chunks handed on by
    an in-memory exchange): Hᴴ·V_all for the rank's (3·b × m) block,
    each step on the block's rows src·b onwards; on the kernel's plain
    version and on matmul_step, the same."""
    dtype = DTYPES[name]
    p, b, m, k = 3, 11, 17, 4
    H, V = _arrays(dtype, p * b, m, k, 23)
    Ht, Vt = _tensors(dtype, H, V)
    me = 1
    chunks = [Vt[q * b:(q + 1) * b] for q in range(p)]
    for step in (None, matmul_step):
        got = {"s": 0}

        def exchange(send, recv):
            got["s"] += 1
            recv.copy_(chunks[(me + got["s"]) % p])
            return type("Done", (), {"wait": lambda self: None})()
        if step is matmul_step and name == "bf16":
            continue                         # matmul takes no bf16 · f32
        W = ring_steps(Ht, chunks[me], me=me, p=p, exchange=exchange,
                       step=step, trans=True)
        assert _rel(W.numpy(), _exact(Ht, Vt, 0, p * b)) <= RTOL
    with pytest.raises(ValueError, match="rows"):
        ring_steps(Ht[:-1], chunks[me], me=me, p=p, exchange=None,
                   trans=True)


@pytest.mark.parametrize("row0,b", [(0, 24), (7, 13)])
def test_trans_c64_float_view_identity(row0, b):
    """The c64 trans route on the f32 kernel: A_f[i, 2kk+e] = Hf[row0+kk,
    2i+e] (the float view of h read transposed in 1 × 2 blocks) times the
    pre-pass's real rows with −i·V (``real_rows(V, conj=True)``, split by
    ``tf32_split_reference(V, conj=True)``) is hᴴ·V viewed as floats."""
    H, V = _arrays(torch.complex64, 40, 21, 6, row0 + b)
    Ht, Vt = torch.from_numpy(H), torch.from_numpy(V[row0:row0 + b])
    Hf = torch.view_as_real(Ht).reshape(40, 42)            # float view
    Af = Hf[row0:row0 + b].reshape(b, 21, 2).permute(1, 0, 2).reshape(
        21, 2 * b)
    B = real_rows(Vt, conj=True)
    Wf = (Af.double() @ B.double()).numpy()
    ref = _exact(Ht, Vt, row0, b)
    assert _rel(Wf.reshape(21, 6, 2), np.stack([ref.real, ref.imag], -1)) \
        <= RTOL
    # the pre-pass's planes rebuild the conjugate rows (hi + lo = B)
    Vs = tf32_split_reference(Vt, conj=True)
    rebuilt = (Vs[0] + Vs[1])[:12, :2 * b].T
    assert float((rebuilt - B).abs().max() / B.abs().max()) <= 2.0 ** -22
    assert torch.equal(B[0::2], real_rows(Vt)[0::2])
    assert torch.equal(B[1::2], -real_rows(Vt)[1::2])
    # on the CPU the wrapper takes that plain version
    assert torch.equal(tf32_split(Vt, conj=True), Vs)


def _tile_row(L, tu):
    """csrc/ring_hemm.cu's tile_row<TU>."""
    if tu == 1:
        return (L & 0x63) | ((L & 0x04) << 2) | ((L & 0x18) >> 1)
    return (L & 0x71) | ((L & 0x06) << 1) | ((L & 0x08) >> 2)


@pytest.mark.parametrize("tu", [1, 2], ids=["f32", "c64"])
def test_trans_tile_permutation_reads_each_element_conflict_free(tu):
    """The f32 kernel's MN-major A tile (csrc/ring_hemm.cu, load_a on the
    trans route): 4·TU TMA boxes of 32/TU H rows × 128 bytes, 128-byte
    swizzled.  For every warp, k-step ks and fragment register v, each
    lane's word is the float of H(row kc / TU, column tile_row(L)) that
    the wgmma fragment layout puts there (A row L = 16·(warp % 4) +
    lane/4 + 8·(v & 1) + 64·wg, K position kc = 8 ks + 4 (v >> 1) +
    lane % 4) — the word the kernel computes from a per-thread base and
    XOR key and two constants per register —, tile_row is a bijection of
    the 128 rows, and the 32 lanes hit 32 distinct banks."""
    bk, epb = 32, 32 // tu                       # floats per K tile, per box row
    rows = sorted(_tile_row(L, tu) for L in range(128))
    assert rows == list(range(128))
    # smem words of the tile as TMA writes them: box x, box row kk, float f
    where = {}
    for x in range(4 * tu):
        for kk in range(bk // tu):
            for f in range(32):
                chunk = (f >> 2) ^ (kk & 7)
                word = x * (bk // tu) * 32 + kk * 32 + chunk * 4 + (f & 3)
                where[word] = (kk, epb * x + f // tu, f % tu)  # (row, col, e)
    for wg, warp, ks, v in np.ndindex(2, 4, 4, 4):
        banks = set()
        for lane in range(32):
            q = lane % 4
            L = 64 * wg + 16 * warp + lane // 4 + 8 * (v & 1)
            P = _tile_row(L, tu)
            # the kernel's per-thread base and key, per-register constant c
            qr = q // tu
            fi = tu * (P % epb) + q % tu
            tbase = P // epb * (bk // tu) * 32 + 32 * qr + (fi & 3)
            tkey = ((fi >> 2) ^ qr) << 2
            c = (8 * ks + 4 * (v >> 1)) // tu
            word = tbase + 32 * c + (tkey ^ ((c & 7) << 2))
            kc = 8 * ks + 4 * (v >> 1) + q
            assert where[word] == (kc // tu, P, kc % tu)
            banks.add(word % 32)
        assert len(banks) == 32


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _padded(rows, cols, g, dev, dtype):
    """(rows, cols) of ``dtype`` with the row stride TMA reads (16 bytes)."""
    if dtype == torch.bfloat16:
        return torch.randn((rows, tma_ld(cols, 2)), generator=g, device=dev
                           ).to(dtype)[:, :cols]
    w = 2 if dtype.is_complex else 1
    return torch.randn((rows, tma_ld(w * cols) // w), generator=g,
                       device=dev, dtype=dtype)[:, :cols]


def _wide(t):
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def _check_card(H, V, row0, out=None, accumulate=False):
    """The trans launch against the f64 (c128) product and its plain
    version (bf16: the library's bf16 GEMM): 1e-5 and 4× the yardstick."""
    b = V.shape[0]
    base = None if out is None else _wide(out.clone())
    before = LAUNCHES["ring_hemm"]
    W = ring_hemm(H, V, col0=row0, out=out, accumulate=accumulate,
                  trans=True)
    torch.cuda.synchronize()
    assert LAUNCHES["ring_hemm"] == before + 1
    Hb = H[row0:row0 + b]
    if H.dtype == torch.bfloat16:
        ref = Hb.double().mT @ V.to(torch.bfloat16).double()
        yard = torch.mm(Hb.mT, V.to(torch.bfloat16),
                        out_dtype=torch.float32)
    else:
        ref = _wide(Hb).mH @ _wide(V)
        yard = ring_hemm_reference(H, V, col0=row0, trans=True)
    if base is not None:
        ref = ref + base
        yard = _wide(yard) + base
    scale = ref.abs().max()
    err = float((_wide(W) - ref).abs().max() / scale)
    erry = float((_wide(yard) - ref).abs().max() / scale)
    assert err <= RTOL and err <= 4 * max(erry, 1e-7), (err, erry)
    return W


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (300, 200, 37, 0, 300), (300, 257, 40, 13, 211), (129, 130, 3, 1, 127),
    (1000, 385, 193, 499, 501), (70, 17, 1, 69, 1)],
    ids=["whole", "ragged", "tiny", "k193", "one_row"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_cuda_trans_matches_plain_version(cuda, name, shape):
    """Ragged tiles: W's rows (H's columns) past whole 128-row tiles, k
    past whole column tiles, b past whole K tiles, any row0."""
    n_rows, n_cols, k, row0, b = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    dtype = DTYPES[name]
    H = _padded(n_rows, n_cols, g, cuda, dtype)
    vdt = torch.float32 if name == "bf16" else dtype
    V = torch.randn((b, k), generator=g, device=cuda, dtype=vdt)
    _check_card(H, V, row0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DTYPES))
def test_cuda_trans_two_chunks_into_a_strided_window(cuda, name):
    """A two-chunk ring_B (store, then accumulate at row0 = 1001 of a
    2000-row block) into a strided column window of a wider W; the
    columns around it untouched."""
    g = torch.Generator(device=cuda).manual_seed(7)
    dtype = DTYPES[name]
    vdt = torch.float32 if name == "bf16" else dtype
    H = _padded(2000, 300, g, cuda, dtype)
    V = torch.randn((2000, 70), generator=g, device=cuda, dtype=vdt)
    Wfull = torch.randn((300, 100), generator=g, device=cuda, dtype=vdt)
    before = Wfull.clone()
    W = Wfull[:, 20:90]
    ring_hemm(H, V[:1001], col0=0, out=W, trans=True)
    _check_card(H, V[1001:], 1001, out=W, accumulate=True)
    ref = _wide(H).mH @ _wide(V) if name != "bf16" else \
        H.double().mT @ V.to(torch.bfloat16).double()
    assert float((_wide(W) - ref).abs().max() / ref.abs().max()) <= RTOL
    assert torch.equal(Wfull[:, :20], before[:, :20])
    assert torch.equal(Wfull[:, 90:], before[:, 90:])


@pytest.mark.gpu
@pytest.mark.parametrize("K", [7500, 30000], ids=["K7500", "K30000"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_cuda_trans_holds_the_gate_at_stripe_depths(cuda, name, K):
    """K = 7500 (a (2, 2) ring_B stripe at N = 30000) and K = 30000 (the
    promotion's longest sum), with an offset of every entry so that the
    partial sums grow."""
    g = torch.Generator(device=cuda).manual_seed(K)
    dtype = DTYPES[name]
    vdt = torch.float32 if name == "bf16" else dtype
    H = (_padded(K, 384, g, cuda, dtype).to(vdt) + 0.5).to(dtype)
    V = torch.randn((K, 192), generator=g, device=cuda, dtype=vdt) + 0.5
    _check_card(H, V, 0)


@pytest.mark.gpu
def test_cuda_trans_reads_the_c64_conjugate(cuda):
    """A c64 block whose imaginary part alone is non-zero: the route
    multiplies by conj(h) (the pre-pass's −i·V rows), not by h."""
    g = torch.Generator(device=cuda).manual_seed(3)
    H = 1j * _padded(256, 256, g, cuda, torch.float32).to(torch.complex64)
    V = torch.randn((256, 64), generator=g, device=cuda,
                    dtype=torch.complex64)
    W = _check_card(H, V, 0)
    assert float((_wide(W) - _wide(H).mT @ _wide(V)).abs().max()) \
        > 1.0                                  # not hᵀ·V
