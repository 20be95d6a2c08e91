"""The port's block-cyclic layouts (``chase_tpu_torch.parallel.layouts``)
against the JAX package's (``chase_tpu.parallel.layouts``): the
permutations and the numpy row gathers bitwise equal, a tensor's gathers
the same values on its device and in its dtype.  On a DTensor (gathered
whole first): ``tests/test_torch_grid_io.py``."""

import numpy as np
import pytest
import torch

from chase_tpu.parallel import layouts as jl
from chase_tpu_torch.parallel import layouts as tl

# (N, mb, p_r, p_c): ragged blocks, one process, more processes than blocks
CASES = [(130, 8, 2, 2), (96, 8, 3, 1), (64, 5, 1, 2), (12, 4, 4, 3),
         (100, 100, 2, 2)]


def _inputs(N, dtype=np.complex128, seed=0):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    V = rng.standard_normal((N, 7)) + 1j * rng.standard_normal((N, 7))
    if not np.issubdtype(dtype, np.complexfloating):
        H, V = H.real, V.real
    return H.astype(dtype), V.astype(dtype)


@pytest.mark.parametrize("N,mb,p", [(130, 8, 2), (96, 8, 3), (12, 4, 5),
                                    (7, 1, 7)])
def test_block_cyclic_perm_is_the_jax_packages(N, mb, p):
    perm = tl.block_cyclic_perm(N, mb, p)
    np.testing.assert_array_equal(perm, jl.block_cyclic_perm(N, mb, p))
    assert sorted(perm) == list(range(N))


@pytest.mark.parametrize("N,mb,p_r,p_c", CASES)
@pytest.mark.parametrize("pseudo", [False, True], ids=["herm", "pseudo"])
def test_layout_on_numpy_is_the_jax_packages(N, mb, p_r, p_c, pseudo):
    """row/col permutations, apply, restore_rows and apply_rows on numpy:
    bitwise the JAX package's, numpy in and out; restore_rows undoes
    apply_rows."""
    cls_t = tl.PseudoBlockCyclicLayout if pseudo else tl.BlockCyclicLayout
    cls_j = jl.PseudoBlockCyclicLayout if pseudo else jl.BlockCyclicLayout
    t, j = cls_t(N, mb, p_r, p_c), cls_j(N, mb, p_r, p_c)
    np.testing.assert_array_equal(t.row_perm, j.row_perm)
    np.testing.assert_array_equal(t.col_perm, j.col_perm)
    H, V = _inputs(N)
    for got, want in ((t.apply(H), j.apply(H)),
                      (t.apply_rows(V), j.apply_rows(V)),
                      (t.restore_rows(V), j.restore_rows(V))):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.restore_rows(t.apply_rows(V)), V)


@pytest.mark.parametrize("N,mb,p_r,p_c", CASES[:3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128],
                         ids=["f32", "c128"])
def test_layout_on_tensors_keeps_the_tensor(N, mb, p_r, p_c, dtype):
    """On a tensor every gather gives a tensor of its dtype and device
    with the numpy gather's values; a lazy conjugate view gathers the
    values it stands for."""
    lay = tl.BlockCyclicLayout(N, mb, p_r, p_c)
    H, V = _inputs(N, np.complex128, seed=1)
    if not dtype.is_complex:
        H, V = H.real.copy(), V.real.copy()
    Ht = torch.from_numpy(H).to(dtype)
    Vt = torch.from_numpy(V).to(dtype)
    for got, want in ((lay.apply(Ht), lay.apply(Ht.numpy())),
                      (lay.apply_rows(Vt), lay.apply_rows(Vt.numpy())),
                      (lay.restore_rows(Vt), lay.restore_rows(Vt.numpy()))):
        assert isinstance(got, torch.Tensor) and got.dtype == dtype
        assert got.device == Ht.device
        np.testing.assert_array_equal(got.numpy(), want)
    if dtype.is_complex:
        np.testing.assert_array_equal(
            lay.apply_rows(Vt.conj()).resolve_conj().numpy(),
            lay.apply_rows(V.conj()))


def test_pseudo_layout_keeps_the_halves():
    """The S-preserving permutation never crosses N/2 and permutes each
    half alike; an odd N raises as in the JAX package."""
    lay = tl.PseudoBlockCyclicLayout(40, 4, 3, 2)
    half = lay.row_perm[:20]
    assert sorted(half) == list(range(20))
    np.testing.assert_array_equal(lay.row_perm[20:], half + 20)
    for mod in (tl, jl):
        with pytest.raises(ValueError, match="must be even"):
            mod.PseudoBlockCyclicLayout(41, 4, 2)


@pytest.mark.parametrize("like", [False, True], ids=["own", "like"])
def test_block_cyclic_vector_1d_is_the_jax_packages(like):
    """BlockCyclicVector1D's own permutation, or the matrix layout's row
    permutation with like=; to_owner_order / from_owner_order round trip
    on numpy and on a tensor."""
    N, mb, p = 90, 6, 4
    jlike = jl.BlockCyclicLayout(N, mb, p, 2) if like else None
    tlike = tl.BlockCyclicLayout(N, mb, p, 2) if like else None
    t = tl.BlockCyclicVector1D(N, mb, p, like=tlike)
    j = jl.BlockCyclicVector1D(N, mb, p, like=jlike)
    np.testing.assert_array_equal(t.perm, j.perm)
    V = _inputs(N, np.float64, seed=2)[1].real.copy()
    np.testing.assert_array_equal(t.to_owner_order(V), j.to_owner_order(V))
    np.testing.assert_array_equal(t.from_owner_order(t.to_owner_order(V)),
                                  V)
    Vt = torch.from_numpy(V)
    assert torch.equal(t.from_owner_order(t.to_owner_order(Vt)), Vt)
