"""The port's ring HEMM (chase_tpu_torch/ops/ring_hemm.py) against the JAX
package's Pallas ring kernel (chase_tpu/ops/pallas_ring.py), run in the
TPU interpreter as the JAX package's own tests run it off-TPU.

On the CPU the wrapper takes its plain version; the CUDA kernel itself is
checked by the ``gpu``-marked tests at the end (and by chip_smoke.py).
Tolerance: the JAX kernel and torch.matmul are both f32 dots with f32
accumulation in different orders, so 1e-5 relative to the largest entry.

JAX is imported only by the parity tests (the ``jx`` fixture), so the
card-only tests also run where JAX is not installed:

    python -m pytest tests/test_torch_ring_hemm.py -m gpu --noconftest
"""

import types

import numpy as np
import pytest
import torch

from chase_tpu_torch.ops.ring_hemm import ring_hemm, ring_hemm_reference

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
    before = ring_hemm.launches
    Wt = ring_hemm(torch.from_numpy(H), torch.from_numpy(V))
    assert ring_hemm.launches == before
    np.testing.assert_array_equal(
        Wt.numpy(), ring_hemm_reference(torch.from_numpy(H),
                                        torch.from_numpy(V)).numpy())


@pytest.mark.parametrize("case", ["f64", "complex", "col_stride", "out_shape",
                                  "acc_no_out", "col0_range", "ndim",
                                  "devices"])
def test_rejects_what_the_kernel_does_not_take(case):
    H = torch.zeros((16, 16))
    V = torch.zeros((16, 4))
    kw = {}
    err = ValueError
    if case == "f64":
        H, V, err = H.double(), V.double(), TypeError
    elif case == "complex":
        V, err = V.to(torch.complex64), TypeError
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n_cols,k", [(200, 200, 37), (300, 1000, 129),
                                        (130, 17, 3)],
                         ids=["200x37", "ragged300x129", "tiny"])
def test_cuda_kernel_matches_plain_version(cuda, m, n_cols, k):
    """The hand-written kernel against torch.matmul on the card: error vs
    an f64 product within 1e-5 and within 4x the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(m)
    H = torch.randn((m, n_cols), generator=g, device=cuda)
    V = torch.randn((n_cols, k), generator=g, device=cuda)
    before = ring_hemm.launches
    W = ring_hemm(H, V)
    torch.cuda.synchronize()
    assert ring_hemm.launches == before + 1
    ref = H.double() @ V.double()
    err = float((W.double() - ref).abs().max() / ref.abs().max())
    errp = float((ring_hemm_reference(H, V).double() - ref).abs().max()
                 / ref.abs().max())
    assert err <= RTOL and err <= 4 * max(errp, 1e-7)


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
    ring_hemm.launches = 0
    res = ct.eigsh(H, 40, 20, tol=1e-2, device=cuda, collect_perf=True,
                   config=ct.ChaseConfig(ring_backend="pallas"))
    assert res.converged and res.V.device.type == "cuda"
    assert ring_hemm.launches == res.perf.filter_hemm_steps > 0
    assert np.abs(res.ritzv - clement_eigenvalues(512)[:40]).max() <= 1e-3
