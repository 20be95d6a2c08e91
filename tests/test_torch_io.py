"""ChASE binary files, the native block reader and warm-restart
checkpoints: the port (``chase_tpu_torch.io``, ``chase_tpu_torch._native``)
held against ``chase_tpu``'s on the same numpy inputs, on the CPU.

A file written by either package is read bitwise by the other; the native
reader agrees with its plain version (numpy, under ``CHASE_DISABLE_NATIVE``)
and with the JAX package's reader; a checkpoint written by either package
warm-starts the other's solver to the same spectrum.
"""

import os

import numpy as np
import pytest
import torch

import chase_tpu
from chase_tpu import _native as jnative
from chase_tpu import io as jio

import chase_tpu_torch as ct
from chase_tpu_torch import _build
from chase_tpu_torch import _native as tnative
from chase_tpu_torch import io as tio
from chase_tpu_torch.models import clement, clement_eigenvalues, \
    random_hermitian
from chase_tpu_torch.parallel.operator import to_device

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
IDS = ["f32", "f64", "c64", "c128"]
PACKAGES = {"jax": jio, "port": tio}


def _matrix(N, M, dtype, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, M))
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal((N, M))
    return A.astype(dtype)


@pytest.fixture
def numpy_reader(monkeypatch):
    """The plain (numpy) reader: CHASE_DISABLE_NATIVE set for the test."""
    monkeypatch.setenv("CHASE_DISABLE_NATIVE", "1")
    assert not tnative.available()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_files_cross_read_bitwise(tmp_path, writer, dtype):
    """A square file written by one package is read bitwise by the other,
    and both write the same bytes."""
    reader = "port" if writer == "jax" else "jax"
    A = _matrix(40, 40, dtype)
    p, q = tmp_path / "w.bin", tmp_path / "r.bin"
    PACKAGES[writer].save_matrix(A, str(p))
    back = PACKAGES[reader].load_matrix(str(p), 40, dtype)
    assert back.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(back, A)
    PACKAGES[reader].save_matrix(A, str(q))
    assert p.read_bytes() == q.read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex64],
                         ids=["f64", "c64"])
def test_non_square_files_cross_read(tmp_path, writer, dtype):
    reader = "port" if writer == "jax" else "jax"
    A = _matrix(30, 17, dtype, seed=1)
    p = tmp_path / "m.bin"
    PACKAGES[writer].save_matrix(A, str(p))
    np.testing.assert_array_equal(
        PACKAGES[reader].load_matrix(str(p), 30, dtype, M=17), A)


def test_file_is_column_major(tmp_path):
    """Byte-compatibility with ChASE: the stream is column-major."""
    H = np.arange(12, dtype=np.float64).reshape(3, 4)
    p = tmp_path / "cm.bin"
    tio.save_matrix(H, str(p))
    np.testing.assert_array_equal(np.fromfile(p, dtype=np.float64),
                                  H.flatten(order="F"))


@pytest.mark.parametrize("view", ["plain", "conj", "neg", "transposed",
                                  "f32"])
def test_save_matrix_takes_tensors(tmp_path, view):
    """A tensor is written as the values it stands for, lazy conj/neg
    views resolved — the bytes the JAX package writes for those values."""
    A = random_hermitian(24, dtype=np.complex128, seed=2)
    A[0, 1] += 0.5                               # not Hermitian: order shows
    t = torch.from_numpy(A.copy())
    want = {"plain": (t, A), "conj": (t.conj(), A.conj()),
            "neg": (t.conj().imag, -A.imag),
            "transposed": (t.T, A.T),
            "f32": (t.real.float(), A.real.astype(np.float32))}[view]
    if view == "neg":
        assert want[0].is_neg()
    p, q = tmp_path / "t.bin", tmp_path / "j.bin"
    tio.save_matrix(want[0], str(p))
    jio.save_matrix(want[1], str(q))
    assert p.read_bytes() == q.read_bytes()


def test_load_matrix_refuses_a_short_file(tmp_path):
    p = tmp_path / "short.bin"
    np.zeros(10).tofile(p)
    with pytest.raises(ValueError, match="expected"):
        tio.load_matrix(str(p), 4, np.float64)


def test_native_builds_into_the_checkouts_build_dir():
    lib = tnative.get_lib()
    assert lib is not None and tnative.available()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == str(_build.BUILD_DIR)
    assert os.path.basename(path).startswith("libchaseio-")
    assert tnative.get_lib() is lib              # built and loaded once


BLOCKS = [(0, 64, 0, 48), (10, 20, 5, 17), (63, 1, 47, 1), (0, 64, 30, 0)]


@pytest.mark.parametrize("block", BLOCKS,
                         ids=["full", "inner", "corner", "no_cols"])
def test_read_block_matches_numpy_and_jax(tmp_path, monkeypatch, block):
    A = _matrix(64, 48, np.float64, seed=3)
    p = str(tmp_path / "a.bin")
    tio.save_matrix(A, p)
    r0, nr, c0, nc = block
    native = tnative.read_block(p, 64, np.float64, r0, nr, c0, nc)
    np.testing.assert_array_equal(native, A[r0:r0 + nr, c0:c0 + nc])
    np.testing.assert_array_equal(
        native, jnative.read_block(p, 64, np.float64, r0, nr, c0, nc))
    monkeypatch.setenv("CHASE_DISABLE_NATIVE", "1")
    np.testing.assert_array_equal(
        tnative.read_block(p, 64, np.float64, r0, nr, c0, nc), native)


def test_read_block_complex(tmp_path):
    H = random_hermitian(40, dtype=np.complex128, seed=1)
    p = str(tmp_path / "h.bin")
    jio.save_matrix(H, p)
    blk = tnative.read_block(p, 40, np.complex128, 8, 16, 0, 40)
    np.testing.assert_array_equal(blk, H[8:24])
    np.testing.assert_array_equal(
        blk, jnative.read_block(p, 40, np.complex128, 8, 16, 0, 40))


@pytest.mark.parametrize("reader", ["native", "numpy"])
def test_write_block_round_trip(tmp_path, monkeypatch, reader):
    """write_block into a pre-sized file and into a new one: the bytes
    equal the JAX package's native writer's, and the block reads back."""
    if reader == "numpy":
        monkeypatch.setenv("CHASE_DISABLE_NATIVE", "1")
    N = 32
    rng = np.random.default_rng(2)
    blk = rng.standard_normal((12, 8))
    p, q = str(tmp_path / "w.bin"), str(tmp_path / "j.bin")
    np.zeros(N * N).tofile(p)
    np.zeros(N * N).tofile(q)
    tnative.write_block(p, N, blk, 4, 3)
    jnative.write_block(q, N, blk, 4, 3)
    assert open(p, "rb").read() == open(q, "rb").read()
    np.testing.assert_array_equal(
        tnative.read_block(p, N, np.float64, 4, 12, 3, 8), blk)
    new = str(tmp_path / "new.bin")
    tnative.write_block(new, N, blk, 0, 0)
    np.testing.assert_array_equal(
        tnative.read_block(new, N, np.float64, 0, 12, 0, 8), blk)


@pytest.mark.parametrize("reader", ["native", "numpy"])
def test_read_block_errors(tmp_path, monkeypatch, reader):
    if reader == "numpy":
        monkeypatch.setenv("CHASE_DISABLE_NATIVE", "1")
    with pytest.raises(OSError):
        tnative.read_block(str(tmp_path / "missing.bin"), 10, np.float64,
                           0, 10, 0, 10)
    p = str(tmp_path / "short.bin")
    np.zeros(10).tofile(p)
    with pytest.raises(OSError):                 # premature end of file
        tnative.read_block(p, 100, np.float64, 0, 100, 0, 100)
    with pytest.raises(ValueError):              # rows past the matrix
        tnative.read_block(p, 5, np.float64, 3, 4, 0, 1)


def test_load_matrix_numpy_reader_parity(tmp_path, numpy_reader):
    H = random_hermitian(48, dtype=np.complex64, seed=4)
    p = str(tmp_path / "h48.bin")
    jio.save_matrix(H, p)
    np.testing.assert_array_equal(tio.load_matrix(p, 48, np.complex64), H)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a build that fails raises, unless the caller
    asked for the numpy path with CHASE_DISABLE_NATIVE."""
    p = str(tmp_path / "one.bin")
    np.zeros(1).tofile(p)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed on chaseio.cpp"):
        tio.load_matrix(p, 1, np.float64)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="could not run"):
        tnative.get_lib()
    monkeypatch.setenv("CHASE_DISABLE_NATIVE", "1")
    assert not tnative.available()
    np.testing.assert_array_equal(tio.load_matrix(p, 1, np.float64),
                                  [[0.0]])


def test_a_loaded_matrix_solves_on_the_ring_path(tmp_path):
    """load_matrix returns a Fortran-ordered view; placed on the CPU it
    becomes a row-major operator, which the ring path's plain version
    needs (it refuses a column-major H)."""
    N = 200
    p = str(tmp_path / "c.bin")
    tio.save_matrix(clement(N, np.float32), p)
    H = tio.load_matrix(p, N, np.float32)
    assert H.flags.f_contiguous and not H.flags.c_contiguous
    assert ct.DenseOperator(H, "cpu").H.stride() == (N, 1)
    cfg = ct.ChaseConfig(ring_backend="pallas", mixed_precision=False)
    r = ct.eigsh(H, 20, 12, tol=1e-3, device="cpu", config=cfg,
                 collect_perf=True)
    assert r.converged and r.perf.filter_hemm_steps > 0
    np.testing.assert_allclose(r.ritzv, clement_eigenvalues(N)[:20],
                               rtol=0, atol=1e-2)


def _layouts(A):
    """``A``'s values in the layouts a caller may hand the solver."""
    ro = np.array(A)
    ro.flags.writeable = False
    return {"c": np.array(A), "fortran": np.asfortranarray(A),
            "reversed": np.ascontiguousarray(A[::-1])[::-1],
            "read_only": ro, "strided": np.array(np.repeat(A, 2, 1))[:, ::2]}


@pytest.mark.parametrize("layout", ["c", "fortran", "reversed", "read_only",
                                    "strided"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex128],
                         ids=["f32", "c128"])
def test_placement_is_row_major_and_never_aliases(layout, dtype):
    """A numpy H in any layout becomes a row-major operator holding its
    values, not a view of the caller's buffer (the solver writes its
    blocks in place)."""
    A = _matrix(24, 24, dtype, seed=5)
    a = _layouts(A)[layout]
    op = ct.DenseOperator(a, "cpu")
    t = to_device(a, torch.device("cpu"))
    for x in (op.H, t):
        assert x.is_contiguous()
        np.testing.assert_array_equal(x.numpy(), A)
        assert not np.shares_memory(x.numpy(), a)


def _jax_solve(H, tol, **kw):
    return chase_tpu.eigsh(H, 8, 8, tol=tol, **kw)


def _port_solve(H, tol, **kw):
    cfg = ct.ChaseConfig(mixed_precision=False)
    return ct.eigsh(H, 8, 8, tol=tol, device="cpu", config=cfg, **kw)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("dtype,tol,ev_tol", [(np.float64, 1e-10, 1e-9),
                                              (np.float32, 1e-5, 1e-4)],
                         ids=["f64", "f32"])
def test_checkpoint_cross_loads_and_warm_starts(tmp_path, direction, dtype,
                                                tol, ev_tol):
    """A checkpoint written by one package is loaded by the other and
    warm-starts its solver to the same converged spectrum."""
    N = 128
    H = clement(N, dtype=dtype)
    writer, resume = ((_jax_solve, _port_solve) if direction == "jax_to_port"
                      else (_port_solve, _jax_solve))
    save, load = ((jio.save_state, tio.load_state)
                  if direction == "jax_to_port"
                  else (tio.save_state, jio.load_state))
    r = writer(H, tol)
    p = str(tmp_path / "state")
    save(p, r.V, r.ritzv_full, {"N": N})
    V, ritzv, meta = load(p)
    assert meta == {"N": N}
    want_V = r.V.numpy() if isinstance(r.V, torch.Tensor) else np.asarray(r.V)
    np.testing.assert_array_equal(np.asarray(V), want_V)
    np.testing.assert_array_equal(ritzv, r.ritzv_full)
    r2 = resume(H, tol, v0=V, ritzv0=ritzv, approx=True)
    # as the JAX package's own checkpoint test (f32 warm starts at tol
    # 1e-5 take 4-5 iterations in either package, f64 ones 1)
    assert r2.converged and r2.iterations <= r.iterations
    np.testing.assert_allclose(r2.ritzv, r.ritzv, rtol=0, atol=ev_tol)
    np.testing.assert_allclose(r2.ritzv, clement_eigenvalues(N)[:8], rtol=0,
                               atol=ev_tol)


def test_checkpoint_reads_a_sharded_jax_state(tmp_path):
    """A checkpoint whose V the JAX package wrote per shard (``.V.bin``
    beside the ``.npz``) is read whole on one device."""
    H = clement(128)
    grid = chase_tpu.make_grid()
    r = chase_tpu.eigsh(H, 8, 8, tol=1e-9, grid=grid)
    p = str(tmp_path / "state")
    jio.save_state(p, r.V, r.ritzv_full, {"N": 128}, sharded=True)
    V, ritzv, meta = tio.load_state(p + ".npz")
    assert meta == {"N": 128}
    np.testing.assert_array_equal(V, np.asarray(r.V))
    r2 = _port_solve(H, 1e-10, v0=V, ritzv0=ritzv, approx=True)
    assert r2.converged and r2.iterations <= 2


def test_save_state_takes_a_tensor(tmp_path):
    V = torch.randn(16, 4, dtype=torch.complex128)
    p = str(tmp_path / "s.npz")
    tio.save_state(p, V.conj(), torch.arange(4.0))
    V2, r2, meta = tio.load_state(p)
    np.testing.assert_array_equal(V2, V.conj().resolve_conj().numpy())
    np.testing.assert_array_equal(r2, np.arange(4.0))
    assert meta == {}
