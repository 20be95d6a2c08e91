"""The port's sharded and block-cyclic I/O, sharded checkpoints and the
CLI's ``--grid``/``--mb`` on gloo process grids, held against the JAX
package's ``chase_tpu.io`` and ``chase_tpu.cli``.

One group of ``tests/torch_grid_worker.py`` ranks per grid shape — (2, 2),
(2, 1), (1, 2), and (3, 1), where N = 130 is ragged — started once for the
module after this process wrote the JAX package's files into the group's
directory (``chase_tpu.io.save_matrix`` of an f64 and a c64 Hermitian H
and a rectangular f32 matrix, a sharded ``save_state`` from a JAX mesh of
the same shape where N divides it).  Each rank's blocks are compared here,
bitwise:

* ``load_matrix_sharded``: DTensor's even split of the file, against the
  file's slice and the JAX reader's shard at the same grid coordinate;
* ``save_matrix_sharded``: the files the ranks wrote — from the readers'
  DTensors and from a whole V in each of the four shardings, over an
  oversized file too — byte-identical to ``chase_tpu.io.save_matrix`` and
  ``save_matrix_sharded`` of the same matrix; refused layouts write
  nothing;
* ``load_matrix_blockcyclic``: the JAX layout's permutation and the JAX
  reader's shard; its one native gather against the numpy gather
  (``CHASE_DISABLE_NATIVE``);
* sharded checkpoints both ways (the port's read by ``chase_tpu.io.
  load_state`` with and without a grid, the JAX package's by the port's
  with ``grid=``), and a warm start from a solve's sharded checkpoint;
* the CLI with ``--grid`` and ``--grid --mb`` against the JAX CLI's
  printed eigenvalues, rank 0 alone printing.
"""

import re

import numpy as np
import pytest
import torch

import jax

import chase_tpu
from chase_tpu import cli as jcli
from chase_tpu import io as jio
from chase_tpu.parallel.layouts import BlockCyclicLayout as JLayout

from chase_tpu_torch import _native
from chase_tpu_torch.models import clement_eigenvalues

import torch_grid_worker as gw

torch.set_num_threads(1)

SHAPES = {"io22": (2, 2), "io21": (2, 1), "io12": (1, 2), "io31": (3, 1)}
N, M, MB = gw.IO["N"], gw.IO["M"], gw.IO["mb"]


def _even(n, p, k):
    chunk = -(-n // p)
    start = min(k * chunk, n)
    return start, min(start + chunk, n)


def _jax_grid(shape):
    return chase_tpu.make_grid(jax.devices()[:shape[0] * shape[1]],
                               shape=shape)


def _divides(shape) -> bool:
    return N % shape[0] == 0 and N % shape[1] == 0


def _write_inputs(d, shape):
    """The JAX package's files the ranks read."""
    for dt in gw.IO_DTYPES:
        jio.save_matrix(gw.io_matrix(dt), str(d / f"jax_{np.dtype(dt).name}"
                                                  f".bin"))
    jio.save_matrix(gw.io_rect(), str(d / "jax_rect.bin"))
    jio.save_matrix(gw.cli_matrix(), str(d / "jax_cli.bin"))
    V, ritzv, meta = gw.io_state()
    if _divides(shape):
        Vj = jax.device_put(V, _jax_grid(shape).sharding("r", None))
    else:
        Vj = V                               # JAX cannot split N here
    jio.save_state(str(d / "jax_state"), Vj, ritzv, meta, sharded=True)
    # an oversized file the sharded writer must cut to the matrix
    (d / "oversized.bin").write_bytes(b"\x7f" * (N * N * 8 + 4096))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {}
    for name, (r, c) in SHAPES.items():
        d = tmp_path_factory.mktemp(name)
        _write_inputs(d, (r, c))
        started[name] = gw.Group(name, r, c, d, timeout=300)
    yield started
    for g in started.values():
        g.kill()


def _ranks(groups, name):
    return groups[name].results()


def _jax_shards(arr) -> dict:
    """grid coordinate → the JAX array's shard there (numpy)."""
    mesh = arr.sharding.mesh
    out = {}
    for i in range(mesh.devices.shape[0]):
        for j in range(mesh.devices.shape[1]):
            dev = mesh.devices[i, j]
            shard = next(s for s in arr.addressable_shards
                         if s.device == dev)
            out[(i, j)] = np.asarray(shard.data)
    return out


@pytest.mark.parametrize("name", list(SHAPES))
def test_load_matrix_sharded_is_the_files_even_split(groups, name):
    """Each rank's block is DTensor's even split of the file, bitwise; on
    the shapes that divide N it is the JAX reader's shard there."""
    shape = SHAPES[name]
    ranks = _ranks(groups, name)
    for dt in gw.IO_DTYPES:
        H = gw.io_matrix(dt)
        dname = np.dtype(dt).name
        jshards = (_jax_shards(jio.load_matrix_sharded(
            str(groups[name].tmp / f"jax_{dname}.bin"), N, dt,
            _jax_grid(shape))) if _divides(shape) else None)
        for rec in ranks:
            i, j = (int(x) for x in rec["io/coords"])
            r0, r1 = _even(N, shape[0], i)
            c0, c1 = _even(N, shape[1], j)
            block = rec[f"io/{dname}"]
            assert block.dtype == H.dtype and bool(rec[f"io/{dname}/layout"])
            np.testing.assert_array_equal(block, H[r0:r1, c0:c1])
            if jshards is not None:
                np.testing.assert_array_equal(block, jshards[(i, j)])
    R = gw.io_rect()
    for rec in ranks:
        i, j = (int(x) for x in rec["io/coords"])
        r0, r1 = _even(N, shape[0], i)
        c0, c1 = _even(M, shape[1], j)
        np.testing.assert_array_equal(rec["io/rect"], R[r0:r1, c0:c1])
        assert bool(rec["io/short_raises"])


@pytest.mark.parametrize("name", list(SHAPES))
def test_sharded_writes_are_the_jax_packages_files(groups, name, tmp_path):
    """Every file the ranks wrote is byte-identical to the one the JAX
    package writes for the same matrix (save_matrix; save_matrix_sharded
    of a mesh-sharded array where the shape divides N); refused layouts
    raise ValueError and write nothing."""
    shape = SHAPES[name]
    d = groups[name].tmp
    ranks = _ranks(groups, name)
    V = gw.io_state()[0]
    wants = {f"port_{np.dtype(dt).name}.bin": gw.io_matrix(dt)
             for dt in gw.IO_DTYPES}
    wants.update({"port_rect.bin": gw.io_rect(), "port_colvec.bin": V,
                  "port_rowvec.bin": V, "port_replicated.bin": V,
                  "port_plain.bin": V,
                  "oversized.bin": gw.io_matrix(np.float64)})
    for fname, A in wants.items():
        ref = tmp_path / fname
        jio.save_matrix(A, str(ref))
        assert (d / fname).read_bytes() == ref.read_bytes(), fname
    if _divides(shape):
        jg = _jax_grid(shape)
        for dt in gw.IO_DTYPES:
            ref = tmp_path / "jax_sharded.bin"
            jio.save_matrix_sharded(jax.device_put(gw.io_matrix(dt),
                                                   jg.sharding("r", "c")),
                                    str(ref))
            assert (d / f"port_{np.dtype(dt).name}.bin").read_bytes() \
                == ref.read_bytes()
    for rec in ranks:
        assert list(rec["io/refused"]) == [True, True]
        assert not bool(rec["io/refused_wrote"])


@pytest.mark.parametrize("name", list(SHAPES))
def test_load_matrix_blockcyclic_matches_jax(groups, name):
    """The ownership-permuted blocks: the JAX layout's permutation, the
    permuted file's even split on every rank, the JAX reader's shard
    where the shape divides N."""
    shape = SHAPES[name]
    ranks = _ranks(groups, name)
    jlay = JLayout(N, MB, *shape)
    for dt in gw.IO_DTYPES:
        dname = np.dtype(dt).name
        P = jlay.apply(gw.io_matrix(dt))
        jshards = None
        if _divides(shape):
            Hj, _ = jio.load_matrix_blockcyclic(
                str(groups[name].tmp / f"jax_{dname}.bin"), N, dt,
                _jax_grid(shape), MB)
            jshards = _jax_shards(Hj)
        for rec in ranks:
            np.testing.assert_array_equal(rec[f"bc/{dname}/perm"],
                                          jlay.row_perm)
            i, j = (int(x) for x in rec["io/coords"])
            r0, r1 = _even(N, shape[0], i)
            c0, c1 = _even(N, shape[1], j)
            np.testing.assert_array_equal(rec[f"bc/{dname}"],
                                          P[r0:r1, c0:c1])
            if jshards is not None:
                np.testing.assert_array_equal(rec[f"bc/{dname}"],
                                              jshards[(i, j)])
        # the layout on a DTensor: gathered, then permuted
        V = gw.io_state()[0]
        for rec in ranks:
            np.testing.assert_array_equal(rec["layout/dtensor"],
                                          jlay.apply_rows(V))
            np.testing.assert_array_equal(rec["layout/dtensor_restore"],
                                          jlay.restore_rows(V))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_read_gather_is_the_files_permuted_block(tmp_path, monkeypatch,
                                                 native):
    """The block-cyclic reader's gather (one native call: each column's
    row span read once) and its numpy version under CHASE_DISABLE_NATIVE
    give the file's rows × columns; indices outside the file raise."""
    if not native:
        monkeypatch.setenv("CHASE_DISABLE_NATIVE", "1")
    A = gw.io_matrix(np.complex64)
    path = str(tmp_path / "a.bin")
    jio.save_matrix(A, path)
    perm = JLayout(N, MB, 3, 2).row_perm
    rows, cols = perm[44:88], perm[65:]
    got = _native.read_gather(path, N, np.complex64, rows, cols)
    np.testing.assert_array_equal(got, A[np.ix_(rows, cols)])
    assert got.flags.f_contiguous
    assert _native.read_gather(path, N, np.complex64, rows[:0],
                               cols).shape == (0, cols.size)
    with pytest.raises(ValueError, match="outside"):
        _native.read_gather(path, N, np.complex64, [N], cols)
    with pytest.raises(OSError):
        _native.read_gather(path, N, np.complex64, rows, [N + 5])


@pytest.mark.parametrize("name", list(SHAPES))
def test_sharded_checkpoints_cross_packages(groups, name):
    """The port's sharded checkpoint loads in JAX (whole, and on a mesh
    where the shape divides N) and the JAX package's in the port with
    grid= (a (Shard(0), Replicate()) DTensor of this rank's rows) and
    without, all bitwise; a solve's V comes back bitwise from a sharded
    checkpoint and warm-starts in no more iterations than the cold
    solve."""
    shape = SHAPES[name]
    V, ritzv, meta = gw.io_state()
    base = str(groups[name].tmp / "port_state")
    ranks = _ranks(groups, name)
    Vw, rw, mw = jio.load_state(base)
    np.testing.assert_array_equal(np.asarray(Vw), V)
    np.testing.assert_array_equal(rw, ritzv)
    assert mw == meta
    if _divides(shape):
        Vs, _, _ = jio.load_state(base + ".npz", grid=_jax_grid(shape))
        np.testing.assert_array_equal(np.asarray(Vs), V)
    for rec in ranks:
        i = int(rec["io/coords"][0])
        r0, r1 = _even(N, shape[0], i)
        assert bool(rec["state/port/same"])
        np.testing.assert_array_equal(rec["state/port"], V[r0:r1])
        np.testing.assert_array_equal(rec["state/jax"], V[r0:r1])
        np.testing.assert_array_equal(rec["state/jax/ritzv"], ritzv)
        assert bool(rec["state/jax/meta"]) and bool(rec["state/jax/layout"])
        np.testing.assert_array_equal(rec["state/jax/whole"], V)
        assert bool(rec["state/solve/bitwise"])
        cold, warm = (int(x) for x in rec["state/solve/iterations"])
        assert warm <= cold
        np.testing.assert_allclose(rec["state/solve/ritzv"],
                                   clement_eigenvalues(N)[:8], rtol=0,
                                   atol=1e-6)


def _eigenvalues(out: str) -> np.ndarray:
    line = next(ln for ln in out.splitlines() if "eigenvalues:" in ln)
    return np.array([float(x) for x in re.findall(
        r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?", line.split(":", 1)[1])])


@pytest.mark.parametrize("name", list(SHAPES))
def test_cli_grid_and_mb_match_jax(groups, name, capsys):
    """``--grid`` (Clement N=128) and ``--grid --mb 8 --path_in`` (a random
    f64 H, N=128, read block-cyclically): exit 0 on every rank, rank 0 alone
    prints, its eigenvalues those of the JAX CLI with the same options
    (on all of its 8 devices) at 1e-6 relative — numpy prints 8 digits."""
    ranks = _ranks(groups, name)
    for case, argv in gw.CLI_GRID.items():
        assert jcli.main(argv(str(groups[name].tmp))) == 0
        jax_ev = _eigenvalues(capsys.readouterr().out)
        for rec in ranks:
            assert int(rec[f"cli/{case}/rc"]) == 0
        outs = [str(rec[f"cli/{case}/out"]) for rec in ranks]
        coords = [tuple(int(x) for x in rec["io/coords"]) for rec in ranks]
        printed = [c for c, o in zip(coords, outs) if o]
        assert printed == [(0, 0)]
        out = outs[coords.index((0, 0))]
        assert "[problem 0] converged in" in out and "GFLOPS" in out
        np.testing.assert_allclose(_eigenvalues(out), jax_ev, rtol=1e-6,
                                   atol=1e-9)
