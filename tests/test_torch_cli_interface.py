"""The flat interface (``chase_tpu_torch.interface``) and the CLI
(``chase_tpu_torch.cli``, ``python -m chase_tpu_torch``) held against
``chase_tpu.interface`` and ``chase_tpu.cli`` on the same problems, on
the CPU (``device="cpu"``, ``--device cpu``).  The distributed init on
the (2, 1), (1, 2) and (2, 2) grids runs in gloo groups of
``tests/torch_grid_worker.py`` ranks started once for the module (the
other distributed modes: ``tests/test_torch_grid_interface.py``)."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import chase_tpu.interface as jface
from chase_tpu import cli as jcli
from chase_tpu import io as jio

import chase_tpu_torch.interface as tface
from chase_tpu_torch import cli as tcli
from chase_tpu_torch.models import clement, clement_eigenvalues, \
    random_hermitian, random_pseudo_hermitian
from chase_tpu_torch.parallel import multihost

import torch_grid_worker as gw

torch.set_num_threads(1)

N, NEV, NEX = 128, 8, 8
GRIDS = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module")
def grid_groups(tmp_path_factory):
    """One group per grid of GRIDS running init(distributed=True) on
    Clement N=128 (the worker's ``case_iface_whole``)."""
    started = {shape: gw.Group(f"w{shape[0]}{shape[1]}", *shape,
                               tmp_path_factory.mktemp("w"), timeout=300)
               for shape in GRIDS}
    yield started
    for g in started.values():
        g.kill()


@pytest.fixture(autouse=True)
def fresh_sessions():
    yield
    jface.finalize()
    tface.finalize()


def _lifecycle(iface, H, **init_kw):
    """init, set_tol, set_deg, solve, get_eigenpairs, a mode-'A' solve;
    (evals, evecs, warm iterations)."""
    assert iface.init(N, NEV, NEX, H, **init_kw) == 0
    iface.set_tol(1e-10)
    iface.set_deg(20)
    assert iface.solve(mode="R", opt="S", qr="C") == 0
    evals, evecs = iface.get_eigenpairs()
    assert iface.solve(mode="A") == 0
    return evals, evecs, iface._require().result.iterations


def test_interface_lifecycle_matches_jax():
    H = clement(N)
    ej, vj, _ = _lifecycle(jface, H)
    et, vt, warm = _lifecycle(tface, H, device="cpu")
    assert isinstance(et, np.ndarray) and isinstance(vt, np.ndarray)
    assert vt.shape == vj.shape == (N, NEV)
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-9)
    np.testing.assert_allclose(et, clement_eigenvalues(N)[:NEV], rtol=0,
                               atol=1e-9)
    assert np.linalg.norm(H @ vt - vt * et, axis=0).max() < 1e-8
    assert warm <= 2                 # mode 'A' from the previous solve
    assert tface.finalize() == 0
    with pytest.raises(RuntimeError):
        tface.get_eigenpairs()
    with pytest.raises(RuntimeError, match="init"):
        tface.solve()


def test_interface_warm_start_from_init_buffers():
    """mode='A' straight from the V/ritzv buffers passed at init (the
    reference's cross-application warm restart), from a JAX session's
    results, as the JAX interface's own test does."""
    H = clement(N)
    jface.init(N, NEV, NEX, H)
    jface.set_tol(1e-9)
    assert jface.solve() == 0
    V, ritzv = np.asarray(jface._session.result.V), \
        jface._session.result.ritzv_full
    tface.init(N, NEV, NEX, H, V=V, ritzv=ritzv, device="cpu")
    tface.set_tol(1e-9)
    assert tface.solve(mode="A") == 0
    assert tface._require().result.iterations <= 2
    np.testing.assert_allclose(tface.get_eigenpairs()[0],
                               clement_eigenvalues(N)[:NEV], rtol=0,
                               atol=1e-9)


def test_interface_mode_a_without_a_start_raises():
    tface.init(N, NEV, NEX, clement(N), device="cpu")
    with pytest.raises(RuntimeError, match="mode='A'"):
        tface.solve(mode="A")


SETTERS = [("set_tol", 1e-7), ("set_deg", 14), ("set_opt", False),
           ("set_maxiter", 9), ("set_lanczos", (17, 3)),
           ("set_decaying_rate", 0.5), ("set_upperb_scale_rate", 1.5),
           ("set_cluster_aware_degrees", False), ("set_max_deg", 30),
           ("set_deg_extra", 4), ("set_cholqr", False), ("set_approx", True),
           ("enable_sym_check", False)]


def test_setter_names_match_jax():
    """The C ABI calls ``'set_' + name``: the port has every setter the JAX
    interface has."""
    names = {n for n in dir(jface) if n.startswith("set_")}
    assert names <= {n for n in dir(tface) if n.startswith("set_")}
    assert names | {"enable_sym_check"} == {s for s, _ in SETTERS}


@pytest.mark.parametrize("setter,value", SETTERS, ids=[s for s, _ in SETTERS])
def test_setters_change_the_config_as_jax(setter, value):
    H = clement(16)
    jface.init(16, 2, 2, H)
    tface.init(16, 2, 2, H, device="cpu")
    args = value if isinstance(value, tuple) else (value,)
    getattr(jface, setter)(*args)
    getattr(tface, setter)(*args)
    jc = dataclasses.asdict(jface._require().config)
    tc = dataclasses.asdict(tface._require().config)
    changed = {k for k, v in jc.items() if v != getattr(jface.ChaseConfig(),
                                                        k)}
    assert changed
    assert {k: tc[k] for k in changed} == {k: jc[k] for k in changed}


def test_interface_pseudo_matches_jax():
    n, nev, nex = 64, 4, 6
    H = np.asarray(random_pseudo_hermitian(n, dtype=np.complex128, seed=3))
    jface.init_pseudo(n, nev, nex, H)
    tface.init_pseudo(n, nev, nex, H, device="cpu")
    assert jface.solve(tol=1e-9) == 0 and tface.solve(tol=1e-9) == 0
    ej, _ = jface.get_eigenpairs()
    et, vt = tface.get_eigenpairs()
    full = np.sort(np.linalg.eigvals(H).real)
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-9)
    np.testing.assert_allclose(et, full[full > 0][:nev], rtol=0, atol=1e-9)
    assert np.linalg.norm(H @ vt - vt * et, axis=0).max() < 1e-7


def test_set_matrix_replaces_h_and_keeps_the_warm_start():
    """``set_matrix`` (the C ABI's readHam) binds a matrix to a session
    made without one, and a later one replaces it (its shadow dropped)
    while mode 'A' starts from the previous result."""
    tface.init(N, NEV, NEX, None, device="cpu")
    with pytest.raises(RuntimeError, match="no matrix"):
        tface.solve()
    tface.set_matrix(clement(N))
    tface.set_tol(1e-10)
    assert tface.solve() == 0
    op = tface._require().op
    tface.set_matrix(2.0 * clement(N))
    assert tface._require().op is not op
    assert tface.solve(mode="A") == 0
    assert tface._require().result.iterations <= 2
    np.testing.assert_allclose(tface.get_eigenpairs()[0],
                               2.0 * clement_eigenvalues(N)[:NEV], rtol=0,
                               atol=1e-9)
    with pytest.raises(ValueError, match="shape"):
        tface.set_matrix(clement(N + 1))


@pytest.mark.parametrize("grid", GRIDS)
def test_interface_refuses_grids_until_multi_gpu(grid_groups, grid):
    """init(distributed=True) on a d0×d1 grid solves when run as d0·d1
    gloo ranks: the JAX interface's eigenvalues on a mesh of that shape
    (and Clement's), bitwise equal on every rank, whole eigenvectors with
    true residuals ≤ 1e-8, each rank holding N/d0 rows of H, a warm solve
    in ≤ 2 iterations.  In one process the grid is refused (ValueError
    naming both sizes), and a 1×1 grid is the one-device solve."""
    ranks = grid_groups[grid].results()
    jface.init(N, NEV, NEX, clement(N), distributed=True, grid_shape=grid)
    jface.set_tol(1e-10)
    jface.set_deg(20)
    assert jface.solve() == 0
    jev = jface.get_eigenpairs()[0]
    H = clement(N)
    for rec in ranks:
        assert int(rec["whole/rc"]) == 0
        np.testing.assert_array_equal(rec["whole/ritzv"],
                                      ranks[0]["whole/ritzv"])
        np.testing.assert_array_equal(rec["whole/V"], ranks[0]["whole/V"])
        assert int(rec["whole/local_rows"]) == N // grid[0]
        assert int(rec["whole/warm"]) <= 2
    ev, V = ranks[0]["whole/ritzv"], ranks[0]["whole/V"]
    np.testing.assert_allclose(ev, jev, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ev, clement_eigenvalues(N)[:NEV], rtol=0,
                               atol=1e-9)
    assert np.linalg.norm(H @ V - V * ev, axis=0).max() < 1e-8
    import torch.distributed as dist
    was = dist.is_initialized()
    try:
        with pytest.raises(ValueError, match=f"need {grid[0] * grid[1]} "
                                             f"ranks.*has 1"):
            tface.init(N, NEV, NEX, H, distributed=True, grid_shape=grid,
                       device="cpu")
    finally:
        if dist.is_initialized() and not was:
            dist.destroy_process_group()
    assert tface.init(N, NEV, NEX, H, distributed=True, grid_shape=(1, 1),
                      device="cpu") == 0
    assert tface._require().grid is None


def test_interface_introspection():
    """has_distribution() is the JAX package's "more than one device can
    be used": more than one card visible, or a group of more than one
    rank (True in the grid groups, tests/test_torch_grid_interface.py)."""
    assert tface.has_gpu() == torch.cuda.is_available()
    assert tface.has_distribution() is (torch.cuda.device_count() > 1
                                        or multihost.is_multihost())
    assert tface.has_pseudo() is True


def test_interface_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="does not fall back"):
        tface.init(N, NEV, NEX, clement(N))
    with pytest.raises(RuntimeError, match="does not fall back"):
        tcli.main(["--n", "16", "--nev", "2", "--isMatGen", "clement"])


def _eigenvalue_lines(out: str) -> list:
    return [np.array([float(x) for x in re.findall(
        r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?", line.split(":", 1)[1])])
        for line in out.splitlines() if "eigenvalues:" in line]


def _files(tmp_path, make, count=1):
    paths = []
    for i in range(count):
        p = str(tmp_path / f"h_{i}.bin")
        jio.save_matrix(make(i), p)
        paths.append(p)
    return paths


CLI_CASES = {
    "generated": lambda tmp: ["--n", "200", "--nev", "10", "--nex", "10",
                              "--isMatGen", "clement", "--tol", "1e-9"],
    "file": lambda tmp: ["--n", "150", "--nev", "8", "--nex", "8",
                         "--path_in", _files(tmp, lambda i: random_hermitian(
                             150, dtype=np.float64, seed=3))[0],
                         "--dtype", "float64", "--tol", "1e-9"],
    "sequence": lambda tmp: ["--n", "120", "--nev", "6", "--nex", "6",
                             "--path_in", _files(tmp, lambda i: (
                                 1.0 + 0.01 * i) * clement(120), 2)[0]
                             .replace("h_0", "h_{}"), "--sequence", "2",
                             "--tol", "1e-9"],
    "fused": lambda tmp: ["--n", "200", "--nev", "10", "--nex", "10",
                          "--isMatGen", "clement", "--tol", "1e-9",
                          "--fused"],
    "pseudo": lambda tmp: ["--n", "64", "--nev", "4", "--nex", "6",
                           "--path_in", _files(tmp, lambda i: np.asarray(
                               random_pseudo_hermitian(
                                   64, dtype=np.complex128, seed=4)))[0],
                           "--dtype", "complex128", "--pseudo", "--tol",
                           "1e-9"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_matches_jax(tmp_path, capsys, case):
    """The port's CLI on ``--device cpu`` prints the eigenvalues the JAX
    CLI prints for the same problem (the same file for file cases):
    numpy prints 8 significant digits, so they are compared at 1e-6
    relative."""
    argv = CLI_CASES[case](tmp_path)
    assert jcli.main(argv) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    problems = 2 if case == "sequence" else 1
    assert out.count("converged in") == jax_out.count("converged in") \
        == problems
    assert "NOT converged" not in out and "GFLOPS" in out
    port, jax = _eigenvalue_lines(out), _eigenvalue_lines(jax_out)
    assert len(port) == len(jax) >= 1
    for p, j in zip(port, jax):
        np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-9)


def test_cli_rejects_the_grid_options():
    """--mb without --grid exits as the JAX CLI does; --grid and --mb
    parse (they run on a grid: tests/test_torch_grid_io.py)."""
    argv = ["--n", "16", "--nev", "2", "--isMatGen", "clement", "--mb", "4"]
    with pytest.raises(SystemExit, match="requires --grid"):
        jcli.main(argv)
    with pytest.raises(SystemExit, match="requires --grid"):
        tcli.main(argv + ["--device", "cpu"])
    args = tcli.build_parser().parse_args(argv + ["--grid"])
    assert args.grid and args.mb == 4
