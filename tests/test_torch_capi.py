"""The port's C ABI, ``libchase_tpu_torch.so`` (``_native/chase_capi.cpp``):
built once for the module, held against the JAX package's
``libchase_tpu.so`` (the same exported ``*chase*`` symbols, every Fortran
declaration of ``interface/chase_tpu_fortran.f90`` resolved) and driven
from C as real processes — the unchanged ``examples/c_interface_demo.c``,
``examples/c_file_demo.c`` (against either library) and small programs
for the p* grids, readHam/wrtHam and the build introspection — on the CPU
(``CHASE_TPU_PLATFORM=cpu``).  The p* grids, and the unchanged
``examples/c_dist_interface_demo.c`` and ``examples/c_dist_2proc_demo.c``,
run as one process per rank of a gloo group (torchrun's variables, and
``JAX_PROCESS_ID``, which the 2-process demo reads for its rank).  The
``gpu``-marked cases run the demos on the card."""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from chase_tpu_torch import io as tio
from chase_tpu_torch.models import clement
from chase_tpu_torch.parallel.operator import DenseOperator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F90 = os.path.join(REPO, "interface", "chase_tpu_fortran.f90")


def _need_compilers():
    if shutil.which("g++") is None or shutil.which("cc") is None:
        pytest.skip("no C/C++ compiler")


@pytest.fixture(scope="module")
def port_lib(tmp_path_factory):
    _need_compilers()
    from chase_tpu_torch import _native
    return _native.build_capi(
        str(tmp_path_factory.mktemp("port") / "libchase_tpu_torch.so"))


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    _need_compilers()
    from chase_tpu import _native
    return _native.build_capi(
        str(tmp_path_factory.mktemp("jax") / "libchase_tpu.so"))


def _link(src: str, lib: str, exe) -> str:
    """cc ``src`` against ``lib`` (by its -l name) with an rpath to it."""
    d = os.path.dirname(lib)
    name = os.path.basename(lib)[3:-3]
    subprocess.run(["cc", "-O2", src, "-L", d, f"-l{name}", "-lm",
                    f"-Wl,-rpath,{d}", "-o", str(exe)], check=True,
                   capture_output=True)
    return str(exe)


def _env(platform="cpu", **extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in sys.path if p])
    env.pop("CHASE_TPU_PLATFORM", None)
    if platform:
        env["CHASE_TPU_PLATFORM"] = platform
    env.update(extra)
    return env


def _run(exe, *args, platform="cpu", **extra):
    return subprocess.run([exe, *map(str, args)], capture_output=True,
                          text=True, env=_env(platform, **extra),
                          timeout=600)


def _exports(lib: str) -> set:
    nm = subprocess.run(["nm", "-D", "--defined-only", lib], check=True,
                        capture_output=True, text=True).stdout
    return {m.group(1) for m in re.finditer(r"\sT\s+(\w*chase\w*)", nm)}


def _f90_names() -> list:
    return sorted(set(re.findall(r"bind\(c,\s*name='([^']+)'\)",
                                 open(F90).read(), re.IGNORECASE)))


def test_export_table_equals_the_jax_librarys(port_lib, jax_lib):
    port, jax = _exports(port_lib), _exports(jax_lib)
    assert len(port) > 90
    assert port == jax, (sorted(port - jax), sorted(jax - port))


def test_every_fortran_declaration_resolves(port_lib):
    names = _f90_names()
    assert len(names) >= 20
    lib = ctypes.CDLL(port_lib)
    assert [n for n in names if not hasattr(lib, n)] == []
    assert sorted(_exports(port_lib) - set(names)) == []


def test_c_interface_demo_passes(port_lib, tmp_path):
    """The unchanged examples/c_interface_demo.c (f64 Clement N=301, init
    with the caller's buffers and the internal-init variant)."""
    exe = _link(os.path.join(REPO, "examples", "c_interface_demo.c"),
                port_lib, tmp_path / "c_demo")
    r = _run(exe)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "C-interface demo: PASS" in r.stdout


@pytest.fixture(scope="module")
def clement_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("file") / "clement600.bin"
    tio.save_matrix(clement(600, np.float32), str(p))
    return str(p)


@pytest.mark.parametrize("lib,backend", [("port", "xla"), ("port", "pallas"),
                                         ("jax", "xla")],
                         ids=["port", "port-pallas", "jax"])
def test_c_file_demo_passes(request, tmp_path, clement_file, lib, backend):
    """examples/c_file_demo.c (f32 Clement from a ChASE file through
    init_internal + readHam, residuals checked in C) links against either
    library and passes at N=600, nev=40, nex=20, tol 1e-3."""
    path = request.getfixturevalue(f"{lib}_lib")
    exe = _link(os.path.join(REPO, "examples", "c_file_demo.c"), path,
                tmp_path / "c_file_demo")
    r = _run(exe, clement_file, 600, 40, 20, 1e-3,
             CHASE_RING_BACKEND=backend)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "c_file_demo: PASS" in r.stdout
    assert re.search(r"init [\d.]+ s, readHam [\d.]+ s, solve [\d.]+ s, "
                     r"get [\d.]+ s", r.stdout)


HEADER = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
void pdchase_init_(int*, int*, int*, int*, int*, double*, int*, double*,
                   double*, int*, int*, char*, void*, int*);
void pdchase_init_blockcyclic_(int*, int*, int*, int*, int*, double*, int*,
                               double*, double*, int*, int*, char*, int*,
                               int*, void*, int*);
void dchase_init_(int*, int*, int*, double*, int*, double*, double*, int*);
void pdchase_(int*, double*, char*, char*, char*);
void pdchase_get_eigenpairs_(double*, int*, double*);
void dchase_(int*, double*, char*, char*, char*);
void dchase_get_eigenpairs_(double*, int*, double*);
void dchase_finalize_(int*);
void pdchase_wrtHam_(const char*);
void dchase_readHam_(const char*);
void chase_has_cuda_(int*);
void chase_has_mpi_(int*);
void chase_has_nccl_(int*);
void chase_has_tpu_(int*);
void chase_get_version_(char*, int*);
static double* clement(int N, double scale) {
    double* H = (double*)calloc((size_t)N * N, sizeof(double));
    for (int i = 0; i < N - 1; ++i) {
        double v = scale * sqrt((double)(i + 1) * (N - i - 1));
        H[i + (size_t)(i + 1) * N] = v;
        H[(i + 1) + (size_t)i * N] = v;
    }
    return H;
}
"""

PINIT = HEADER + r"""
/* pinit m n d0 d1 cyclic: a p* init of Clement N=64 as rank RANK of a
 * d0 x d1 grid ('R' major) — its local (m, n) block (the whole matrix
 * when (m, n) = (N, N)) — then solve, get this rank's rows, check. */
int main(int argc, char** argv) {
    int N = 64, nev = 4, nex = 4, m = atoi(argv[1]), n = atoi(argv[2]);
    int d0 = atoi(argv[3]), d1 = atoi(argv[4]), cyclic = atoi(argv[5]);
    const char* rank_env = getenv("RANK");
    int rank = rank_env ? atoi(rank_env) : 0;
    size_t i0 = m < N ? (size_t)(rank / d1) * m : 0;
    size_t j0 = n < N ? (size_t)(rank % d1) * n : 0;
    int init = 0, deg = 20, mb = 8, zero = 0;
    double tol = 1e-10;
    char major = 'R', mode = 'R', opt = 'S', qr = 'C';
    double* H = clement(N, 1.0);
    double* V = (double*)calloc((size_t)N * (nev + nex), sizeof(double));
    double* ritzv = (double*)calloc(nev + nex, sizeof(double));
    if (cyclic)
        pdchase_init_blockcyclic_(&N, &nev, &nex, &mb, &mb, H, &N, V, ritzv,
                                  &d0, &d1, &major, &zero, &zero, NULL,
                                  &init);
    else
        pdchase_init_(&N, &nev, &nex, &m, &n, H + i0 + j0 * N, &N, V, ritzv,
                      &d0, &d1, &major, NULL, &init);
    printf("initialized\n");
    pdchase_(&deg, &tol, &mode, &opt, &qr);
    pdchase_get_eigenpairs_(V, &m, ritzv);
    int ok = 1;
    for (int i = 0; i < nev; ++i)
        if (fabs(ritzv[i] - (-(N - 1) + 2.0 * i)) > 1e-8) ok = 0;
    /* this rank's rows of the first eigenvector against the same rows
     * of H·v with the whole v: (H v)[i0 + i] = sum_k H[i0+i, k] v[k] */
    double* v = (double*)calloc(N, sizeof(double));
    double rmax = 0.0;
    if (m == N) {
        for (int i = 0; i < N; ++i) v[i] = V[i];
        for (int i = 0; i < N; ++i) {
            double hv = 0.0;
            for (int k = 0; k < N; ++k) hv += H[i + (size_t)k * N] * v[k];
            if (fabs(hv - ritzv[0] * v[i]) > rmax)
                rmax = fabs(hv - ritzv[0] * v[i]);
        }
        if (rmax > 1e-7) ok = 0;
    }
    printf(ok ? "pinit: PASS (resid %.2e)\n" : "pinit: FAIL (resid %.2e)\n",
           rmax);
    return ok ? 0 : 1;
}
"""


@pytest.fixture(scope="module")
def pinit_exe(port_lib, tmp_path_factory):
    d = tmp_path_factory.mktemp("pinit")
    (d / "pinit.c").write_text(PINIT)
    return _link(str(d / "pinit.c"), port_lib, d / "pinit")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(exe, world: int, *args, **extra) -> list:
    """``exe args`` as the ``world`` ranks of a gloo group (torchrun's
    variables, JAX_PROCESS_ID = the rank) on the CPU, started at once;
    each rank's (exit code, stdout, stderr).  Every rank is killed after
    300 s."""
    port = _free_port()
    procs = [subprocess.Popen(
        [exe, *map(str, args)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env("cpu", RANK=str(k), LOCAL_RANK=str(k),
                 WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), JAX_PROCESS_ID=str(k), **extra))
        for k in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


@pytest.mark.parametrize("m,n,d0,d1,cyclic", [
    (32, 64, 2, 1, 0), (64, 32, 1, 2, 0), (64, 64, 2, 1, 0),
    (32, 64, 1, 1, 0), (64, 64, 2, 2, 1)],
    ids=["2x1", "1x2", "2x1_whole", "1x1_local", "blockcyclic_2x2"])
def test_pinit_grid_is_refused_naming_item_5(pinit_exe, m, n, d0, d1,
                                             cyclic):
    """A p* init on a d0×d1 grid run as d0·d1 ranks of a gloo group
    solves: per rank with each rank's (m, n) block (2x1, 1x2), the whole
    matrix on every rank (2x1_whole), block-cyclic (2x2); every rank gets
    Clement's eigenvalues (and, holding all rows, true residuals).  The
    JAX package's refusal remains for 1x1_local: a (32, 64) block is not
    (N/d0, N/d1), and the process ends with the ValueError."""
    ranks = _run_ranks(pinit_exe, d0 * d1, m, n, d0, d1, cyclic)
    if (m, n, d0, d1) == (32, 64, 1, 1):
        rc, out, err = ranks[0]
        assert rc == 1 and "initialized" not in out
        assert "ValueError: local block (32, 64) != (N/dim0, N/dim1) = " \
               "(64, 64)" in err
        assert "capi_init_dist failed; exiting" in err
        return
    for rc, out, err in ranks:
        assert rc == 0, out + err
        assert "pinit: PASS" in out


@pytest.mark.parametrize("m,n,d0,d1", [(32, 64, 2, 1), (64, 64, 2, 1)],
                         ids=["per_rank", "whole"])
def test_pinit_needs_the_grids_world_size(pinit_exe, m, n, d0, d1):
    """A 2x1 p* init in a single process (a group of one): ValueError
    naming both sizes, nothing solves."""
    r = _run(pinit_exe, m, n, d0, d1, 0)
    assert r.returncode == 1 and "initialized" not in r.stdout
    assert "ValueError" in r.stderr
    assert re.search(r"needs? 2.*(process group|the process group) has 1",
                     r.stderr), r.stderr
    assert "capi_init_dist failed; exiting" in r.stderr


@pytest.mark.parametrize("demo,world,passed", [
    ("c_dist_interface_demo", 4, "C-dist-interface demo: PASS"),
    ("c_dist_2proc_demo", 2, "C-dist-2proc demo: PASS")],
    ids=["interface_2x2", "2proc"])
def test_c_dist_demos_run_as_ranks(port_lib, tmp_path, demo, world, passed):
    """The unchanged distributed C demos, one process per rank: the
    block-cyclic Hermitian and the whole-matrix pseudo solve on 2x2 (the
    residual in the caller's row order checked in C), and the per-rank
    2x1 solve, each rank with its own rows."""
    exe = _link(os.path.join(REPO, "examples", f"{demo}.c"), port_lib,
                tmp_path / demo)
    for rank, (rc, out, err) in enumerate(_run_ranks(exe, world)):
        assert rc == 0, out + err
        assert passed in out
        if world == 2:
            assert f"rank {rank} " in out


@pytest.mark.parametrize("cyclic", [0, 1], ids=["blockblock", "blockcyclic"])
def test_pinit_on_a_1x1_grid_solves(pinit_exe, cyclic):
    r = _run(pinit_exe, 64, 64, 1, 1, cyclic)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "pinit: PASS" in r.stdout


HAM = HEADER + r"""
int main(int argc, char** argv) {
    int N = 64, nev = 4, nex = 4, init = 0, deg = 20, flag = 0;
    double tol = 1e-10;
    char mode = 'R', opt = 'S', qr = 'C';
    double* H = clement(N, 1.0);
    double* V = (double*)calloc((size_t)N * (nev + nex), sizeof(double));
    double* ritzv = (double*)calloc(nev + nex, sizeof(double));
    dchase_init_(&N, &nev, &nex, H, &N, V, ritzv, &init);
    pdchase_wrtHam_(argv[1]);          /* the bound H, as a ChASE file */
    dchase_(&deg, &tol, &mode, &opt, &qr);
    dchase_readHam_(argv[2]);          /* replace H: 2 x Clement */
    mode = 'A';
    dchase_(&deg, &tol, &mode, &opt, &qr);
    dchase_get_eigenpairs_(V, &N, ritzv);
    dchase_finalize_(&flag);
    int ok = 1;
    for (int i = 0; i < nev; ++i)
        if (fabs(ritzv[i] - 2.0 * (-(N - 1) + 2.0 * i)) > 1e-8) ok = 0;
    printf(ok ? "ham: PASS\n" : "ham: FAIL\n");
    return ok ? 0 : 1;
}
"""


def test_read_and_write_ham(port_lib, tmp_path):
    """wrtHam writes the session's H as the ChASE file save_matrix writes;
    readHam replaces it, and a mode-'A' solve finds the new spectrum."""
    (tmp_path / "ham.c").write_text(HAM)
    exe = _link(str(tmp_path / "ham.c"), port_lib, tmp_path / "ham")
    out, new = tmp_path / "out.bin", tmp_path / "new.bin"
    tio.save_matrix(2.0 * clement(64), str(new))
    r = _run(exe, out, new)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ham: PASS" in r.stdout
    want = tmp_path / "want.bin"
    tio.save_matrix(clement(64), str(want))
    assert out.read_bytes() == want.read_bytes()


INTROSPECT = HEADER + r"""
int main(void) {
    int cuda = -1, mpi = -1, nccl = -1, tpu = -1, len = 64;
    char version[64];
    chase_has_cuda_(&cuda); chase_has_mpi_(&mpi); chase_has_nccl_(&nccl);
    chase_has_tpu_(&tpu); chase_get_version_(version, &len);
    printf("cuda=%d mpi=%d nccl=%d tpu=%d version=%s\n", cuda, mpi, nccl,
           tpu, version);
    return 0;
}
"""


def test_build_introspection(port_lib, tmp_path):
    (tmp_path / "intro.c").write_text(INTROSPECT)
    exe = _link(str(tmp_path / "intro.c"), port_lib, tmp_path / "intro")
    r = _run(exe)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ("cuda=1 mpi=0 nccl=0 tpu=0 "
                                "version=chase_tpu_torch-0.1.0")


def test_init_without_a_card_fails_loudly(port_lib, tmp_path):
    """Without CHASE_TPU_PLATFORM=cpu the library solves on the card; with
    none, init ends the process with the RuntimeError (no CPU solve)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    exe = _link(os.path.join(REPO, "examples", "c_interface_demo.c"),
                port_lib, tmp_path / "c_demo")
    r = _run(exe, platform=None)
    assert r.returncode == 1
    assert "does not fall back" in r.stderr
    assert "capi_init failed; exiting" in r.stderr
    assert "lambda" not in r.stdout


def test_fortran_compiles_and_runs_if_compiler_present(port_lib, tmp_path):
    fc = shutil.which("gfortran") or shutil.which("flang")
    if fc is None:
        pytest.skip("no Fortran compiler in this image")
    driver = tmp_path / "driver.f90"
    driver.write_text("""
program demo
    use chase_tpu_interface
    use iso_c_binding
    implicit none
    integer(c_int) :: n, nev, nex, ldh, init, deg
    real(c_double) :: tol
    real(c_double), allocatable :: h(:, :), v(:, :), ritzv(:)
    integer :: i
    n = 64; nev = 4; nex = 4; ldh = n; init = 0; deg = 10; tol = 1.0d-8
    allocate(h(n, n), v(n, nev + nex), ritzv(nev + nex))
    h = 0.0d0
    do i = 1, n - 1
        h(i + 1, i) = sqrt(real(i * (n - i), c_double))
        h(i, i + 1) = h(i + 1, i)
    end do
    call dchase_init(n, nev, nex, h, ldh, v, ritzv, init)
    call dchase(deg, tol, 'R', 'S', 'C')
    call dchase_get_eigenpairs(v, n, ritzv)
    call dchase_finalize(init)
    print *, 'fortran demo: PASS', ritzv(1)
end program demo
""")
    exe = str(tmp_path / "fdemo")
    d = os.path.dirname(port_lib)
    subprocess.run([fc, F90, str(driver), "-L", d, "-lchase_tpu_torch",
                    f"-Wl,-rpath,{d}", "-o", exe], check=True,
                   capture_output=True)
    r = _run(exe)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS" in r.stdout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_loaded_matrix_lands_on_the_card(cuda, tmp_path):
    """What readHam places: the Fortran-ordered view load_matrix returns
    is copied to the card as it lies and transposed there, into the
    kernel's padded row-major layout, bitwise equal to the file's
    matrix."""
    N = 1001
    A = np.random.default_rng(6).standard_normal((N, N)).astype(np.float32)
    p = str(tmp_path / "a.bin")
    tio.save_matrix(A, p)
    H = tio.load_matrix(p, N, np.float32)
    assert H.flags.f_contiguous and not H.flags.c_contiguous
    op = DenseOperator(H, "cuda")
    assert op.H.stride() == (1004, 1)
    assert torch.equal(op.H.cpu(), torch.from_numpy(A))


@pytest.mark.gpu
def test_c_interface_demo_on_the_card(cuda, port_lib, tmp_path):
    exe = _link(os.path.join(REPO, "examples", "c_interface_demo.c"),
                port_lib, tmp_path / "c_demo")
    r = _run(exe, platform=None)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "C-interface demo: PASS" in r.stdout


@pytest.mark.gpu
def test_c_file_demo_on_the_card_on_the_ring(cuda, port_lib, tmp_path,
                                             clement_file):
    exe = _link(os.path.join(REPO, "examples", "c_file_demo.c"), port_lib,
                tmp_path / "c_file_demo")
    r = _run(exe, clement_file, 600, 40, 20, 1e-3, platform=None,
             CHASE_RING_BACKEND="pallas")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "c_file_demo: PASS" in r.stdout
    launches = re.search(r"ring_hemm launches in this process: (\d+)",
                         r.stdout)
    assert launches and int(launches.group(1)) > 0
